"""The port's full-sequence path (``GQA.fwd``, ``forward``,
``forward_features``, ``prefill_logits``, ``prefill``), its plain
attention twins and its shape plan against the JAX reference, on the
CPU, where ``ops.flash_attention`` runs its plain version.

Models are compared on f32 smoke configs from the reference's own
weights (``interop.params_from_numpy``); logits within 1e-4 (f32
products summed in another order) with identical argmax.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models.attention as ref_attention
from repro.dist.context import set_activation_axes
from repro.kernels import ops as ref_ops
from repro.models import transformer as RT

import repro_torch.configs as pt_configs
from repro_torch import interop
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models import attention as PA
from repro_torch.models import transformer as PT
from torch_threads import one_torch_thread  # noqa: F401

_TOL = 1e-4

#: (arch, config overrides): QKV bias, g = 4, Hkv = 1, gelu/layernorm,
#: non-causal with embedding inputs and D = 20, a sliding window, and
#: causal with embedding inputs (pixtral)
_MODELS = [
    ("qwen1.5-0.5b", ()),
    ("mistral-nemo-12b", ()),
    ("internlm2-20b", ()),
    ("starcoder2-7b", ()),
    ("hubert-xlarge", ()),
    ("mistral-nemo-12b", (("sliding_window", 8),)),
    ("pixtral-12b", ()),
]
_IDS = ["qwen", "mistral", "internlm2", "starcoder2", "hubert",
        "mistral-window8", "pixtral"]


@pytest.fixture(autouse=True)
def _no_mesh():
    """A mesh left bound by another test on this worker (the reference's
    train() never clears its activation axes) would break the reference
    forward."""
    set_activation_axes()
    yield


@functools.lru_cache(maxsize=None)
def _model(arch: str, overrides: tuple):
    """f32 reference and port configs, the reference's weights and the
    same weights in the port's layout."""
    kw = dict(overrides, dtype="float32")
    cfg_ref = ref_configs.get_config(arch, "smoke").replace(**kw)
    cfg = pt_configs.get_config(arch, "smoke").replace(**kw)
    params = RT.init(jax.random.PRNGKey(0), cfg_ref)
    port = interop.params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                     device="cpu")
    return cfg_ref, cfg, params, port


def _batch(cfg, B, S, seed=0):
    """The same inputs for both packages: tokens or frame embeddings."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        a = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
        return jnp.asarray(a), torch.from_numpy(a).long()
    a = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _close_logits(port: torch.Tensor, ref) -> None:
    ref = np.asarray(ref, np.float32)
    out = port.float().numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=_TOL, atol=_TOL)
    assert (out.argmax(-1) == ref.argmax(-1)).all()


# --------------------------------------------------------------------------
# Shapes
# --------------------------------------------------------------------------

def test_shapes_field_equal():
    assert list(pt_configs.SHAPES) == list(ref_configs.SHAPES)
    for name, spec in pt_configs.SHAPES.items():
        assert dataclasses.asdict(spec) == \
            dataclasses.asdict(ref_configs.SHAPES[name])


@pytest.mark.parametrize("arch", ref_configs.arch_names())
@pytest.mark.parametrize("variant", ["full", "smoke"])
def test_shape_plan_equal(arch, variant):
    assert pt_configs.shape_plan(pt_configs.get_config(arch, variant)) == \
        ref_configs.shape_plan(ref_configs.get_config(arch, variant))


# --------------------------------------------------------------------------
# Plain attention twins
# --------------------------------------------------------------------------

def _qkv(B, S, H, Hkv, D, seed=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D))]


@pytest.mark.parametrize("causal,window,q_offset", [
    (True, None, 0), (True, 5, 0), (False, None, 0), (False, 7, 0),
    (True, 4, 9), (True, None, -3)])
def test_causal_mask_bias_twin(causal, window, q_offset):
    ref = ref_attention.causal_mask_bias(12, 20, causal=causal,
                                         window=window, q_offset=q_offset)
    out = PA.causal_mask_bias(12, 20, causal=causal, window=window,
                              q_offset=q_offset)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("H,Hkv", [(4, 4), (8, 2), (6, 1)])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 6),
                                           (False, None)])
def test_sdpa_twin(H, Hkv, causal, window):
    B, S, D = 2, 33, 16
    q, k, v = _qkv(B, S, H, Hkv, D)
    scale = 1.0 / math.sqrt(D)
    ref = ref_attention.sdpa(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        ref_attention.causal_mask_bias(S, S, causal=causal, window=window),
        scale=scale)
    out = PA.sdpa(torch.from_numpy(q), torch.from_numpy(k),
                  torch.from_numpy(v),
                  PA.causal_mask_bias(S, S, causal=causal, window=window),
                  scale=scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 24),
                                           (True, 3), (False, None)])
@pytest.mark.parametrize("q_chunk,kv_chunk", [(32, 32), (64, 16), (48, 40)])
def test_blockwise_sdpa_twin(causal, window, q_chunk, kv_chunk):
    """Small chunks, so that several query and KV blocks (and, with a
    window, the KV span) are walked; 48 and 40 halve to divide S."""
    B, S, H, Hkv, D = 1, 128, 4, 2, 16
    q, k, v = _qkv(B, S, H, Hkv, D, seed=5)
    scale = 1.0 / math.sqrt(D)
    ref = ref_attention.blockwise_sdpa(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale,
        causal=causal, window=window, q_chunk=q_chunk, kv_chunk=kv_chunk)
    out = PA.blockwise_sdpa(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        scale=scale, causal=causal, window=window, q_chunk=q_chunk,
        kv_chunk=kv_chunk)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


def test_flash_attention_matches_reference_model_attention():
    """The op the port's default path takes equals the reference's XLA
    blockwise path (``tests/test_kernels.py``'s model-attention check)."""
    B, S, H, Hkv, D = 2, 256, 4, 2, 64
    q, k, v = _qkv(B, S, H, Hkv, D, seed=6)
    ref = ref_attention.blockwise_sdpa(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        scale=1.0 / np.sqrt(D), causal=True, window=None, q_chunk=64,
        kv_chunk=64)
    out = PA.ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


# --------------------------------------------------------------------------
# The attention layer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,overrides", _MODELS, ids=_IDS)
def test_gqa_fwd_matches_reference(arch, overrides):
    cfg_ref, cfg, params, port = _model(arch, overrides)
    B, S = 2, 24
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    cos, sin = RT._rope_for(cfg_ref, jnp.arange(S))
    ref = jax.jit(lambda p, x: ref_attention.GQA.fwd(p, cfg_ref, x, cos, sin))(
        jax.tree.map(lambda a: a[0], params["stack"][0]["mixer"]),
        jnp.asarray(x))
    pcos, psin = PT._rope_for(cfg, torch.arange(S))
    for impl in ("kernel", "xla"):
        out = PA.GQA.fwd(port["layers"][0]["mixer"], cfg,
                         torch.from_numpy(x), pcos, psin, impl=impl)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=_TOL,
                                   atol=_TOL)
    with pytest.raises(ValueError):
        PA.GQA.fwd(port["layers"][0]["mixer"], cfg, torch.from_numpy(x),
                   pcos, psin, impl="pallas")


# --------------------------------------------------------------------------
# Model entry points
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,overrides", _MODELS, ids=_IDS)
def test_forward_entry_points_match_reference(arch, overrides):
    """forward, forward_features and prefill_logits on both of the
    port's paths against the reference's XLA path."""
    cfg_ref, cfg, params, port = _model(arch, overrides)
    jb, tb = _batch(cfg, 2, 24)
    logits, aux = jax.jit(lambda p, b: RT.forward(p, cfg_ref, b))(params, jb)
    feats, _ = jax.jit(lambda p, b: RT.forward_features(p, cfg_ref, b))(
        params, jb)
    last = jax.jit(lambda p, b: RT.prefill_logits(p, cfg_ref, b))(params, jb)
    for impl in ("kernel", "xla"):
        with torch.inference_mode():
            p_logits, p_aux = PT.forward(port, cfg, tb, impl=impl)
            p_feats, _ = PT.forward_features(port, cfg, tb, impl=impl)
            p_last = PT.prefill_logits(port, cfg, tb, impl=impl)
        _close_logits(p_logits, logits)
        _close_logits(p_last, last)
        np.testing.assert_allclose(p_feats.numpy(), np.asarray(feats),
                                   rtol=_TOL, atol=_TOL)
        assert set(p_aux) == set(aux)
        assert all(float(a) == 0.0 for a in p_aux.values())
    np.testing.assert_array_equal(
        PT.head_matrix(port, cfg).numpy(),
        np.asarray(RT.head_matrix(params, cfg_ref)))


def _kernel_decode_sdpa(q, k, v, length_mask, *, scale):
    """The function the TPU decode kernel computes, in ``decode_sdpa``'s
    signature (f32 softmax weights, as the port's kernel keeps them)."""
    del scale  # ops.decode_attention uses 1/sqrt(D), as decode_sdpa's caller
    lengths = length_mask.sum(-1).astype(jnp.int32)
    return ref_ops.decode_attention(q, k, v, lengths, interpret=True)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,overrides", _MODELS, ids=_IDS)
def test_prefill_matches_reference(monkeypatch, arch, overrides,
                                   cache_dtype):
    """prefill replays the prompt through decode_step, as the
    reference's does, with the reference's decode core pointed at the
    kernel's function (f32 softmax weights, as the port's kernel).

    With f32 caches (both packages' ``init_cache`` patched) the last
    logits agree to 1e-4.  With the real bf16 caches the caches agree to
    one bf16 ulp (2^-8 relative: an f32 value near a rounding boundary
    may round the other way, its f32 sums being taken in another order),
    and one such cached value moves the logits by a few 1e-4 (measured
    up to 5.3e-4), so the logits bound is 2e-3."""
    monkeypatch.setattr(ref_attention, "decode_sdpa", _kernel_decode_sdpa)
    if cache_dtype == "float32":
        monkeypatch.setattr(RT, "init_cache", functools.partial(
            RT.init_cache, dtype=jnp.float32))
        monkeypatch.setattr(PT, "init_cache", functools.partial(
            PT.init_cache, dtype=torch.float32))
    cfg_ref, cfg, params, port = _model(arch, overrides)
    jb, tb = _batch(cfg, 2, 12, seed=1)
    logits, cache = RT.prefill(params, cfg_ref, jb, 16)
    with torch.inference_mode():
        p_logits, p_cache = PT.prefill(port, cfg, tb, 16)
    tol = _TOL if cache_dtype == "float32" else 2e-3
    ref = np.asarray(logits, np.float32)
    np.testing.assert_allclose(p_logits.numpy(), ref, rtol=tol, atol=tol)
    assert (p_logits.numpy().argmax(-1) == ref.argmax(-1)).all()
    ulp = _TOL if cache_dtype == "float32" else 2 ** -8
    for r in range(cfg.n_layers):
        for name in ("k", "v"):
            got = p_cache["layers"][r][name]
            assert got.dtype == getattr(torch, cache_dtype)
            np.testing.assert_allclose(
                got.float().numpy(),
                np.asarray(cache["stack"][0][name][r], np.float32),
                rtol=ulp, atol=ulp)


@pytest.mark.parametrize("arch,overrides", [_MODELS[0], _MODELS[4],
                                            _MODELS[5]],
                         ids=["qwen", "hubert", "mistral-window8"])
def test_long_sequence_forward_matches_reference(arch, overrides):
    """S = 2304 > 2048 takes blockwise_sdpa on the XLA paths (q_chunk
    halves to 256), causal, non-causal and with a window, on a 1-layer
    config."""
    cfg_ref, cfg, params, port = _model(arch, overrides + (("n_layers", 1),))
    jb, tb = _batch(cfg, 1, 2304, seed=2)
    logits, _ = jax.jit(lambda p, b: RT.forward(p, cfg_ref, b))(params, jb)
    for impl in ("kernel", "xla"):
        with torch.inference_mode():
            p_logits, _ = PT.forward(port, cfg, tb, impl=impl)
        _close_logits(p_logits, logits)


def test_cpu_forward_counts_no_launch():
    """On the CPU every op takes its plain version: no kernel launches."""
    _, cfg, _, port = _model("qwen1.5-0.5b", ())
    _, tb = _batch(cfg, 1, 8)
    reset_launch_counts()
    with torch.inference_mode():
        PT.prefill_logits(port, cfg, tb)
    assert launch_counts() == {"rmsnorm": 0, "decode_attention": 0,
                               "flash_attention": 0, "event_scan": 0,
                               "mamba_scan": 0}
