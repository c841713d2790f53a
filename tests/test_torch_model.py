"""The port's configs, parameters and dense decode path against the
JAX reference, on the CPU (the kernels' plain versions run there)."""

import dataclasses
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
from repro_torch.models import attention as PA
from repro_torch.models import common as PC
from repro_torch.models import transformer as PT

_VARIANTS = [(a, v) for a in ref_configs.arch_names() for v in ("full",
                                                                 "smoke")]
_DENSE_GQA = ["qwen1.5-0.5b", "mistral-nemo-12b", "internlm2-20b",
              "starcoder2-7b", "pixtral-12b"]


@pytest.fixture(autouse=True)
def _no_mesh():
    """A mesh left bound by another test on this worker (the reference's
    train() never clears its activation axes) would break the reference
    decode path."""
    set_activation_axes()
    yield


def kernel_decode_sdpa(q, k, v, length_mask, *, scale):
    """The function the TPU kernel computes, in ``decode_sdpa``'s
    signature: the reference's Pallas decode attention (interpret mode)
    over the valid prefix.  Unlike ``decode_sdpa`` it keeps the softmax
    weights in f32, as the port's kernel does."""
    del scale  # ops.decode_attention uses 1/sqrt(D), as decode_sdpa's caller
    lengths = length_mask.sum(-1).astype(jnp.int32)
    return ref_ops.decode_attention(q, k, v, lengths, interpret=True)


@pytest.mark.parametrize("arch,variant", _VARIANTS)
def test_config_field_equal(arch, variant):
    ref = ref_configs.get_config(arch, variant)
    port = pt_configs.get_config(arch, variant)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.q_per_kv == ref.q_per_kv
    assert port.compute_dtype == getattr(torch, ref.dtype)
    assert PT.unit_period(port) == RT.unit_period(ref)


#: The reference's ``repro.models`` names the port does not export yet:
#: none.
_UNPORTED_MODEL_NAMES: set[str] = set()


def test_models_package_exports_reference_names():
    """``repro_torch.models`` exports what ``repro.models`` does, less the
    unported names, each the port's own (not a re-export of JAX code)."""
    import repro.models as ref_models
    import repro_torch.models as port_models
    want = set(ref_models.__all__) - _UNPORTED_MODEL_NAMES
    assert want <= set(port_models.__all__)
    assert port_models.transformer is PT
    for name in want - {"transformer"}:
        assert getattr(port_models, name).__module__.startswith(
            "repro_torch.models")
    from repro_torch.models import (count_params, decode_step,  # noqa: F401
                                    forward, init, init_cache, prefill,
                                    transformer, unit_period)
    assert transformer.decode_step is decode_step is PT.decode_step


def test_arch_names_equal():
    assert pt_configs.arch_names() == ref_configs.arch_names()


@pytest.mark.parametrize("arch", _DENSE_GQA)
def test_count_params_smoke(arch):
    ref_cfg = ref_configs.get_config(arch, "smoke")
    port = PT.init(pt_configs.get_config(arch, "smoke"), seed=0, device="cpu")
    ref = RT.init(jax.random.PRNGKey(0), ref_cfg)
    assert PT.count_params(port) == RT.count_params(ref)


def _shape_tree(cfg):
    """The reference's parameter tree at ``cfg``'s full size, as
    zero-stride NumPy views: shapes without the memory."""
    shapes = jax.eval_shape(lambda: RT.init(jax.random.PRNGKey(0), cfg))
    return jax.tree.map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes)


def test_count_params_full_qwen():
    """weights_bytes = 2 * n_params feeds every modelled round time, so
    the count must match the reference leaf for leaf."""
    cfg = ref_configs.get_config("qwen1.5-0.5b", "full")
    tree = _shape_tree(cfg)
    n_ref = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(tree))
    port = interop.params_from_numpy(
        tree, pt_configs.get_config("qwen1.5-0.5b", "full"), device="meta")
    assert n_ref == PT.count_params(port) == 463_987_712


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "starcoder2-7b"])
def test_params_from_numpy_round_trips_shapes(arch):
    ref_cfg = ref_configs.get_config(arch, "smoke")
    cfg = pt_configs.get_config(arch, "smoke")
    tree = jax.tree.map(np.asarray, RT.init(jax.random.PRNGKey(0), ref_cfg))
    port = interop.params_from_numpy(tree, cfg, device="cpu")
    own = PT.init(cfg, seed=0, device="cpu")

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return (tuple(t.shape), t.dtype)

    assert shapes(port) == shapes(own)
    assert len(port["layers"]) == cfg.n_layers
    # layer r of the unstacked port tree is slice r of the reference stack
    for r in (0, cfg.n_layers - 1):
        np.testing.assert_array_equal(
            port["layers"][r]["mixer"]["wq"]["w"].float().numpy(),
            tree["stack"][0]["mixer"]["wq"]["w"][r].astype(np.float32)
            .astype(jnp.bfloat16).astype(np.float32))
    assert port["final_norm"]["scale"].dtype == torch.float32


def test_unsupported_archs_raise():
    """Only xLSTM is left to port; deepseek-v2 (MLA) initialises."""
    with pytest.raises(NotImplementedError):
        PT.init(pt_configs.get_config("xlstm-125m", "smoke"), device="cpu")
    PT.init(pt_configs.get_config("deepseek-v2-236b", "smoke"), device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference_layer(dtype):
    from repro.models import common as RC
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 96)).astype(np.float32)
    s = (rng.standard_normal(96) * 0.1 + 1.0).astype(np.float32)
    ref = RC.rmsnorm({"scale": jnp.asarray(s)},
                     jnp.asarray(x, getattr(jnp, dtype)))
    out = PC.rmsnorm({"scale": torch.from_numpy(s)},
                     torch.from_numpy(x).to(getattr(torch, dtype)))
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol, atol=tol)


def test_rope_rotates_halves_like_reference():
    from repro.models import common as RC
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    pos = np.array([0, 7, 300], np.int32)
    c, s = RC.rope_tables(jnp.asarray(pos), 16, 1e4)
    ref = RC.apply_rope(jnp.asarray(x), c, s)
    pc, ps = PC.rope_tables(torch.from_numpy(pos), 16, 1e4)
    out = PC.apply_rope(torch.from_numpy(x), pc, ps)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("g", [1, 4])
def test_decode_sdpa_twin_matches_reference(g):
    rng = np.random.default_rng(2)
    B, T, Hkv, D = 2, 40, 2, 16
    q = rng.standard_normal((B, Hkv * g, D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    mask = np.arange(T)[None, :] < np.array([[7], [40]])
    scale = 1.0 / math.sqrt(D)
    ref = ref_attention.decode_sdpa(
        jnp.asarray(q), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), jnp.asarray(mask), scale=scale)
    out = PA.decode_sdpa(
        torch.from_numpy(q), torch.from_numpy(k).bfloat16(),
        torch.from_numpy(v).bfloat16(), torch.from_numpy(mask), scale=scale)
    # both round their output to the bf16 cache dtype: one bf16 ulp
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=1e-2,
                               atol=1e-2)


def _decode_both(cfg_ref, cfg_port, prompt, max_len):
    """Replay ``prompt`` through both decode_steps from the reference's
    f32 weights; returns per-position logits and the final caches."""
    params = RT.init(jax.random.PRNGKey(0), cfg_ref)
    port_params = interop.params_from_numpy(
        jax.tree.map(np.asarray, params), cfg_port, device="cpu")
    step = jax.jit(lambda p, t, c, s: RT.decode_step(p, cfg_ref, t, c, s))
    cache = RT.init_cache(cfg_ref, 1, max_len)
    pcache = PT.init_cache(cfg_port, 1, max_len, device="cpu")
    ref_logits, port_logits = [], []
    with torch.inference_mode():
        for s, tok in enumerate(prompt):
            lg, cache = step(params, jnp.asarray([tok], jnp.int32), cache, s)
            ref_logits.append(np.asarray(lg, np.float32))
            plg, pcache = PT.decode_step(
                port_params, cfg_port, torch.tensor([int(tok)]), pcache, s)
            port_logits.append(plg.float().numpy())
    return (np.stack(ref_logits), np.stack(port_logits), cache, pcache)


def _prompt(n=12, vocab=512):
    return np.random.default_rng(3).integers(0, vocab, size=n)


def test_decode_step_matches_kernel_function(monkeypatch):
    """With the reference's decode core pointed at the function the TPU
    kernel computes, the port's f32 decode path agrees to 1e-4 at every
    position (f32 matmuls summed in another order), the greedy tokens
    are identical, and the bf16 caches agree to one bf16 ulp (2^-8
    relative: an f32 value near a rounding boundary may round the other
    way)."""
    monkeypatch.setattr(ref_attention, "decode_sdpa", kernel_decode_sdpa)
    cfg_ref = ref_configs.get_config("qwen1.5-0.5b", "smoke").replace(
        dtype="float32")
    cfg_port = pt_configs.get_config("qwen1.5-0.5b", "smoke").replace(
        dtype="float32")
    ref, port, cache, pcache = _decode_both(cfg_ref, cfg_port, _prompt(), 32)
    np.testing.assert_allclose(port, ref, rtol=1e-4, atol=1e-4)
    assert (port.argmax(-1) == ref.argmax(-1)).all()
    for r in range(cfg_port.n_layers):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                pcache["layers"][r][name].float().numpy(),
                np.asarray(cache["stack"][0][name][r], np.float32),
                rtol=2 ** -8, atol=2 ** -8)


def test_decode_step_matches_reference_decode_sdpa():
    """Against the reference's own model path (``decode_sdpa``), which
    rounds the softmax weights and its output to the bf16 cache dtype
    (relative 2^-9 each) where the port keeps them f32.  Through four
    layers that moves the logits by a few 1e-3 (measured 3.5e-3), so the
    bound is 1e-2, still far below the logits' spread."""
    cfg_ref = ref_configs.get_config("qwen1.5-0.5b", "smoke").replace(
        dtype="float32")
    cfg_port = pt_configs.get_config("qwen1.5-0.5b", "smoke").replace(
        dtype="float32")
    ref, port, _, _ = _decode_both(cfg_ref, cfg_port, _prompt(), 32)
    np.testing.assert_allclose(port, ref, rtol=1e-2, atol=1e-2)
    assert np.abs(port - ref).max() < 0.05 * ref.std()


def test_sliding_window_ring_buffer_matches_reference(monkeypatch):
    """The lengths = min(pos + 1, slots) contract reproduces the
    reference's ring-buffer mask once the window is warm."""
    monkeypatch.setattr(ref_attention, "decode_sdpa", kernel_decode_sdpa)
    base = dict(dtype="float32", sliding_window=8)
    cfg_ref = ref_configs.get_config("mistral-nemo-12b", "smoke").replace(
        **base)
    cfg_port = pt_configs.get_config("mistral-nemo-12b", "smoke").replace(
        **base)
    ref, port, _, pcache = _decode_both(cfg_ref, cfg_port, _prompt(14), 32)
    assert pcache["layers"][0]["k"].shape[1] == 8
    np.testing.assert_allclose(port, ref, rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------
# The reference's call signatures (ROADMAP §3, F1-F4)
# --------------------------------------------------------------------------

def _qwen_f32_params():
    cfg_ref = ref_configs.get_config("qwen1.5-0.5b", "smoke").replace(
        dtype="float32")
    cfg = pt_configs.get_config("qwen1.5-0.5b", "smoke").replace(
        dtype="float32")
    params = RT.init(jax.random.PRNGKey(0), cfg_ref)
    port = interop.params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                     device="cpu")
    return cfg_ref, cfg, params, port


def test_decode_step_accepts_unroll(monkeypatch):
    """F1: ``decode_step(..., unroll=True)``, as the reference's property
    tests, dry run and roofline correction call it, runs on the port and
    changes nothing: the same logits as without it, within 1e-4 of the
    reference's unrolled step."""
    monkeypatch.setattr(ref_attention, "decode_sdpa", kernel_decode_sdpa)
    cfg_ref, cfg, params, port = _qwen_f32_params()
    tok = _prompt(1, cfg.vocab)
    ref, _ = RT.decode_step(params, cfg_ref, jnp.asarray(tok, jnp.int32),
                            RT.init_cache(cfg_ref, 1, 16), 0, unroll=True)
    out = {}
    for unroll in (True, False):
        with torch.inference_mode():
            out[unroll], _ = PT.decode_step(
                port, cfg, torch.from_numpy(tok).long(),
                PT.init_cache(cfg, 1, 16, device="cpu"), 0, unroll=unroll)
    assert torch.equal(out[True], out[False])
    np.testing.assert_allclose(out[True].numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)


def test_prefill_accepts_impl(monkeypatch):
    """F2: ``prefill(..., impl="xla")`` runs on the port, is ignored as
    the reference ignores it, and gives the reference's greedy token."""
    monkeypatch.setattr(ref_attention, "decode_sdpa", kernel_decode_sdpa)
    cfg_ref, cfg, params, port = _qwen_f32_params()
    prompt = _prompt(9, cfg.vocab)[None, :]
    ref, _ = RT.prefill(params, cfg_ref, jnp.asarray(prompt, jnp.int32), 16,
                        impl="xla")
    tb = torch.from_numpy(prompt).long()
    with torch.inference_mode():
        got, cache = PT.prefill(port, cfg, tb, 16, impl="xla")
        plain, _ = PT.prefill(port, cfg, tb, 16)
    assert torch.equal(got, plain)
    assert got.shape == ref.shape
    assert (got.argmax(-1).numpy() == np.asarray(ref).argmax(-1)).all()
    assert cache["layers"][0]["k"].shape[1] == 16


def test_mamba_fwd_accepts_chunk():
    """F3: ``Mamba.fwd(p, cfg, x, chunk=64)``, the reference's call, runs
    on the port and changes nothing (chunking shapes only the
    reference's backward memory); within 1e-4 of the reference's."""
    from repro.models.common import ModelConfig as RConfig
    from repro.models.ssm import Mamba as RMamba

    from repro_torch.models.common import ModelConfig as PConfig
    from repro_torch.models.ssm import Mamba as PMamba
    kw = dict(name="m", n_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
              head_dim=8, d_ff=64, vocab=64, block_pattern=("mamba",),
              mamba_d_state=8, dtype="float32")
    cfg_ref, cfg = RConfig(**kw), PConfig(**kw)
    p = RMamba.init(jax.random.PRNGKey(0), cfg_ref)
    x = np.random.default_rng(1).standard_normal((2, 45, 32)).astype(
        np.float32)
    ref = RMamba.fwd(p, cfg_ref, jnp.asarray(x), chunk=64)
    pp = interop._convert(jax.tree.map(np.asarray, p), torch.float32, "cpu")
    got = PMamba.fwd(pp, cfg, torch.from_numpy(x), chunk=64)
    assert torch.equal(got, PMamba.fwd(pp, cfg, torch.from_numpy(x)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mixtral-8x7b",
                                  "deepseek-v2-236b"])
def test_model_flops_matches_reference(arch):
    """F4: ``model_flops`` (6 · N_active · tokens) is exported by the
    port's ``models`` and equals the reference's on the smoke configs'
    parameter counts."""
    from repro.models import model_flops as ref_model_flops

    from repro_torch.models import model_flops
    cfg_ref = ref_configs.get_config(arch, "smoke")
    cfg = pt_configs.get_config(arch, "smoke")
    n = PT.count_params(PT.init(cfg, device="cpu"))
    for tokens in (1, 4096, 32 * 2048):
        assert model_flops(cfg, n, tokens) == ref_model_flops(cfg_ref, n,
                                                              tokens)
    assert model_flops is PT.model_flops
