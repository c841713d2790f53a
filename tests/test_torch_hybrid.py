"""The port's hybrid stack (Mamba and MoE layers: jamba-v0.1-52b and
mixtral-8x7b) against the JAX reference, on the CPU, where the
selective-scan and attention ops run their plain versions.

Models are compared on f32 smoke configs from the reference's own
weights (``interop.params_from_numpy``): logits and features within
1e-4 (f32 products summed in another order) with identical argmax, MoE
aux terms within 1e-6.  The card's check of the jamba smoke forward
(kernels against the plain twins) is in ``tests/test_torch_kernels.py``,
whose card-only tests run without JAX.
"""

import functools

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
from repro.models.common import ModelConfig as RConfig
from repro.models.moe import MoE as RMoE
from repro.models.ssm import Mamba as RMamba
from repro.serve import Request as RRequest
from repro.serve import SchedulerPolicy as RPolicy
from repro.serve import ServingEngine as REngine

import repro_torch.configs as pt_configs
from repro_torch import interop
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models import transformer as PT
from repro_torch.models.common import ModelConfig as PConfig
from repro_torch.models.moe import MoE as PMoE
from repro_torch.models.ssm import Mamba as PMamba
from repro_torch.serve import Request, SchedulerPolicy, ServingEngine
from torch_threads import one_torch_thread  # noqa: F401

_TOL = 1e-4
_AUX_TOL = 1e-6
_HYBRID = ["jamba-v0.1-52b", "mixtral-8x7b"]
_F32_LEAVES = ("a_log", "dt_bias", "d_skip", "conv_w", "conv_b")


@pytest.fixture(autouse=True)
def _no_mesh():
    """A mesh left bound by another test on this worker (the reference's
    train() never clears its activation axes) would send the reference's
    MoE to its mesh paths."""
    set_activation_axes()
    yield


@functools.lru_cache(maxsize=None)
def _model(arch: str, overrides: tuple = ()):
    """f32 reference and port configs, the reference's weights and the
    same weights in the port's layout."""
    kw = dict(overrides, dtype="float32")
    cfg_ref = ref_configs.get_config(arch, "smoke").replace(**kw)
    cfg = pt_configs.get_config(arch, "smoke").replace(**kw)
    params = RT.init(jax.random.PRNGKey(0), cfg_ref)
    port = interop.params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                     device="cpu")
    return cfg_ref, cfg, params, port


def _ref_layer(params, cfg, i: int):
    """Layer ``i``'s parameters out of the reference's stacked tree."""
    prefix, period = RT.unit_period(cfg)
    if i < prefix:
        return params["prefix"][i]
    u, r = (i - prefix) % period, (i - prefix) // period
    return jax.tree.map(lambda a: a[r], params["stack"][u])


def _tokens(cfg, B, S, seed=0):
    a = np.random.default_rng(seed).integers(0, cfg.vocab, size=(B, S))
    return jnp.asarray(a, jnp.int32), torch.from_numpy(a).long()


def _close(port: torch.Tensor, ref, tol=_TOL) -> None:
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(port.float().numpy(), ref, rtol=tol, atol=tol)


def _kernel_decode_sdpa(q, k, v, length_mask, *, scale):
    """The function the TPU decode kernel computes, in ``decode_sdpa``'s
    signature (f32 softmax weights, as the port's kernel keeps them)."""
    del scale  # ops.decode_attention uses 1/sqrt(D), as decode_sdpa's caller
    lengths = length_mask.sum(-1).astype(jnp.int32)
    return ref_ops.decode_attention(q, k, v, lengths, interpret=True)


# --------------------------------------------------------------------------
# The Mamba layer
# --------------------------------------------------------------------------

#: the config of the reference's test_mamba_kernel_matches_model_layer,
#: and jamba's smoke width
_MAMBA_CFGS = {
    "kernel-test": dict(name="m", n_layers=2, d_model=32, n_heads=4,
                        n_kv_heads=4, head_dim=8, d_ff=64, vocab=64,
                        block_pattern=("mamba",), mamba_d_state=8,
                        dtype="float32"),
    "jamba-smoke": dict(name="j", n_layers=8, d_model=64, n_heads=4,
                        n_kv_heads=2, head_dim=16, d_ff=128, vocab=512,
                        block_pattern=("mamba",), mamba_d_state=8,
                        dtype="float32"),
}


@pytest.mark.parametrize("name", list(_MAMBA_CFGS))
@pytest.mark.parametrize("S", [32, 45])
def test_mamba_fwd_matches_reference(name, S):
    """Both of the port's scans (``ops.mamba_scan``, which includes the
    D·x skip, and the plain twin of the reference's chunked scan) against
    the reference's ``Mamba.fwd``; S = 45 is no multiple of anything."""
    cfg_ref, cfg = RConfig(**_MAMBA_CFGS[name]), PConfig(**_MAMBA_CFGS[name])
    p = RMamba.init(jax.random.PRNGKey(0), cfg_ref)
    x = np.random.default_rng(1).standard_normal((2, S, cfg.d_model))
    x = x.astype(np.float32)
    ref = jax.jit(lambda p, x: RMamba.fwd(p, cfg_ref, x))(p, jnp.asarray(x))
    pp = interop._convert(jax.tree.map(np.asarray, p), torch.float32, "cpu")
    for impl in ("kernel", "xla"):
        out = PMamba.fwd(pp, cfg, torch.from_numpy(x), impl=impl)
        _close(out, ref)
    with pytest.raises(ValueError):
        PMamba.fwd(pp, cfg, torch.from_numpy(x), impl="pallas")


def test_mamba_decode_matches_reference():
    """One decode step at a time from a zero cache: outputs and both
    cache leaves (conv window in the cache dtype, ssm state f32)."""
    cfg_ref = RConfig(**_MAMBA_CFGS["jamba-smoke"])
    cfg = PConfig(**_MAMBA_CFGS["jamba-smoke"])
    p = RMamba.init(jax.random.PRNGKey(2), cfg_ref)
    pp = interop._convert(jax.tree.map(np.asarray, p), torch.float32, "cpu")
    xs = np.random.default_rng(3).standard_normal((6, 2, 1, cfg.d_model))
    cache = RMamba.init_cache(cfg_ref, 2, 16, jnp.float32)
    pcache = PMamba.init_cache(cfg, 2, 16, torch.float32, device="cpu")
    assert pcache["ssm"].dtype == torch.float32
    step = jax.jit(lambda p, x, c: RMamba.decode(p, cfg_ref, x, c, 0))
    for x in xs.astype(np.float32):
        y, cache = step(p, jnp.asarray(x), cache)
        py, pcache = PMamba.decode(pp, cfg, torch.from_numpy(x), pcache, 0)
        _close(py, y)
    _close(pcache["conv"], cache["conv"])
    _close(pcache["ssm"], cache["ssm"])


# --------------------------------------------------------------------------
# The MoE layer
# --------------------------------------------------------------------------

#: (arch, overrides): jamba's and mixtral's routing, a capacity that
#: drops most assignments, and a shared expert
_MOE_CASES = [
    ("jamba-v0.1-52b", ()),
    ("mixtral-8x7b", ()),
    ("mixtral-8x7b", (("capacity_factor", 0.25),)),
    ("jamba-v0.1-52b", (("n_shared_experts", 1),)),
]
_MOE_IDS = ["jamba", "mixtral", "mixtral-drops", "jamba-shared"]


@pytest.mark.parametrize("arch,overrides", _MOE_CASES, ids=_MOE_IDS)
def test_moe_fwd_local_matches_reference(arch, overrides):
    cfg_ref, cfg, params, port = _model(arch, overrides)
    i = next(i for i in range(cfg.n_layers) if cfg.is_moe_layer(i))
    p_ref = _ref_layer(params, cfg_ref, i)["moe"]
    p = port["layers"][i]["moe"]
    assert ("shared" in p) == bool(cfg.n_shared_experts)
    x = np.random.default_rng(4).standard_normal((2, 24, cfg.d_model))
    x = x.astype(np.float32)
    y, aux = jax.jit(lambda p, x: RMoE._fwd_local(p, cfg_ref, x))(
        p_ref, jnp.asarray(x))
    py, paux = PMoE._fwd_local(p, cfg, torch.from_numpy(x))
    _close(py, y)
    assert set(paux) == set(aux)
    for k in aux:
        np.testing.assert_allclose(float(paux[k]), float(aux[k]),
                                   rtol=_AUX_TOL, atol=_AUX_TOL)
    assert PMoE.capacity(cfg, 48) == RMoE.capacity(cfg_ref, 48)
    if cfg.capacity_factor < 1:
        assert float(paux["moe_drop_frac"]) > 0.5


def test_moe_routes_in_f32_on_bf16():
    """The router weight stays f32 on a bf16 config (interop and the
    port's own init), so routing sees f32 weights; the experts take the
    compute dtype."""
    cfg = pt_configs.get_config("mixtral-8x7b", "smoke")
    for p in (PT.init(cfg, device="cpu"),
              interop.params_from_numpy(
                  jax.tree.map(np.asarray, _model("mixtral-8x7b")[2]), cfg,
                  device="cpu")):
        moe = p["layers"][0]["moe"]
        assert moe["router"]["w"].dtype == torch.float32
        assert moe["experts"]["w_gate"].dtype == torch.bfloat16
        x = torch.randn(1, 5, cfg.d_model, dtype=torch.bfloat16)
        y, aux = PMoE.fwd(moe, cfg, x)
        assert y.dtype == torch.bfloat16 and y.shape == x.shape
        assert all(v.dtype == torch.float32 for v in aux.values())


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", _HYBRID)
def test_params_match_reference_leaf_for_leaf(arch):
    """count_params equal at smoke size, the port's own init and the
    converted tree agree in every leaf's shape and dtype, and the
    leaves the reference keeps f32 come out f32 on a bf16 config."""
    cfg = pt_configs.get_config(arch, "smoke")
    params = RT.init(jax.random.PRNGKey(0),
                     ref_configs.get_config(arch, "smoke"))
    port = interop.params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                     device="cpu")
    own = PT.init(cfg, seed=0, device="cpu")

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return (tuple(t.shape), t.dtype)

    assert shapes(port) == shapes(own)
    assert PT.count_params(port) == RT.count_params(params)
    for lp in port["layers"]:
        if "a_log" in lp["mixer"]:
            for k in _F32_LEAVES:
                assert lp["mixer"][k].dtype == torch.float32, k
            assert lp["mixer"]["w_in"]["w"].dtype == torch.bfloat16
        if "moe" in lp:
            assert lp["moe"]["router"]["w"].dtype == torch.float32
    if arch.startswith("jamba"):
        # a_log survives the conversion exactly (log 2 is no bf16 value)
        np.testing.assert_array_equal(
            port["layers"][0]["mixer"]["a_log"].numpy(),
            np.asarray(params["stack"][0]["mixer"]["a_log"][0]))


def _shape_tree(cfg):
    shapes = jax.eval_shape(lambda: RT.init(jax.random.PRNGKey(0), cfg))
    return jax.tree.map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes)


@pytest.mark.parametrize("arch,n", [("jamba-v0.1-52b", 51_570_315_264),
                                    ("mixtral-8x7b", 46_702_792_704)])
def test_count_params_full(arch, n):
    """Full width through shapes only: weights_bytes = 2 * n_params
    feeds every modelled round time."""
    cfg = ref_configs.get_config(arch, "full")
    tree = _shape_tree(cfg)
    n_ref = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(tree))
    port = interop.params_from_numpy(
        tree, pt_configs.get_config(arch, "full"), device="meta")
    assert n_ref == PT.count_params(port) == n


# --------------------------------------------------------------------------
# Model entry points
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", _HYBRID)
def test_forward_entry_points_match_reference(arch):
    """forward (logits and the summed MoE aux terms), forward_features and
    prefill_logits on both of the port's paths against the reference's
    XLA path."""
    cfg_ref, cfg, params, port = _model(arch)
    jb, tb = _tokens(cfg, 2, 24)
    logits, aux = jax.jit(lambda p, b: RT.forward(p, cfg_ref, b))(params, jb)
    feats, faux = jax.jit(lambda p, b: RT.forward_features(p, cfg_ref, b))(
        params, jb)
    last = jax.jit(lambda p, b: RT.prefill_logits(p, cfg_ref, b))(params, jb)
    for impl in ("kernel", "xla"):
        with torch.inference_mode():
            p_logits, p_aux = PT.forward(port, cfg, tb, impl=impl)
            p_feats, p_faux = PT.forward_features(port, cfg, tb, impl=impl)
            p_last = PT.prefill_logits(port, cfg, tb, impl=impl)
        _close(p_logits, logits)
        _close(p_feats, feats)
        _close(p_last, last)
        assert (p_last.numpy().argmax(-1) ==
                np.asarray(last).argmax(-1)).all()
        for a, b in ((p_aux, aux), (p_faux, faux)):
            assert set(a) == set(b)
            for k in b:
                np.testing.assert_allclose(float(a[k]), float(b[k]),
                                           rtol=_AUX_TOL, atol=_AUX_TOL)
    assert float(aux["moe_lb_loss"]) > 0


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", _HYBRID)
def test_prefill_matches_reference(monkeypatch, arch, cache_dtype):
    """prefill's decode replay: the last logits and every cache leaf (KV,
    conv window, ssm state) against the reference's prefill, with its
    decode core pointed at the kernel's function.  With f32 caches
    everything agrees to 1e-4.  With the real bf16 caches an f32 value
    near a rounding boundary may round the other way (its f32 sums are
    taken in another order); in jamba the recurrent state carries each
    such flip to every later position and layer, so the caches drift
    apart by more than one ulp: measured up to 1.6e-2 in the conv
    windows and KV (bound 2^-5), 1.3e-3 in the ssm states (bound 5e-3),
    and 4.6e-3 in the logits (bound 1e-2, their spread is ~1), with
    identical argmax."""
    monkeypatch.setattr(ref_attention, "decode_sdpa", _kernel_decode_sdpa)
    if cache_dtype == "float32":
        monkeypatch.setattr(RT, "init_cache", functools.partial(
            RT.init_cache, dtype=jnp.float32))
        monkeypatch.setattr(PT, "init_cache", functools.partial(
            PT.init_cache, dtype=torch.float32))
    cfg_ref, cfg, params, port = _model(arch)
    jb, tb = _tokens(cfg, 2, 10, seed=1)
    logits, cache = RT.prefill(params, cfg_ref, jb, 16)
    with torch.inference_mode():
        p_logits, p_cache = PT.prefill(port, cfg, tb, 16)
    f32 = cache_dtype == "float32"
    _close(p_logits, logits, _TOL if f32 else 1e-2)
    assert (p_logits.numpy().argmax(-1) ==
            np.asarray(logits).argmax(-1)).all()
    kinds = set()
    for i in range(cfg.n_layers):
        ref_c = _ref_layer(cache, cfg_ref, i)
        assert set(p_cache["layers"][i]) == set(ref_c)
        for name, got in p_cache["layers"][i].items():
            kinds.add(name)
            want = np.asarray(ref_c[name])
            # the ssm state is f32 in both whatever the cache dtype
            assert str(got.dtype).split(".")[-1] == (
                "float32" if name == "ssm" else cache_dtype) == str(
                    want.dtype)
            _close(got, want, _TOL if f32 else
                   5e-3 if name == "ssm" else 2 ** -5)
    assert kinds == ({"k", "v", "conv", "ssm"} if arch.startswith("jamba")
                     else {"k", "v"})


@pytest.mark.parametrize("arch", _HYBRID)
def test_decode_step_matches_reference(monkeypatch, arch):
    """decode_step's logits at every position of a 12-token prompt, from
    f32 caches, within 1e-4 and with identical greedy tokens."""
    monkeypatch.setattr(ref_attention, "decode_sdpa", _kernel_decode_sdpa)
    cfg_ref, cfg, params, port = _model(arch)
    step = jax.jit(lambda p, t, c, s: RT.decode_step(p, cfg_ref, t, c, s))
    cache = RT.init_cache(cfg_ref, 1, 32, jnp.float32)
    pcache = PT.init_cache(cfg, 1, 32, torch.float32, device="cpu")
    prompt = np.random.default_rng(3).integers(0, cfg.vocab, size=12)
    ref, got = [], []
    with torch.inference_mode():
        for s, tok in enumerate(prompt):
            lg, cache = step(params, jnp.asarray([tok], jnp.int32), cache, s)
            ref.append(np.asarray(lg))
            plg, pcache = PT.decode_step(port, cfg, torch.tensor([int(tok)]),
                                         pcache, s)
            got.append(plg.numpy())
    ref, got = np.stack(ref), np.stack(got)
    np.testing.assert_allclose(got, ref, rtol=_TOL, atol=_TOL)
    assert (got.argmax(-1) == ref.argmax(-1)).all()


def test_cpu_hybrid_forward_counts_no_launch():
    """On the CPU the scan and the attention take their plain versions."""
    _, cfg, _, port = _model("jamba-v0.1-52b")
    _, tb = _tokens(cfg, 1, 8)
    reset_launch_counts()
    with torch.inference_mode():
        PT.prefill_logits(port, cfg, tb)
    assert all(n == 0 for n in launch_counts().values())
    assert "mamba_scan" in launch_counts()


def test_only_xlstm_raises():
    """xLSTM, once the only arch that raised, is ported: every arch's
    smoke config initialises and gives a cache for each of its layers,
    one per layer kind's mixer (the hybrid and xLSTM ones included)."""
    for arch in ref_configs.arch_names():
        cfg = pt_configs.get_config(arch, "smoke")
        params = PT.init(cfg, device="cpu")
        cache = PT.init_cache(cfg, 1, 8, device="cpu")
        assert len(params["layers"]) == len(cache["layers"]) == cfg.n_layers
        for i, c in enumerate(cache["layers"]):
            want = {"attn": {"k", "v"} if cfg.attn_type == "gqa"
                    else {"c_kv", "k_rope"}, "mamba": {"conv", "ssm"},
                    "mlstm": {"C", "n", "m"},
                    "slstm": {"c", "n", "h", "m"}}[cfg.layer_kind(i)]
            assert set(c) == want, (arch, i)


# --------------------------------------------------------------------------
# Serving
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", _HYBRID)
def test_engine_matches_reference(monkeypatch, arch):
    """The symbiotic engine on the hybrid smoke configs: rounds,
    modelled time and cache counters bit-equal, tokens equal (a request
    joins at iteration 2)."""
    monkeypatch.setattr(ref_attention, "decode_sdpa", _kernel_decode_sdpa)
    cfg_ref, cfg, params, port = _model(arch)

    def scenario(req_cls):
        rng = np.random.default_rng(0)
        reqs = [req_cls(i, rng.integers(0, cfg.vocab, size=4 + i),
                        max_new_tokens=5) for i in range(3)]
        return reqs, [(2, [req_cls(10, rng.integers(0, cfg.vocab, size=4),
                                   max_new_tokens=4)])]

    reqs, arr = scenario(RRequest)
    ref_eng = REngine(cfg_ref, params, max_len=32,
                      policy=RPolicy(kind="symbiotic"))
    ref_eng.submit(reqs)
    ref = ref_eng.run(arrivals=arr)
    reqs, arr = scenario(Request)
    eng = ServingEngine(cfg, port, max_len=32,
                        policy=SchedulerPolicy(kind="symbiotic"))
    assert eng.n_params == ref_eng.n_params
    assert eng._kv_bytes_per_token() == ref_eng._kv_bytes_per_token()
    eng.submit(reqs)
    out = eng.run(arrivals=arr)
    assert out["rounds"] == ref["rounds"]
    assert out["modelled_time_s"] == ref["modelled_time_s"]
    assert out["schedule_cache"] == ref["schedule_cache"]
    assert out["outputs"] == ref["outputs"]
