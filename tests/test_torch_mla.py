"""The port's MLA and deepseek-v2 against the JAX reference, on the CPU.

MLA has no kernel in either package: ``MLA.fwd`` runs the plain
``sdpa`` (S <= 2048) or ``blockwise_sdpa`` (above), ``MLA.decode`` the
absorbed einsums.  Its RMSNorms (``q_norm``, ``kv_norm``) take the
RMSNorm op's plain version here.

Everything is compared on f32 configs from the reference's own weights
(``interop.params_from_numpy``): layer outputs, logits and features
within 1e-4 (f32 products summed in another order) with identical
argmax, MoE aux terms within 1e-6, the engines bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.configs as ref_configs
from repro.dist.context import set_activation_axes
from repro.models import transformer as RT
from repro.models.attention import MLA as RMLA
from repro.models.common import rope_tables as ref_rope_tables
from repro.serve import Request as RRequest
from repro.serve import SchedulerPolicy as RPolicy
from repro.serve import ServingEngine as REngine

import repro_torch.configs as pt_configs
from repro_torch import interop
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models import transformer as PT
from repro_torch.models.attention import MLA
from repro_torch.models.common import ModelConfig as PConfig
from repro_torch.models.common import rope_tables
from repro_torch.serve import Request, SchedulerPolicy, ServingEngine
from torch_threads import one_torch_thread  # noqa: F401

_ARCH = "deepseek-v2-236b"
_TOL = 1e-4
_AUX_TOL = 1e-6


@pytest.fixture(autouse=True)
def _no_mesh():
    """A mesh left bound by another test on this worker (the reference's
    train() never clears its activation axes) would send the reference's
    MoE to its mesh paths."""
    set_activation_axes()
    yield


def _perturb_scales(tree, seed: int):
    """Norm scales drawn around 1 (the reference initialises them to
    ones), so that a scale read in the wrong place shows."""
    rng = np.random.default_rng(seed)

    def walk(t, key=None):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        a = np.asarray(t)
        if key == "scale":
            return (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return walk(tree)


@functools.lru_cache(maxsize=None)
def _model(overrides: tuple = ()):
    """f32 deepseek smoke configs of both packages, the reference's
    weights (norm scales perturbed) and the same weights in the port's
    layout."""
    kw = dict(overrides, dtype="float32")
    cfg_ref = ref_configs.get_config(_ARCH, "smoke").replace(**kw)
    cfg = pt_configs.get_config(_ARCH, "smoke").replace(**kw)
    params = _perturb_scales(RT.init(jax.random.PRNGKey(0), cfg_ref), 1)
    port = interop.params_from_numpy(params, cfg, device="cpu")
    params = jax.tree.map(jnp.asarray, params)
    return cfg_ref, cfg, params, port


def _tokens(cfg, B, S, seed=0):
    a = np.random.default_rng(seed).integers(0, cfg.vocab, size=(B, S))
    return jnp.asarray(a, jnp.int32), torch.from_numpy(a).long()


def _close(port: torch.Tensor, ref, tol=_TOL) -> None:
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(port.float().numpy(), ref, rtol=tol, atol=tol)


_Q_FORMS = {"q_lora": (), "no_q_lora": (("q_lora_rank", 0),)}


# --------------------------------------------------------------------------
# The MLA layer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("S", [16, 2560])
@pytest.mark.parametrize("form", list(_Q_FORMS))
def test_mla_fwd_matches_reference(form, S):
    """Layer 0's MLA on both q forms; S 16 takes sdpa, S 2560 the
    blockwise branch (1024-wide tiles, so a ragged last tile pair)."""
    cfg_ref, cfg, params, port = _model(_Q_FORMS[form])
    rp = params["prefix"][0]["mixer"]
    pp = port["layers"][0]["mixer"]
    assert ("w_dq" in pp) == bool(cfg.q_lora_rank) == ("q_norm" in pp)
    assert ("wq" in pp) != ("w_dq" in pp)
    x = np.random.default_rng(2).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    dr = cfg.qk_rope_head_dim
    cos, sin = ref_rope_tables(jnp.arange(S), dr, cfg.rope_theta)
    want = jax.jit(lambda p, x: RMLA.fwd(p, cfg_ref, x, cos, sin))(
        rp, jnp.asarray(x))
    pcos, psin = rope_tables(torch.arange(S), dr, cfg.rope_theta)
    for impl in ("kernel", "xla"):
        with torch.inference_mode():
            got = MLA.fwd(pp, cfg, torch.from_numpy(x), pcos, psin, impl=impl)
        _close(got, want)


@pytest.mark.parametrize("form", list(_Q_FORMS))
def test_mla_decode_matches_reference(form):
    """The absorbed decode at every position of 12, into f32 caches: the
    layer output and both cache leaves."""
    cfg_ref, cfg, params, port = _model(_Q_FORMS[form])
    rp = params["prefix"][0]["mixer"]
    pp = port["layers"][0]["mixer"]
    B, T = 2, 16
    xs = np.random.default_rng(4).standard_normal(
        (12, B, 1, cfg.d_model)).astype(np.float32)
    step = jax.jit(lambda p, x, c, s: RMLA.decode(p, cfg_ref, x, c, s))
    cache = RMLA.init_cache(cfg_ref, B, T, jnp.float32)
    pcache = MLA.init_cache(cfg, B, T, torch.float32, device="cpu")
    assert {k: tuple(v.shape) for k, v in pcache.items()} == {
        "c_kv": (B, T, cfg.kv_lora_rank),
        "k_rope": (B, T, cfg.qk_rope_head_dim)}
    with torch.inference_mode():
        for s, x in enumerate(xs):
            y, cache = step(rp, jnp.asarray(x), cache, jnp.int32(s))
            py, pcache2 = MLA.decode(pp, cfg, torch.from_numpy(x), pcache, s)
            assert pcache2 is pcache
            _close(py, y)
    for name in ("c_kv", "k_rope"):
        _close(pcache[name], cache[name])


def test_mla_cache_is_bf16_by_default():
    _, cfg, _, _ = _model()
    c = PT.init_cache(cfg, 1, 8, device="cpu")
    for i, layer in enumerate(c["layers"]):
        assert set(layer) == {"c_kv", "k_rope"}, i
        assert all(t.dtype == torch.bfloat16 for t in layer.values())


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------

def test_params_match_reference_leaf_for_leaf():
    """interop carries the reference's deepseek tree across: the dense
    prefix layer, then the stacked MoE layers, every leaf equal; the
    norm scales (``kv_norm``, ``q_norm`` among them) stay f32 on a bf16
    config, the other MLA leaves take the compute dtype."""
    cfg_ref = ref_configs.get_config(_ARCH, "smoke")
    cfg = pt_configs.get_config(_ARCH, "smoke")
    tree = _perturb_scales(RT.init(jax.random.PRNGKey(0), cfg_ref), 3)
    port = interop.params_from_numpy(tree, cfg, device="cpu")
    assert len(port["layers"]) == cfg.n_layers == 3
    assert "mlp" in port["layers"][0] and "moe" not in port["layers"][0]
    assert all("moe" in lp for lp in port["layers"][1:])
    own = PT.init(cfg, device="cpu")

    def flat(t, path=()):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from flat(v, path + (k,))
        else:
            yield path, t

    def ref_leaf(path):
        if path[0] != "layers":
            node = tree
            for k in path:
                node = node[k]
            return np.asarray(node)
        i = path[1]
        prefix, period = RT.unit_period(cfg_ref)
        node = (tree["prefix"][i] if i < prefix else
                tree["stack"][(i - prefix) % period])
        for k in path[2:]:
            node = node[k]
        return (np.asarray(node) if i < prefix else
                np.asarray(node)[(i - prefix) // period])

    def leaves(p):
        out = {}
        for k, v in p.items():
            if k == "layers":
                for i, lp in enumerate(v):
                    out.update(dict(flat(lp, ("layers", i))))
            else:
                out.update(dict(flat(v, (k,))))
        return out

    got, mine = leaves(port), leaves(own)
    assert got.keys() == mine.keys()
    n_scale = 0
    for path, t in got.items():
        assert t.shape == mine[path].shape and t.dtype == mine[path].dtype
        f32 = path[-1] == "scale" or path[-2:] == ("router", "w")
        assert t.dtype == (torch.float32 if f32 else torch.bfloat16), path
        want = ref_leaf(path).astype(np.float32)
        if not f32:
            want = np.asarray(jnp.asarray(want, jnp.bfloat16), np.float32)
        np.testing.assert_array_equal(t.float().numpy(), want)
        n_scale += path[-2] in ("kv_norm", "q_norm")
    assert n_scale == 2 * cfg.n_layers


def _shape_tree(cfg):
    """The reference's parameter tree as zero-stride NumPy arrays of the
    right shapes, without materialising the weights."""
    shapes = jax.eval_shape(lambda k: RT.init(k, cfg), jax.random.PRNGKey(0))
    return jax.tree.map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes)


@pytest.mark.parametrize("n_layers,n", [(None, 235_741_434_880),
                                        (8, 29_191_377_920),
                                        (4, 13_302_912_000),
                                        (2, 5_358_679_040)])
def test_count_params_full(n_layers, n):
    """Full width through shapes only, at the full depth, at the two
    depths the card runs (``chip_smoke.py``: 8 layers in bf16, 2 in
    f32) and at 4."""
    kw = {} if n_layers is None else {"n_layers": n_layers}
    cfg_ref = ref_configs.get_config(_ARCH, "full").replace(**kw)
    tree = _shape_tree(cfg_ref)
    n_ref = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(tree))
    port = interop.params_from_numpy(
        tree, pt_configs.get_config(_ARCH, "full").replace(**kw),
        device="meta")
    assert n_ref == PT.count_params(port) == n


# --------------------------------------------------------------------------
# Model entry points
# --------------------------------------------------------------------------

@pytest.mark.parametrize("form", list(_Q_FORMS))
def test_forward_entry_points_match_reference(form):
    """forward (logits and the summed MoE aux terms), forward_features and
    prefill_logits, with either ``impl``, against the reference's."""
    cfg_ref, cfg, params, port = _model(_Q_FORMS[form])
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
def test_prefill_matches_reference(monkeypatch, cache_dtype):
    """prefill's decode replay: the last logits and every cache leaf.
    With f32 caches everything agrees to 1e-4.  In bf16 a cached value
    summed in another order may round to the neighbouring bf16 number
    (bound 2^-6 on cache values of spread ~1; logits within 1e-2),
    with identical argmax."""
    if cache_dtype == "float32":
        monkeypatch.setattr(RT, "init_cache", functools.partial(
            RT.init_cache, dtype=jnp.float32))
        monkeypatch.setattr(PT, "init_cache", functools.partial(
            PT.init_cache, dtype=torch.float32))
    cfg_ref, cfg, params, port = _model()
    jb, tb = _tokens(cfg, 2, 10, seed=1)
    logits, cache = RT.prefill(params, cfg_ref, jb, 16)
    with torch.inference_mode():
        p_logits, p_cache = PT.prefill(port, cfg, tb, 16)
    f32 = cache_dtype == "float32"
    _close(p_logits, logits, _TOL if f32 else 1e-2)
    assert (p_logits.numpy().argmax(-1) ==
            np.asarray(logits).argmax(-1)).all()
    prefix, period = RT.unit_period(cfg_ref)
    for i in range(cfg.n_layers):
        ref_c = (cache["prefix"][i] if i < prefix else jax.tree.map(
            lambda a: a[(i - prefix) // period],
            cache["stack"][(i - prefix) % period]))
        assert set(p_cache["layers"][i]) == set(ref_c) == {"c_kv", "k_rope"}
        for name, got in p_cache["layers"][i].items():
            want = np.asarray(ref_c[name])
            assert str(got.dtype).split(".")[-1] == cache_dtype == str(
                want.dtype)
            _close(got, want, _TOL if f32 else 2 ** -6)


def test_decode_step_matches_reference():
    """decode_step's logits at every position of a 12-token prompt, from
    f32 caches, within 1e-4 and with identical greedy tokens."""
    cfg_ref, cfg, params, port = _model()
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


def test_cpu_deepseek_counts_no_launch():
    """On the CPU every norm takes its plain version: no launch counted."""
    _, cfg, _, port = _model()
    _, tb = _tokens(cfg, 1, 8)
    reset_launch_counts()
    with torch.inference_mode():
        PT.prefill_logits(port, cfg, tb)
        PT.decode_step(port, cfg, tb[:, 0],
                       PT.init_cache(cfg, 1, 8, device="cpu"), 0)
    assert all(n == 0 for n in launch_counts().values())


# --------------------------------------------------------------------------
# Decode matches forward (the ``mla`` family of the reference's
# tests/test_model_properties.py, on the port)
# --------------------------------------------------------------------------

@given(n_heads=st.sampled_from([2, 4]), hd=st.sampled_from([8, 16]),
       n_layers=st.sampled_from([2, 3]), q_lora=st.booleans(),
       qkv_bias=st.booleans(), seed=st.integers(0, 2 ** 31 - 1))
@settings(max_examples=12, deadline=None)
def test_decode_matches_forward(n_heads, hd, n_layers, q_lora, qkv_bias,
                                seed):
    """Cached decode reproduces the full forward, on f32 configs drawn
    as the reference's property test draws its ``mla`` family (both q
    forms), within its tolerance (3e-4 of the largest logit)."""
    d = n_heads * hd
    cfg = PConfig(name="h-mla", n_layers=n_layers, d_model=d,
                  n_heads=n_heads, n_kv_heads=n_heads, head_dim=hd,
                  d_ff=2 * d, vocab=64, dtype="float32", qkv_bias=qkv_bias,
                  attn_type="mla", kv_lora_rank=d // 2,
                  q_lora_rank=d // 2 if q_lora else 0,
                  qk_nope_head_dim=hd, qk_rope_head_dim=8, v_head_dim=hd)
    params = PT.init(cfg, seed=seed, device="cpu")
    B, S = 2, 9
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=g)
    with torch.inference_mode():
        logits, _ = PT.forward(params, cfg, toks)
        cache = PT.init_cache(cfg, B, S, torch.float32, device="cpu")
        outs = []
        for s in range(S):
            lg, cache = PT.decode_step(params, cfg, toks[:, s], cache, s)
            outs.append(lg)
    dec = torch.stack(outs, dim=1)
    scale = float(logits.abs().max()) + 1e-6
    np.testing.assert_allclose(dec.numpy() / scale, logits.numpy() / scale,
                               rtol=0, atol=3e-4)


# --------------------------------------------------------------------------
# Serving
# --------------------------------------------------------------------------

def _scenario(req_cls, cfg):
    rng = np.random.default_rng(0)
    reqs = [req_cls(i, rng.integers(0, cfg.vocab, size=4 + i),
                    max_new_tokens=5) for i in range(3)]
    return reqs, [(2, [req_cls(10, rng.integers(0, cfg.vocab, size=4),
                               max_new_tokens=4)])]


@pytest.mark.parametrize("kind", ["fifo", "symbiotic", "refined"])
def test_engine_matches_reference(kind):
    """The flat engine on deepseek smoke: rounds, modelled time and cache
    counters bit-equal, tokens equal (a request joins at iteration 2)."""
    cfg_ref, cfg, params, port = _model()
    reqs, arr = _scenario(RRequest, cfg)
    ref_eng = REngine(cfg_ref, params, max_len=32, policy=RPolicy(kind=kind))
    ref_eng.submit(reqs)
    ref = ref_eng.run(arrivals=arr)
    reqs, arr = _scenario(Request, cfg)
    eng = ServingEngine(cfg, port, max_len=32,
                        policy=SchedulerPolicy(kind=kind))
    assert eng.n_params == ref_eng.n_params
    assert eng._kv_bytes_per_token() == ref_eng._kv_bytes_per_token()
    eng.submit(reqs)
    out = eng.run(arrivals=arr)
    assert out["rounds"] == ref["rounds"]
    assert out["modelled_time_s"] == ref["modelled_time_s"]
    assert out["schedule_cache"] == ref["schedule_cache"]
    assert out["outputs"] == ref["outputs"]
    assert all(len(t) >= 4 for t in out["outputs"].values())
