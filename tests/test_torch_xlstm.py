"""The port's xLSTM blocks (``repro_torch.models.xlstm``: the chunkwise
mLSTM, its recurrence, the sLSTM scan) and xlstm-125m's model entry
points and serving engine against the JAX reference, on the CPU.

Models are compared on the f32 smoke config from the reference's own
weights (``interop.params_from_numpy``): block outputs and logits within
1e-4 relative to their largest magnitude (f32 exps, cumulative sums and
products summed in another order), identical argmax, and the engine's
tokens identical with rounds and modelled time bit-equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.dist.context import set_activation_axes
from repro.models import transformer as RT
from repro.models import xlstm as RX
from repro.serve import Request as RRequest
from repro.serve import SchedulerPolicy as RPolicy
from repro.serve import ServingEngine as REngine

import repro_torch.configs as pt_configs
from repro_torch import interop
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models import transformer as PT
from repro_torch.models import xlstm as PX
from repro_torch.models.common import ModelConfig as PConfig
from repro_torch.serve import Request, SchedulerPolicy, ServingEngine
from torch_threads import one_torch_thread  # noqa: F401

_TOL = 1e-4
_ARCH = "xlstm-125m"


@pytest.fixture(autouse=True)
def _no_mesh():
    """A mesh left bound by another test on this worker (the reference's
    train() never clears its activation axes) would break the reference
    forward."""
    set_activation_axes()
    yield


@functools.lru_cache(maxsize=None)
def _model():
    """f32 reference and port configs, the reference's weights and the
    same weights in the port's layout."""
    cfg_ref = ref_configs.get_config(_ARCH, "smoke").replace(dtype="float32")
    cfg = pt_configs.get_config(_ARCH, "smoke").replace(dtype="float32")
    params = jax.jit(lambda key: RT.init(key, cfg_ref))(jax.random.PRNGKey(0))
    port = interop.params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                     device="cpu")
    return cfg_ref, cfg, params, port


@functools.lru_cache(maxsize=None)
def _ref_decode_step():
    """One jitted reference ``decode_step`` that the reference engines
    share (each would otherwise compile its own)."""
    cfg_ref = _model()[0]
    return jax.jit(lambda p, t, c, s: RT.decode_step(p, cfg_ref, t, c, s))


def _ref_layer(params, cfg, i: int):
    prefix, period = RT.unit_period(cfg)
    u, r = (i - prefix) % period, (i - prefix) // period
    return jax.tree.map(lambda a: a[r], params["stack"][u])


def _close(got: torch.Tensor, want, tol: float = _TOL) -> None:
    """Within ``tol`` relative to the reference's largest magnitude."""
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) + 1e-6
    np.testing.assert_allclose(got.float().numpy() / scale, want / scale,
                               rtol=0, atol=tol)


def _x(cfg, B, S, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


# --------------------------------------------------------------------------
# The blocks
# --------------------------------------------------------------------------

def test_xlstm_module_exports_reference_names():
    assert PX.__all__ == RX.__all__ == ["MLSTM", "SLSTM"]


@pytest.mark.parametrize("S,chunk", [(24, 256), (48, 16), (37, 16),
                                     (37, 256)],
                         ids=["one-chunk", "three-chunks", "prime-chunk1",
                              "prime-one-chunk"])
def test_mlstm_fwd_matches_reference(S, chunk):
    """The chunkwise form across chunks (the carried (C, n, m) state); at
    the prime S 37 the chunk 16 halves down to 1, as the reference's
    does."""
    cfg_ref, cfg, params, port = _model()
    x = _x(cfg, 2, S)
    ref = RX.MLSTM.fwd(_ref_layer(params, cfg_ref, 1)["mixer"], cfg_ref,
                       jnp.asarray(x), chunk=chunk)
    out = PX.MLSTM.fwd(port["layers"][1]["mixer"], cfg, torch.from_numpy(x),
                       chunk=chunk)
    _close(out, ref)


@pytest.mark.parametrize("S", [24, 37])
def test_slstm_fwd_matches_reference(S):
    """The reference scans in chunks of 64 (S 37: one padded chunk) and
    of 16 (S 37: three, the last padded): the port's step loop gives
    both."""
    cfg_ref, cfg, params, port = _model()
    x = _x(cfg, 2, S, seed=4)
    out = PX.SLSTM.fwd(port["layers"][0]["mixer"], cfg, torch.from_numpy(x))
    for chunk in (64, 16):
        ref = RX.SLSTM.fwd(_ref_layer(params, cfg_ref, 0)["mixer"], cfg_ref,
                           jnp.asarray(x), chunk=chunk)
        _close(out, ref)


@pytest.mark.parametrize("layer", [0, 1], ids=["slstm", "mlstm"])
def test_block_decode_matches_reference_at_every_position(layer):
    """``decode`` one position at a time against the reference's decode
    and against the full-sequence ``fwd``; the caches stay f32 and are
    updated in place."""
    cfg_ref, cfg, params, port = _model()
    cls_r = RX.SLSTM if layer == 0 else RX.MLSTM
    cls_p = PX.SLSTM if layer == 0 else PX.MLSTM
    pr = _ref_layer(params, cfg_ref, layer)["mixer"]
    pp = port["layers"][layer]["mixer"]
    S = 20
    x = _x(cfg, 2, S, seed=5)
    c_ref = cls_r.init_cache(cfg_ref, 2, S)
    c_port = cls_p.init_cache(cfg, 2, S, device="cpu")
    tensors = {k: v for k, v in c_port.items()}
    full = cls_p.fwd(pp, cfg, torch.from_numpy(x))
    ref_decode = jax.jit(lambda p, xs, c, s: cls_r.decode(p, cfg_ref, xs, c,
                                                          s))
    for s in range(S):
        y_ref, c_ref = ref_decode(pr, jnp.asarray(x[:, s:s + 1]), c_ref, s)
        y, c_out = cls_p.decode(pp, cfg, torch.from_numpy(x[:, s:s + 1]),
                                c_port, s)
        assert c_out is c_port
        assert all(c_port[k] is tensors[k] for k in tensors)
        _close(y, y_ref)
        _close(y[:, 0], full[:, s].numpy())
    for k, v in c_port.items():
        assert v.dtype == torch.float32
        _close(v, c_ref[k])


def test_f32_leaves_and_cache_dtypes():
    """``ln_scale`` and sLSTM's ``r`` stay f32 in a bf16 model, from
    ``init`` and through ``params_from_numpy``; the states are f32 in a
    bf16 cache."""
    cfg = pt_configs.get_config(_ARCH, "smoke")
    cfg_ref = ref_configs.get_config(_ARCH, "smoke")
    ref_params = jax.jit(lambda key: RT.init(key, cfg_ref))(
        jax.random.PRNGKey(1))
    conv = interop.params_from_numpy(jax.tree.map(np.asarray, ref_params),
                                     cfg, device="cpu")
    for p in (PT.init(cfg, device="cpu"), conv):
        s, m = p["layers"][0]["mixer"], p["layers"][1]["mixer"]
        assert s["r"].dtype == s["ln_scale"].dtype == torch.float32
        assert m["ln_scale"].dtype == torch.float32
        assert s["w_x"]["w"].dtype == m["wq"]["w"].dtype == torch.bfloat16
        assert m["w_if"]["b"].dtype == torch.bfloat16
    cache = PT.init_cache(cfg, 1, 8, device="cpu")
    assert all(t.dtype == torch.float32 for c in cache["layers"]
               for t in c.values())
    assert PT.count_params(PT.init(cfg, device="cpu")) == \
        sum(int(a.size) for a in jax.tree.leaves(ref_params))


# --------------------------------------------------------------------------
# The model
# --------------------------------------------------------------------------

def test_entry_points_match_reference():
    """forward, forward_features and prefill_logits (both ``impl``s: the
    blocks have no kernel branch), and decode_step at every position
    against the reference's forward; on the CPU no kernel launches."""
    cfg_ref, cfg, params, port = _model()
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 21))
    jt, tt = jnp.asarray(toks, jnp.int32), torch.from_numpy(toks)
    logits, aux = jax.jit(lambda p, b: RT.forward(p, cfg_ref, b))(params, jt)
    feats, _ = jax.jit(lambda p, b: RT.forward_features(p, cfg_ref, b))(
        params, jt)
    last = jax.jit(lambda p, b: RT.prefill_logits(p, cfg_ref, b))(params, jt)
    reset_launch_counts()
    with torch.inference_mode():
        for impl in ("kernel", "xla"):
            p_logits, p_aux = PT.forward(port, cfg, tt, impl=impl)
            p_feats, _ = PT.forward_features(port, cfg, tt, impl=impl)
            p_last = PT.prefill_logits(port, cfg, tt, impl=impl)
            _close(p_logits, logits)
            _close(p_feats, feats)
            _close(p_last, last)
            assert (p_logits.numpy().argmax(-1)
                    == np.asarray(logits).argmax(-1)).all()
            assert set(p_aux) == set(aux)
        cache = PT.init_cache(cfg, 2, 21, dtype=torch.float32, device="cpu")
        steps = []
        for s in range(21):
            lg, cache = PT.decode_step(port, cfg, tt[:, s], cache, s)
            steps.append(lg)
        p_last_replay, _ = PT.prefill(port, cfg, tt, 21)
    _close(torch.stack(steps, 1), logits)
    _close(p_last_replay, last)
    assert all(n == 0 for n in launch_counts().values())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decode_matches_forward_family(seed):
    """``tests/test_model_properties.py``'s xlstm family (slstm/mlstm, 2
    layers, 2 or 4 heads of 8 or 16, S 9, f32 caches) on the port, with
    the reference's weights: decode within 3e-4 of the forward, as the
    reference's property holds it, and the forward within 1e-4 of the
    reference's."""
    rng = np.random.default_rng(seed)
    n_heads = int(rng.choice([2, 4]))
    hd = int(rng.choice([8, 16]))
    d = n_heads * hd
    kw = dict(name="h-xlstm", n_layers=2, d_model=d, n_heads=n_heads,
              n_kv_heads=n_heads, head_dim=hd, d_ff=0, vocab=64,
              dtype="float32", qkv_bias=bool(rng.integers(2)),
              block_pattern=("slstm", "mlstm"))
    from repro.models.common import ModelConfig as RConfig
    cfg_ref, cfg = RConfig(**kw), PConfig(**kw)
    key = jax.random.PRNGKey(seed)
    params = jax.jit(lambda k: RT.init(k, cfg_ref))(key)
    port = interop.params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                     device="cpu")
    toks = np.asarray(jax.random.randint(key, (2, 9), 0, cfg.vocab))
    ref, _ = jax.jit(lambda p, b: RT.forward(p, cfg_ref, b))(
        params, jnp.asarray(toks))
    tt = torch.from_numpy(toks).long()
    with torch.inference_mode():
        logits, _ = PT.forward(port, cfg, tt)
        cache = PT.init_cache(cfg, 2, 9, dtype=torch.float32, device="cpu")
        outs = []
        for s in range(9):
            lg, cache = PT.decode_step(port, cfg, tt[:, s], cache, s)
            outs.append(lg)
    dec = torch.stack(outs, 1).numpy()
    scale = float(np.abs(logits.numpy()).max()) + 1e-6
    np.testing.assert_allclose(dec / scale, logits.numpy() / scale, rtol=0,
                               atol=3e-4)
    _close(logits, ref)


@pytest.mark.parametrize("kind", ["fifo", "symbiotic"])
def test_engine_matches_reference(kind):
    """Three 4-token prompts and a request joining at iteration 2:
    tokens identical, rounds, modelled time and cache counters
    bit-equal."""
    cfg_ref, cfg, params, port = _model()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=4) for _ in range(4)]

    def run(req, eng):
        eng.submit([req(i, prompts[i], max_new_tokens=5) for i in range(3)])
        return eng.run(arrivals=[(2, [req(10, prompts[3],
                                          max_new_tokens=4)])])
    ref_eng = REngine(cfg_ref, params, max_len=32, policy=RPolicy(kind=kind))
    ref_eng._decode_jit = _ref_decode_step()
    ref = run(RRequest, ref_eng)
    eng = ServingEngine(cfg, port, max_len=32,
                        policy=SchedulerPolicy(kind=kind))
    assert eng.n_params == ref_eng.n_params
    out = run(Request, eng)
    assert out["outputs"] == ref["outputs"]
    assert out["rounds"] == ref["rounds"]
    assert out["modelled_time_s"] == ref["modelled_time_s"]
    assert out["schedule_cache"] == ref["schedule_cache"]
    assert all(len(t) == (4 if rid == 10 else 5)
               for rid, t in out["outputs"].items())
