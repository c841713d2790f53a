"""The port's training path (``repro_torch.optim``, ``repro_torch.train``,
``repro_torch.launch.train``, ``serve(ckpt_dir=)``) and the RMSNorm
kernel's autograd wrapper against the JAX reference, on the CPU.

Tolerances, and why:

* AdamW on given gradients: 1e-6 relative (f32 elementwise arithmetic
  in another order).
* The train step's loss: 1e-5 relative.  Its gradients, per leaf,
  within 1e-4 of the leaf's norm against the reference's jitted gradient
  of the same f32 loss.  With the bf16 cast of the matrices
  (``cast_matmul_params``) the port differentiates its forward exactly:
  its gradient equals the reference's gradient of that forward (the
  weights rounded to bf16 before the loss) within 1e-6.  The reference's
  own gradient of the cast step is not that gradient: XLA differs from
  it by up to 1.1e-3 of a leaf's norm (qwen smoke: the q/k/v biases and
  the norm scales), so against it the bound is 2e-3.
* Ten steps of the f32 step (the cast off in both packages): the losses
  within 1e-4 relative at every step on qwen, mixtral and xlstm smoke;
  with the cast, on qwen.  (With the cast AdamW carries the reference's
  gradient error above into mixtral's and xlstm's trajectories: 3.2e-3
  and 2.1e-3 by step 10, measured.)
"""

import functools
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.optim as RO
import repro.train.step as RS
from repro.data import DataConfig as RDataConfig
from repro.data import SyntheticLM as RSyntheticLM
from repro.dist.context import set_activation_axes
from repro.models import transformer as RT
from repro.optim.adamw import _decay_mask as ref_decay_mask

import repro_torch.configs as pt_configs
import repro_torch.optim as PO
import repro_torch.train.step as PS
from repro_torch import interop
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.kernels import rmsnorm as PR
from repro_torch.launch.serve import serve
from repro_torch.launch.train import main as train_main
from repro_torch.launch.train import train
from repro_torch.models import transformer as PT
from repro_torch.optim.adamw import _decay_mask
from repro_torch.pytree import flatten, path_str, unflatten
from repro_torch.train import (latest_step, make_train_step,
                               restore_checkpoint)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _no_mesh():
    """A mesh left bound by another test on this worker (the reference's
    train() never clears its activation axes) would send the reference's
    step to its mesh paths."""
    set_activation_axes()
    yield


@functools.lru_cache(maxsize=None)
def _model(arch: str):
    cfg_ref = ref_configs.get_config(arch, "smoke").replace(dtype="float32")
    cfg = pt_configs.get_config(arch, "smoke").replace(dtype="float32")
    params = jax.jit(lambda key: RT.init(key, cfg_ref))(jax.random.PRNGKey(0))
    return cfg_ref, cfg, params


def _port(params, cfg):
    return interop.params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                     device="cpu")


def _rel_to_norm(got: dict, want: dict) -> dict:
    """Per leaf path: max |got - want| over ||want||."""
    out = {}
    for (p, g), (q, w) in zip(flatten(got), flatten(want)):
        assert p == q
        out[path_str(p)] = ((g.float() - w.float()).abs().max().item()
                            / (w.float().norm().item() + 1e-30))
    return out


def _batch(cfg, B=4, S=32, seed=0):
    return RSyntheticLM(RDataConfig(vocab=cfg.vocab, seq_len=S,
                                    global_batch=B, seed=seed)).next_batch()


# --------------------------------------------------------------------------
# AdamW, schedule, compression
# --------------------------------------------------------------------------

def _tree(rng):
    shapes = {"final_norm": {"scale": (8,)},
              "layers": [{"mixer": {"wq": {"w": (8, 6), "b": (6,)},
                                    "a_log": (6, 3)},
                          "bias_free": {"w": (4, 4)}}],
              "embed": {"w": (10, 8)}}

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, list):
            return [build(v) for v in t]
        return rng.standard_normal(t).astype(np.float32)
    return build(shapes)


def _to_ref(tree):
    """The port-layout test tree as the reference's pytree (lists stay
    lists: the same paths in both)."""
    return jax.tree.map(jnp.asarray, tree)


def _to_port(tree):
    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, list):
            return [build(v) for v in t]
        return torch.from_numpy(np.asarray(t, np.float32).copy())
    return build(tree)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(state_dtype):
    """Three updates on given gradients (clipped: their norm is above
    ``grad_clip``): parameters and moments within 1e-6 relative, the
    step, learning rate and gradient norm equal."""
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]
    cfg_ref = RO.AdamWConfig(warmup_steps=2, total_steps=10,
                             state_dtype=state_dtype)
    cfg = PO.AdamWConfig(warmup_steps=2, total_steps=10,
                         state_dtype=state_dtype)
    rp, rs = _to_ref(params), RO.adamw_init(_to_ref(params),
                                            jnp.dtype(state_dtype))
    pp, ps = _to_port(params), PO.adamw_init(_to_port(params), state_dtype)
    tol = 1e-6 if state_dtype == "float32" else 2 ** -8
    ref_update = jax.jit(functools.partial(RO.adamw_update, cfg_ref))
    for g in grads:
        rp, rs, rm = ref_update(rp, _to_ref(g), rs)
        pp, ps, pm = PO.adamw_update(cfg, pp, _to_port(g), ps)
        for got, want in ((pp, rp), (ps["m"], rs["m"]), (ps["v"], rs["v"])):
            for (p, a), (_, b) in zip(flatten(got), flatten(_to_port(
                    jax.tree.map(lambda x: np.asarray(x, np.float32), want)))):
                np.testing.assert_allclose(a.float().numpy(), b.numpy(),
                                           rtol=tol, atol=1e-7,
                                           err_msg=path_str(p))
        assert int(ps["step"]) == int(rs["step"])
        assert ps["m"]["embed"]["w"].dtype == getattr(torch, state_dtype)
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(pm[k]), float(rm[k]), rtol=1e-6)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "jamba-v0.1-52b",
                                  "deepseek-v2-236b", "xlstm-125m",
                                  "hubert-xlarge"])
def test_decay_set_matches_reference(arch):
    """The reference decides weight decay by substring tests on its
    stacked tree's paths; each of its leaves' verdicts, carried through
    ``params_from_numpy`` to the port's per-layer leaves, is the port's
    verdict on the port's path."""
    cfg_ref = ref_configs.get_config(arch, "smoke").replace(dtype="float32")
    cfg = pt_configs.get_config(arch, "smoke").replace(dtype="float32")
    # the verdicts need the reference tree's paths and shapes, not its
    # numbers
    shapes = jax.eval_shape(lambda key: RT.init(key, cfg_ref),
                            jax.random.PRNGKey(0))
    flags = jax.tree_util.tree_map_with_path(
        lambda path, a: np.full(a.shape, float(ref_decay_mask(path)),
                                np.float32), shapes)
    port_flags = _port(flags, cfg)
    n_decayed = 0
    for path, t in flatten(port_flags):
        want = bool(t.all())
        assert want == bool(t.any()), path_str(path)
        assert _decay_mask(path) == want, path_str(path)
        n_decayed += want
    assert 0 < n_decayed < len(flatten(port_flags))


def test_cosine_schedule_matches_reference():
    for kw in (dict(), dict(warmup_steps=5, total_steps=20),
               dict(warmup_steps=0, total_steps=1, min_lr_frac=0.0)):
        steps = np.arange(0, 130, dtype=np.float32)
        ref = RO.cosine_schedule(RO.AdamWConfig(**kw), jnp.asarray(steps))
        out = PO.cosine_schedule(PO.AdamWConfig(**kw), torch.from_numpy(steps))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-12)


def test_int8_compression_matches_reference():
    rng = np.random.default_rng(1)
    tree = {"g": rng.standard_normal((7, 33)).astype(np.float32) * 3,
            "h": [np.linspace(-2, 5, 50, dtype=np.float32)]}
    ref = RO.compress_int8(_to_ref(tree))
    out = PO.compress_int8(_to_port(tree))
    for (p, a), (_, b) in zip(flatten(out), flatten(
            jax.tree.map(np.asarray, ref))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-7,
                                   err_msg=path_str(p))
    assert out["g"]["q"].dtype == torch.int8
    dec = PO.decompress_int8(out)
    ref_dec = RO.decompress_int8(ref)
    np.testing.assert_allclose(dec["h"][0].numpy(),
                               np.asarray(ref_dec["h"][0]), rtol=1e-7)
    assert (dec["g"] - torch.from_numpy(tree["g"])).abs().max() <= \
        float(out["g"]["scale"]) / 2 + 1e-6


def test_global_norm_and_clip_match_reference():
    rng = np.random.default_rng(2)
    tree = _tree(rng)
    ref_c, ref_n = RO.clip_by_global_norm(_to_ref(tree), 0.5)
    out_c, out_n = PO.clip_by_global_norm(_to_port(tree), 0.5)
    np.testing.assert_allclose(float(out_n), float(ref_n), rtol=1e-6)
    np.testing.assert_allclose(float(PO.global_norm(out_c)), 0.5, rtol=1e-5)


# --------------------------------------------------------------------------
# Losses
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_chunks", [0, 1, 3, 7])
def test_chunked_cross_entropy_matches_cross_entropy(n_chunks):
    """Chunked against the full logits, in both packages, with ignored
    labels; 7 chunks of 48 tokens fall to 6, as the reference's do."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 24, 16)).astype(np.float32)
    w = rng.standard_normal((16, 40)).astype(np.float32)
    labels = rng.integers(0, 40, (2, 24)).astype(np.int32)
    labels[0, :5] = -1
    full = PS.cross_entropy(torch.from_numpy(x @ w), torch.from_numpy(labels))
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w)
    ch = PS.chunked_cross_entropy(xt, wt, torch.from_numpy(labels),
                                  n_chunks=n_chunks)
    ref = RS.chunked_cross_entropy(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(labels), n_chunks=n_chunks)
    ref_full = RS.cross_entropy(jnp.asarray(x @ w), jnp.asarray(labels))
    np.testing.assert_allclose(float(ch.detach()), float(full), rtol=1e-6)
    np.testing.assert_allclose(float(ch.detach()), float(ref), rtol=1e-6)
    np.testing.assert_allclose(float(full), float(ref_full), rtol=1e-6)
    (gx,) = torch.autograd.grad(ch, xt)
    ref_gx = jax.grad(lambda a: RS.chunked_cross_entropy(
        a, jnp.asarray(w), jnp.asarray(labels), n_chunks=n_chunks))(
        jnp.asarray(x))
    np.testing.assert_allclose(gx.numpy(), np.asarray(ref_gx), rtol=1e-5,
                               atol=1e-7)


def test_chunked_cross_entropy_bounds_a_chunks_logits(monkeypatch):
    """By default a chunk holds at most ``_CHUNK_BYTES`` of f32 logits:
    48 tokens of a 40-word vocabulary, 10 tokens' logits a chunk, go in
    6 chunks of 8 (5 do not divide 48); the loss and its gradient are
    the full logits' ones."""
    monkeypatch.setattr(PS, "_CHUNK_BYTES", 10 * 40 * 4)
    sizes = []
    chunk = PS._ce_chunk
    monkeypatch.setattr(PS, "_ce_chunk", lambda xc, *a: (
        sizes.append(xc.shape[0]), chunk(xc, *a))[1])
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 24, 16)).astype(np.float32)
    w = rng.standard_normal((16, 40)).astype(np.float32)
    labels = torch.from_numpy(rng.integers(0, 40, (2, 24)))
    xt = torch.from_numpy(x).requires_grad_()
    with torch.no_grad():
        PS.chunked_cross_entropy(xt, torch.from_numpy(w), labels)
    assert sizes == [8] * 6
    ch = PS.chunked_cross_entropy(xt, torch.from_numpy(w), labels)
    (gx,) = torch.autograd.grad(ch, xt)
    xf = torch.from_numpy(x).requires_grad_()
    full = PS.cross_entropy(xf @ torch.from_numpy(w), labels)
    (gf,) = torch.autograd.grad(full, xf)
    np.testing.assert_allclose(float(ch.detach()), float(full.detach()),
                               rtol=1e-6)
    np.testing.assert_allclose(gx.numpy(), gf.numpy(), rtol=1e-5, atol=1e-7)


# --------------------------------------------------------------------------
# The train step
# --------------------------------------------------------------------------

def _port_grads(port, cfg, batch, **kw):
    leaves = [t.detach().requires_grad_() for _, t in flatten(port)]
    loss, metrics = PS.loss_fn(unflatten(port, leaves), cfg,
                               PS._to_device(batch, "cpu"), **kw)
    grads = torch.autograd.grad(loss, leaves)
    return loss, unflatten(port, list(grads))


def test_first_step_loss_and_gradients_match_reference():
    """qwen smoke, f32, against the reference's jitted loss gradient (no
    mesh); the bounds are the module docstring's."""
    cfg_ref, cfg, params = _model("qwen1.5-0.5b")
    port = _port(params, cfg)
    batch = _batch(cfg)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b, mp: RS.loss_fn(p, cfg_ref, b, mixed_precision=mp),
        has_aux=True), static_argnums=2)
    # the step as it is: the bf16 cast of the matrices
    (ref_loss, _), ref_g = vg(params, batch, True)
    loss, g = _port_grads(port, cfg, batch)
    assert abs(float(loss) - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    assert max(_rel_to_norm(g, _port(ref_g, cfg)).values()) < 2e-3
    # the exact gradient of that forward: the matrices rounded first
    rounded = jax.tree.map(lambda a: a.astype(jnp.bfloat16).astype(
        jnp.float32) if a.ndim >= 2 else a, params)
    _, exact_g = vg(rounded, batch, False)
    errs = _rel_to_norm(g, _port(exact_g, cfg))
    dims = {path_str(p): t.dim() for p, t in flatten(g)}
    # 1-D leaves: the same gradient; matrices: the port's is rounded to
    # bf16 at the cast (as autograd rounds a bf16 tensor's gradient)
    assert max(v for k, v in errs.items() if dims[k] == 1) < 1e-5
    assert max(v for k, v in errs.items() if dims[k] > 1) < 2e-3
    # the f32 loss (no cast): every leaf within 1e-4 of its norm
    (ref_loss32, _), ref_g32 = vg(params, batch, False)
    loss32, g32 = _port_grads(port, cfg, batch, mixed_precision=False)
    assert abs(float(loss32) - float(ref_loss32)) <= \
        1e-5 * abs(float(ref_loss32))
    assert max(_rel_to_norm(g32, _port(ref_g32, cfg)).values()) < 1e-4


def _trajectory(monkeypatch, arch, cast: bool, steps=10):
    if not cast:
        monkeypatch.setattr(RS, "cast_matmul_params", lambda p, dtype=None: p)
        monkeypatch.setattr(PS, "cast_matmul_params", lambda p, dtype=None: p)
    cfg_ref, cfg, params = _model(arch)
    port = _port(params, cfg)
    # the launcher's schedule for `steps` steps
    kw = dict(warmup_steps=max(steps // 20, 5), total_steps=steps)
    ref_step = jax.jit(RS.make_train_step(cfg_ref, RO.AdamWConfig(**kw)))
    step = make_train_step(cfg, PO.AdamWConfig(**kw))
    rs, ps = RO.adamw_init(params), PO.adamw_init(port)
    data_r = RSyntheticLM(RDataConfig(vocab=cfg.vocab, seq_len=32,
                                      global_batch=4))
    data_p = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                    global_batch=4))
    out = []
    for _ in range(steps):
        params, rs, rm = ref_step(params, rs, data_r.next_batch())
        port, ps, pm = step(port, ps, data_p.next_batch())
        out.append((float(pm["loss"]), float(rm["loss"])))
    return out


@pytest.mark.parametrize("arch,cast", [
    ("qwen1.5-0.5b", False), ("mixtral-8x7b", False), ("xlstm-125m", False),
    ("qwen1.5-0.5b", True)], ids=["qwen-f32", "mixtral-f32", "xlstm-f32",
                                  "qwen-bf16-cast"])
def test_loss_trajectory_matches_reference(monkeypatch, arch, cast):
    """Ten steps of ``make_train_step`` from the same weights and
    batches: every step's loss within 1e-4 relative."""
    for got, want in _trajectory(monkeypatch, arch, cast):
        assert np.isfinite(got)
        assert abs(got - want) <= 1e-4 * abs(want), (got, want)


def test_accum_matches_one_batch(monkeypatch):
    """``accum=2`` (two microbatches of 2, f32 accumulation) against one
    batch of 4: equal-sized microbatches give the same mean loss and
    gradients, so the same update.  The f32 step (the bf16 cast off:
    with it each microbatch's matrix gradients are rounded to bf16
    before the sum, 6.7e-5 of the gradient norm measured)."""
    monkeypatch.setattr(PS, "cast_matmul_params", lambda p, dtype=None: p)
    _, cfg, params = _model("qwen1.5-0.5b")
    opt = PO.AdamWConfig(warmup_steps=1, total_steps=4)
    batch = _batch(cfg)
    outs = []
    for accum in (1, 2):
        port = _port(params, cfg)
        step = make_train_step(cfg, opt, accum=accum)
        p, s, m = step(port, PO.adamw_init(port), batch)
        outs.append((p, s, m))
    (p1, s1, m1), (p2, s2, m2) = outs
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m2["grad_norm"]), float(m1["grad_norm"]),
                               rtol=1e-5)
    assert max(_rel_to_norm(s2["m"], s1["m"]).values()) < 1e-5
    assert max(_rel_to_norm(p2, p1).values()) < 1e-6


def test_init_draws_f32_master_weights():
    cfg = pt_configs.get_config("qwen1.5-0.5b", "smoke")
    p = PT.init(cfg, device="cpu", param_dtype=torch.float32)
    assert all(t.dtype == torch.float32 for _, t in flatten(p))
    q = PT.init(cfg, device="cpu")
    assert q["layers"][0]["mixer"]["wq"]["w"].dtype == torch.bfloat16
    torch.testing.assert_close(q["layers"][0]["mixer"]["wq"]["w"],
                               p["layers"][0]["mixer"]["wq"]["w"].to(
                                   torch.bfloat16), rtol=0, atol=0)
    params, opt = PS.init_train_state(cfg, device="cpu")
    assert set(opt) == {"m", "v", "step"} and int(opt["step"]) == 0


def test_remat_recomputes_and_changes_nothing():
    """``remat`` runs each layer under ``torch.utils.checkpoint``: the
    same loss and gradients."""
    _, cfg, params = _model("mixtral-8x7b")
    port = _port(params, cfg)
    batch = _batch(cfg, B=2, S=16)
    out = [_port_grads(port, cfg, batch, remat=r) for r in (False, True)]
    assert float(out[0][0].detach()) == pytest.approx(
        float(out[1][0].detach()), rel=1e-6)
    assert max(_rel_to_norm(out[1][1], out[0][1]).values()) < 1e-5


# --------------------------------------------------------------------------
# F5: the RMSNorm kernel's autograd wrapper
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_function_gradient_matches_plain(monkeypatch, dtype):
    """The ``autograd.Function`` the card takes (here with the plain
    version in the kernel's place): its forward's output, and its
    backward's dx and dscale (plain f32 from the saved x and scale)
    against autograd through the plain version, at f32 2e-5 / bf16
    2e-2."""
    monkeypatch.setattr(PR, "_launch", lambda x, s, eps:
                        PR.rmsnorm_rows_plain(x, s, eps=eps))
    g = torch.Generator().manual_seed(0)
    dt = getattr(torch, dtype)
    x0 = torch.randn(96, 64, generator=g).to(dt)
    s0 = torch.randn(64, generator=g) * 0.1 + 1.0
    gy = torch.randn(96, 64, generator=g).to(dt)
    x, s = x0.clone().requires_grad_(), s0.clone().requires_grad_()
    y = PR._RMSNormRows.apply(x, s, 1e-6)
    dx, ds = torch.autograd.grad(y, (x, s), gy)
    xp, sp = x0.clone().requires_grad_(), s0.clone().requires_grad_()
    yp = PR.rmsnorm_rows_plain(xp, sp)
    dxp, dsp = torch.autograd.grad(yp, (xp, sp), gy)
    tol = 2e-5 if dtype == "float32" else 2e-2
    for a, b in ((y, yp), (dx, dxp), (ds, dsp)):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)
    # x alone, and scale alone
    (dx_only,) = torch.autograd.grad(PR._RMSNormRows.apply(
        x, s0, 1e-6), (x,), gy)
    torch.testing.assert_close(dx_only.float(), dxp.float(), rtol=tol,
                               atol=tol)


def test_rmsnorm_backward_matches_reference_autodiff():
    """``rmsnorm_rows_backward`` against JAX's gradient of the
    reference's RMSNorm, f32."""
    from repro.models.common import rmsnorm as ref_rmsnorm
    rng = np.random.default_rng(5)
    x = rng.standard_normal((40, 32)).astype(np.float32)
    s = (rng.standard_normal(32) * 0.1 + 1).astype(np.float32)
    gy = rng.standard_normal((40, 32)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: ref_rmsnorm({"scale": b}, a),
                     jnp.asarray(x), jnp.asarray(s))
    rdx, rds = vjp(jnp.asarray(gy))
    dx, ds = PR.rmsnorm_rows_backward(torch.from_numpy(x), torch.from_numpy(s),
                                      torch.from_numpy(gy))
    np.testing.assert_allclose(dx.numpy(), np.asarray(rdx), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(ds.numpy(), np.asarray(rds), rtol=2e-5,
                               atol=2e-5)


# --------------------------------------------------------------------------
# The launcher and serving from its checkpoint
# --------------------------------------------------------------------------

def test_train_on_cpu_resumes_and_serves(tmp_path):
    """``train`` on the CPU: the loss falls over 12 steps; the same run
    preempted after step 10 (its last checkpoint at step 6) and called
    again on the same directory resumes at step 6, with the data
    pipeline's state, and gives the straight run's losses; serve()
    restores the trained parameters."""
    class Preempted(Exception):
        pass

    def preempt(s, m):
        if s == 10:
            raise Preempted

    kw = dict(variant="smoke", steps=12, global_batch=2, seq_len=32,
              ckpt_every=6, device="cpu")
    straight = train("qwen1.5-0.5b", ckpt_dir=str(tmp_path / "s"),
                     log_fn=lambda s, m: None, **kw)
    losses = straight["losses"]
    assert len(losses) == 12 and np.mean(losses[-3:]) < np.mean(losses[:3])
    d = str(tmp_path / "a")
    with pytest.raises(Preempted):
        train("qwen1.5-0.5b", ckpt_dir=d, log_fn=preempt, **kw)
    for _ in range(600):          # the step-6 save runs on its own thread
        if latest_step(d) == 6:
            break
        time.sleep(0.05)
    assert latest_step(d) == 6
    again = train("qwen1.5-0.5b", ckpt_dir=d, log_fn=lambda s, m: None, **kw)
    assert again["losses"] == losses[6:]
    assert latest_step(d) == 12
    cfg = pt_configs.get_config("qwen1.5-0.5b", "smoke")
    tree, extra = restore_checkpoint(d, {"params": PT.init(cfg, device="cpu"),
                                         "opt": None})
    assert extra == {"step": 12, "data": {"step": 12}}
    w = tree["params"]["layers"][0]["mlp"]["w_up"]["w"]
    assert w.dtype == torch.bfloat16
    assert not torch.equal(w, PT.init(cfg, device="cpu")["layers"][0]["mlp"]
                           ["w_up"]["w"])
    stats = serve("qwen1.5-0.5b", n_requests=2, max_len=32, max_new_tokens=3,
                  ckpt_dir=d, device="cpu")
    assert all(len(t) == 3 for t in stats["outputs"].values())


@pytest.mark.parametrize("sharded", [False, True], ids=["none", "host_mesh"])
def test_resume_or_init_accepts_shardings(tmp_path, sharded):
    """F8: the reference's call ``resume_or_init(p, o, shardings=...)``
    runs on the port, and the keyword stands in for the loop's
    ``shardings`` field for that call.  Without a mesh, ``shardings=None``
    gives the call without it, which gives the reference's loop's step,
    data state and values on the same checkpoint; with the host mesh's
    shardings, the keyword gives the blocks (plain tensors) that a loop
    whose field holds them gives, bit for bit."""
    import repro.train.loop as RL

    from repro_torch.launch import make_host_mesh
    from repro_torch.pytree import flatten
    from repro_torch.train import LoopConfig, TrainLoop, init_train_state
    from repro_torch.train.checkpoint import save_checkpoint
    from repro_torch.train.sharded import train_state_shardings
    cfg = pt_configs.get_config("qwen1.5-0.5b", "smoke")
    p, o = init_train_state(cfg, seed=3, device="cpu")
    d = str(tmp_path)
    save_checkpoint(d, 7, {"params": p, "opt": o},
                    extra={"step": 7, "data": {"step": 7}})
    p0, o0 = init_train_state(cfg, seed=0, device="cpu")
    shd = train_state_shardings(p0, make_host_mesh("cpu")) if sharded \
        else None

    def loop(field=None):
        return TrainLoop(step_fn=None, cfg=LoopConfig(ckpt_dir=d),
                         data=SyntheticLM(DataConfig(cfg.vocab, 8, 2)),
                         shardings=field)

    def leaves(res):
        return [t for _, t in flatten({"params": res[0], "opt": res[1]})]

    by_kw, by_field = loop(), loop(shd)
    got = by_kw.resume_or_init(p0, o0, shardings=shd)
    want = by_field.resume_or_init(p0, o0)
    assert got[2] == want[2] == 7
    assert by_kw.data.step == by_field.data.step == 7
    saved = leaves((p, o))
    for g, w, s in zip(leaves(got), leaves(want), saved, strict=True):
        assert type(g) is torch.Tensor and type(w) is torch.Tensor
        assert torch.equal(g, w) and torch.equal(g, s)
    if sharded:
        return
    to_ref = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    ref = RL.TrainLoop(step_fn=None, cfg=RL.LoopConfig(ckpt_dir=d),
                       data=RSyntheticLM(RDataConfig(cfg.vocab, 8, 2)))
    rp, ro, rstep = ref.resume_or_init(jax.tree.map(to_ref, p0),
                                       jax.tree.map(to_ref, o0),
                                       shardings=None)
    assert rstep == got[2] and ref.data.step == by_kw.data.step
    ref_leaves = jax.tree_util.tree_leaves({"params": rp, "opt": ro})
    for g, r in zip(leaves(got), ref_leaves, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_train_cli_and_meshes(tmp_path, capsys):
    assert train_main(["--device", "cpu", "--steps", "2", "--batch", "2",
                       "--seq", "16", "--ckpt-dir", str(tmp_path),
                       "--ckpt-every", "0"]) == 0
    assert "done: loss" in capsys.readouterr().out
    assert os.path.exists(tmp_path / "LATEST")
    for mesh, world in (("single", 256), ("multi", 512)):
        with pytest.raises(ValueError, match=f"world of {world} ranks"):
            train("qwen1.5-0.5b", steps=1, mesh_kind=mesh, device="cpu")
    with pytest.raises(ValueError):
        train("qwen1.5-0.5b", steps=1, mesh_kind="pod", device="cpu")


@pytest.mark.parametrize("pkg", ["optim", "data", "train", "models.xlstm"])
def test_packages_export_reference_names(pkg):
    """The port's package exports every name of the reference's
    ``__all__``, each the port's own object."""
    import importlib
    ref = importlib.import_module(f"repro.{pkg}")
    port = importlib.import_module(f"repro_torch.{pkg}")
    assert set(ref.__all__) <= set(port.__all__)
    for name in ref.__all__:
        assert getattr(port, name).__module__.startswith("repro_torch.")
