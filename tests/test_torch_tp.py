"""Tensor parallelism's single-process parts (``repro_torch.dist.tp``, the
per-layer gather hook, decode attention's log-sum-exp output), on the
CPU, where the kernels run their plain versions.

* Decode attention's ``lse`` against a float64 log-sum-exp of the same
  scores (f32 2e-5, -inf exactly for a row of length 0), and a cache cut
  into slot blocks, attended block by block and merged by
  ``merge_partials``, against the whole cache (f32 2e-5, bf16 2e-2: the
  kernels' tolerances), blocks and rows of length 0 included.
* ``tp_dense``, ``tp_norm`` and ``tp_embed`` on a world-1 gloo mesh: the
  plain ``dense``, ``norm`` and lookup, bit for bit, on every path.
* The sharded step's gradients through the per-layer gather hook, on a
  world-1 mesh, bit-equal to the program it replaced (every leaf
  gathered whole, then the step body); the hook's forward and decode on
  the JAX reference's weights bit-equal to the bare port and within
  1e-4 of the reference (``tests/test_torch_forward.py``'s bound).
* ``as_block`` and ``reblock`` on ``meta`` over a 4-rank ``model`` axis
  (a mesh description): the blocks' shapes, and one all-to-all a re-cut.
* The Mamba and xLSTM mixers on their blocks (jamba and xlstm smoke):
  on one rank every mixer, ``tp_dense_groups`` and the hook's programs
  are the plain ones, bit for bit (gradients too); on mesh descriptions
  (``meta``; (1, 2) at smoke size, 16 x 16 at full width) the hook's
  plan and the collectives' tally gather no Mamba weight over ``model``
  and no xLSTM weight but sLSTM's ``r``, and a width that ``model`` does
  not divide keeps the whole gather; the plain selective scans on
  channel blocks give the whole scan's columns bit for bit.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.dist.context import set_activation_axes
from repro.models import transformer as RT

import repro_torch.dist.context as C
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.dist import tp
from repro_torch.dist.sharding import (PartitionSpec as P, cache_specs,
                                       gather_block, gather_hook,
                                       local_shape, param_specs,
                                       spec_leaves, under)
from repro_torch.kernels import decode_attention_plain
from repro_torch.kernels.decode_attention import merge_partials
from repro_torch.kernels.mamba_scan import mamba_scan_plain
from repro_torch.launch import make_host_mesh
from repro_torch.launch.mesh import production_mesh_spec
from repro_torch.models import transformer as T
from repro_torch.models.common import dense, norm
from repro_torch.models.ssm import Mamba, _scan_xla
from repro_torch.models.xlstm import MLSTM, SLSTM
from repro_torch.pytree import flatten, unflatten
from repro_torch.train.sharded import sharded_grads
from repro_torch.train.step import _to_device, accumulate_grads
from torch_threads import one_torch_thread  # noqa: F401

_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture(autouse=True)
def _no_mesh():
    set_activation_axes()
    C.set_activation_axes()
    yield
    C.set_activation_axes()


def _attn(B, H, Hkv, T_, D, lengths, dtype=torch.float32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((B, H, D), generator=gen).to(dtype)
    k = torch.randn((B, T_, Hkv, D), generator=gen).to(dtype)
    v = torch.randn((B, T_, Hkv, D), generator=gen).to(dtype)
    return q, k, v, torch.tensor(lengths, dtype=torch.int32)


def test_plain_lse_matches_float64_logsumexp():
    B, H, Hkv, T_, D = 3, 8, 2, 40, 16
    q, k, v, lens = _attn(B, H, Hkv, T_, D, [0, 17, 40])
    out, lse = decode_attention_plain(q, k, v, lens, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, H)
    assert torch.equal(out, decode_attention_plain(q, k, v, lens))
    qd, kd = q.double(), k.double()
    for b, n in enumerate(lens.tolist()):
        for h in range(H):
            if n == 0:
                assert lse[b, h] == -np.inf
                continue
            s = kd[b, :n, h // (H // Hkv)] @ qd[b, h] / np.sqrt(D)
            want = float(torch.logsumexp(s, 0))
            assert abs(float(lse[b, h]) - want) <= 2e-5 * max(1.0,
                                                              abs(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_blocks,lengths", [
    (2, [1, 17, 39, 40]),        # the second block empty, then partial
    (4, [0, 9, 10, 31, 40]),     # a row of length 0: every block empty
    (4, [0, 0]),                 # every row empty
])
def test_slot_blocks_merged_match_whole_cache(dtype, n_blocks, lengths):
    """Each block of ``T / n`` slots attended with its own lengths
    (``clamp(len - i * T_r, 0, T_r)``), the (out, lse) pairs merged in
    block order, against one call on the whole cache; rows of length 0
    merge to zeros."""
    B, H, Hkv, T_, D = len(lengths), 6, 3, 40, 16
    q, k, v, lens = _attn(B, H, Hkv, T_, D, lengths, dtype)
    T_r = T_ // n_blocks
    outs, lses = [], []
    for i in range(n_blocks):
        loc = torch.clamp(lens - i * T_r, 0, T_r).to(torch.int32)
        o, lse = decode_attention_plain(q, k[:, i * T_r:(i + 1) * T_r],
                                        v[:, i * T_r:(i + 1) * T_r], loc,
                                        return_lse=True)
        outs.append(o)
        lses.append(lse)
    got = merge_partials(torch.stack(outs), torch.stack(lses))
    want = decode_attention_plain(q, k, v, lens).float()
    live = lens > 0
    assert got.dtype == torch.float32
    assert torch.equal(got[~live], torch.zeros_like(got[~live]))
    torch.testing.assert_close(got[live], want[live], rtol=_TOL[dtype],
                               atol=_TOL[dtype])


def test_tp_layers_on_one_rank_are_the_plain_layers():
    """On a world-1 mesh every path of ``tp_dense`` (each placement,
    with and without a feature block in and out), ``tp_norm`` and
    ``tp_embed`` give the plain layer's bits."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 5, 12), generator=gen)
    p = {"w": torch.randn((12, 20), generator=gen),
         "b": torch.randn((20,), generator=gen)}
    want = dense(p, x)
    ln = {"scale": torch.rand((12,), generator=gen),
          "bias": torch.rand((12,), generator=gen)}
    emb = torch.randn((30, 12), generator=gen)
    tok = torch.randint(0, 30, (2, 5), generator=gen)
    with C.act_ctx(dp="data", tp="model", mesh=make_host_mesh("cpu")):
        assert tp.tp_axis()[0] == 1
        for spec in (P("model", None), P(None, "model"), P(None, None)):
            for kw in ({}, {"x_block": True}, {"keep_block": True}):
                y, blk = tp.tp_dense(p, x, spec, **kw)
                assert torch.equal(y, want) and not blk
        for kind in ("rmsnorm", "layernorm"):
            y, blk = tp.tp_norm(ln, x, kind)
            assert torch.equal(y, norm(ln, x, kind)) and not blk
        assert torch.equal(tp.tp_embed(emb, tok, (30, 12), torch.float32),
                           emb[tok])


@functools.lru_cache(maxsize=None)
def _ref_model(arch: str):
    cfg_ref = ref_configs.get_config(arch, "smoke").replace(dtype="float32")
    cfg = get_config(arch, "smoke").replace(dtype="float32")
    params = RT.init(jax.random.PRNGKey(0), cfg_ref)
    port = interop.params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                     device="cpu")
    return cfg_ref, cfg, params, port


_MIXER_ARCHS = ["jamba-v0.1-52b", "xlstm-125m"]


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "deepseek-v2-236b",
                                  *_MIXER_ARCHS])
def test_hook_grads_match_whole_gather_one_rank(arch):
    """``sharded_grads`` (blocks, the per-layer gather hook inside each
    layer's checkpoint) against the program it replaced: every leaf
    gathered whole, then ``accumulate_grads``, then the reduce (the
    identity on one rank); the bf16 cast on, bit for bit."""
    cfg = get_config(arch, "smoke").replace(dtype="float32")
    mesh = make_host_mesh("cpu")
    p0 = T.init(cfg, seed=0, device="cpu", param_dtype=torch.float32)
    specs = spec_leaves(p0, param_specs(p0, mesh))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16,
                                  global_batch=2))
    batch = _to_device(data.next_batch(), "cpu")
    with C.act_ctx(dp="data", tp="model", mesh=mesh):
        got, m_got = sharded_grads(cfg, mesh, specs, p0, batch)
        whole = unflatten(p0, [gather_block(t, s)
                               for (_, t), s in zip(flatten(p0), specs)])
        want, m_want = accumulate_grads(whole, cfg, batch)
    assert torch.equal(m_got["loss"], m_want["loss"])
    for g, (_, w) in zip(got, flatten(want)):
        assert torch.equal(g, w)


def test_hook_forward_and_decode_match_reference_one_rank():
    """qwen smoke on the JAX reference's weights: the forward and a
    decode step through the hook on a world-1 mesh (blocks placed by
    ``param_specs``, the cache by ``cache_specs``) are the bare port's
    bits, and within 1e-4 of the reference's."""
    _hook_forward_and_decode("qwen1.5-0.5b")


@pytest.mark.parametrize("arch", _MIXER_ARCHS)
def test_hook_forward_and_decode_match_reference_one_rank_mixers(arch):
    """The same for jamba smoke (Mamba on its channel blocks, an
    attention layer, MoE) and xlstm smoke (mLSTM and sLSTM on their
    blocks)."""
    _hook_forward_and_decode(arch)


def _hook_forward_and_decode(arch: str) -> None:
    cfg_ref, cfg, params, port = _ref_model(arch)
    mesh = make_host_mesh("cpu")
    hook = gather_hook(param_specs(port, mesh, mode="serve"))
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 9))
    x = torch.from_numpy(toks).long()
    ref_logits, _ = RT.forward(params, cfg_ref, jax.numpy.asarray(toks),
                               impl="xla")
    bare, _ = T.forward(port, cfg, x, remat=False)
    cache = T.init_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
    cache_b = T.init_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
    with C.act_ctx(dp="data", tp="model", mesh=mesh):
        got, _ = T.forward(port, cfg, x, remat=False, gather=hook)
        dec = T.decode_step(port, cfg, x[:, 0], cache, 0, gather=hook,
                            cache_specs=cache_specs(cache, mesh))[0]
    assert torch.equal(got, bare)
    assert torch.equal(dec, T.decode_step(port, cfg, x[:, 0], cache_b,
                                          0)[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_logits),
                               rtol=1e-4, atol=1e-4)


def test_blocks_recut_on_meta():
    """On a (1, 4) mesh description: a whole weight is sliced to this
    rank's block along the dim asked, a block already cut there is kept,
    and a block cut along another dim is re-cut by one all-to-all of its
    own size (no gather)."""
    mesh = C.MeshSpec(("data", "model"), (1, 4))
    shape = (8, 128, 64)                 # (E, d, ff): model on d
    whole = torch.empty(shape, device="meta")
    block = torch.empty((8, 32, 64), device="meta")
    calls = []
    with C.act_ctx(dp="data", tp="model", mesh=mesh), \
            C.count_collectives(calls):
        assert tp.model_dim(tp.weight_spec(shape)) == 1
        assert tp.as_block(whole, shape, 0).shape == (2, 128, 64)
        assert tp.as_block(block, shape, 1) is block
        assert tp.as_block(block, shape, 0).shape == (2, 128, 64)
        assert tp.as_block(block, shape, 2).shape == (8, 128, 16)
    assert [c[:2] for c in calls] == [("all-to-all", "model")] * 2
    assert all(np.prod(c[2]) == 8 * 32 * 64 for c in calls)


def _mixer_case(arch: str):
    """A smoke config in f32, one layer of each mixer kind it has, and an
    input: (cfg, {kind: (class, layer params)}, x)."""
    cfg = get_config(arch, "smoke").replace(dtype="float32")
    p = T.init(cfg, seed=0, device="cpu", param_dtype=torch.float32)
    kinds = {}
    for i, lp in enumerate(p["layers"]):
        kind = cfg.layer_kind(i)
        if kind != "attn" and kind not in kinds:
            kinds[kind] = (T._mixer(cfg, i), lp["mixer"])
    x = torch.randn((2, 7, cfg.d_model), generator=torch.Generator()
                    .manual_seed(2))
    return cfg, kinds, x


@pytest.mark.parametrize("arch", _MIXER_ARCHS)
def test_tp_mixers_on_one_rank_are_the_plain_layers(arch):
    """On a world-1 mesh each Mamba, mLSTM and sLSTM mixer's ``fwd`` and
    three ``decode`` steps (the cache placed by ``cache_specs``) give the
    plain mixer's bits; ``tp_dense_groups`` is ``dense``; the hook keeps
    no mixer whole but sLSTM's ``r``."""
    cfg, kinds, x = _mixer_case(arch)
    mesh = make_host_mesh("cpu")
    for kind, (cls, mp) in kinds.items():
        want = cls.fwd(mp, cfg, x)
        c1 = cls.init_cache(cfg, 2, 8, torch.float32, device="cpu")
        c2 = cls.init_cache(cfg, 2, 8, torch.float32, device="cpu")
        want_dec = [cls.decode(mp, cfg, x[:, t:t + 1], c1, t)[0]
                    for t in range(3)]
        with C.act_ctx(dp="data", tp="model", mesh=mesh):
            assert torch.equal(cls.fwd(mp, cfg, x), want), kind
            cs = cache_specs({"l": c2}, mesh)["l"]
            for t in range(3):
                y, _ = cls.decode(mp, cfg, x[:, t:t + 1], c2, t, cspec=cs)
                assert torch.equal(y, want_dec[t]), (kind, t)
            w = mp["w_up" if kind != "mamba" else "w_in"]
            shape = tuple(w["w"].shape)
            y, blk = tp.tp_dense_groups(w, x, shape, 2)
            assert torch.equal(y, dense(w, x)) and not blk
        for k in c1:
            assert torch.equal(c1[k], c2[k]), (kind, k)
    with C.act_ctx(dp="data", tp="model", mesh=mesh):
        assert {T.whole_keys(cfg, i) for i in range(cfg.n_layers)} <= {
            (), (("mixer", "r"),)}


def _model_gathers(cfg, mesh, mode: str):
    """On the mesh description ``mesh`` (``meta``): the hook's plan for
    every layer of ``cfg``'s blocks placed by ``param_specs(mode=)``, and
    the collectives of a forward and (serve) a decode step on them: the
    layer's leaves the plan gathers over ``model``, by key path, and the
    calls."""
    params = T.init(cfg, device="meta", param_dtype=torch.float32)
    stree = param_specs(params, mesh, mode=mode)
    specs = spec_leaves(params, stree)
    blocks = unflatten(params, [
        torch.empty(local_shape(t.shape, s, mesh), device="meta")
        for (_, t), s in zip(flatten(params), specs)])
    hook = gather_hook(stree)
    calls = []
    tok = torch.zeros((2, 8), dtype=torch.long, device="meta")
    with C.act_ctx(dp="data", tp="model", mesh=mesh), \
            C.count_collectives(calls), torch.no_grad():
        T.forward(blocks, cfg, tok, remat=False, gather=hook)
        if mode == "serve":
            cache = T.init_cache(cfg, 2, 16, device="meta")
            ctree = cache_specs(cache, mesh)
            cb = unflatten(cache, [
                torch.empty(local_shape(t.shape, s, mesh), dtype=t.dtype,
                            device="meta")
                for (_, t), s in zip(flatten(cache),
                                     spec_leaves(cache, ctree))])
            T.decode_step(blocks, cfg, tok[:, 0], cb, 0, gather=hook,
                          cache_specs=ctree)
        whole = {i: T.whole_keys(cfg, i) for i in range(cfg.n_layers)}
    gathered = {}
    for (path, w), todo in hook.plans.items():
        if path[0] != "layers":
            continue
        leaves = flatten(blocks["layers"][path[1]])
        for j, dims in todo:
            if any("model" in C.as_axes(e) for _, e in dims):
                gathered.setdefault(path[1], set()).add(leaves[j][0])
    return params, specs, gathered, calls, whole


@pytest.mark.parametrize("mode", ["serve", "train"])
@pytest.mark.parametrize("arch,full", [(a, f) for a in _MIXER_ARCHS
                                       for f in (False, True)])
def test_hook_gathers_no_mixer_weight_over_model(arch, full, mode):
    """jamba's and xlstm's rank programs on mesh descriptions (``meta``):
    smoke on (1, 2), full width on the production 16 x 16.  The hook's
    plan gathers no Mamba or mLSTM leaf over ``model``, of an sLSTM layer
    only ``r`` (the recurrence needs every head's), and no all-gather
    over ``model`` in a forward or a decode step gives any other weight's
    shape."""
    cfg = get_config(arch, "full" if full else "smoke")
    if full:
        cfg = cfg.replace(n_layers=8 if arch.startswith("jamba") else 2)
        mesh = production_mesh_spec()
    else:
        mesh = C.MeshSpec(("data", "model"), (1, 2))
    params, specs, gathered, calls, whole = _model_gathers(cfg, mesh, mode)
    for i in range(cfg.n_layers):
        kind = cfg.layer_kind(i)
        got = gathered.get(i, set())
        if kind == "slstm":
            assert whole[i] == (("mixer", "r"),)
            assert got == {("mixer", "r")}, (i, got)
        elif kind != "attn":
            assert whole[i] == () and not got, (i, kind, got)
    exempt, weights = set(), set()
    for (kp, t), s in zip(flatten(params), specs):
        data = P(*(None if e == "model" else e for e in s))
        shapes = {tuple(t.shape), local_shape(t.shape, data, mesh)}
        (exempt if under(kp[2:], (("mixer", "r"),)) else weights).update(
            shapes)
    bad = [c for c in calls if c[:2] == ("all-gather", "model")
           and c[2] in weights - exempt]
    assert not bad, bad
    if arch.startswith("xlstm"):
        assert any(c[:2] == ("all-gather", "model") and c[2] in exempt
                   for c in calls)


@pytest.mark.parametrize("arch,m,widths", [
    ("jamba-v0.1-52b", 2, {"d_model": 63, "mamba_expand": 1}),
    ("xlstm-125m", 3, {"d_model": 32})])
def test_mixer_width_model_does_not_divide_keeps_whole_gather(arch, m,
                                                              widths):
    """Mixers whose width ``model`` does not divide: jamba smoke at d 63
    and d_inner 63 on a (1, 2) mesh description, xlstm smoke at d 32
    (mLSTM's inner 64) on (1, 3).  Each is gathered whole (every leaf
    the spec splits over ``model``: jamba's ``w_in``, ``w_x_dbc``,
    ``conv_w``, ``a_log``; sLSTM's FF) and runs its one-device program;
    the forward and a decode step run (``meta``)."""
    cfg = get_config(arch, "smoke").replace(**widths)
    mesh = C.MeshSpec(("data", "model"), (1, m))
    params, specs, gathered, calls, whole = _model_gathers(cfg, mesh,
                                                           "serve")
    n_split = 0
    for i, lp in enumerate(params["layers"]):
        if cfg.layer_kind(i) == "attn":
            continue
        with C.act_ctx(dp="data", tp="model", mesh=mesh):
            assert T.whole_mixer(cfg, i)
        assert whole[i] == ("mixer",)
        split = {kp for kp, t in flatten(lp) if kp[0] == "mixer"
                 and any(n % m == 0 for n in t.shape)}
        assert gathered.get(i, set()) >= split, (i, split)
        n_split += len(split)
    assert n_split


@pytest.mark.parametrize("n", [2, 4])
def test_scan_on_channel_blocks_is_the_whole_scan_bitwise(n):
    """The selective scan is independent per channel: the kernel's plain
    version run on each of ``n`` channel blocks gives the whole scan's
    columns bit for bit.  The plain twin of the reference's scan sums
    ``h·C`` in an einsum whose order follows the width: within 1e-6."""
    gen = torch.Generator().manual_seed(4)
    B, S, Dc, N = 2, 19, 64, 8
    x, dt = (torch.randn((B, S, Dc), generator=gen) for _ in range(2))
    dt = torch.nn.functional.softplus(dt)
    bc = torch.randn((B, S, 2 * N), generator=gen)
    bm, cm = bc[..., :N], bc[..., N:]
    a = -torch.rand((Dc, N), generator=gen) - 0.1
    d = torch.randn((Dc,), generator=gen)
    whole = mamba_scan_plain(x, dt, bm, cm, a, d)
    whole_xla = _scan_xla(x, dt, bm, cm, a)
    c = Dc // n
    for r in range(n):
        sl = slice(r * c, (r + 1) * c)
        blk = mamba_scan_plain(x[..., sl].contiguous(),
                               dt[..., sl].contiguous(), bm, cm,
                               a[sl].contiguous(), d[sl].contiguous())
        assert torch.equal(blk, whole[..., sl]), r
        torch.testing.assert_close(_scan_xla(x[..., sl], dt[..., sl], bm,
                                             cm, a[sl]), whole_xla[..., sl],
                                   rtol=1e-6, atol=1e-6)


def test_meta_recurrences_keep_shapes_and_gradients():
    """On ``meta`` the plain twin of the reference's scan and sLSTM's step
    loop run no step loop: the outputs keep their shapes, and autograd
    reaches every input with its shape (the dry run's train cells)."""
    meta = {"device": "meta", "requires_grad": True}
    xc, dt = (torch.empty((2, 4096, 256), **meta) for _ in range(2))
    bm, cm = (torch.empty((2, 4096, 16), **meta) for _ in range(2))
    a = torch.empty((256, 16), **meta)
    y = _scan_xla(xc, dt, bm, cm, a)
    assert y.shape == (2, 4096, 256) and y.dtype == torch.float32
    grads = torch.autograd.grad(y.sum(), (xc, dt, bm, cm, a))
    assert [g.shape for g in grads] == [t.shape for t in
                                        (xc, dt, bm, cm, a)]
    cfg = get_config("xlstm-125m", "smoke")
    p = SLSTM.init(torch.Generator(), cfg, dtype=torch.float32,
                   device="meta")
    leaves = [t.requires_grad_() for _, t in flatten(p)]
    x = torch.empty((2, 4096, cfg.d_model), **meta)
    y = SLSTM.fwd(p, cfg, x)
    assert y.shape == x.shape
    grads = torch.autograd.grad(y.sum(), [x, *leaves])
    assert [g.shape for g in grads] == [t.shape for t in [x, *leaves]]
