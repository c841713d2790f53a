"""The port's distributed paths on two ranks (``torch.distributed`` over
gloo, two CPU processes), held against the one-device computation.

One module fixture spawns the two ranks once (a ``file://`` store under
a temporary directory, so no port can clash across test workers); they
run every case and write their results, and each test checks one case.
The ranks are joined under ``_TIMEOUT_S`` and killed on expiry, so a
hung collective fails the tests instead of stalling the suite.  Nothing
here imports JAX: the reference is the port's own one-device path.

Tolerances (f32 throughout; the two sides differ in the order of their
sums only):

* MoE outputs within 2e-5 (absolute and relative; the reference's
  ``test_moe_distributed_matches_local`` allows 2e-4), the aux terms
  within 1e-5 relative, and the drop fractions equal (0: the capacity
  factors are chosen so that neither path drops a token);
* three sharded train steps against three single-device steps, with
  the train step's bf16 cast of the matrices off: the losses and
  gradient norms within 1e-5 relative (measured: 1.4e-7), each
  parameter within 1e-4 of its norm (measured: 3.7e-5, qwen's k biases,
  whose true gradient is zero: softmax ignores a shift of all scores,
  and AdamW turns rounding noise into steps of the learning rate);
* the same with the cast on: 1e-4 on the losses, 1e-3 on the gradient
  norms, 1e-2 of a parameter's norm (measured: 1.1e-5, 1.2e-4 and
  5.5e-3).  Autograd rounds each bf16 matrix's gradient to bf16 on each
  rank, before the ranks' mean, where the one-device step rounds the
  whole batch's once; AdamW's normalisation carries that rounding into
  the leaves whose gradients are near zero.

The tensor-parallel cases (qwen, deepseek, mixtral, internlm2, jamba and
xlstm smoke on a (1, 2) ``model`` mesh) hold the forward and greedy
decodes within 1e-5 of the largest logit, with equal tokens, and each
leaf's gradient within 5e-6 of its norm in f32 (1e-6 in f64; xlstm 5e-5,
``_GRAD_TOL_CASE``), with no weight all-gathered over ``model`` but
sLSTM's ``r``.
"""

import os
import threading
import time
import traceback

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch_threads import one_torch_thread  # noqa: F401

_WORLD = 2
_TIMEOUT_S = 240


def _moe_cases():
    from repro_torch.configs import get_config
    from repro_torch.models.common import ModelConfig
    mixtral = get_config("mixtral-8x7b", "smoke")
    deepseek = get_config("deepseek-v2-236b", "smoke")
    three = ModelConfig(name="three", n_layers=2, d_model=32, n_heads=4,
                        n_kv_heads=4, head_dim=8, d_ff=64, vocab=64,
                        n_experts=3, top_k=2, n_shared_experts=1,
                        moe_d_ff=48)
    # capacity factor E / K: a slot for every token at every expert
    return {
        "ep_mixtral": (mixtral, "ep"),
        "ep_deepseek": (deepseek, "ep"),
        "tp_three": (three, "tp"),
    }, lambda cfg: cfg.replace(dtype="float32",
                               capacity_factor=cfg.n_experts / cfg.top_k)


def _run_moe(rank, out):
    from repro_torch.dist.context import act_ctx
    from repro_torch.models.moe import MoE
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (1, _WORLD),
                            mesh_dim_names=("data", "model"))
    cases, f32 = _moe_cases()
    for name, (cfg, path) in cases.items():
        cfg = f32(cfg)
        gen = torch.Generator().manual_seed(0)
        p = MoE.init(gen, cfg, dtype=torch.float32, device="cpu")
        x = torch.randn((2, 16, cfg.d_model), generator=gen)
        y_local, aux_local = MoE._fwd_local(p, cfg, x)
        with act_ctx(dp="data", tp="model", mesh=mesh):
            fwd = MoE.fwd(p, cfg, x)
            want = MoE._fwd_ep if path == "ep" else MoE._fwd_tp
            y, aux = want(p, cfg, x)
        out[name] = {"y": y, "aux": aux, "y_local": y_local,
                     "aux_local": aux_local, "fwd_equal":
                     torch.equal(fwd[0], y)}


def _train_cases():
    from repro_torch.configs import get_config
    qwen = get_config("qwen1.5-0.5b", "smoke").replace(dtype="float32")
    mixtral = get_config("mixtral-8x7b", "smoke").replace(
        dtype="float32", capacity_factor=2.0)
    # (config, mesh shape, the train step's bf16 cast of the matrices)
    return {"train_qwen_2x1": (qwen, (2, 1), False),
            "train_mixtral_2x1": (mixtral, (2, 1), False),
            "train_mixtral_1x2": (mixtral, (1, 2), False),
            "train_qwen_2x1_cast": (qwen, (2, 1), True),
            "train_mixtral_1x2_cast": (mixtral, (1, 2), True)}


def _run_train(rank, out):
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.optim import AdamWConfig
    from repro_torch.pytree import flatten
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.sharded import (as_dtensors,
                                           make_sharded_train_step,
                                           shard_train_state,
                                           train_state_shardings)
    import repro_torch.train.step as PS
    from torch.distributed.device_mesh import init_device_mesh
    cast_matmul_params = PS.cast_matmul_params
    for name, (cfg, shape, cast) in _train_cases().items():
        PS.cast_matmul_params = (cast_matmul_params if cast
                                 else lambda p, dtype=None: p)
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        opt = AdamWConfig(warmup_steps=2, total_steps=10)
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                      global_batch=4))
        batches = [data.next_batch() for _ in range(3)]
        p0, o0 = init_train_state(cfg, device="cpu")
        shardings = train_state_shardings(p0, mesh)["params"]
        params, opt_state = shard_train_state(p0, o0, mesh)
        step = make_sharded_train_step(cfg, opt, mesh)
        metrics = []
        for b in batches:
            params, opt_state, m = step(params, opt_state, b)
            metrics.append({k: float(v) for k, v in m.items()})
        res = {"metrics": metrics,
               "params": {"/".join(map(str, k)): v.full_tensor()
                          for k, v in flatten(as_dtensors(params,
                                                          shardings))}}
        if rank == 0:
            p1, o1 = init_train_state(cfg, device="cpu")
            bare = make_train_step(cfg, opt)
            res["bare_metrics"] = []
            for b in batches:
                p1, o1, m = bare(p1, o1, b)
                res["bare_metrics"].append({k: float(v)
                                            for k, v in m.items()})
            res["bare_params"] = {"/".join(map(str, k)): v
                                  for k, v in flatten(p1)}
        out[name] = res
    PS.cast_matmul_params = cast_matmul_params


def _tp_cases():
    from repro_torch.configs import get_config
    from repro_torch.models.common import ModelConfig
    f32 = dict(dtype="float32")
    qwen = get_config("qwen1.5-0.5b", "smoke").replace(**f32)
    # capacity factor E / K: no token drops on either path
    deepseek = get_config("deepseek-v2-236b", "smoke").replace(
        capacity_factor=4.0, **f32)
    mixtral = get_config("mixtral-8x7b", "smoke").replace(
        capacity_factor=2.0, **f32)
    internlm2 = get_config("internlm2-20b", "smoke").replace(**f32)
    # more kv heads than head_dim and slots: cache_specs splits the heads
    wide_kv = ModelConfig(name="wide-kv", n_layers=2, d_model=64,
                          n_heads=32, n_kv_heads=32, head_dim=8, d_ff=128,
                          vocab=128, dtype="float32")
    # (config, cache slots, prompt tokens replayed, greedy steps after
    # them, the cache dim cache_specs splits over "model"): the slots in
    # qwen's k/v (B, 32, 6, 16), deepseek's c_kv (B, 64, 64) and k_rope
    # (B, 64, 8), mixtral's 64-slot ring (its window; the replay wraps
    # it) and internlm2's (B, 32, 1, 16) (one kv head: each rank reads
    # it for its 3 query heads); the replays reach the second rank's
    # slots, so that rank holds no valid slot for the first steps.
    # qwen's head_dim in an 8-slot cache (gathered for the step), and
    # wide-kv's kv heads (each rank decodes its own).  jamba smoke: Mamba
    # on each rank's d_inner channels, the conv window (B, 3, 128) and the
    # ssm state split on them (updated in place), one attention layer
    # over a slot block, MoE; xlstm smoke: mLSTM and sLSTM on their
    # blocks, the sLSTM states (B, 4, 16) split on head_dim (gathered for
    # the step); 20 greedy steps each
    jamba = get_config("jamba-v0.1-52b", "smoke").replace(
        capacity_factor=2.0, **f32)
    xlstm = get_config("xlstm-125m", "smoke").replace(**f32)
    return {"qwen": (qwen, 32, 12, 8, 1),
            "deepseek": (deepseek, 64, 30, 8, 1),
            "mixtral": (mixtral, 64, 60, 8, 1),
            "internlm2": (internlm2, 32, 20, 8, 1),
            "qwen_hd": (qwen, 8, 3, 4, 3),
            "wide_kv": (wide_kv, 16, 6, 8, 2),
            "jamba": (jamba, 32, 12, 20, 2),
            "xlstm": (xlstm, 32, 12, 20, 2)}


#: the configs of ``_tp_cases`` whose first layer's decode gathers its
#: cache for the step: xLSTM's recurrences run on whole states
_STATE_GATHERED = {"xlstm"}


def _whole_cases():
    """A Mamba width that ``model`` does not divide (d_inner 63 on two
    ranks): the mixers gathered whole, their states for a decode step;
    the same tuple as ``_tp_cases``' (no cache dim splits)."""
    from repro_torch.configs import get_config
    odd = get_config("jamba-v0.1-52b", "smoke").replace(
        d_model=63, mamba_expand=1, capacity_factor=2.0, dtype="float32")
    return {"jamba_odd": (odd, 32, 12, 8, None)}


#: name -> (arch, mesh shape, dtype) of the gradient cases
_GRAD_CASES = {"grads_qwen_1x2": ("qwen", (1, 2), torch.float32),
               "grads_deepseek_1x2": ("deepseek", (1, 2), torch.float32),
               "grads_qwen_2x1": ("qwen", (2, 1), torch.float32),
               "grads_qwen_1x2_f64": ("qwen", (1, 2), torch.float64),
               "grads_deepseek_1x2_f64": ("deepseek", (1, 2), torch.float64),
               "grads_jamba_1x2": ("jamba", (1, 2), torch.float32),
               "grads_jamba_1x2_f64": ("jamba", (1, 2), torch.float64),
               "grads_xlstm_1x2": ("xlstm", (1, 2), torch.float32)}

#: bound on each leaf's gradient error over the leaf's norm, by dtype.
#: In f32 the one-device gradient is itself 1.6e-6 (qwen smoke) and
#: 2.3e-6 (deepseek smoke) of a leaf's norm away from the f64 gradient,
#: so no reordering of its sums can meet 1e-6: the TP gradients measured
#: 2.1e-6 (qwen) and 2.7e-6 (deepseek) from the one-device ones, the
#: FSDP ones 2.3e-7 (``tools/tp_grad_errors.py``).  In f64 the same
#: programs are held to 1e-6.
_GRAD_TOL = {torch.float32: 5e-6, torch.float64: 1e-6}

#: xlstm smoke's one-device f32 gradient is itself 3.12e-5 of a leaf's
#: norm from f64 (its exponential gates; the TP gradients measured 1.52e-5
#: from the one-device ones), so its f32 case is held to 5e-5; and its
#: recurrences compute in f32 in every dtype, so it has no f64 case
#: (``tools/tp_grad_errors.py``)
_GRAD_TOL_CASE = {"grads_xlstm_1x2": 5e-5}


def _blocks(tree, specs, mesh):
    from repro_torch.dist.sharding import local_block, placements
    from repro_torch.pytree import flatten, unflatten
    return unflatten(tree, [
        local_block(t, mesh, placements(mesh, s)).contiguous()
        for (_, t), s in zip(flatten(tree), specs)])


def _weight_shapes(params, specs, mesh):
    """The shapes a weight takes gathered over ``model``: whole, or whole
    over ``model`` and still split over the data axes; sLSTM's ``r``, the
    one weight its layer gathers whole, left out."""
    from repro_torch.dist.sharding import PartitionSpec, local_shape
    from repro_torch.pytree import flatten
    out = set()
    for (kp, t), s in zip(flatten(params), specs):
        if kp[-2:] == ("mixer", "r"):
            continue
        out.add(tuple(t.shape))
        data = PartitionSpec(*(None if e == "model" else e for e in s))
        out.add(local_shape(t.shape, data, mesh))
    return out


def _greedy(step, toks, n_prompt: int, n_new: int):
    """Replay ``toks[:, :n_prompt]`` through ``step(tok, pos) -> logits``,
    then ``n_new`` greedy steps: every step's logits and the tokens."""
    logits, out = [], []
    tok = toks[:, 0]
    for pos in range(n_prompt + n_new):
        lg = step(tok, pos)
        logits.append(lg)
        nxt = lg.argmax(-1)
        if pos + 1 < n_prompt:
            tok = toks[:, pos + 1]
        else:
            tok = nxt
            out.append(nxt)
    return torch.stack(logits), torch.stack(out)


def _run_tp(rank, out):
    """TP on a (1, 2) mesh (forward, decode over slot-split caches, the
    train step's gradients) and per-layer FSDP on a (2, 1) mesh, each
    against the one-device port; every collective's call recorded."""
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.dist.context import act_ctx, count_collectives
    from repro_torch.dist.sharding import (cache_specs, gather_hook,
                                           param_specs, spec_leaves)
    from repro_torch.models import transformer as T
    from repro_torch.pytree import flatten, unflatten
    from repro_torch.train.sharded import (as_dtensors, sharded_grads,
                                           train_state_shardings)
    from repro_torch.train.step import _to_device, accumulate_grads
    import repro_torch.train.step as PS
    from torch.distributed.device_mesh import init_device_mesh
    cast_matmul_params = PS.cast_matmul_params
    PS.cast_matmul_params = lambda p, dtype=None: p   # the bf16 cast off
    try:
        mp = init_device_mesh("cpu", (1, _WORLD),
                              mesh_dim_names=("data", "model"))
        _run_regroup(rank, mp, out)
        for name, (cfg, slots, n_prompt, n_new, _) in {
                **_tp_cases(), **_whole_cases()}.items():
            params = T.init(cfg, seed=0, device="cpu",
                            param_dtype=torch.float32)
            stree = param_specs(params, mp, mode="serve")
            specs = spec_leaves(params, stree)
            blocks = _blocks(params, specs, mp)
            hook = gather_hook(stree)
            toks = torch.randint(0, cfg.vocab, (2, n_prompt),
                                 generator=torch.Generator().manual_seed(1))
            res = {"weight_shapes": _weight_shapes(params, specs, mp)}
            calls = []
            with count_collectives(calls), \
                    act_ctx(dp="data", tp="model", mesh=mp):
                res["logits"] = T.forward(blocks, cfg, toks, remat=False,
                                          gather=hook)[0]
            res["logits_1"] = T.forward(params, cfg, toks, remat=False)[0]
            res["forward_calls"] = calls
            res["mamba_shapes"] = {
                tuple(t.shape) for kp, t in flatten(params)
                if kp[0] == "layers" and kp[2] == "mixer"
                and cfg.layer_kind(kp[1]) == "mamba"}

            cache = T.init_cache(cfg, 2, slots, dtype=torch.float32,
                                 device="cpu")
            cspec = cache_specs(cache, mp)
            cblocks = _blocks(cache, spec_leaves(cache, cspec), mp)
            res["cache_block"] = tuple(flatten(cblocks)[0][1].shape)
            res["cache_whole"] = tuple(flatten(cache)[0][1].shape)
            calls = []
            with count_collectives(calls), \
                    act_ctx(dp="data", tp="model", mesh=mp), \
                    torch.no_grad():
                res["decode"] = _greedy(
                    lambda t, pos: T.decode_step(blocks, cfg, t, cblocks,
                                                 pos, gather=hook,
                                                 cache_specs=cspec)[0],
                    toks, n_prompt, n_new)
            whole = T.init_cache(cfg, 2, slots, dtype=torch.float32,
                                 device="cpu")
            with torch.no_grad():
                res["decode_1"] = _greedy(
                    lambda t, pos: T.decode_step(params, cfg, t, whole,
                                                 pos)[0],
                    toks, n_prompt, n_new)
            res["decode_calls"] = calls
            out[f"tp_{name}"] = res

        # 4 x 40 tokens (80 a data rank): no weight has a dim of 160 or
        # 80, so a gathered activation never takes a weight's shape
        data = SyntheticLM(DataConfig(vocab=512, seq_len=40, global_batch=4))
        batch = _to_device(data.next_batch(), "cpu")
        for name, (arch, shape, dt) in _GRAD_CASES.items():
            cfg = _tp_cases()[arch][0].replace(dtype=str(dt)[6:])
            mesh = mp if shape == (1, 2) else init_device_mesh(
                "cpu", shape, mesh_dim_names=("data", "model"))
            p0 = T.init(cfg, seed=0, device="cpu", param_dtype=dt)
            specs = spec_leaves(p0, param_specs(p0, mesh))
            n, i = mesh.size(0), mesh.get_local_rank(0)
            rows = {k: v.chunk(n, 0)[i] for k, v in batch.items()}
            calls = []
            with count_collectives(calls), \
                    act_ctx(dp="data", tp="model", mesh=mesh):
                gl, metrics = sharded_grads(cfg, mesh, specs,
                                            _blocks(p0, specs, mesh), rows)
            shd = train_state_shardings(p0, mesh)["params"]
            res = {"grads": {"/".join(map(str, k)): v.full_tensor()
                             for k, v in flatten(as_dtensors(
                                 unflatten(p0, gl), shd))},
                   "loss": float(metrics["loss"]), "calls": calls,
                   "weight_shapes": _weight_shapes(p0, specs, mesh)}
            g1, m1 = accumulate_grads(p0, cfg, batch)
            res["grads_1"] = {"/".join(map(str, k)): v
                              for k, v in flatten(g1)}
            res["loss_1"] = float(m1["loss"])
            out[name] = res

        # the backward (and each layer's recompute) on another thread, as
        # autograd runs a CUDA tensor's: the checkpointed functions carry
        # their activation axes with them
        cfg = _tp_cases()["qwen"][0]
        p0 = T.init(cfg, seed=0, device="cpu", param_dtype=torch.float32)
        stree = param_specs(p0, mp)
        leaves = [t.detach().requires_grad_() for _, t in flatten(
            _blocks(p0, spec_leaves(p0, stree), mp))]
        grads = {}
        for where in ("here", "thread"):
            with act_ctx(dp="data", tp="model", mesh=mp):
                loss, _ = PS.loss_fn(unflatten(p0, leaves), cfg, batch,
                                     gather=gather_hook(stree))

            def backward(where=where, loss=loss):
                grads[where] = torch.autograd.grad(loss, leaves)
            if where == "here":
                backward()
            else:
                t = threading.Thread(target=backward)
                t.start()
                t.join()
        out["thread_qwen_1x2"] = {k: list(v) for k, v in grads.items()}
    finally:
        PS.cast_matmul_params = cast_matmul_params


def _run_regroup(rank, mesh, out):
    """``tp.regroup`` on a (1, 2) mesh: whole tensors whose entries are
    their index along the grouped dim, this rank's contiguous block of
    them re-cut, for 2 and 4 groups along dim 1 of a (3, 16) and dim 2 of
    a (2, 3, 16); and ``tp_dense_groups`` on mamba's [x | z] at jamba
    smoke's (64, 256), a 2-row input (the output re-cut) and a 96-row one
    (the weight's block re-cut), against this rank's channels of x and z
    of the whole product."""
    from repro_torch.dist import tp
    from repro_torch.dist.context import act_ctx, count_collectives
    res = {"index": {}, "dense": {}}
    with act_ctx(dp="data", tp="model", mesh=mesh):
        for groups in (2, 4):
            for shape, dim in (((3, 16), 1), ((2, 3, 16), 2)):
                whole = torch.arange(16.0).expand(shape).contiguous()
                block = whole.chunk(_WORLD, dim)[rank]
                calls = []
                with count_collectives(calls):
                    got = tp.regroup(block, dim, groups)
                res["index"][(groups, shape)] = (
                    got.select(0, 0).reshape(-1, 16 // _WORLD)[0].tolist()
                    if got.dim() == 2 else got[0, 0].tolist(),
                    [c[0] for c in calls])
        gen = torch.Generator().manual_seed(3)
        w = {"w": torch.randn((64, 256), generator=gen)}
        wb = {"w": w["w"].chunk(_WORLD, 1)[rank].contiguous()}
        for rows in (2, 96):
            x = torch.randn((1, rows, 64), generator=gen)
            calls = []
            with count_collectives(calls):
                y, blk = tp.tp_dense_groups(wb, x, (64, 256), 2)
            # this rank's 64 channels of x and of z
            want = (x @ w["w"]).unflatten(-1, (2, _WORLD, 64))[
                ..., rank, :].flatten(-2)
            res["dense"][rows] = (float((y - want).abs().max()), blk,
                                  tuple(y.shape),
                                  [(c[0], c[2]) for c in calls])
    out["regroup"] = res


def _rank_main(rank: int, store: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=_WORLD)
    out = {}
    for run in (_run_moe, _run_train, _run_tp):
        try:
            run(rank, out)
        except Exception:
            out[run.__name__] = traceback.format_exc()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("two_ranks")
    store = str(d / "store")
    ctx = mp.spawn(_rank_main, args=(store, str(d)), nprocs=_WORLD,
                   join=False)
    deadline = time.monotonic() + _TIMEOUT_S
    done = False
    try:
        # join() returns False while a rank is still running
        while not done and time.monotonic() < deadline:
            done = ctx.join(timeout=max(deadline - time.monotonic(), 0.1))
    finally:
        if not done:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join(5)
    assert done, f"the two ranks did not finish in {_TIMEOUT_S} s"
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(_WORLD)]


def _case(ranks, name):
    for r, out in enumerate(ranks):
        for run in ("_run_moe", "_run_train", "_run_tp"):
            assert run not in out, f"rank {r}: {out[run]}"
    return [out[name] for out in ranks]


@pytest.mark.parametrize("name", ["ep_mixtral", "ep_deepseek", "tp_three"])
def test_moe_two_ranks_match_local(ranks, name):
    """``_fwd_ep`` (mixtral smoke, E 4; deepseek smoke, E 8 with a shared
    expert) and ``_fwd_tp`` (3 experts) at tp 2 against ``_fwd_local`` on
    the same tokens; ``MoE.fwd`` takes the same path."""
    for res in _case(ranks, name):
        assert res["fwd_equal"]
        torch.testing.assert_close(res["y"], res["y_local"], rtol=2e-5,
                                   atol=2e-5)
        for k in ("moe_lb_loss", "moe_z_loss"):
            torch.testing.assert_close(res["aux"][k], res["aux_local"][k],
                                       rtol=1e-5, atol=0)
        assert float(res["aux"]["moe_drop_frac"]) == 0.0
        assert float(res["aux_local"]["moe_drop_frac"]) == 0.0


#: name -> (relative bound on the losses, on the gradient norms, on each
#: parameter's distance from the one-device step's, over the parameter's
#: norm); measured maxima in the module docstring
_TRAIN_TOL = {"train_qwen_2x1": (1e-5, 1e-5, 1e-4),
              "train_mixtral_2x1": (1e-5, 1e-5, 1e-4),
              "train_mixtral_1x2": (1e-5, 1e-5, 1e-4),
              "train_qwen_2x1_cast": (1e-4, 1e-3, 1e-2),
              "train_mixtral_1x2_cast": (1e-4, 1e-3, 1e-2)}


@pytest.mark.parametrize("name", list(_TRAIN_TOL))
def test_sharded_train_two_ranks_match_one_device(ranks, name):
    """Three sharded steps on a (2, 1) mesh (qwen and mixtral smoke: the
    batch split over data, FSDP; mixtral's aux terms averaged over the
    data shards) and a (1, 2) mesh (mixtral smoke: TP placement and
    MoE's expert parallelism) against three single-device steps on the
    global batches: losses, gradient norms and final parameters, with
    the train step's bf16 cast of the matrices off and on."""
    rel_loss, rel_gnorm, rel_param = _TRAIN_TOL[name]
    res = _case(ranks, name)
    want = res[0]
    for r in res:
        for got_m, want_m in zip(r["metrics"], want["bare_metrics"]):
            for k, rel in (("loss", rel_loss), ("ce", rel_loss),
                           ("moe_lb_loss", rel_loss),
                           ("grad_norm", rel_gnorm)):
                assert got_m[k] == pytest.approx(want_m[k], rel=rel,
                                                 abs=1e-7), k
        for k, w in want["bare_params"].items():
            err = float((r["params"][k] - w).norm())
            assert err <= rel_param * float(w.norm()), (k, err)


def _no_model_weight_gather(calls, weight_shapes):
    """No all-gather over ``model`` gives a weight's gathered shape."""
    bad = [c for c in calls if c[0] == "all-gather" and c[1] == "model"
           and c[2] in weight_shapes]
    assert not bad, bad


@pytest.mark.parametrize("name", [f"tp_{k}" for k in _tp_cases()])
def test_tp_forward_and_decode_over_cache_blocks_match_one_device(ranks,
                                                                  name):
    """Each config of ``_tp_cases`` on a (1, 2) ``model`` mesh, each rank
    holding its blocks of the weights and of the cache (``cache_specs``):
    the forward's logits and those of a prompt replay and greedy decode
    steps within 1e-5 of the one-device port's (relative to the logits'
    largest magnitude), with the same greedy tokens.  Over a slot block
    GQA merges the ranks' decode attention by its log-sum-exp and MLA
    runs the reference's partitioned softmax; a kv-head block decodes its
    heads; a head_dim block is gathered for the step.  No all-gather over
    ``model`` carries a weight."""
    cfg, slots, _, _, split = _tp_cases()[name[3:]]
    for res in _case(ranks, name):
        want = res["logits_1"]
        err = float((res["logits"] - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), err
        assert torch.equal(res["logits"].argmax(-1), want.argmax(-1))
        (lg, tok), (lg1, tok1) = res["decode"], res["decode_1"]
        assert torch.equal(tok, tok1)
        err = float((lg - lg1).abs().max())
        assert err <= 1e-5 * float(lg1.abs().max()), err
        block, whole = res["cache_block"], res["cache_whole"]
        assert [i for i, (b, w) in enumerate(zip(block, whole))
                if b != w] == [split]
        assert block[split] * _WORLD == whole[split]
        for calls in (res["forward_calls"], res["decode_calls"]):
            _no_model_weight_gather(calls, res["weight_shapes"])
        gathered = {c[2] for c in res["decode_calls"]
                    if c[:2] == ("all-gather", "model")}
        # the cache's k (and v) gathered only where head_dim is split, an
        # xLSTM state always (its recurrence runs whole), a Mamba state
        # never (each rank updates its channels)
        assert (whole in gathered) == (split == 3
                                       or name[3:] in _STATE_GATHERED)


def test_mixer_width_model_does_not_divide_gathers_whole(ranks):
    """jamba smoke at d_inner 63 on a (1, 2) mesh: ``model`` does not
    divide the Mamba width, so each Mamba mixer's weights are gathered
    whole for its layer and its state for a decode step, and it runs its
    one-device program; the logits of the forward and of 20 decode steps
    within 1e-5 of the one-device port's (the attention, MoE and MLP
    layers on their blocks), the same tokens."""
    for res in _case(ranks, "tp_jamba_odd"):
        want = res["logits_1"]
        err = float((res["logits"] - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), err
        (lg, tok), (lg1, tok1) = res["decode"], res["decode_1"]
        assert torch.equal(tok, tok1)
        err = float((lg - lg1).abs().max())
        assert err <= 1e-5 * float(lg1.abs().max()), err
        weights = {c[2] for c in res["forward_calls"]
                   if c[:2] == ("all-gather", "model")} & res["weight_shapes"]
        # w_in (63, 126) among them; no weight of another layer kind
        assert (63, 126) in weights and weights <= res["mamba_shapes"]


@pytest.mark.parametrize("groups", [2, 4])
def test_regroup_gives_each_rank_its_channels_of_every_group(ranks,
                                                            groups):
    """After the re-cut each rank holds the same channels of every group
    (Mamba's x and z): rank r's block of each group, the groups in order,
    along the last dim of a 2-D and a 3-D tensor, from one all-to-all."""
    for r, res in enumerate(_case(ranks, "regroup")):
        c = 16 // groups // _WORLD
        want = [float(g * 16 // groups + r * c + j) for g in range(groups)
                for j in range(c)]
        for shape in ((3, 16), (2, 3, 16)):
            got, kinds = res["index"][(groups, shape)]
            assert got == want and kinds == ["all-to-all"], (shape, got)


def test_dense_groups_recut_output_or_weight(ranks):
    """``tp_dense_groups`` on jamba smoke's ``w_in`` (64, 256) split over
    two ranks: a 2-row input re-cuts the output (128 x 2 values a rank),
    a 96-row input the weight's block (128 x 64), one all-to-all either
    way, and each rank gets its 64 channels of x and of z of the whole
    product (within 1e-5)."""
    for res in _case(ranks, "regroup"):
        # the moved tensor's shape, the grouped dim leading
        for rows, moved in ((2, (128, 1, 2)), (96, (128, 64))):
            err, blk, shape, calls = res["dense"][rows]
            assert err <= 1e-5 and blk and shape == (1, rows, 128), rows
            assert calls == [("all-to-all", moved)], (rows, calls)


@pytest.mark.parametrize("name", list(_GRAD_CASES))
def test_sharded_grads_match_one_device(ranks, name):
    """The sharded step's gradients (the per-layer gather hook, no whole
    tree gathered) on a (1, 2) mesh (qwen smoke; deepseek smoke with
    MLA's heads, the MoE experts re-cut from their ``d`` blocks to
    expert blocks by an all-to-all) and a (2, 1) mesh (qwen smoke: FSDP,
    one layer's data blocks gathered at a time), bf16 cast off, against
    the one-device gradients of the global batch: the ranks' mean loss
    within 1e-6 relative, each leaf's gradient within ``_GRAD_TOL`` of
    its norm.  No all-gather over ``model`` carries a weight; on the
    data mesh every all-gather over ``data`` gives a weight's
    model-whole shape (one group at a time: the hook's)."""
    res = _case(ranks, name)
    loss = sum(r["loss"] for r in res) / len(res)
    assert loss == pytest.approx(res[0]["loss_1"], rel=1e-6)
    tol = _GRAD_TOL_CASE.get(name, _GRAD_TOL[_GRAD_CASES[name][2]])
    for r in res:
        for k, want in r["grads_1"].items():
            err = float((r["grads"][k] - want).norm())
            assert err <= tol * float(want.norm()), (k, err,
                                                     float(want.norm()))
        _no_model_weight_gather(r["calls"], r["weight_shapes"])
        if name.endswith("2x1"):
            data = [c for c in r["calls"] if c[1] == "data"
                    and c[0] == "all-gather"]
            assert data and all(c[2] in r["weight_shapes"] for c in data)


def test_backward_on_another_thread_recomputes_on_the_mesh(ranks):
    """qwen smoke's loss on a (1, 2) mesh, its backward run on another
    thread (where autograd runs a CUDA tensor's backward, and where no
    activation axes are bound): each layer's checkpoint recomputes on
    the mesh, and the gradients are those of a backward on this thread,
    bit for bit."""
    for res in _case(ranks, "thread_qwen_1x2"):
        assert "thread" in res, "the backward on another thread failed"
        for a, b in zip(res["here"], res["thread"]):
            assert torch.equal(a, b)
