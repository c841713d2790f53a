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
"""

import os
import time
import traceback

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

_WORLD = 2
_TIMEOUT_S = 120


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


def _rank_main(rank: int, store: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=_WORLD)
    out = {}
    for run in (_run_moe, _run_train):
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
        for run in ("_run_moe", "_run_train"):
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
