#!/usr/bin/env python3
"""How far the sharded step's gradients sit from one device's, beside
f32's own rounding: each leaf's error over the leaf's norm.

    PYTHONPATH=src python tools/tp_grad_errors.py

Two gloo ranks on the CPU (spawned processes, a ``file://`` store under
a temporary directory) run ``train.sharded.sharded_grads`` on a (1, 2)
``model`` mesh (qwen, deepseek, jamba and xlstm smoke, tensor
parallelism) and a
(2, 1) data mesh (qwen smoke, per-layer FSDP), the bf16 cast off, on
the 4 x 40-token batch of ``tests/test_torch_dist_ranks.py``; rank 0
also takes the one-device f32 gradient and the f64 one of the same
weights.  Prints the largest relative error of each against the
one-device f32 gradient, and of that against f64 (~1 min).
"""

from __future__ import annotations

import os
import sys
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

CASES = {"qwen 1x2": ("qwen1.5-0.5b", (1, 2)),
         "deepseek 1x2": ("deepseek-v2-236b", (1, 2)),
         "jamba 1x2": ("jamba-v0.1-52b", (1, 2)),
         "xlstm 1x2": ("xlstm-125m", (1, 2)),
         "qwen 2x1": ("qwen1.5-0.5b", (2, 1))}


def _cfg(arch: str, dtype: str):
    from repro_torch.configs import get_config
    # capacity factor E / K for deepseek (at least that for jamba): no
    # token drops on either path
    return get_config(arch, "smoke").replace(dtype=dtype,
                                             capacity_factor=4.0)


def _worst(got, want) -> tuple[float, str]:
    return max((float((g.double() - w.double()).norm() / w.double().norm()),
                k) for (k, g), w in zip(got.items(), want.values()))


def _rank(rank: int, store: str, out: str) -> None:
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.dist.context import act_ctx
    from repro_torch.dist.sharding import (local_block, param_specs,
                                           placements, spec_leaves)
    from repro_torch.models import transformer as T
    from repro_torch.pytree import flatten, unflatten
    from repro_torch.train.sharded import (as_dtensors, sharded_grads,
                                           train_state_shardings)
    import repro_torch.train.step as PS
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    PS.cast_matmul_params = lambda p, dtype=None: p
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=2)
    batch = PS._to_device(SyntheticLM(DataConfig(
        vocab=512, seq_len=40, global_batch=4)).next_batch(), "cpu")
    lines = []
    for name, (arch, shape) in CASES.items():
        cfg = _cfg(arch, "float32")
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data",
                                                              "model"))
        p0 = T.init(cfg, seed=0, device="cpu", param_dtype=torch.float32)
        specs = spec_leaves(p0, param_specs(p0, mesh))
        blocks = unflatten(p0, [
            local_block(t, mesh, placements(mesh, s)).contiguous()
            for (_, t), s in zip(flatten(p0), specs)])
        n, i = mesh.size(0), mesh.get_local_rank(0)
        rows = {k: v.chunk(n, 0)[i] for k, v in batch.items()}
        with act_ctx(dp="data", tp="model", mesh=mesh):
            gl, _ = sharded_grads(cfg, mesh, specs, blocks, rows)
        got = {"/".join(map(str, k)): v.full_tensor() for k, v in flatten(
            as_dtensors(unflatten(p0, gl),
                        train_state_shardings(p0, mesh)["params"]))}
        if rank:
            continue
        g32, _ = PS.accumulate_grads(p0, cfg, batch)
        g32 = {"/".join(map(str, k)): v for k, v in flatten(g32)}
        err, leaf = _worst(got, g32)
        lines.append(f"{name}: sharded vs one device (f32) {err:.2e} "
                     f"({leaf})")
        if shape == (1, 2):
            # the same draws in f64 (the leaves kept f32 stay f32)
            cfg64 = _cfg(arch, "float64")
            g64, _ = PS.accumulate_grads(T.init(
                cfg64, seed=0, device="cpu", param_dtype=torch.float64),
                cfg64, batch)
            g64 = {"/".join(map(str, k)): v for k, v in flatten(g64)}
            err, leaf = _worst(g32, g64)
            lines.append(f"{arch} smoke: one device f32 vs f64 {err:.2e} "
                         f"({leaf})")
    if rank == 0:
        Path(out).write_text("\n".join(lines) + "\n")
    dist.barrier()
    dist.destroy_process_group()


def main() -> int:
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "errors.txt")
        mp.spawn(_rank, args=(os.path.join(d, "store"), out), nprocs=2)
        print(Path(out).read_text(), end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
