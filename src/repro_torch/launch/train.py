"""Training entry point (the port of the reference's
``repro.launch.train``): seeded f32 master weights, the synthetic data
pipeline and the fault-tolerant loop (auto-resume, async checkpoints,
NaN guard) around the sharded train step
(:mod:`repro_torch.train.sharded`), on a mesh: ``--mesh host`` is the
1 x 1 mesh of one device, ``single`` and ``multi`` the 16 x 16 and
2 x 16 x 16 production meshes, which need 256 and 512 ranks:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --variant full --steps 20 --batch 8 --seq 1024
  PYTHONPATH=src torchrun --nnodes 32 --nproc-per-node 8 ... \
      -m repro_torch.launch.train --mesh single --variant full

Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..configs import arch_names, get_config
from ..data import DataConfig, SyntheticLM
from ..optim import AdamWConfig
from ..train import LoopConfig, TrainLoop, init_train_state
from ..train.sharded import (make_sharded_train_step, shard_train_state,
                             train_state_shardings)
from .mesh import make_host_mesh, make_production_mesh

__all__ = ["main", "train"]


def train(arch: str, *, variant: str = "smoke", steps: int = 100,
          global_batch: int = 8, seq_len: int = 128, accum: int = 1,
          lr: float = 3e-4, ckpt_dir: str | None = None,
          ckpt_every: int = 50, mesh_kind: str = "host",
          log_fn=None, device="cuda") -> dict:
    """Train ``arch`` for ``steps`` steps (resuming from ``ckpt_dir``'s
    latest checkpoint; by default ``LoopConfig``'s, under the temporary
    directory) -> {"losses", "seconds", "first_loss", "last_loss"}, as
    the reference's ``train``; ``seconds`` is synchronised on a CUDA
    device.  ``mesh_kind``: "host" (one device), "single" or "multi"
    (the production meshes; they raise unless the job has their 256 or
    512 ranks)."""
    if mesh_kind == "host":
        mesh = make_host_mesh(device)
    elif mesh_kind in ("single", "multi"):
        mesh = make_production_mesh(multi_pod=mesh_kind == "multi",
                                    device=device)
    else:
        raise ValueError(f"unknown mesh_kind {mesh_kind!r}")
    if torch.device(device).type == "cuda":
        # this rank's card (make_production_mesh set it from LOCAL_RANK)
        device = torch.device("cuda", torch.cuda.current_device())
    cfg = get_config(arch, variant)
    params, opt_state = init_train_state(cfg, seed=0, device=device)
    shardings = train_state_shardings(params, mesh)
    params, opt_state = shard_train_state(params, opt_state, mesh)
    opt = AdamWConfig(lr=lr, warmup_steps=max(steps // 20, 5),
                      total_steps=steps)
    step = make_sharded_train_step(cfg, opt, mesh, accum=accum)
    data = SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=seq_len, global_batch=global_batch))

    def log(s, m):
        if log_fn:
            log_fn(s, m)
        else:
            print(f"step {s:5d} loss {float(m['loss']):.4f} "
                  f"gnorm {float(m['grad_norm']):.3f}", flush=True)

    loop = TrainLoop(
        step_fn=step, data=data,
        cfg=LoopConfig(total_steps=steps, ckpt_every=ckpt_every,
                       ckpt_dir=ckpt_dir or LoopConfig().ckpt_dir,
                       log_every=10),
        log_fn=log, shardings=shardings)
    params, opt_state, start = loop.resume_or_init(params, opt_state)
    dev = torch.device(device)
    t0 = time.perf_counter()
    params, opt_state, losses = loop.run(params, opt_state, start)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    return {"losses": losses, "seconds": dt,
            "first_loss": losses[0] if losses else None,
            "last_loss": losses[-1] if losses else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=arch_names())
    ap.add_argument("--variant", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default="host",
                    choices=["host", "single", "multi"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = train(args.arch, variant=args.variant, steps=args.steps,
                global_batch=args.batch, seq_len=args.seq,
                accum=args.accum, lr=args.lr, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, mesh_kind=args.mesh,
                device=args.device)
    if not out["losses"]:
        print(f"done: the checkpoint is already at step >= {args.steps}; "
              "no step run")
        return 0
    print(f"done: loss {out['first_loss']:.4f} -> {out['last_loss']:.4f} "
          f"in {out['seconds']:.1f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
