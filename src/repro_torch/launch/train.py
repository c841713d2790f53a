"""Training entry point (the port of the reference's
``repro.launch.train``): seeded f32 master weights, the synthetic data
pipeline and the fault-tolerant loop (auto-resume, async checkpoints,
NaN guard) around the train step, on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --variant full --steps 20 --batch 8 --seq 1024

Runs on ``cuda`` unless ``--device cpu`` is given.  ``--mesh host`` (one
device) is the only mesh until ``dist`` is ported (ROADMAP §1 item 5).
"""

from __future__ import annotations

import argparse
import time

import torch

from ..configs import arch_names, get_config
from ..data import DataConfig, SyntheticLM
from ..optim import AdamWConfig
from ..train import LoopConfig, TrainLoop, init_train_state, make_train_step

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
    device."""
    if mesh_kind in ("single", "multi"):
        raise NotImplementedError(
            f"mesh_kind={mesh_kind!r}: the production meshes wait for the "
            "port of dist (ROADMAP §1 item 5); use mesh_kind='host'")
    if mesh_kind != "host":
        raise ValueError(f"unknown mesh_kind {mesh_kind!r}")
    cfg = get_config(arch, variant)
    params, opt_state = init_train_state(cfg, seed=0, device=device)
    opt = AdamWConfig(lr=lr, warmup_steps=max(steps // 20, 5),
                      total_steps=steps)
    step = make_train_step(cfg, opt, accum=accum)
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
        log_fn=log)
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
