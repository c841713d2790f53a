"""Serving entry point: seeded weights, batched requests through the
symbiotic engine, generations + scheduling stats.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
      --variant full --requests 8 --policy symbiotic [--respect-deps]

Runs on ``cuda`` unless ``--device cpu`` is given.  ``--respect-deps``
composes over the per-layer dependency graph
(``SchedulerPolicy.respect_deps``); the tokens are the same.
``--ckpt-dir`` serves the parameters of the latest checkpoint there
(as ``repro_torch.launch.train`` writes them) in place of the seeded
ones.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import arch_names, get_config
from ..models import transformer as T
from ..serve import Request, SchedulerPolicy, ServingEngine
from ..train.checkpoint import latest_step, restore_checkpoint

__all__ = ["main", "serve"]


def serve(arch: str, *, variant: str = "smoke", n_requests: int = 8,
          policy: str = "symbiotic", max_len: int = 96,
          max_new_tokens: int = 8, ckpt_dir: str | None = None,
          seed: int = 0, device="cuda", **policy_kw) -> dict:
    """Serve ``n_requests`` seeded random prompts with the
    :class:`SchedulerPolicy` of kind ``policy`` (``policy_kw`` sets its
    other fields, such as ``refine_model``); the stats of
    :meth:`ServingEngine.run` plus ``wall_s`` (synchronised on a CUDA
    device) and ``prompt_tokens``.  With a checkpoint in ``ckpt_dir``
    its parameters are served, each cast to the serving tree's dtype."""
    cfg = get_config(arch, variant)
    if not cfg.causal:
        raise SystemExit(f"{arch} is encoder-only: no autoregressive "
                         "serving (use the forward path)")
    params = T.init(cfg, seed=seed, device=device)
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        tree, _ = restore_checkpoint(ckpt_dir, {"params": params,
                                                "opt": None})
        params = tree["params"]
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n_requests):
        plen = int(rng.integers(4, max(5, max_len // 4)))
        reqs.append(Request(i, rng.integers(0, cfg.vocab, size=plen),
                            max_new_tokens=max_new_tokens))
    eng = ServingEngine(cfg, params, max_len=max_len,
                        policy=SchedulerPolicy(kind=policy, **policy_kw))
    eng.submit(reqs)
    t0 = time.perf_counter()
    stats = eng.run()
    if eng.exec_device.type == "cuda":
        torch.cuda.synchronize(eng.exec_device)
    stats["wall_s"] = time.perf_counter() - t0
    stats["prompt_tokens"] = sum(len(r.prompt) for r in reqs)
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=arch_names())
    ap.add_argument("--variant", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--policy", default="symbiotic",
                    choices=["fifo", "symbiotic", "refined"])
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--respect-deps", action="store_true")
    args = ap.parse_args(argv)
    stats = serve(args.arch, variant=args.variant,
                  n_requests=args.requests, policy=args.policy,
                  max_len=args.max_len,
                  max_new_tokens=args.max_new_tokens,
                  ckpt_dir=args.ckpt_dir, device=args.device,
                  respect_deps=args.respect_deps)
    print(f"policy={args.policy} respect_deps={args.respect_deps} "
          f"rounds={stats['rounds']} "
          f"new_tokens={stats['total_new_tokens']} "
          f"modelled={stats['modelled_time_s'] * 1e3:.2f}ms "
          f"wall={stats['wall_s']:.1f}s")
    for rid, toks in sorted(stats["outputs"].items())[:4]:
        print(f"  req {rid}: {toks[:10]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
