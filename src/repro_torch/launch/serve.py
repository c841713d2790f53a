"""Serving entry point: seeded weights, batched requests through the
symbiotic engine, generations + scheduling stats.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
      --variant full --requests 8 --policy symbiotic

Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import arch_names, get_config
from ..models import transformer as T
from ..serve import Request, SchedulerPolicy, ServingEngine

__all__ = ["main", "serve"]


def serve(arch: str, *, variant: str = "smoke", n_requests: int = 8,
          policy: str = "symbiotic", max_len: int = 96,
          max_new_tokens: int = 8, seed: int = 0,
          device="cuda") -> dict:
    """Serve ``n_requests`` seeded random prompts; the stats of
    :meth:`ServingEngine.run` plus ``wall_s`` (synchronised on a CUDA
    device) and ``prompt_tokens``."""
    cfg = get_config(arch, variant)
    if not cfg.causal:
        raise SystemExit(f"{arch} is encoder-only: no autoregressive "
                         "serving (use the forward path)")
    params = T.init(cfg, seed=seed, device=device)
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n_requests):
        plen = int(rng.integers(4, max(5, max_len // 4)))
        reqs.append(Request(i, rng.integers(0, cfg.vocab, size=plen),
                            max_new_tokens=max_new_tokens))
    eng = ServingEngine(cfg, params, max_len=max_len,
                        policy=SchedulerPolicy(kind=policy))
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
                    choices=["fifo", "symbiotic"])
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    stats = serve(args.arch, variant=args.variant,
                  n_requests=args.requests, policy=args.policy,
                  max_len=args.max_len,
                  max_new_tokens=args.max_new_tokens, device=args.device)
    print(f"policy={args.policy} rounds={stats['rounds']} "
          f"new_tokens={stats['total_new_tokens']} "
          f"modelled={stats['modelled_time_s'] * 1e3:.2f}ms "
          f"wall={stats['wall_s']:.1f}s")
    for rid, toks in sorted(stats["outputs"].items())[:4]:
        print(f"  req {rid}: {toks[:10]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
