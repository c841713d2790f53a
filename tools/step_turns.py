#!/usr/bin/env python3
"""A full-width ``decode_step`` on the card (qwen1.5-0.5b by default),
this tree's port against an earlier commit's, step by step in one
process.

    git archive <commit> | (mkdir -p build/parent && tar -x -C build/parent)
    python3 tools/step_turns.py --parent build/parent
    python3 tools/step_turns.py --parent build/parent \
        --arch jamba-v0.1-52b --layers 8

The earlier tree's ``src/repro_torch`` is imported under another name
(``repro_torch_parent``, through a symlink under ``<parent>/build``),
with its own kernel library built from its own sources.  Each tree draws
its bf16 weights on the card from seed 0 and decodes greedily at B 1 on
a 512-slot cache of its own.  After 16 warm steps each, the two trees'
steps alternate (earlier then this, then this then earlier, ...), each
step timed on the host clock around work that ends in a synchronise, for
640 pairs: a pair's two steps see the same state of the host, so
the median of the pairs' differences resolves what the host's own drift
hides between processes.  The decode step is host-bound, so this
measures the host work a tree's Python adds a step.  Also printed: the
operators one step of each tree dispatches, and its calls into
``dist/`` (the placement lookups).  Exits 1 where ``torch.cuda.is_available()`` is false.
"""

from __future__ import annotations

import argparse
import collections
import importlib
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from turns import HERE, port_as

PAIRS = 640


def _dist_calls(fn) -> dict[str, int]:
    """The calls ``fn()`` makes into functions of a ``dist/`` module."""
    calls: collections.Counter = collections.Counter()

    def prof(frame, event, arg):
        code = frame.f_code
        if event == "call" and "/dist/" in code.co_filename:
            calls[f"{Path(code.co_filename).name}:{code.co_name}"] += 1

    sys.setprofile(prof)
    try:
        fn()
    finally:
        sys.setprofile(None)
    return dict(calls)


def _ops(fn) -> int:
    """The operators ``fn()`` dispatches (``torch.profiler``'s host
    events): the launches a step asks of the card."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return len(prof.events())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="an unpacked tree of the earlier commit")
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("step_turns: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"[turns] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
          f"{args.arch}, {args.layers or 'all'} layers")
    sides = {}
    for side, tree, name in (("earlier", args.parent.resolve(),
                              "repro_torch_parent"),
                             ("this", HERE, "repro_torch")):
        port_as(tree, name)
        T = importlib.import_module(name + ".models.transformer")
        cfg = importlib.import_module(name + ".configs").get_config(
            args.arch, "full")
        if args.layers:
            cfg = cfg.replace(n_layers=args.layers)
        st = {"T": T, "cfg": cfg,
              "p": T.init(cfg, seed=0, device="cuda", draw_device="cuda"),
              "cache": T.init_cache(cfg, 1, 512, device="cuda"),
              "tok": torch.zeros(1, dtype=torch.long, device="cuda"),
              "pos": 0, "ms": []}
        sides[side] = st

    def step(st):
        st["tok"] = st["T"].decode_step(st["p"], st["cfg"], st["tok"],
                                        st["cache"], st["pos"] % 512
                                        )[0].argmax(-1)
        st["pos"] += 1

    with torch.no_grad():
        for st in sides.values():
            for _ in range(16):
                step(st)
        for side, st in sides.items():
            calls = _dist_calls(lambda: step(st))
            print(f"[turns] {side}: one decode_step dispatches "
                  f"{_ops(lambda: step(st))} operators and calls into "
                  f"dist/ {sum(calls.values())} times {calls}")
        order = list(sides.values())
        for i in range(PAIRS):
            for st in (order if i % 2 == 0 else order[::-1]):
                torch.cuda.synchronize()
                t = time.perf_counter()
                step(st)
                torch.cuda.synchronize()
                st["ms"].append((time.perf_counter() - t) * 1e3)
    e, n = sides["earlier"]["ms"], sides["this"]["ms"]
    diff = sorted(b - a for a, b in zip(e, n))
    q = statistics.quantiles(diff, n=4)
    me, mn, md = (statistics.median(e), statistics.median(n),
                  statistics.median(diff))
    print(f"[turns] {PAIRS} pairs: median ms per decode_step, earlier "
          f"{me:.4f}, this {mn:.4f}; quartiles earlier "
          f"{[round(v, 4) for v in statistics.quantiles(e, n=4)]}, this "
          f"{[round(v, 4) for v in statistics.quantiles(n, n=4)]}")
    print(f"[turns] this minus earlier, paired: median {md:+.4f} ms "
          f"({md / me * 100:+.2f}% of the earlier median), quartiles "
          f"{q[0]:+.4f} / {q[2]:+.4f} ms; this slower in "
          f"{sum(d > 0 for d in diff)} of {len(diff)} pairs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
