#!/usr/bin/env python3
"""Times the RMSNorm kernel and its call path in turns with an earlier
commit's, on one GPU.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 tools/rmsnorm_turns.py --parent build/parent [--out PATH]

The earlier tree's ``src/repro_torch`` is imported as
``repro_torch_parent`` (``turns.port_as``) and builds its kernels from its
own sources; each tree is called through its own wrappers
(``kernels.rmsnorm.rmsnorm_rows`` and ``kernels.ops.rmsnorm``).

Measured, every pair in the order this, earlier, earlier, this:

1. each kernel's max abs error against this tree's
   ``rmsnorm_rows_plain`` at every width the configs normalise (512, 768,
   1024, 1536, 4096, 5120, 6144) at 1, 8 and 4,096 rows, bf16 and f32,
   and whether two calls give the same bits; this tree's plan at each;
2. the device µs per launch at ``chip_smoke.py`` §4's six shapes (bf16:
   1 x 1024, 32,768 x 1024, 32,768 x 4096, 4,096 x 512, 1536 and 5120),
   from CUDA events around the replay of a CUDA graph of 50 calls that
   rotate over inputs spanning twice the L2 (one row is L2-resident all
   the same), beside ``F.rms_norm``'s and the bytes bound; the blocks an
   SM holds of each launch;
3. the call at the decode step's row, x (1, 1024) bf16: CUDA-event ms per
   call of ``rmsnorm_rows`` and of ``ops.rmsnorm`` on (1, 1, 1024) (the
   model's call) through each tree's wrappers, and ``F.rms_norm``'s
   (median of 5 repeats of 200 calls); then where a call's host time
   goes, piece by piece (host clock over 4,000 calls each, then a
   synchronise): each tree's whole call, its C entry point alone with
   its arguments made, ``torch.empty_like``, the stream lookup (the raw
   current stream here, ``torch.cuda.current_stream().cuda_stream``
   earlier), the grad-mode test, the earlier tree's ``_check``; what is
   left of this tree's call is its checks and Python;
4. full-width qwen1.5-0.5b ``decode_step`` (bf16, weights drawn on the
   card from seed 0, B 1, a 512-slot cache) with ``ops.rmsnorm`` pointed
   at each tree's, the two alternating step by step after 16 warm steps
   (earlier then this, then this then earlier, ...), each step on the
   host clock around work that ends in a synchronise, for 320 pairs: the
   median of the pairs' differences.

Prints one JSON object as its last line; ``--out`` also writes it.
Exits 1 where ``torch.cuda.is_available()`` is false.
"""

from __future__ import annotations

import argparse
import importlib
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from turns import (HERE, graph_us, nvidia_smi, port_as, ptxas_report,
                   time_ms)

HBM_BPS = 3.35e12
WIDTHS = (512, 768, 1024, 1536, 4096, 5120, 6144)
#: chip_smoke.py §4's device shapes (rows, D), bf16
SHAPES = ((1, 1024), (32768, 1024), (32768, 4096), (4096, 512),
          (4096, 1536), (4096, 5120))
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
PAIRS = 320
N_HOST = 4000


def host_us(fn, n: int = N_HOST) -> float:
    """Host µs per call over ``n`` calls, the card synchronised at the
    end (the kernels queued here take less device time than their
    calls take host time)."""
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="an unpacked tree of the earlier commit")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rmsnorm_turns: no CUDA device", file=sys.stderr)
        return 1
    smi = nvidia_smi()
    print(f"[turns] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    t0 = time.perf_counter()
    trees = {"this": port_as(HERE, "repro_torch"),
             "earlier": port_as(args.parent.resolve(), "repro_torch_parent")}
    print(f"[turns] kernels built in {time.perf_counter() - t0:.1f} s")
    mods = {side: importlib.import_module(pkg.__name__ + ".kernels.rmsnorm")
            for side, pkg in trees.items()}
    ops = {side: importlib.import_module(pkg.__name__ + ".kernels.ops")
           for side, pkg in trees.items()}
    build = {side: importlib.import_module(pkg.__name__ + ".kernels.build")
             for side, pkg in trees.items()}
    RN = mods["this"]
    plain = RN.rmsnorm_rows_plain
    rows_fn = {side: m.rmsnorm_rows for side, m in mods.items()}
    order = ("this", "earlier", "earlier", "this")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size",
                 50 << 20)
    gen = torch.Generator().manual_seed(0)
    lib = build["this"].library()
    rep: dict = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                 "ptxas": {side: ptxas_report(
                     (b.build_dir() / "build.log").read_text(),
                     "rmsnorm") for side, b in build.items()},
                 "errors": {}, "device_us": {}, "call": {}}
    for side, kernels in rep["ptxas"].items():
        for name, r in kernels.items():
            print(f"[turns] ptxas {side} {name[:60]}: {r}")

    def randn(*shape, dtype=torch.bfloat16, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen) * scale + shift).to(
            dev, dtype)

    # 1. errors and bits at every config width
    for D in WIDTHS:
        for R in (1, 8, 4096):
            for dt in (torch.bfloat16, torch.float32):
                x, s = randn(R, D, dtype=dt), randn(D, dtype=torch.float32,
                                                   scale=0.1, shift=1.0)
                want = plain(x, s).float()
                row = {"plan": RN.rmsnorm_plan(R, D, dt, sms)._asdict()}
                for side, fn in rows_fn.items():
                    a, b = fn(x, s), fn(x, s)
                    row[side] = {"max_abs_err": (a.float() - want).abs()
                                 .max().item(),
                                 "same_bits_twice": bool(torch.equal(a, b))}
                    if row[side]["max_abs_err"] > TOL[dt]:
                        raise SystemExit(f"{side} ({R}, {D}) {dt}: error "
                                         f"{row[side]['max_abs_err']}")
                rep["errors"][f"{R}x{D}_{str(dt)[6:]}"] = row
        print(f"[turns] D {D}: " + "; ".join(
            f"{k.split('_')[0]} {k.split('_')[1]} this "
            f"{v['this']['max_abs_err']:.3e} earlier "
            f"{v['earlier']['max_abs_err']:.3e} plan "
            f"{tuple(v['plan'].values())}"
            for k, v in rep["errors"].items() if f"x{D}_" in k))

    # 2. device µs at the six shapes, in turns, beside F.rms_norm
    for R, D in SHAPES:
        n_in = min(50, -(-2 * l2 // (R * D * 2)))
        xs = [(randn(R, D),) for _ in range(n_in)]
        s = randn(D, dtype=torch.float32, scale=0.1, shift=1.0)
        s_lib = s.to(torch.bfloat16)
        plan = RN.rmsnorm_plan(R, D, torch.bfloat16, sms)
        occ = lib.repro_rmsnorm_blocks_per_sm(1, plan.vecs, plan.lanes,
                                              plan.rows_per_block)
        turns = {"this": [], "earlier": []}
        for side in order:
            turns[side].append(graph_us(lambda xr: rows_fn[side](xr, s), xs))
        lib_us = graph_us(lambda xr: F.rms_norm(xr, (D,), s_lib, 1e-6), xs)
        bound_us = (R * D * 2 * 2 + D * 4) / HBM_BPS * 1e6
        r = {"us": {k: float(np.mean(v)) for k, v in turns.items()},
             "turns_us": turns, "f_rms_norm_us": lib_us,
             "bound_us": bound_us, "bound_by": "bytes",
             "inputs_rotated": n_in, "rotation_bytes": n_in * R * D * 2,
             "plan": plan._asdict(), "blocks_per_sm": occ}
        r["share_of_bound"] = {k: bound_us / v for k, v in r["us"].items()}
        rep["device_us"][f"{R}x{D}"] = r
        print(f"[turns] ({R}, {D}) bf16 device: this {r['us']['this']:.3f} "
              f"us ({r['share_of_bound']['this']:.1%} of the bound), "
              f"earlier {r['us']['earlier']:.3f} us "
              f"({r['share_of_bound']['earlier']:.1%}), F.rms_norm "
              f"{lib_us:.3f} us, bound {bound_us:.3f} us; turns "
              f"{ {k: [round(t, 3) for t in v] for k, v in turns.items()} }; "
              f"plan {tuple(plan)}, {occ} blocks an SM")
        del xs
        torch.cuda.empty_cache()

    # 3. the call at (1, 1024) bf16, and its host time piece by piece
    x, s = randn(1, 1024), randn(1024, dtype=torch.float32, scale=0.1,
                                   shift=1.0)
    x3, s_lib = x.view(1, 1, 1024), s.to(torch.bfloat16)
    call = {"rows": {"this": [], "earlier": []},
            "ops": {"this": [], "earlier": []}}
    for side in order:
        call["rows"][side].append(time_ms(lambda: rows_fn[side](x, s),
                                          n=200, warm=20))
        call["ops"][side].append(time_ms(lambda: ops[side].rmsnorm(x3, s),
                                         n=200, warm=20))
    f_ms = time_ms(lambda: F.rms_norm(x, (1024,), s_lib, 1e-6), n=200,
                   warm=20)
    rep["call"] = {k: {"ms": {side: float(np.mean(v))
                               for side, v in t.items()}, "turns_ms": t}
                   for k, t in call.items()}
    rep["call"]["f_rms_norm_ms"] = f_ms
    y = torch.empty_like(x)
    launch = RN._LAUNCHES[(x.shape, x.dtype, 0, 1e-6)]
    raw = torch._C._cuda_getCurrentRawStream
    old = mods["earlier"]
    old_lib = build["earlier"].library()
    xp, sp, yp = x.data_ptr(), s.data_ptr(), y.data_ptr()
    pieces = {
        "this: rmsnorm_rows": lambda: rows_fn["this"](x, s),
        "this: ops.rmsnorm (1, 1, 1024)": lambda: ops["this"].rmsnorm(x3, s),
        "this: C entry point alone": lambda: launch[0](
            xp, sp, yp, launch[1], raw(0)),
        "this: raw current stream": lambda: raw(0),
        "earlier: rmsnorm_rows": lambda: rows_fn["earlier"](x, s),
        "earlier: ops.rmsnorm (1, 1, 1024)": lambda: ops["earlier"].rmsnorm(
            x3, s),
        "earlier: C entry point alone": lambda: old_lib.repro_rmsnorm(
            xp, sp, yp, 1, 1024, 1e-6, 1, raw(0)),
        "earlier: _check": lambda: old._check(x, s),
        "earlier: current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream,
        "torch.empty_like": lambda: torch.empty_like(x),
        "grad-mode test": lambda: torch.is_grad_enabled() and (
            x.requires_grad or s.requires_grad),
        "F.rms_norm": lambda: F.rms_norm(x, (1024,), s_lib, 1e-6),
    }
    host = {k: [] for k in pieces}
    for _ in range(2):
        for k, fn in pieces.items():
            host[k].append(host_us(fn))
    host = {k: float(np.mean(v)) for k, v in host.items()}
    host["this: checks and Python (the rest)"] = (
        host["this: rmsnorm_rows"] - host["this: C entry point alone"]
        - host["torch.empty_like"] - host["grad-mode test"])
    rep["call"]["host_us"] = host
    print(f"[turns] call (1, 1024) bf16, ms (CUDA events, 200 calls): "
          + "; ".join(f"{k} " + ", ".join(
              f"{side} {v:.5f}" for side, v in t["ms"].items())
              for k, t in rep["call"].items() if k in ("rows", "ops"))
          + f"; F.rms_norm {f_ms:.5f}")
    for k, v in host.items():
        print(f"[turns]   host {k}: {v:.3f} us")

    # 4. qwen's decode step with each tree's RMSNorm, paired
    T = importlib.import_module("repro_torch.models.transformer")
    cfg = importlib.import_module("repro_torch.configs").get_config(
        "qwen1.5-0.5b", "full")
    params = T.init(cfg, seed=0, device=dev, draw_device="cuda")
    this_op = ops["this"].rmsnorm
    norms = {"earlier": ops["earlier"].rmsnorm, "this": this_op}
    st = {side: {"cache": T.init_cache(cfg, 1, 512, device=dev),
                 "tok": torch.zeros(1, dtype=torch.long, device=dev),
                 "pos": 0, "ms": []} for side in norms}

    def step(side):
        ops["this"].rmsnorm = norms[side]
        s_ = st[side]
        s_["tok"] = T.decode_step(params, cfg, s_["tok"], s_["cache"],
                                  s_["pos"] % 512)[0].argmax(-1)
        s_["pos"] += 1

    launches = {side: mods[side].rmsnorm_rows.launches for side in mods}
    try:
        with torch.no_grad():
            for side in norms:
                for _ in range(16):
                    step(side)
            for i in range(PAIRS):
                for side in (("earlier", "this") if i % 2 == 0
                             else ("this", "earlier")):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    step(side)
                    torch.cuda.synchronize()
                    st[side]["ms"].append((time.perf_counter() - t) * 1e3)
    finally:
        ops["this"].rmsnorm = this_op
    per_step = {side: (mods[side].rmsnorm_rows.launches - launches[side])
                / (PAIRS + 16) for side in mods}
    e, n = st["earlier"]["ms"], st["this"]["ms"]
    diff = sorted(b - a for a, b in zip(e, n))
    q = statistics.quantiles(diff, n=4)
    rep["decode_step"] = {
        "pairs": PAIRS, "median_ms": {"earlier": statistics.median(e),
                                      "this": statistics.median(n)},
        "quartiles_ms": {"earlier": statistics.quantiles(e, n=4),
                         "this": statistics.quantiles(n, n=4)},
        "paired_diff_median_ms": statistics.median(diff),
        "paired_diff_quartiles_ms": [q[0], q[2]],
        "this_slower_pairs": sum(d > 0 for d in diff),
        "rmsnorm_launches_per_step": per_step}
    d = rep["decode_step"]
    print(f"[turns] qwen decode_step, {PAIRS} pairs: median earlier "
          f"{d['median_ms']['earlier']:.4f} ms, this "
          f"{d['median_ms']['this']:.4f} ms; this minus earlier, paired: "
          f"median {d['paired_diff_median_ms']:+.4f} ms, quartiles "
          f"{q[0]:+.4f} / {q[2]:+.4f}; this slower in "
          f"{d['this_slower_pairs']} of {PAIRS}; RMSNorm launches a step "
          f"{per_step}")
    line = json.dumps(rep)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
