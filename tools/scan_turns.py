#!/usr/bin/env python3
"""Times the selective-scan kernel in turns with an earlier commit's, on
one GPU.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 tools/scan_turns.py --parent build/parent [--probe] [--out PATH]

Kernels, each called through its C entry point on the same inputs:

- ``this``: the checkout's (``repro_torch.kernels.mamba_scan``'s kernel,
  with :func:`scan_plan`'s plan);
- ``earlier``: the earlier tree's, built from its own sources by its own
  ``kernels/build.py`` into ``<parent>/build/kernels`` and called with the
  argument list that module declares (17 arguments without a plan, 22
  with one);
- with ``--probe``, copies of the checkout's ``csrc/mamba_scan.cu``,
  edited as ``VARIANTS`` says, built into ``build/variants`` three more
  times: one that also holds the plan of 2 states a thread, timed at
  the plans of 2, 4 and 8 states a thread; one without the exp and one
  without the staging after the first two chunks, at the library's plan.
  The ablations are wrong by design; their times say what the exps and
  the staging cost.

Measured, at jamba's B 1 and B 8 x T 4096 x Dc 8192 x S 16 in bf16 (x and
dt softplus-scaled as ``chip_smoke.py`` draws them), with B and C
contiguous and as the slices at columns 256 and 272 of a (B, T, 288)
projection, as ``Mamba.fwd`` passes them:

1. each kernel's max abs error against ``mamba_scan_plain`` and whether
   two calls give the same bits;
2. CUDA-event ms per call in the order this, earlier, earlier, this
   (median of 5 repeats of 20 calls each, the mean of the two turns; the
   probe's builds in one order and then the reverse one), the median
   device µs per launch of each from ``torch.profiler`` (10 launches), and
   the same with the 50 MB L2 flushed before each launch (a 256 MB write
   between calls); each scan kernel's registers and spills from the
   build's ``-Xptxas -v`` log;
   the bound (``chip_smoke.mamba_bound``: exps on the SFUs at 16 per SM
   per clock, 1.98 GHz) and each kernel's share of it;
3. the SM clock (``nvidia-smi --query-gpu=clocks.sm``, sampled every
   100 ms) over two seconds of back-to-back launches of each kernel;
4. jamba-v0.1-52b ``prefill_logits`` at full width, depth cut to one
   period of 8 layers (bf16, weights drawn on the card from seed 0), at
   B 1 and B 8 x S 4096, ``ops.mamba_scan`` pointed at each kernel in the
   order earlier, this, this, earlier: ms per call (median of 3 after a
   warm-up call), then a profiled call: device busy ms, the scan's median
   device µs per launch and share of it; the SM clock over the timed
   calls.

Prints one JSON object as its last line; ``--out`` also writes it.
Exits 1 where ``torch.cuda.is_available()`` is false.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from turns import (HERE, device_events, nvidia_smi, parent_library,
                   start_variants, time_ms, variant_entry)

#: jamba-v0.1-52b's scan: (T, Dc, S) and the dbc projection's width
#: (dt_rank 256 + 2 S), B at column 256 and C at 272
SCAN = (4096, 8192, 16)
DBC_WIDTH, B_COL = 288, 256
CODES = {torch.float32: 0, torch.bfloat16: 1}
#: ``--probe``'s builds of csrc/mamba_scan.cu, as edits of a copy: the
#: plan of 2 states a thread (8 lanes a channel at S 16), which the
#: library does not build, and two ablations, wrong by design: no exp
#: (ex2 of x is x) and no staging after the first two chunks (the scan
#: warps rerun their tiles)
PROBE_STATES = (2, 4, 8)
VARIANTS = {
    "probe": ((), [("  REPRO_SCAN_PLAN(8, 4)\n",
                    "  REPRO_SCAN_PLAN(8, 4)\n  REPRO_SCAN_PLAN(2, 8)\n")]),
    "no_exp": ((), [('  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : '
                     '"f"(x));\n', "  y = x;\n")]),
    "no_staging": ((), [("        convert(n * CHUNK, s);\n",
                         "        if (n < 2) convert(n * CHUNK, s);\n")]),
}


def caller(entry, states=None):
    """A scan through ``entry``: x, dt (B, T, Dc), bm, cm (B, T, S) views
    with a contiguous last axis, a (Dc, S), d (Dc,) f32; with
    ``scan_plan``'s plan, or the plan of ``states`` states a thread, where
    the argument list takes one."""
    from repro_torch.kernels.mamba_scan import _plan, scan_plan
    with_plan = len(entry.argtypes) == 22
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def run(x, dt, bm, cm, a, d):
        B, T, Dc = x.shape
        S = bm.shape[-1]
        y = torch.empty_like(x)
        args = [x.data_ptr(), dt.data_ptr(), bm.data_ptr(), cm.data_ptr(),
                a.data_ptr(), d.data_ptr(), y.data_ptr(), B, T, Dc, S,
                bm.stride(0), bm.stride(1), cm.stride(0), cm.stride(1),
                CODES[x.dtype]]
        if with_plan:
            p = (scan_plan(B, T, Dc, S, x.dtype, sms) if states is None
                 else _plan(states, B, T, Dc, S, x.dtype))
            args += [p.states, p.lanes, p.chunk, p.grid[0], p.smem]
        rc = entry(*args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"scan kernel launch failed: CUDA error {rc}")
        return y
    return run


def scan_us(events) -> tuple[float, int]:
    """The median device µs of the selective-scan launches in ``events``
    (a median, so that a launch the profiler clipped does not count), and
    the launches."""
    us = [t for name, t in events if "mamba_scan" in name]
    if not us:
        raise RuntimeError("the profile has no selective-scan launch")
    return float(np.median(us)), len(us)


def ptxas_report(build) -> dict:
    """Registers and spill bytes of each scan kernel, from the build's
    ``-Xptxas -v`` log."""
    log = (build.build_dir() / "build.log").read_text()
    out = {}
    for part in log.split("Compiling entry function '")[1:]:
        kernel = re.search(r"mamba_scan_kernelI(\w+?)Li(\d)ELi(\d)E", part)
        used = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores", part)
        if kernel and used:
            dtype = "bf16" if "bfloat16" in kernel.group(1) else "f32"
            out[f"{dtype}_K{kernel.group(2)}_L{kernel.group(3)}"] = {
                "registers": int(used.group(1)),
                "spill_store_bytes": int(spill.group(1)) if spill else None}
    return out


class SmClock:
    """``nvidia-smi``'s SM clock (MHz), sampled every 100 ms while the
    block runs: the samples' median, min and max, or the error."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        time.sleep(0.3)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            text, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            text, _ = self.proc.communicate()
        mhz = [float(v) for v in text.split() if v.replace(".", "").isdigit()]
        self.result = ({"median_mhz": float(np.median(mhz)),
                        "min_mhz": min(mhz), "max_mhz": max(mhz),
                        "samples": len(mhz)} if mhz else
                       {"not_measured": text.strip()[-200:]})
        return False


def scan_inputs(gen, dev, B: int, layout: str):
    """jamba's scan inputs in bf16 (``chip_smoke.scan_inputs``' recipe),
    B and C contiguous or slices of one (B, T, 288) projection."""
    T, Dc, S = SCAN

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    x = randn(B, T, Dc).to(torch.bfloat16)
    dt = (F.softplus(randn(B, T, Dc)) * 0.1).to(torch.bfloat16)
    if layout == "strided":
        dbc = randn(B, T, DBC_WIDTH).to(torch.bfloat16)
        bm, cm = dbc[..., B_COL:B_COL + S], dbc[..., B_COL + S:B_COL + 2 * S]
    else:
        bm, cm = (randn(B, T, S).to(torch.bfloat16) for _ in range(2))
    a = -torch.exp(randn(Dc, S) * 0.3)
    return x, dt, bm, cm, a, randn(Dc)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="an unpacked tree of the earlier commit")
    ap.add_argument("--probe", action="store_true",
                    help="also time the probe build's plans")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("scan_turns: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE / "src"))
    sys.path.insert(0, str(HERE))
    from chip_smoke import mamba_bound
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, mamba_scan_plain, ops
    from repro_torch.models import transformer as T

    smi = nvidia_smi()
    print(f"[turns] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    t0 = time.perf_counter()
    builds = (start_variants(build, "mamba_scan.cu", VARIANTS)
              if args.probe else {})
    this_lib = build.library()
    kernels = {"this": caller(this_lib.repro_mamba_scan),
               "earlier": caller(
                   parent_library(args.parent).repro_mamba_scan)}
    variants = {}
    argtypes = this_lib.repro_mamba_scan.argtypes
    for name, (proc, path) in builds.items():
        entry = variant_entry(proc, path, "repro_mamba_scan", argtypes)
        if name == "probe":
            variants.update({f"K{k}": caller(entry, k)
                             for k in PROBE_STATES})
        else:
            variants[name] = caller(entry)
    print(f"[turns] kernels built in {time.perf_counter() - t0:.1f} s")
    rep_ptxas = ptxas_report(build)
    print(f"[turns] scan kernels' registers and spills: {rep_ptxas}")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    rep: dict = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                 "ptxas": rep_ptxas, "kernel": {}, "clock_alone": {},
                 "prefill": {}}
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    for B in (1, 8):
        bound, by, terms = mamba_bound(B, *SCAN, torch.bfloat16)
        for layout in ("contiguous", "strided"):
            ins = scan_inputs(gen, dev, B, layout)
            want = mamba_scan_plain(*ins).float()
            err, same = {}, {}
            for name, fn in {**kernels, **variants}.items():
                y1, y2 = fn(*ins), fn(*ins)
                err[name] = (y1.float() - want).abs().max().item()
                same[name] = bool(torch.equal(y1, y2))
            del want, y1, y2
            turns = {name: [] for name in kernels}
            for name in ("this", "earlier", "earlier", "this"):
                turns[name].append(time_ms(lambda: kernels[name](*ins)))
            for name in [*variants, *reversed(variants)]:
                turns.setdefault(name, []).append(
                    time_ms(lambda: variants[name](*ins)))
            dev_us, cold_us = {}, {}
            for name, fn in {**kernels, **variants}.items():
                dev_us[name] = scan_us(device_events(lambda: fn(*ins),
                                                     10))[0]

                def cold(fn=fn):
                    flush.zero_()
                    fn(*ins)
                if name in kernels:
                    cold_us[name] = scan_us(device_events(cold, 10))[0]
            r = {"B": B, "layout": layout,
                 "ms": {n: float(np.mean(t)) for n, t in turns.items()},
                 "turns_ms": turns, "device_us": dev_us,
                 "device_us_l2_flushed": cold_us,
                 "bound_ms": bound, "bound_by": by, "bound_terms": terms,
                 "share_of_bound": {n: bound * 1e3 / us
                                    for n, us in dev_us.items()},
                 "max_abs_err": err, "same_bits_twice": same}
            rep["kernel"][f"B{B}_{layout}"] = r
            print(f"[turns] scan B {B} x {SCAN} bf16, B/C {layout}, bound "
                  f"{bound * 1e3:.2f} us ({by}):")
            for name in dev_us:
                cold = (f", {cold_us[name]:.2f} us L2 flushed"
                        if name in cold_us else "")
                print(f"[turns]   {name}: {r['ms'][name]:.5f} ms / "
                      f"{dev_us[name]:.2f} us device{cold} "
                      f"({r['share_of_bound'][name]:.1%} of bound), err "
                      f"{err[name]:.3e}, same bits {same[name]}")
            if layout == "contiguous":
                for name, fn in kernels.items():
                    with SmClock() as clk:
                        t_end = time.perf_counter() + 2.0
                        while time.perf_counter() < t_end:
                            for _ in range(20):
                                fn(*ins)
                            torch.cuda.synchronize()
                    rep["clock_alone"][f"B{B}_{name}"] = clk.result
                    print(f"[turns]   SM clock, {name} back to back: "
                          f"{clk.result}")
            del ins
            torch.cuda.empty_cache()
    del flush
    torch.cuda.empty_cache()

    cfg = get_config("jamba-v0.1-52b", "full").replace(n_layers=8)
    params = T.init(cfg, seed=0, device=dev, draw_device="cuda")
    this_op = ops.mamba_scan
    try:
        for B in (1, 8):
            toks = torch.randint(0, cfg.vocab, (B, 4096), generator=gen).to(dev)
            res = {"earlier": [], "this": []}
            with torch.inference_mode():
                for name in ("earlier", "this", "this", "earlier"):
                    ops.mamba_scan = kernels[name]
                    T.prefill_logits(params, cfg, toks)   # warm-up
                    torch.cuda.synchronize()
                    walls = []
                    with SmClock() as clk:
                        for _ in range(3):
                            t0 = time.perf_counter()
                            T.prefill_logits(params, cfg, toks)
                            torch.cuda.synchronize()
                            walls.append(time.perf_counter() - t0)
                    events = device_events(
                        lambda: T.prefill_logits(params, cfg, toks), 1)
                    us, launches = scan_us(events)
                    busy = sum(x[1] for x in events)
                    res[name].append({
                        "ms_per_call": float(np.median(walls)) * 1e3,
                        "device_busy_ms": busy / 1e3,
                        "scan_device_us_per_launch": us,
                        "scan_launches": launches,
                        "scan_share": us * launches / busy,
                        "sm_clock": clk.result})
            rep["prefill"][f"B{B}xS4096"] = res
            for name, runs in res.items():
                print(f"[turns] jamba prefill_logits B {B} x S 4096, {name}: "
                      + "; ".join(
                          f"{x['ms_per_call']:.1f} ms/call, busy "
                          f"{x['device_busy_ms']:.1f} ms, scan "
                          f"{x['scan_device_us_per_launch']:.1f} us x "
                          f"{x['scan_launches']} ({x['scan_share']:.1%}), "
                          f"SM clock {x['sm_clock']}" for x in runs))
            del toks
    finally:
        ops.mamba_scan = this_op
    line = json.dumps(rep)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
