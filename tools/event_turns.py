#!/usr/bin/env python3
"""Times the event-scan kernel in turns with an earlier commit's, on one
GPU.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 tools/event_turns.py --parent build/parent [--out PATH]

Kernels, each called through its C entry point on the same rows:

- ``this``: the checkout's (``repro_torch.kernels.event_scan``'s kernel,
  with :func:`event_plan`'s plan);
- ``earlier``: the earlier tree's, built from its own sources by its own
  ``kernels/build.py`` into ``<parent>/build/kernels`` and called with the
  argument list that module declares (24 arguments, no plan);
- the ablations: the checkout's kernel under the other layouts its entry
  point takes, ``burst`` (unit state in shared memory, one row a warp)
  and ``burst+warps`` (shared memory, 32 / W rows a warp), where ``this``
  is burst, full warps and each lane's own arrays; and ``registers``, a
  copy of the checkout's ``csrc/event_scan.cu`` edited as ``VARIANTS``
  says and built into ``build/variants``, which indexes those arrays by
  constants only, so that they stay in registers (the same bits).

Measured:

1. whether every kernel gives the earlier one's bits on every row of
   ``chip_smoke.py`` §3's tables (4,096 seeded orders each, the same seeds)
   and of §10's six permutation spaces, and whether two calls of ``this``
   give the same bits;
2. at §4's two shapes (n 64 x 4,096 orders of the gpu64 table,
   EpBsEsSw-8's 40,320): CUDA-event ms per call in the order this,
   earlier, earlier, this (median of 5 repeats of 20 calls each, the mean
   of the two turns; the ablations after, in one order and then the
   reverse one), and the median device µs per launch from
   ``torch.profiler`` (10 launches) in the same turns; orders/s, ns per
   serial step (bursts, completions and solo drains, the plain version's
   count) and the operations bound (``chip_smoke.scan_bound``);
3. each event-scan kernel's registers, stack frame and spills from the
   builds' ``-Xptxas -v`` logs (the private plan's 148-byte frame is its
   lane's arrays in local memory).

Prints one JSON object as its last line; ``--out`` also writes it.
Exits 1 where ``torch.cuda.is_available()`` is false.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from turns import (HERE, device_events, nvidia_smi, parent_build,
                   ptxas_report, start_variants, time_ms, variant_entry)

#: chip_smoke.py §3's tables, in its order (the rows' seeds are 40 + i)
TABLES = ("gpu8", "gpu16", "gpu24", "gpu64", "oversized", "gpu12_u5",
          "gpu16_u40", "serving")
#: the ``registers`` build of csrc/event_scan.cu, as edits of a copy: the
#: private plan's slots walked as a loop over constant slots (not the bits
#: of a mask), the occupancy read as a sum of 0 * used[d] and 1 *
#: used[sat] (exact for finite, non-negative used), and every slot
#: written in a loop over constant slots, the chosen one with the new
#: values (a conditional store alone the compiler turns back into an
#: indexed one)
VARIANTS = {"registers": ((), [
    ("    for (; slots; slots &= slots - 1) f(__ffs(slots) - 1);\n",
     "#pragma unroll\n"
     "    for (int c = 0; c < CM; ++c)\n"
     "      if (slots >> c & 1u) f(c);\n"),
    ("    const float occ = s.use(p.sat_idx);\n",
     "    float occ = 0.f;\n"
     "#pragma unroll\n"
     "    for (int d = 0; d < (CM > 0 ? kLaneD : p.D); ++d)\n"
     "      occ = __fadd_rn(occ, __fmul_rn(d == p.sat_idx ? 1.f : 0.f,\n"
     "                                     s.use(d)));\n"),
    ("""  if (hit >= 0) {
    s.b(hit) += m;
    return true;
  }
""", """  if (hit >= 0) {
    if constexpr (CM > 0) {
#pragma unroll
      for (int c = 0; c < CM; ++c) s.b(c) = c == hit ? s.b(c) + m : s.b(c);
    } else {
      s.b(hit) += m;
    }
    return true;
  }
"""),
    ("""  if (free_slot < 0) return false;
  s.k(free_slot) = kid;
  s.b(free_slot) = m;
  s.f(free_slot) = 1.f;
  s.a(free_slot) = t;
""", """  if (free_slot < 0) return false;
  if constexpr (CM > 0) {
#pragma unroll
    for (int c = 0; c < CM; ++c) {
      const bool o = c == free_slot;
      s.k(c) = o ? kid : s.k(c);
      s.b(c) = o ? m : s.b(c);
      s.f(c) = o ? 1.f : s.f(c);
      s.a(c) = o ? t : s.a(c);
    }
  } else {
    s.k(free_slot) = kid;
    s.b(free_slot) = m;
    s.f(free_slot) = 1.f;
    s.a(free_slot) = t;
  }
""")])}


def caller(entry, es, table, n: int, layout=None):
    """A scan of (B, n) int32 CUDA rows of ``table`` through ``entry``: the
    earlier argument list where ``layout`` is None, else this one's with
    ``layout`` ("plan", or (private, one row a warp) of an ablation).  The
    scan writes into ``out`` and ORs its error bits into ``err`` where
    given (new tensors else) and returns both, unread."""
    nbk, dem, inst, mem, caps = es._device_pack(table, torch.device("cuda"))
    cfg = es.config_for_device(table.device)
    K, D = dem.shape
    C = es.cohort_slots(n, es._pack_f32(table)[0], cfg.max_resident)
    extra = ()
    if layout is not None:
        plan = es.event_plan(K, D, cfg.n_units, C)
        if layout != "plan":
            private, alone = layout
            plan = es._plan(private, 32 if alone else plan.width, K, D,
                            cfg.n_units, C)
        extra = (int(plan.private), plan.width, plan.smem)

    def run(rows, out=None, err=None):
        if out is None:
            out = torch.empty(rows.shape[0], dtype=torch.float32,
                              device=rows.device)
            err = torch.zeros(1, dtype=torch.int32, device=rows.device)
        rc = entry(
            rows.data_ptr(), nbk.data_ptr(), dem.data_ptr(), inst.data_ptr(),
            mem.data_ptr(), caps.data_ptr(), out.data_ptr(), err.data_ptr(),
            rows.shape[0], n, K, D, cfg.n_units, C, cfg.max_resident,
            cfg.sat_idx, 0, cfg.compute_rate, cfg.mem_bw, cfg.sat_compute,
            cfg.sat_memory, es.F32_FIT_RTOL, es._RETIRE_EPS, *extra,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"event scan launch failed: CUDA error {rc}")
        return out, err
    return run


def scan_us(events) -> float:
    """The median device µs of the event-scan launches in ``events``."""
    us = [t for name, t in events if "event_scan" in name]
    if not us:
        raise RuntimeError("the profile has no event-scan launch")
    return float(np.median(us))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="an unpacked tree of the earlier commit")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("event_turns: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE / "src"))
    sys.path.insert(0, str(HERE))
    from chip_smoke import random_rows, scan_bound
    import repro_torch.core as core
    from repro_torch.core.seeded import scan_table
    from repro_torch.kernels import build
    from repro_torch.kernels import event_scan as es

    smi = nvidia_smi()
    print(f"[turns] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    t0 = time.perf_counter()
    builds = start_variants(build, "event_scan.cu", VARIANTS)
    this_lib = build.library()
    pbuild = parent_build(args.parent)
    earlier_lib = pbuild.library()
    proc, path = builds["registers"]
    registers = variant_entry(proc, path, "repro_event_scan",
                              this_lib.repro_event_scan.argtypes)
    print(f"[turns] kernels built in {time.perf_counter() - t0:.1f} s")
    ptxas = {name: ptxas_report(log.read_text(), "event_scan")
             for name, log in (("this", build.build_dir() / "build.log"),
                               ("earlier", pbuild.build_dir() / "build.log"),
                               ("registers", path.parent / "build.log"))}
    print(f"[turns] event-scan kernels' registers and spills: {ptxas}")
    layouts = {"this": "plan", "earlier": None, "registers": "plan",
               "burst": (False, True), "burst+warps": (False, False)}
    entries = {"this": this_lib.repro_event_scan,
               "earlier": earlier_lib.repro_event_scan,
               "registers": registers, "burst": this_lib.repro_event_scan,
               "burst+warps": this_lib.repro_event_scan}
    dev = torch.device("cuda")

    def kernels(table, n):
        return {name: caller(entries[name], es, table, n, layout)
                for name, layout in layouts.items()}

    # 1. bits --------------------------------------------------------------
    spaces = {name: (core.ProfileTable.build(core.experiment(name),
                                             core.GTX580),
                     np.asarray(list(itertools.permutations(
                         range(len(core.experiment(name))))), np.int32))
              for name in core.EXPERIMENTS}
    cases = {name: (scan_table(name),
                    random_rows(len(scan_table(name).kernels), 4096, 40 + i))
             for i, name in enumerate(TABLES)}
    cases.update(spaces)
    bits = {}
    for key, (table, rows) in cases.items():
        rows = torch.from_numpy(rows).to(dev)
        outs = {}
        for name, fn in kernels(table, rows.shape[1]).items():
            out, err = fn(rows)
            if int(err.item()):
                raise RuntimeError(f"{key}: {name} set error bits "
                                   f"{int(err.item())}")
            outs[name] = out
        ref = outs["earlier"]
        bits[key] = {"rows": rows.shape[0],
                     **{f"{name}_equal": bool(torch.equal(o, ref))
                        for name, o in outs.items() if name != "earlier"},
                     "this_twice_equal": bool(torch.equal(
                         outs["this"], kernels(table, rows.shape[1])["this"](
                             rows)[0]))}
        print(f"[turns] bits {key}: {bits[key]}")

    # 2. times ---------------------------------------------------------------
    shapes = {"n64_B4096": (scan_table("gpu64"),
                            random_rows(64, 4096, 40 + TABLES.index("gpu64"))),
              "EpBsEsSw-8_B40320": spaces["EpBsEsSw-8"]}
    times = {}
    for key, (table, rows) in shapes.items():
        rows = torch.from_numpy(rows).to(dev)
        B, n = rows.shape
        work = {}
        es.event_times_plain(rows, table, work=work)
        steps = work["head_steps"] + work["completions"] + work["solo"]
        bound, by = scan_bound(table, B, n, work)
        fns = kernels(table, n)
        out = torch.empty(B, dtype=torch.float32, device=dev)
        err = torch.zeros(1, dtype=torch.int32, device=dev)
        order = ["this", "earlier", "earlier", "this"]
        ablations = [k for k in fns if k not in ("this", "earlier")]
        order += ablations + ablations[::-1]
        ms = {k: [] for k in fns}
        us = {k: [] for k in fns}
        for name in order:
            ms[name].append(time_ms(lambda: fns[name](rows, out, err)))
            us[name].append(scan_us(device_events(
                lambda: fns[name](rows, out, err), 10)))
        if int(err.item()):
            raise RuntimeError(f"{key}: a timed launch set error bits "
                               f"{int(err.item())}")
        r = {"B": B, "n": n, "steps_per_row": steps / B, "work": work,
             "bound_ms": bound, "bound_by": by,
             "turns_ms": ms, "turns_device_us": us,
             "ms": {k: float(np.mean(v)) for k, v in ms.items()},
             "device_us": {k: float(np.mean(v)) for k, v in us.items()}}
        r["device_ns_per_step"] = {k: v * 1e3 / steps
                                   for k, v in r["device_us"].items()}
        r["orders_per_s"] = {k: B / v * 1e6
                             for k, v in r["device_us"].items()}
        r["speedup_vs_earlier"] = {k: r["device_us"]["earlier"] / v
                                   for k, v in r["device_us"].items()}
        times[key] = r
        print(f"[turns] {key}: {steps / B:.2f} serial steps a row, bound "
              f"{bound * 1e3:.3f} us ({by})")
        for name in fns:
            print(f"[turns]   {name}: {r['ms'][name]:.5f} ms/call, "
                  f"{r['device_us'][name]:.1f} us device "
                  f"({r['speedup_vs_earlier'][name]:.2f}x earlier's; "
                  f"{r['device_ns_per_step'][name]:.3f} ns a step, "
                  f"{r['orders_per_s'][name]:.4g} orders/s; turns "
                  f"{[round(x, 1) for x in us[name]]})")
    rep = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "ptxas": ptxas, "bits": bits, "times": times}
    ok = all(v for b in bits.values() for k, v in b.items() if k != "rows")
    rep["all_bit_equal"] = ok
    line = json.dumps(rep)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line)
    print(line)
    return 0 if ok else 2


if __name__ == "__main__":
    sys.exit(main())
