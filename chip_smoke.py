#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--report PATH]

Phases, in order; any failure exits non-zero before the last line, and
no phase catches its own failure:

1. device   — the card's name and count, and ``nvidia-smi``'s name and
              power limit;
2. build    — the CUDA kernels from ``src/repro_torch/csrc`` (``nvcc``,
              ``sm_90a``), with the compiler's register/spill report, the
              flash kernels' kernel by kernel: the bf16 (wgmma) ones must
              not spill;
3. kernels  — each kernel against its plain PyTorch version on the card,
              within f32 2e-5 / bf16 2e-2 (the reference's
              ``tests/test_kernels.py``): RMSNorm at the serving path's
              row and the forward's 32,768 rows, and at deepseek-v2's
              widths 512, 1536 and 5120 over 4,096 rows (twice, for the
              same bits), decode attention at the
              serving path's shapes and a GQA shape, at qwen's heads on a
              32,768-slot cache at seven lengths around tile and cluster
              boundaries, at jamba's (B 8, T 4096, 32 heads over 8, D 128)
              with a ragged batch whose length-0 row must be exactly zero,
              at mixtral's (B 1, 32 heads over 8, D 128, a 512-slot cache)
              at fifteen lengths from 1 to 512, and on a strided view of
              a larger cache (its contiguous copy's bits), each called
              twice for the same bits; flash
              attention at qwen's, a windowed GQA and hubert's (odd S)
              shapes and, in
              bf16, at qwen's prefill shapes B 8 x S 4096 and B 1 x S
              32768 (the latter held one head at a time), jamba's
              (8, 4096, 32 heads over 8, D 128) and mixtral's (1, 8192,
              32 heads over 8, D 128, window 4096), these two one KV head
              at a time;
              the event scan on
              4,096 random orders of seeded GTX580 tables (n 8, 16, 24,
              64, and oversized blocks; n 12 on 5 units, n 16 on 40) and
              of the serving device's (n 24, one unit), every row against
              the plain version and 256 against the float64 oracle, within
              ``F32_EVENT_RTOL`` (relative), each table called twice for
              the same bits and the tables reaching every plan
              (``EVENT_PLANS``); the selective scan at
              (B 2, T 1000, Dc 256, S 16) in f32 and bf16 and at jamba's
              (B 1, T 4096, Dc 8192, S 16) in bf16, there also with B
              and C as the slices of one (1, 4096, 288) projection that
              the prefill passes, each called twice for the same bits,
              within the doubled tolerances of the reference's
              ``test_mamba_scan`` (f32 4e-5, bf16 4e-2); the f32 pair scores on the card against
              their NumPy path within ``F32_SCORE_RTOL``;
4. times    — CUDA-event times at the paths' shapes: kernel, plain
              version, one library call computing the same function
              (yardstick only; the port never calls it), and the bound;
              decode attention at L 128 and 512 (a 512-slot cache), 4096
              and 32,768 (a 32,768-slot cache) and jamba's B 8 shape at
              L 4096, its and SDPA's device µs per call from the profiler;
              RMSNorm's and ``F.rms_norm``'s device µs at 1 x 1024,
              32,768 x 1024, 32,768 x 4096 and 4,096 x 512, 1536 and
              5120 rows, each beside its bytes bound, the calls rotating
              over inputs that span twice the L2 (one row stays
              L2-resident);
              flash attention at the three shapes above, at qwen's
              prefill B 8 x S 4096 and at jamba's, with SDPA beside it;
              the event scan at n 64 x 4,096 orders and at
              EpBsEsSw-8's 40,320, with the host ``BatchedEventSim`` as
              its yardstick (no single PyTorch call computes it), device
              µs per launch, orders/s and ns per serial step (bursts,
              completions and solo drains of the plain version's count); the
              selective scan at B 1 and B 8 x T 4096 x Dc 8192 x S 16
              bf16, with B and C contiguous and as the prefill's strided
              slices (no single PyTorch call computes it either); both
              scans' device time per launch from the profiler, the
              selective scan's as a share of its bound;
5. serving  — ``repro_torch.launch.serve.serve`` on qwen1.5-0.5b at full
              width (8 requests, bf16, seeded weights): every request
              finishes, and the launch counters show 49 RMSNorm and 24
              decode-attention launches per ``decode_step``; a full-width
              replay gives finite logits and the served first token;
6. profile  — ``torch.profiler`` over full-width decode steps: device
              time by kernel, the device's busy share, and decode
              attention's device µs per launch and share of the step;
7. prefill  — ``prefill_logits`` on qwen1.5-0.5b at full width (bf16,
              seeded weights) at B 8 x S 4096 and B 1 x S 32768: exactly
              24 flash-attention and 49 RMSNorm launches per call, finite
              logits, wall ms per call, prompt tokens/s, peak memory, and
              a profiled call (flash's device time per launch and share);
8. forward  — on qwen at full width in f32 (TF32 off), ``prefill_logits``
              through the kernels against ``impl="xla"``, and against a
              decode replay of a 64-token prompt (kernel 3 against
              kernel 2); ``forward`` of hubert-xlarge at full width
              (48 flash launches, finite);
9. card/CPU — the qwen, jamba, mixtral and deepseek smoke configs in
              f32 on the card and on the CPU (plain versions) from the
              same seeded weights, TF32 off: served tokens identical and
              replayed logits within 1e-3 (deepseek's in an f32 cache,
              and within 1e-2 in its bf16 one), and ``prefill_logits``
              within 1e-3; the ``respect_deps`` engine on qwen, mixtral
              and deepseek: tokens identical on both devices and equal
              to the flat path's, rounds and modelled time equal;
10. design space — the paper's Fig. 1 / Table 3 protocol: for each of
              the six experiments on the GTX580 model, every launch order
              (720, or 40,320 for EpBsEsSw-8) plus Algorithm 1's and the
              refined order scored in one event-scan launch, every row
              against the plain version, the float64 oracle on all rows
              of the 6-kernel sets and 4,096 of EpBsEsSw-8, and the two
              orders' percentile ranks, every order that float32 and
              float64 rank apart within ``F32_EVENT_RTOL`` of the ranked
              order (a tie);
11. serve-refined — ``serve`` on qwen1.5-0.5b at full width with
              ``policy="refined"`` (``refine_model`` "rounds", then
              "event" with ``refine_backend="batched"``) on §5's
              requests: every request finishes with §5's tokens;
12. jamba   — jamba-v0.1-52b at full width, depth cut to one period of 8
              layers (seven Mamba, one attention, four MoE; bf16, weights
              drawn on the card from seed 0): ``prefill_logits`` at
              B 1 x S 4096 and B 8 x S 4096, exactly 7 selective-scan, 1
              flash-attention and 17 RMSNorm launches per call, finite
              logits, ms per call, prompt tokens/s, peak memory and a
              profiled call each (the scan's and flash's device shares);
13. serve-jamba — the same model through ``ServingEngine`` on §5's
              requests (policy symbiotic, ``max_len`` 512, 32 new
              tokens): every request finishes, 17 RMSNorm and 1
              decode-attention launches per ``decode_step`` and no scan
              (decode is the plain recurrence, as in the reference);
14. jamba f32 — the same weights cast to f32 (TF32 off):
              ``prefill_logits`` at B 1 x S 512 through the kernels
              against ``impl="xla"``, within 1e-3 with the same argmax;
15. deepseek — deepseek-v2-236b at full width, depth cut to 8 layers
              (one dense, seven MoE; bf16, drawn on the card from seed
              0, jamba's weights freed first): ``prefill_logits`` at
              B 1 x S 4096 (``blockwise_sdpa``) and B 4 x S 1024
              (``sdpa``), exactly 33 RMSNorm and no flash launch per
              call, finite logits, ms per call beside the operations
              bound, prompt tokens/s, peak memory and a profiled call
              (the MLA attention einsums' device share);
16. serve-deepseek — the same model through ``ServingEngine`` on §5's
              requests: every request finishes, 33 RMSNorm and no
              decode-attention launch per ``decode_step``, ms per step
              beside the weight-read floor, and a decode profile (the
              device's busy share);
17. deepseek f32 — depth 2 in f32 (TF32 off): ``prefill_logits``
              (``MLA.fwd``) on a 64-token prompt against the replay into
              an f32 cache (the absorbed ``MLA.decode``), within 1e-3
              with the same argmax, ``capacity_factor`` raised only
              until the forward drops no token;
18. mixtral — mixtral-8x7b at full width, depth cut to 16 layers:
              ``prefill_logits`` at B 1 x S 8192 (the 4,096 window
              active), exactly 16 flash and 33 RMSNorm launches per
              call, ms beside the operations bound; the same model
              through ``ServingEngine`` on §5's requests as in §16:
              every request finishes, exactly 16 decode-attention and 33
              RMSNorm launches a step, ms per step beside the weight-read
              floor, and a decode profile;
19. serve-live — qwen1.5-0.5b at full width (bf16, weights drawn on
              the card) behind ``ServingFrontend`` over 2 replicas with
              ``respect_deps``, slicing under the gated guard on a
              ``LIVE_SLOTS``-token slot budget and
              ``composition="incremental"``, on a seeded Poisson and a
              bursty workload whose arrivals come while a step is in
              flight: every request finishes with a flat
              ``ServingEngine``'s tokens, exactly 49 RMSNorm and 24
              decode-attention launches per decode step, the live
              counters, slice rounds and round count, ms per decode step,
              ``phase_compose`` ms per step against
              ``composition="batch"`` on the Poisson workload (the same
              tokens), the device's busy share (a short bursty run under
              the profiler), and the obs round trip: a replica's
              ``ScheduleTrace`` to Chrome trace JSON, every registry's
              counters and gauges through ``prometheus_text`` and
              ``parse_prometheus_text``, the ``FlightRecorder``'s events
              through JSONL.

§4 also times flash attention and SDPA at qwen's B 1 x S 32768.  §9 also
serves the three traced archs with ``respect_deps`` sliced and sliced
through the live composition (two requests arriving at iteration 2, a
6-token slot budget, the gated guard) on both devices: tokens, rounds,
slice rounds, modelled time and cache counters identical.

The kernels' record counts each kernel's launches on the main paths:
the decode steps of §5, §16, §18 and §19 and the prefills of §7 and
§18.
The last lines are the kernels' JSON record, ``nvidia-smi``'s line and
``{"ok": true, "device": {...}}``.  ``--report PATH`` also writes a
fuller JSON report (every timing repeat, the profiles' top kernels).
Exits 1 at once where ``torch.cuda.is_available()`` is false.
"""

from __future__ import annotations

import argparse
import itertools
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

HERE = Path(__file__).resolve().parent
SRC = HERE / "src"

#: H100 SXM data-sheet peaks (dense): HBM bytes/s, bf16 tensor-core and
#: f32 (non-tensor) operations/s.  A card set below 700 W runs slower.
HBM_BPS = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

#: §19's workloads: requests a workload, prompt and new-token ranges,
#: arrivals in the cheapest solo prefill's modelled time, the serving
#: device model's slot budget (prompts above it are oversized stages)
#: and the stage coarsening (None: every layer's two stages)
LIVE_REQUESTS = 6
LIVE_PROMPT = (24, 192)
LIVE_NEW = (8, 16)
LIVE_ARRIVALS_PER_STEP = 4
LIVE_SLOTS = 128
LIVE_MAX_STAGES = None
#: the profiled bursty workload (device busy share): requests, prompt and
#: new-token ranges
LIVE_PROFILED = (2, (24, 64), (4, 8))


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def time_ms(fn, n: int = 200, warm: int = 20, repeats: int = 5,
            runs_out: list | None = None) -> float:
    """Median over ``repeats`` of the mean ms per call across ``n``
    back-to-back calls, timed with CUDA events; ``runs_out`` (if given)
    gets every repeat."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / n)
    if runs_out is not None:
        runs_out.extend(runs)
    return float(np.median(runs))


def bound(n_bytes: float, n_ops: float, dtype) -> tuple[float, str]:
    """Least ms for the work: bytes over HBM rate vs ops over peak."""
    t_bytes = n_bytes / HBM_BPS * 1e3
    t_ops = n_ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(label: str, got, want, dtype, errs: list,
            tol: float | None = None) -> None:
    tol = TOL[dtype] if tol is None else tol
    err = (got.float() - want.float()).abs().max().item()
    ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
    print(f"  {label}: max_abs_err={err:.3e} tol={tol:g} "
          f"{'ok' if ok else 'MISS'}")
    errs.append(err)
    require(ok, f"{label}: kernel disagrees with its plain version")


def device_rows(prof) -> list[tuple[str, float, int]]:
    """(kernel name, device µs, count) of a profile, device-side events
    only: CPU ops (aten::mm) also report the device time of the kernels
    they launch, which would count twice."""
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return rows


def profiled(block, tries: int = 5, on_prof=None):
    """``block()`` under ``torch.profiler``: (the device rows, what
    ``block`` returned, the sessions made).  In this long-lived process a
    session can record no device activity at all, seemingly at random;
    such a session is printed and ``block`` runs again after a pause,
    ``tries`` sessions at most.  ``on_prof`` gets the session that
    recorded, for readings other than the device rows."""
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = block()
        rows = device_rows(prof)
        if rows:
            if on_prof is not None:
                on_prof(prof)
            return rows, out, attempt + 1
        print(f"[profile] session {attempt + 1} recorded no device "
              "activity; again")
        time.sleep(1.0)
    raise SmokeFailure(f"the profiler recorded no device activity in "
                       f"{tries} sessions")


def slice_rounds(trace) -> int:
    """Rounds of an engine's schedule trace that hold a slice: the
    engine records each round's members as spans starting at the
    round's start."""
    return len({s[2] for s in trace.spans if "#s" in s[1]})


def flash_causal_ops(B: int, S: int, H: int, D: int, window=None,
                     causal: bool = True) -> float:
    """Multiply-adds x 2 of QK^T and P.V over the (query, key) pairs the
    mask lets through, for T = S."""
    s = np.arange(S)
    lo = np.zeros(S, np.int64) if window is None else \
        np.maximum(s - window + 1, 0)
    hi = s + 1 if causal else np.full(S, S)
    pairs = float(np.sum(hi - lo))
    return 4.0 * B * H * pairs * D


def visible_pairs(S: int, window=None) -> float:
    """(query, key) pairs a causal mask (with its sliding window) lets
    through, for T = S."""
    s = np.arange(S)
    lo = np.zeros(S, np.int64) if window is None else \
        np.maximum(s - window + 1, 0)
    return float(np.sum(s + 1 - lo))


def prefill_ops(cfg, params, B: int, S: int) -> float:
    """Operations of ``prefill_logits`` at B x S, from the parameters'
    shapes: 2 per weight per token for every projection (attention,
    dense MLP, shared experts, router), 2 per weight per capacity slot
    for the routed experts (static capacity computes every slot, filled
    or not), the attention layers' products over the visible pairs (GQA
    4 x head_dim per pair and head; MLA 2 x (qk 192 + v 128)), and the
    head at the last position.  A Mamba layer counts its projections;
    its scan's few operations a state are left out."""
    from repro_torch.models.moe import MoE

    def n_w(tree):   # projection weights only: no norm scale, no bias
        return sum(v["w"].numel() if "w" in v else n_w(v)
                   for v in tree.values() if isinstance(v, dict))

    N = B * S
    ops = 2.0 * B * cfg.d_model * cfg.vocab
    if cfg.attn_type == "mla":
        per_pair = 2 * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
                        + cfg.v_head_dim)
    else:
        per_pair = 4 * cfg.head_dim
    for i, lp in enumerate(params["layers"]):
        ops += 2.0 * N * n_w(lp["mixer"])
        if cfg.layer_kind(i) == "attn":
            ops += (B * cfg.n_heads * per_pair
                    * visible_pairs(S, cfg.sliding_window))
        if "mlp" in lp:
            ops += 2.0 * N * n_w(lp["mlp"])
        if "moe" in lp:
            m = lp["moe"]
            slots = cfg.n_experts * MoE.capacity(cfg, N)
            per_slot = sum(w[0].numel() for w in m["experts"].values())
            ops += 2.0 * slots * per_slot + 2.0 * N * m["router"]["w"].numel()
            if "shared" in m:
                ops += 2.0 * N * n_w(m["shared"])
    return ops


# -- the event scan ----------------------------------------------------------

def random_rows(n: int, B: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.argsort(rng.random((B, n)), axis=1).astype(np.int32)


def rel_err(got, want) -> np.ndarray:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want) / np.abs(want)


def check_scan(label: str, rows, table, es, n_ref: int, seed: int,
               errs: list, work: dict | None = None
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The kernel on ``rows`` against the plain version on every row and
    the float64 oracle on ``n_ref`` seeded rows (all rows where
    ``n_ref`` >= B), within ``F32_EVENT_RTOL``; returns the kernel's
    times, the oracle's and the oracle's row indices.  ``work`` gets the
    plain version's counts."""
    got = es.event_times(rows, table)
    plain = es.event_times_plain(rows, table, work=work)
    B = rows.shape[0]
    pick = (np.arange(B) if n_ref >= B else
            np.sort(np.random.default_rng(seed).choice(B, n_ref,
                                                       replace=False)))
    oracle = es.event_times_reference(rows.cpu().numpy()[pick], table)
    got = got.cpu().numpy()
    e_plain = float(rel_err(got, plain.cpu().numpy()).max())
    e_ref = float(rel_err(got[pick], oracle).max())
    tol = es.F32_EVENT_RTOL
    ok = e_plain <= tol and e_ref <= tol and bool(np.isfinite(got).all())
    print(f"  {label}: B={B} max rel err vs plain {e_plain:.3e}, vs "
          f"float64 oracle ({len(pick)} rows) {e_ref:.3e}, tol {tol:g} "
          f"{'ok' if ok else 'MISS'}")
    errs.append(max(e_plain, e_ref))
    require(ok, f"{label}: event scan disagrees with its plain version or "
            "the float64 oracle")
    return got, oracle, pick


#: the event scan's plans and row widths: each lane's own arrays at the
#: GTX580's 16 units and at 5 (8 lanes, three idle), shared memory at the
#: serving device's 1 unit (32 rows a warp) and at 40 units (a lane walks
#: two)
EVENT_PLANS = {("private", 16), ("private", 8), ("shared", 1),
               ("shared", 32)}


def event_plan_of(es, table, n: int | None = None):
    """``event_plan`` of ``table`` for rows of ``n`` kernels (all)."""
    nbk, dem = es._pack_f32(table)[:2]
    cfg = es.config_for_device(table.device)
    C = es.cohort_slots(n or len(nbk), nbk, cfg.max_resident)
    return es.event_plan(len(nbk), dem.shape[1], cfg.n_units, C)


def misranked(space32, t32: float, space64, t64: float) -> np.ndarray:
    """Float64 relative gaps between the ranked order (times ``t32`` /
    ``t64``) and each order whose standing against it differs between
    the scan's float32 times and the float64 ones: counted no better
    (>=) by one and better by the other.  A rounding tie has a gap below
    ``F32_EVENT_RTOL``; a real misranking does not."""
    flip = (space32 >= t32) != (space64 >= t64)
    return np.abs(space64[flip] - t64) / t64


def scan_bound(table, B: int, n: int, work: dict) -> tuple[float, str]:
    """Least ms for a scan: each row, the table and the output moved
    once, against the float32 operations this run's data needs
    (``work`` from the plain version): per unit a first fit tests, an
    add and a compare per dimension and the resident-count compare
    (2D + 1), counting from the round-robin pointer to the winner for
    each admission and every unit for the attempt that ends a burst;
    per admission the D adds of the placement; per occupied unit of a
    completion event its rate (12); per occupied cohort slot its work
    sums, time to finish, progress and retirement test (9); per solo
    drain 8."""
    dev = table.device
    D, K = len(dev.caps), len(table.kernels)
    n_bytes = 4 * (B * n + K * (3 + D) + D + B)
    ops = (work["tested_units"] * (2 * D + 1) + work["admissions"] * D
           + 12 * work["unit_events"] + 9 * work["slot_events"]
           + 8 * work["solo"])
    return bound(n_bytes, ops, torch.float32)


#: the special-function units' exp rate of an H100 SXM: 16 per SM per
#: clock (CUDA programming guide, compute capability 9.0) on 132 SMs at
#: the 1.98 GHz boost clock
SFU_EXP_PER_S = 16 * 132 * 1.98e9


def mamba_bound(B: int, T: int, Dc: int, S: int,
                dtype) -> tuple[float, str, dict]:
    """Least ms for a selective scan: x and dt read and y written once,
    B and C read once, A and D once (bytes), against the f32 operations
    (6 per (t, c, s): dt·A, the x·B product, h's FMA, h·C and the sum;
    2 per (t, c): dt·x and the skip) at 67 TFLOP/s and the exps (one per
    (t, c, s)) at the SFUs' rate; the largest term bounds it."""
    isz = torch.tensor([], dtype=dtype).element_size()
    n_bytes = isz * (3 * B * T * Dc + 2 * B * T * S) + 4 * (Dc * S + Dc)
    terms = {"bytes_ms": n_bytes / HBM_BPS * 1e3,
             "f32_ops_ms": B * T * Dc * (6 * S + 2) / PEAK_OPS[torch.float32]
             * 1e3,
             "exp_sfu_ms": B * T * Dc * S / SFU_EXP_PER_S * 1e3}
    by = max(terms, key=terms.get)
    return terms[by], ("bytes" if by == "bytes_ms" else "operations"), terms


#: jamba's dbc projection: dt_rank 256 columns, then B and C (S 16 each)
DBC_DT_RANK = 256


def scan_inputs(randn, B: int, T: int, Dc: int, S: int, dtype,
                strided: bool = False):
    """The reference's test_mamba_scan recipe: x, dt = softplus(N) / 10,
    bm, cm in ``dtype``; a = -exp(0.3 N) and d f32.  ``strided``: bm and
    cm are the slices of one (B, T, 256 + 2 S) projection that
    ``Mamba.fwd`` passes (a row stride of 288 at S 16)."""
    import torch.nn.functional as F
    x = randn(B, T, Dc, dtype=dtype)
    dt = (F.softplus(randn(B, T, Dc)) * 0.1).to(dtype)
    if strided:
        dbc = randn(B, T, DBC_DT_RANK + 2 * S, dtype=dtype)
        bm, cm = dbc[..., DBC_DT_RANK:-S], dbc[..., -S:]
    else:
        bm, cm = randn(B, T, S, dtype=dtype), randn(B, T, S, dtype=dtype)
    a = -torch.exp(randn(Dc, S) * 0.3)
    return x, dt, bm, cm, a, randn(Dc)


def design_space(core, es, dev, errs: list, *, max_ref: int = 4096,
                 names=None) -> dict:
    """The paper's Fig. 1 / Table 3 protocol on the GTX580 model: each
    experiment's whole permutation space, plus Algorithm 1's order and
    the refined order, in one event-scan launch.

    Percentiles come two ways.  ``*_percentile`` is ``percentile_rank``
    as the paper takes it, exact comparisons.  Many orders tie in exact
    arithmetic (BS-6-blk: 621 of 720 share the optimal time), and their
    computed times differ only by rounding, float64's at 1e-16 and the
    scan's at 1e-7, so the exact rank inside a tie depends on the
    precision.  ``*_percentile_ties`` counts every order within
    ``F32_EVENT_RTOL`` of the order's time as a tie (``percentile_rank``
    of ``t * (1 - F32_EVENT_RTOL)``): the rank a computation within that
    tolerance determines, held within 0.5 points of the float64 one
    where the float64 times cover the space.  The exact ranks are held
    order by order on every row with a float64 time: each order that
    float32 and float64 rank differently against Algorithm 1's or the
    refined order must lie within ``F32_EVENT_RTOL`` of it in float64
    (:func:`misranked`), so a swap of two orders that do not tie fails."""
    out = {}
    for name in names or core.EXPERIMENTS:
        ks = core.experiment(name)
        table = core.ProfileTable.build(ks, core.GTX580)
        idx = {id(k): i for i, k in enumerate(table.kernels)}
        greedy = core.greedy_order_fast(ks, core.GTX580, table=table).order
        refined, t_refined64 = core.refined_schedule(ks, core.GTX580)
        n = len(ks)
        space = np.asarray(list(itertools.permutations(range(n))), np.int32)
        extra = np.asarray([[idx[id(k)] for k in o] for o in (greedy,
                                                               refined)],
                           np.int32)
        rows = torch.from_numpy(np.concatenate([space, extra])).to(dev)
        got, oracle, pick = check_scan(
            f"{name}: {len(space)} orders + greedy + refined", rows, table,
            es, max_ref, 13, errs)
        g64 = core.simulate(greedy, core.GTX580)
        times = got[:len(space)]
        t_greedy, t_ref = float(got[-2]), float(got[-1])
        rep = {"orders": len(space),
               "optimal": float(times.min()), "worst": float(times.max()),
               "median": float(np.median(times)),
               "greedy": t_greedy, "refined": t_ref,
               "refined_float64": t_refined64,
               "greedy_percentile": core.percentile_rank(t_greedy, times),
               "refined_percentile": core.percentile_rank(t_ref, times)}
        tie = 1.0 - es.F32_EVENT_RTOL
        in_space = pick < len(space)     # rows with a float64 time
        for k, t, t64 in (("greedy", t_greedy, g64),
                          ("refined", t_ref, t_refined64)):
            rep[f"{k}_percentile_ties"] = core.percentile_rank(t * tie, times)
            gaps = misranked(times[pick[in_space]], t,
                             oracle[in_space], t64)
            rep[f"{k}_misranked"] = len(gaps)
            rep[f"{k}_misranked_max_gap"] = float(gaps.max(initial=0.0))
            require(rep[f"{k}_misranked_max_gap"] <= es.F32_EVENT_RTOL,
                    f"{name}: float32 and float64 rank {len(gaps)} orders "
                    f"differently against the {k} order, one "
                    f"{rep[f'{k}_misranked_max_gap']:.3e} apart in float64 "
                    "(not a tie)")
        if len(rows) <= max_ref:   # the float64 times cover the space
            t64 = oracle[:len(space)]
            for k, t in (("greedy", g64), ("refined", t_refined64)):
                rep[f"{k}_percentile_float64"] = core.percentile_rank(t, t64)
                rep[f"{k}_percentile_ties_float64"] = core.percentile_rank(
                    t * tie, t64)
                d = abs(rep[f"{k}_percentile_ties"]
                        - rep[f"{k}_percentile_ties_float64"])
                require(d <= 0.5, f"{name}: {k} percentile (ties within "
                        f"F32_EVENT_RTOL) {d:.3f} points from the float64 "
                        "one")
        print(f"  {name}: optimal {rep['optimal'] * 1e3:.3f} ms, worst "
              f"{rep['worst'] * 1e3:.3f} ms, median "
              f"{rep['median'] * 1e3:.3f} ms (GTX580 model time); "
              f"Algorithm 1 {t_greedy * 1e3:.3f} ms, refined "
              f"{t_ref * 1e3:.3f} ms")
        for k in ("greedy", "refined"):
            f64 = (f"; float64 {rep[f'{k}_percentile_float64']:.2f} and "
                   f"{rep[f'{k}_percentile_ties_float64']:.2f}"
                   if f"{k}_percentile_float64" in rep else "")
            print(f"    {k}: percentile {rep[f'{k}_percentile']:.2f} "
                  f"(exact ranks), {rep[f'{k}_percentile_ties']:.2f} (ties "
                  f"within F32_EVENT_RTOL){f64}; "
                  f"{rep[f'{k}_misranked']} of {int(in_space.sum())} orders "
                  f"ranked apart from float64, largest float64 gap "
                  f"{rep[f'{k}_misranked_max_gap']:.3e}")
        out[name] = rep
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", type=Path, default=None,
                    help="also write the full report as JSON to this path")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    import repro_torch.core as core
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core.batched import BatchedEventSim, PackedKernels
    from repro_torch.core.seeded import scan_table
    from repro_torch.core.batched import F32_SCORE_RTOL
    from repro_torch.kernels import (build, decode_attention,
                                     decode_attention_plain, event_scan,
                                     flash_attention,
                                     flash_attention_plain, launch_counts,
                                     mamba_scan, mamba_scan_plain,
                                     reset_launch_counts, rmsnorm_rows,
                                     rmsnorm_rows_plain, scan_plan)
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as T
    from repro_torch.models.moe import MoE
    from repro_torch.core.tpu import make_serving_device
    from repro_torch.obs import (FlightRecorder, ScheduleTrace,
                                 parse_prometheus_text, prometheus_text)
    from repro_torch.serve import (Request, SchedulerPolicy, ServingEngine,
                                   ServingFrontend, make_workload)
    from repro_torch.slice import SlicePolicy

    import torch.nn.functional as F

    report: dict = {}
    dev = torch.device("cuda")
    spec_32k = SHAPES["prefill_32k"]

    # 1. device ---------------------------------------------------------
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = nvidia_smi()
    print(f"[device] {name} x{count}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(f"[device] nvidia-smi: {smi}")
    report["device"] = {"name": name, "count": count, "nvidia_smi": smi}

    # 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t0
    print(f"[build] kernels ready in {build_s:.2f} s "
          f"({build.build_dir().relative_to(HERE)})")
    log = build.build_dir() / "build.log"
    if log.is_file():
        for line in log.read_text().splitlines():
            if "Used" in line or "spill" in line:
                print(f"[build]   {line.strip()}")
        # the flash kernel's -Xptxas -v report, kernel by kernel; the bf16
        # (wgmma) kernels must not spill
        text = log.read_text()
        text = text[text.index("== flash_attention.cu"):]
        text = text[:text.find("\n== ", 1) % (len(text) + 1)]
        flash_ptxas = re.findall(
            r"Compiling entry function '\w*?"
            r"(flash_attention_(?:wgmma_)?kernelI(?:Li\d+E)+).*?"
            r"\n\s*(\d+ bytes stack frame, (\d+) bytes spill stores, "
            r"(\d+) bytes spill loads)\s*\nptxas info\s*: (Used [^\n]*)",
            text, re.S)
        require(any("wgmma" in k[0] for k in flash_ptxas),
                "build.log: no report for the flash wgmma kernel")
        for kname, frame, st, ld, used in flash_ptxas:
            print(f"[build]   flash {kname}: {used}; {frame}")
            require("wgmma" not in kname or st == ld == "0",
                    f"build.log: {kname} spills ({frame})")
        serial = text.count("wgmma.mma_async instructions are serialized")
        print(f"[build]   flash: {serial} ptxas note(s) of serialised wgmma")
        report["flash_ptxas"] = [list(k) for k in flash_ptxas]
    report["build_s"] = build_s

    # 3. kernels vs plain on the card ------------------------------------
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, dtype=torch.float32, scale=1.0, shift=0.0):
        x = torch.randn(shape, generator=gen) * scale + shift
        return x.to(dev, dtype)

    errs = {"rmsnorm": [], "decode_attention": [], "flash_attention": [],
            "event_scan": [], "mamba_scan": []}
    print("[kernels] RMSNorm vs plain")
    for rows in (1, 64, 32768):
        for dt in (torch.bfloat16, torch.float32):
            x = randn(rows, 1024, dtype=dt)
            s = randn(1024, scale=0.1, shift=1.0)
            compare(f"rmsnorm ({rows}, 1024) {dt}", rmsnorm_rows(x, s),
                    rmsnorm_rows_plain(x, s), dt, errs["rmsnorm"])
    # deepseek-v2's widths (§15): kv_norm 512, q_norm 1536, d_model 5120,
    # at a prefill's 4,096 rows, twice for the same bits
    for d in (512, 1536, 5120):
        x = randn(4096, d, dtype=torch.bfloat16)
        s = randn(d, scale=0.1, shift=1.0)
        y = rmsnorm_rows(x, s)
        compare(f"rmsnorm (4096, {d}) bf16", y, rmsnorm_rows_plain(x, s),
                torch.bfloat16, errs["rmsnorm"])
        require(torch.equal(y, rmsnorm_rows(x, s)),
                f"rmsnorm (4096, {d}): two calls gave different bits")
    del x, y
    print("[kernels] decode attention vs plain")
    cases = [((1, 16, 16, 512, 64), [1, 100, 128, 511, 512]),
             ((4, 32, 8, 4096, 128), [1, 1000, 4095, 4096]),
             ((1, 6, 6, 64, 16), [1, 37])]
    for (B, H, Hkv, Tc, D), lens in cases:
        for qdt, kvdt in ((torch.bfloat16, torch.bfloat16),
                          (torch.float32, torch.float32),
                          (torch.float32, torch.bfloat16)):
            q = randn(B, H, D, dtype=qdt)
            k = randn(B, Tc, Hkv, D, dtype=kvdt)
            v = randn(B, Tc, Hkv, D, dtype=kvdt)
            for L in lens:
                ln = torch.full((B,), L, dtype=torch.int32, device=dev)
                if B > 1:   # ragged batch: every length in one call
                    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
                compare(f"decode_attention B={B} H={H} Hkv={Hkv} T={Tc} "
                        f"D={D} L={ln.tolist()} q={qdt} kv={kvdt}",
                        decode_attention(q, k, v, ln),
                        decode_attention_plain(q, k, v, ln), qdt,
                        errs["decode_attention"])
                if B > 1:
                    break
    # the split walk: qwen's heads on a 32,768-slot cache at lengths on
    # both sides of a tile (32 or 64 positions) and of a deal over the
    # cluster's 8 blocks; jamba's B 8 shape with a ragged batch holding a
    # length 0 (its row exactly zero, where the plain version averages v);
    # a strided view of a larger cache against its contiguous copy; every
    # call twice, for the same bits
    def check_decode(label, q, k, v, ln, qdt):
        got = decode_attention(q, k, v, ln)
        require(torch.equal(got, decode_attention(q, k, v, ln)),
                f"{label}: two calls on the same inputs differ")
        live = ln > 0
        require(bool((got[~live] == 0).all()),
                f"{label}: a row of length 0 is not exactly zero")
        compare(label, got[live], decode_attention_plain(q, k, v, ln)[live],
                qdt, errs["decode_attention"])
        return got

    for qdt, kvdt in ((torch.bfloat16, torch.bfloat16),
                      (torch.float32, torch.float32)):
        q = randn(1, 16, 64, dtype=qdt)
        k, v = (randn(1, 32768, 16, 64, dtype=kvdt) for _ in range(2))
        for L in (1, 31, 32, 33, 255, 4097, 32768):
            ln = torch.full((1,), L, dtype=torch.int32, device=dev)
            check_decode(f"decode_attention qwen heads T=32768 L={L} "
                         f"q={qdt} kv={kvdt} (twice, same bits)",
                         q, k, v, ln, qdt)
        q = randn(8, 32, 128, dtype=qdt)
        k, v = (randn(8, 4096, 8, 128, dtype=kvdt) for _ in range(2))
        lens = [0, 1, 33, 1000, 2049, 4095, 4096, 4096]
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        check_decode(f"decode_attention jamba B=8 H=32 Hkv=8 T=4096 D=128 "
                     f"L={lens} q={qdt} kv={kvdt} (twice, same bits; the "
                     f"length-0 row exactly zero)", q, k, v, ln, qdt)
        # mixtral's decode (§18): 32 heads over 8, D 128, batch 1 on the
        # served 512-slot cache, at lengths on both sides of a tile and of
        # a deal over the cluster, through the longest served request's
        q = randn(1, 32, 128, dtype=qdt)
        k, v = (randn(1, 512, 8, 128, dtype=kvdt) for _ in range(2))
        for L in (1, 31, 32, 33, 64, 79, 127, 128, 129, 159, 255, 256, 257,
                  511, 512):
            ln = torch.full((1,), L, dtype=torch.int32, device=dev)
            check_decode(f"decode_attention mixtral B=1 H=32 Hkv=8 T=512 "
                         f"D=128 L={L} q={qdt} kv={kvdt} (twice, same bits)",
                         q, k, v, ln, qdt)
        big_k, big_v = (randn(2, 8192, 16, 64, dtype=kvdt) for _ in range(2))
        k, v = big_k[:, 100:4196, 4:12], big_v[:, 100:4196, 4:12]
        q = randn(2, 8, 64, dtype=qdt)
        ln = torch.tensor([4000, 17], dtype=torch.int32, device=dev)
        got = check_decode(f"decode_attention strided view (2, 4096, 8, 64) "
                           f"of a (2, 8192, 16, 64) cache q={qdt} "
                           f"kv={kvdt}", q, k, v, ln, qdt)
        require(torch.equal(got, decode_attention(q, k.contiguous(),
                                                  v.contiguous(), ln)),
                "decode_attention: the strided view and its contiguous "
                "copy differ")
        del q, k, v, big_k, big_v, got
    print("[kernels] flash attention vs plain")
    flash_cases = [  # (B, S, H, Hkv, D, causal, window)
        (1, 4096, 16, 16, 64, True, None),     # qwen1.5-0.5b's forward
        (1, 2048, 32, 8, 128, True, 1024),     # GQA with a window
        (1, 1000, 16, 16, 80, False, None),    # hubert-xlarge, odd S
    ]
    for B, S, H, Hkv, D, causal, window in flash_cases:
        for dt in (torch.bfloat16, torch.float32):
            q = randn(B, S, H, D, dtype=dt)
            k = randn(B, S, Hkv, D, dtype=dt)
            v = randn(B, S, Hkv, D, dtype=dt)
            compare(f"flash_attention B={B} S={S} H={H} Hkv={Hkv} D={D} "
                    f"causal={causal} window={window} {dt}",
                    flash_attention(q, k, v, causal=causal, window=window),
                    flash_attention_plain(q, k, v, causal=causal,
                                          window=window),
                    dt, errs["flash_attention"])
    # the prefill paths' shapes, bf16: qwen's two (§7), jamba's B 8 x
    # S 4096 at D 128, g 4 (§12) and mixtral's B 1 x S 8192 with its 4096
    # window (§18).  qwen B 8 in one plain call (8.6 GB of f32 scores);
    # B 1 x S 32768 (512 query tiles, KV walks up to 512 tiles) in one
    # kernel call, held one head at a time against the plain version on
    # that head's strided views (4.3 GB of scores); jamba and mixtral one
    # KV head (four query heads) at a time (2.1 and 1.1 GB)
    for B, S, H, Hkv, D, window in ((8, 4096, 16, 16, 64, None),
                                    (1, spec_32k.seq_len, 16, 16, 64, None),
                                    (8, 4096, 32, 8, 128, None),
                                    (1, 8192, 32, 8, 128, 4096)):
        q = randn(B, S, H, D, dtype=torch.bfloat16)
        k, v = (randn(B, S, Hkv, D, dtype=torch.bfloat16) for _ in range(2))
        step = Hkv if H * S <= 16 * 4096 else 1   # KV heads per plain call
        g = H // Hkv
        want = torch.cat([flash_attention_plain(q[:, :, g * h:g * (h + step)],
                                                k[:, :, h:h + step],
                                                v[:, :, h:h + step],
                                                window=window)
                          for h in range(0, Hkv, step)], dim=2)
        compare(f"flash_attention B={B} S={S} H={H} Hkv={Hkv} D={D} "
                f"causal=True window={window} {torch.bfloat16} (a prefill "
                f"shape; plain {step} KV head(s) per call)",
                flash_attention(q, k, v, window=window), want,
                torch.bfloat16, errs["flash_attention"])
        del q, k, v, want
    print("[kernels] event scan vs plain and the float64 oracle (relative "
          "error of the makespan), each table under the plan it takes")
    tables = {name: scan_table(name) for name in
              ("gpu8", "gpu16", "gpu24", "gpu64", "oversized", "gpu12_u5",
               "gpu16_u40", "serving")}
    scan_rows, scan_work, event_plans = {}, {}, set()
    for i, (key, table) in enumerate(tables.items()):
        scan_rows[key] = torch.from_numpy(
            random_rows(len(table.kernels), 4096, 40 + i)).to(dev)
        plan = event_plan_of(event_scan, table)
        event_plans.add((plan.name, plan.width))
        got, _, _ = check_scan(
            f"event scan {key} ({table.device.name}, U {table.device.n_units}"
            f"; plan {plan.name}, {32 // plan.width} row(s) a warp)",
            scan_rows[key], table, event_scan, 256, 50 + i,
            errs["event_scan"], work=scan_work.setdefault(key, {}))
        require(np.array_equal(
            got, event_scan.event_times(scan_rows[key], table).cpu().numpy()),
            f"event scan {key}: two calls on the same rows differ")
    require(event_plans == EVENT_PLANS, f"the event-scan checks reach "
            f"{sorted(event_plans)}, not {sorted(EVENT_PLANS)}")
    print("[kernels] selective scan vs plain (tolerances of the reference's "
          "test_mamba_scan, doubled as it doubles them)")
    # every call twice, for the same bits; jamba's shapes (B 1 takes the
    # plan of 4 states a thread, B 8 that of 8) also with B and C as the
    # slices of one (B, T, 288) projection that Mamba.fwd passes
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def mamba_plan_name(ins) -> str:
        p = scan_plan(*ins[0].shape, ins[2].shape[-1], ins[0].dtype, sms)
        return f"{p.states} states x {p.lanes} lanes"

    def at_offset_1(t):
        """``t`` as a contiguous view one element into its storage."""
        v = torch.empty(t.numel() + 1, dtype=t.dtype,
                        device=t.device)[1:].view(t.shape)
        return v.copy_(t)

    def check_mamba(label, ins, dt):
        got = mamba_scan(*ins)
        label += " (twice, same bits)"
        require(torch.equal(got, mamba_scan(*ins)),
                f"{label}: two calls on the same inputs differ")
        compare(label, got, mamba_scan_plain(*ins), dt,
                errs["mamba_scan"], tol=2 * TOL[dt])

    for B, n_t, Dc, S, dt, strided in (
            (2, 1000, 256, 16, torch.float32, False),
            (2, 1000, 256, 16, torch.bfloat16, False),
            (1, 4096, 8192, 16, torch.bfloat16, False),
            (1, 4096, 8192, 16, torch.bfloat16, True),
            (8, 4096, 8192, 16, torch.bfloat16, False),
            (8, 4096, 8192, 16, torch.bfloat16, True)):
        ins = scan_inputs(randn, B, n_t, Dc, S, dt, strided=strided)
        check_mamba(f"mamba_scan B={B} T={n_t} Dc={Dc} S={S} {dt}"
                    f"{' B/C strided' if strided else ''} "
                    f"({mamba_plan_name(ins)})", ins, dt)
        del ins
    torch.cuda.empty_cache()
    # every plan the library builds, in both dtypes, at T 70 (no multiple
    # of a chunk or step group): S 1..32 at B 2 x Dc 200 takes the plans
    # of min(4, S) states a thread, B 33 x Dc 2048 at S 8..32 a grid wide
    # enough for 8; then the staging's other paths: x and dt not 16-byte
    # aligned or Dc * esize no multiple of 16 (scalar loads and stores, a
    # channel tail inside a vector), and B and C rows 16-byte aligned but
    # S * esize not (partial cp.async pieces)
    plans = set()
    for dt in (torch.float32, torch.bfloat16):
        for B, Dc, S in ([(2, 200, S) for S in (1, 2, 4, 8, 16, 32)]
                         + [(33, 2048, S) for S in (8, 16, 32)]):
            ins = scan_inputs(randn, B, 70, Dc, S, dt)
            plans.add(mamba_plan_name(ins))
            check_mamba(f"mamba_scan B={B} T=70 Dc={Dc} S={S} {dt} "
                        f"({mamba_plan_name(ins)})", ins, dt)
        for Dc in (36, 30):
            x, dtv, bm, cm, a, d = scan_inputs(randn, 2, 70, Dc, 16, dt)
            check_mamba(f"mamba_scan B=2 T=70 Dc={Dc} S=16 {dt}, x and dt "
                        "at storage offset 1", (at_offset_1(x),
                                                at_offset_1(dtv), bm, cm, a,
                                                d), dt)
        S, col = (12, 8) if dt == torch.bfloat16 else (6, 4)
        x, dtv, _, _, a, d = scan_inputs(randn, 2, 70, 200, S, dt)
        dbc = randn(2, 70, 6 * col, dtype=dt)
        check_mamba(f"mamba_scan B=2 T=70 Dc=200 S={S} {dt}, B and C at "
                    f"columns {2 * col} and {4 * col} of a "
                    f"{dbc.shape[-1]}-wide projection",
                    (x, dtv, dbc[..., 2 * col:2 * col + S],
                     dbc[..., 4 * col:4 * col + S], a, d), dt)
    require(len(plans) == 9, f"the scan checks reach {sorted(plans)}, not "
                             "the library's 9 plans")
    print("[kernels] f32 pair scores on the card vs their NumPy path")
    for key in ("gpu8", "gpu64", "oversized"):
        got = core.pair_score_matrix_batched(tables[key], device=dev)
        host = core.pair_score_matrix_batched(tables[key], backend="numpy")
        scale = max(float(np.abs(host).max()), 1.0)
        err = float(np.abs(got.astype(np.float64) - host).max())
        ok = got.shape == host.shape and err <= F32_SCORE_RTOL * scale
        print(f"  pair scores {key}: {got.shape}, max abs err {err:.3e} "
              f"(bound F32_SCORE_RTOL x {scale:.4g} = "
              f"{F32_SCORE_RTOL * scale:.3e}) {'ok' if ok else 'MISS'}")
        require(ok, f"pair scores {key}: the card disagrees with NumPy")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # 4. times at the paths' shapes -----------------------------------------
    print("[times] CUDA events: median of 5 repeats of n back-to-back calls "
          "after warm-up calls (n = 200 and 20 warm-up calls unless shown)")
    kern = {}
    repeats: dict = {}

    def profiled_us(fn, name: str, n: int = 5) -> float:
        """Device µs per launch of kernel ``name`` over ``n`` calls of
        ``fn`` under the profiler, averaged over the launches it
        recorded (a launch at the very start of a window can go
        unrecorded)."""
        fn()
        torch.cuda.synchronize()

        def calls():
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows = [r for r in profiled(calls)[0] if name in r[0]]
        seen = sum(r[2] for r in rows)
        require(1 <= seen <= n, f"profile: {name} launches "
                f"{[(r[0][:40], r[2]) for r in rows]} of {n}")
        return sum(r[1] for r in rows) / seen

    def graph_us(fn, n: int = 50, rotate=None) -> float:
        """Device µs per call of ``fn`` from CUDA events around the replay
        of a CUDA graph of ``n`` calls: the launches back to back, with no
        host time between them and no profiler session.  With ``rotate``
        (a list of argument tuples) call i is ``fn(*rotate[i % len])``
        and every call's output is kept until the replay ends, so no call
        finds its input or output in L2 once the tuples span more than
        it."""
        args = rotate or [()]
        outs = []
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*args[0])
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for i in range(n):
                y = fn(*args[i % len(args)])
                if rotate:
                    outs.append(y)
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e3 / n

    def timed(name, fn, **kw):
        return time_ms(fn, runs_out=repeats.setdefault(name, []), **kw)

    x = randn(1, 1024, dtype=torch.bfloat16)
    s = randn(1024, scale=0.1, shift=1.0)
    s_lib = s.to(torch.bfloat16)  # F.rms_norm takes its weight in x's dtype
    r_bytes = x.numel() * 2 * 2 + s.numel() * 4
    r_bound, r_by = bound(r_bytes, 4 * x.numel(), torch.bfloat16)
    kern["rmsnorm"] = {
        "ms": timed("rmsnorm", lambda: rmsnorm_rows(x, s)),
        "plain_ms": timed("rmsnorm.plain", lambda: rmsnorm_rows_plain(x, s)),
        "library_ms": timed("rmsnorm.F.rms_norm",
                            lambda: F.rms_norm(x, (1024,), s_lib, 1e-6)),
        "bound_ms": r_bound, "bound_by": r_by,
        "shape": "x (1, 1024) bf16, scale (1024,) f32"}

    # RMSNorm's device time beside F.rms_norm's at one row (decode) and the
    # prefills' rows (qwen 32,768 x 1024, jamba B 8 x S 4096 x 4096,
    # deepseek's 4,096 rows at kv_norm's 512, q_norm's 1536 and d_model
    # 5120), each beside its bytes bound; device times of short calls
    # come from CUDA graphs, which open no profiler session
    # (tools/decode_turns.py gives the profiler's for decode attention and
    # SDPA).  The calls rotate over enough inputs to span twice the L2
    # (at most one per call), so that a shape whose rotation spans it
    # reads and writes HBM as its bound assumes; one row is L2-resident
    # all the same, as a decode step's is
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size",
                 50 << 20)
    rms_dev = {}
    for rows, d in ((1, 1024), (32768, 1024), (32768, 4096), (4096, 512),
                    (4096, 1536), (4096, 5120)):
        n_in = min(50, -(-2 * l2 // (rows * d * 2)))
        xs = [randn(rows, d, dtype=torch.bfloat16) for _ in range(n_in)]
        sr = randn(d, scale=0.1, shift=1.0)
        sr_lib = sr.to(torch.bfloat16)
        rb, rby = bound(rows * d * 2 * 2 + d * 4, 4 * rows * d,
                        torch.bfloat16)
        rms_dev[f"{rows}x{d}"] = {
            "kernel_device_us": graph_us(lambda xr: rmsnorm_rows(xr, sr),
                                         rotate=[(xr,) for xr in xs]),
            "library_device_us": graph_us(
                lambda xr: F.rms_norm(xr, (d,), sr_lib, 1e-6),
                rotate=[(xr,) for xr in xs]),
            "inputs_rotated": n_in,
            "rotation_bytes": n_in * rows * d * 2, "l2_bytes": l2,
            "bound_us": rb * 1e3, "bound_by": rby,
            "shape": f"x ({rows}, {d}) bf16, scale ({d},)"}
        del xs
        torch.cuda.empty_cache()
    kern["rmsnorm"]["device_us"] = rms_dev

    # decode attention: L 128 and 512 on a 512-slot cache (the serving
    # path's), L 4096 and 32,768 on a 32,768-slot one (qwen's context),
    # and jamba's B 8 x 32 heads over 8 x D 128 at L 4096; kernel, plain
    # and SDPA (the KV heads as they are, enable_gqa) call ms, and the
    # kernel's and SDPA's device µs per call
    att = {}
    qwen_q = randn(1, 16, 64, dtype=torch.bfloat16)
    cache512 = [randn(1, 512, 16, 64, dtype=torch.bfloat16)
                for _ in range(2)]
    cache32k = [randn(1, 32768, 16, 64, dtype=torch.bfloat16)
                for _ in range(2)]
    jamba_q = randn(8, 32, 128, dtype=torch.bfloat16)
    jamba_kv = [randn(8, 4096, 8, 128, dtype=torch.bfloat16)
                for _ in range(2)]
    for key, q, (k, v), L in (("L128", qwen_q, cache512, 128),
                              ("L512", qwen_q, cache512, 512),
                              ("L4096", qwen_q, cache32k, 4096),
                              ("L32768", qwen_q, cache32k, 32768),
                              ("jamba_L4096", jamba_q, jamba_kv, 4096)):
        B, H, D = q.shape
        Tc, Hkv = k.shape[1], k.shape[2]
        ln = torch.full((B,), L, dtype=torch.int32, device=dev)
        q4 = q.view(B, H, 1, D)
        k4, v4 = k[:, :L].transpose(1, 2), v[:, :L].transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(q4, k4, v4,
                                                  enable_gqa=H != Hkv)

        a_bytes = 2 * q.numel() * 2 + 2 * B * L * Hkv * D * 2 + 4 * B
        a_bound, a_by = bound(a_bytes, 4 * B * H * L * D + 3 * B * H * L,
                              torch.bfloat16)
        att[key] = {
            "ms": timed(f"decode_attention.{key}",
                        lambda: decode_attention(q, k, v, ln)),
            "plain_ms": timed(f"decode_attention.{key}.plain",
                              lambda: decode_attention_plain(q, k, v, ln),
                              n=20 if L > 512 else 200),
            "library_ms": timed(f"decode_attention.{key}.sdpa", sdpa),
            "device_us": graph_us(lambda: decode_attention(q, k, v, ln)),
            "library_device_us": graph_us(sdpa),
            "bound_ms": a_bound, "bound_by": a_by,
            "shape": f"q ({B}, {H}, {D}) bf16, cache ({B}, {Tc}, {Hkv}, "
                     f"{D}) bf16, L={L}"}
    del cache32k, jamba_kv
    torch.cuda.empty_cache()
    kern["decode_attention"] = att["L128"]
    # flash attention at the shapes of §3, qwen's prefill B 8, qwen's
    # B 1 x S 32768 and jamba's (no plain time at the last two: 17 GB of
    # f32 scores in one call at jamba's, 4.3 GB a head at S 32768); SDPA
    # gets its own (B, H, S, D) layout, the KV heads repeated to H and the
    # window as a boolean mask, ready-made, so its time has none of that
    # in it
    flash_t = {}
    for key, (B, S, H, Hkv, D, causal, window) in {
            "qwen": (1, 4096, 16, 16, 64, True, None),
            "qwen_B8": (8, 4096, 16, 16, 64, True, None),
            "qwen_S32768": (1, spec_32k.seq_len, 16, 16, 64, True, None),
            "gqa_window": (1, 2048, 32, 8, 128, True, 1024),
            "hubert": (1, 1000, 16, 16, 80, False, None),
            "jamba": (8, 4096, 32, 8, 128, True, None)}.items():
        q = randn(B, S, H, D, dtype=torch.bfloat16)
        k, v = (randn(B, S, Hkv, D, dtype=torch.bfloat16) for _ in range(2))
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (t.repeat_interleave(H // Hkv, dim=2).transpose(1, 2)
                  .contiguous() for t in (k, v))
        mask = None
        if window is not None:
            i = torch.arange(S, device=dev)
            mask = ((i[None, :] <= i[:, None])
                    & (i[None, :] > i[:, None] - window))
        kw = dict(causal=causal, window=window)
        f_bound, f_by = bound(2 * B * S * (H + Hkv) * D * 2,
                              flash_causal_ops(B, S, H, D, window, causal),
                              torch.bfloat16)
        flash_t[key] = {
            "ms": timed(f"flash_attention.{key}",
                        lambda: flash_attention(q, k, v, **kw), n=20, warm=3),
            "plain_ms": None if key in ("jamba", "qwen_S32768") else timed(
                f"flash_attention.{key}.plain",
                lambda: flash_attention_plain(q, k, v, **kw), n=5, warm=2),
            "library_ms": timed(
                f"flash_attention.{key}.sdpa",
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask,
                    is_causal=causal and mask is None),
                n=20, warm=3),
            "bound_ms": f_bound, "bound_by": f_by,
            "shape": f"q ({B}, {S}, {H}, {D}), k/v ({B}, {S}, {Hkv}, {D}) "
                     f"bf16, causal={causal}, window={window}"}
        del q, k, v, qt, kt, vt, mask
    torch.cuda.empty_cache()
    kern["flash_attention"] = flash_t["qwen"]
    # the event scan at refine_batch x 32 orders of n 64 and at the
    # design space of EpBsEsSw-8; plain n = 1 (its first call ran in §3
    # or warms up here), the host BatchedEventSim timed once
    ep8 = core.ProfileTable.build(core.experiment("EpBsEsSw-8"), core.GTX580)
    space8 = np.asarray(list(itertools.permutations(range(8))), np.int32)
    scan_t = {}
    for key, table, rows in (("n64_B4096", tables["gpu64"], scan_rows["gpu64"]),
                             ("EpBsEsSw-8_B40320", ep8,
                              torch.from_numpy(space8).to(dev))):
        B, n = rows.shape
        work = scan_work.get("gpu64") if key.startswith("n64") else None
        if work is None:     # counted on these rows by §3's check, or here
            work = {}
            event_scan.event_times_plain(rows, table, work=work)
        s_bound, s_by = scan_bound(table, B, n, work)
        host_rows = rows.cpu().numpy().astype(np.int64)
        sim = BatchedEventSim(PackedKernels.for_table(table))
        t0 = time.perf_counter()
        sim.times(host_rows, [None] * B)
        host_ms = (time.perf_counter() - t0) * 1e3
        ms = timed(f"event_scan.{key}",
                   lambda: event_scan.event_times(rows, table), n=20, warm=3)
        steps = work["head_steps"] + work["completions"] + work["solo"]
        plan = event_plan_of(event_scan, table, n)
        scan_t[key] = {
            "ms": ms,
            "plain_ms": timed(f"event_scan.{key}.plain",
                              lambda: event_scan.event_times_plain(rows,
                                                                   table),
                              n=1, warm=0, repeats=1),
            "library_ms": None,
            "host_batched_event_sim_ms": host_ms,
            "orders_per_s": B / ms * 1e3,
            "bound_ms": s_bound, "bound_by": s_by, "work": work,
            "serial_steps_per_row": steps / B,
            "plan": {"name": plan.name, **plan._asdict()},
            "shape": f"rows ({B}, {n}) int32, GTX580 table of "
                     f"{len(table.kernels)} kernels"}
        # device time per launch, without the wrapper's host sync; per
        # serial step (bursts, completions and solo drains of all rows)
        us = profiled_us(lambda: event_scan.event_times(rows, table),
                         "event_scan")
        scan_t[key]["device_us_per_launch"] = us
        scan_t[key]["device_orders_per_s"] = B / us * 1e6
        scan_t[key]["device_ns_per_step"] = us * 1e3 / steps
        del rows
    kern["event_scan"] = scan_t["EpBsEsSw-8_B40320"]
    # the selective scan at jamba's shape, B 1 and B 8, with B and C
    # contiguous and as the prefill passes them (slices of the (B, T, 288)
    # projection); plain one repeat of one call; device time per launch
    # from a profile
    mamba_t = {}
    for B, strided in ((1, False), (8, False), (1, True), (8, True)):
        ins = scan_inputs(randn, B, 4096, 8192, 16, torch.bfloat16,
                          strided=strided)
        key = f"B{B}{'_strided' if strided else ''}"
        m_bound, m_by, m_terms = mamba_bound(B, 4096, 8192, 16,
                                             torch.bfloat16)
        ms = timed(f"mamba_scan.{key}", lambda: mamba_scan(*ins), n=20,
                   warm=3)
        plain = None if strided else timed(
            f"mamba_scan.{key}.plain", lambda: mamba_scan_plain(*ins), n=1,
            warm=0, repeats=1)
        us = profiled_us(lambda: mamba_scan(*ins), "mamba_scan")
        mamba_t[key] = {
            "ms": ms, "plain_ms": plain, "library_ms": None,
            "device_us_per_launch": us,
            "share_of_bound": m_bound * 1e3 / us,
            "bound_ms": m_bound, "bound_by": m_by, "bound_terms": m_terms,
            "shape": f"x, dt ({B}, 4096, 8192), bm, cm ({B}, 4096, 16) "
                     f"bf16{' (slices of a (B, 4096, 288) projection)' if strided else ''}, "
                     "a (8192, 16), d (8192,) f32"}
        del ins
    torch.cuda.empty_cache()
    kern["mamba_scan"] = mamba_t["B1"]
    report["times"] = {"rmsnorm": kern["rmsnorm"],
                       "decode_attention": att,
                       "flash_attention": flash_t,
                       "event_scan": scan_t,
                       "mamba_scan": mamba_t,
                       "repeats_ms": repeats}
    for label, t in [("rmsnorm", kern["rmsnorm"])] + [
                        (f"decode_attention {key}", t)
                        for key, t in att.items()] + [
                        (f"flash_attention {key} (n 20, plain n 5)", t)
                        for key, t in flash_t.items()]:
        plain = ("not timed" if t["plain_ms"] is None
                 else f"{t['plain_ms']:.5f} ms")
        print(f"[times] {label}: kernel {t['ms']:.5f} ms, plain "
              f"{plain}, library {t['library_ms']:.5f} ms, "
              f"bound {t['bound_ms']:.3e} ms ({t['bound_by']}) "
              f"[{t['shape']}]")
    for key, t in rms_dev.items():
        warm = ("L2-resident" if t["rotation_bytes"] <= t["l2_bytes"]
                else "past L2")
        print(f"[times] rmsnorm {key} device (CUDA graph of 50 calls over "
              f"{t['inputs_rotated']} input(s), {t['rotation_bytes']} bytes, "
              f"{warm}): kernel {t['kernel_device_us']:.2f} us per launch, "
              f"F.rms_norm {t['library_device_us']:.2f} us per call, bound "
              f"{t['bound_us']:.3f} us ({t['bound_by']}; the kernel at "
              f"{t['bound_us'] / t['kernel_device_us']:.1%} of it) "
              f"[{t['shape']}]")
    for key, t in att.items():
        print(f"[times] decode_attention {key} device (CUDA graph of 50 "
              f"calls): kernel {t['device_us']:.2f} us per launch, SDPA "
              f"{t['library_device_us']:.2f} us per call, bound "
              f"{t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}) "
              f"[{t['shape']}]")
    for key, t in scan_t.items():
        print(f"[times] event_scan {key} (n 20; plain n 1, one repeat): "
              f"kernel {t['ms']:.5f} ms ({t['orders_per_s']:.4g} orders/s), "
              f"device {t['device_us_per_launch']:.1f} us per launch "
              f"(profiler; {t['device_orders_per_s']:.4g} orders/s, "
              f"{t['device_ns_per_step']:.3f} ns per serial step at "
              f"{t['serial_steps_per_row']:.2f} steps a row; plan "
              f"{t['plan']['name']}, width {t['plan']['width']}), "
              f"plain {t['plain_ms']:.3f} ms, library — (no single PyTorch "
              f"call computes the event model), host BatchedEventSim "
              f"(NumPy float64 yardstick, one call) "
              f"{t['host_batched_event_sim_ms']:.1f} ms, bound {t['bound_ms']:.3e} ms ({t['bound_by']}; "
              f"{t['work']}) [{t['shape']}]")
    for key, t in mamba_t.items():
        terms = ", ".join(f"{k} {v:.4g}" for k, v in t["bound_terms"].items())
        plain = ("not timed" if t["plain_ms"] is None
                 else f"{t['plain_ms']:.3f} ms")
        print(f"[times] mamba_scan {key} (n 20; plain n 1, one repeat): "
              f"kernel {t['ms']:.5f} ms, device "
              f"{t['device_us_per_launch']:.1f} us per launch (profiler, "
              f"{t['share_of_bound']:.1%} of the bound), "
              f"plain {plain}, library — (no single PyTorch "
              f"call computes the selective scan), bound "
              f"{t['bound_ms']:.4g} ms ({t['bound_by']}; {terms}; exps at "
              f"16 per SM per clock, 1.98 GHz) [{t['shape']}]")

    # 5. serving at full width -------------------------------------------
    print("[serve] qwen1.5-0.5b full, 8 requests, max_len 512, 32 new "
          "tokens each, policy symbiotic, bf16, seed 0")
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    stats = serve("qwen1.5-0.5b", variant="full", n_requests=8, max_len=512,
                  max_new_tokens=32, policy="symbiotic")
    counts = launch_counts()
    outputs = stats["outputs"]
    n_steps = stats["prompt_tokens"] + sum(len(t) - 1
                                           for t in outputs.values())
    require(len(outputs) == 8 and all(len(t) == 32
                                      for t in outputs.values()),
            f"not every request finished: {outputs}")
    require(stats["latency"]["completed"] == 8, "latency tracker: "
            f"{stats['latency']['completed']} of 8 completed")
    print(f"[serve] decode_steps={n_steps} launches={counts} "
          f"(want rmsnorm {49 * n_steps}, decode_attention {24 * n_steps})")
    require(counts == {"rmsnorm": 49 * n_steps,
                       "decode_attention": 24 * n_steps,
                       "flash_attention": 0, "event_scan": 0,
                       "mamba_scan": 0},
            "the main path did not run the kernels once per layer")
    serve_counts = counts
    cfg_full = get_config("qwen1.5-0.5b", "full")
    n_params = 463_987_712
    floor_ms = 2 * n_params / HBM_BPS * 1e3
    serving = {
        "rounds": stats["rounds"],
        "modelled_time_s_v5e_cost_model": stats["modelled_time_s"],
        "wall_s": stats["wall_s"],
        "new_tokens": stats["total_new_tokens"],
        "tokens_per_s": stats["total_new_tokens"] / stats["wall_s"],
        "decode_steps": n_steps,
        "ms_per_decode_step": stats["wall_s"] * 1e3 / n_steps,
        "weight_read_floor_ms": floor_ms,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "prompt_tokens": stats["prompt_tokens"],
        "launches": counts,
    }
    report["serving"] = serving
    print(f"[serve] rounds={serving['rounds']} modelled_time_s (TPU v5e "
          f"round cost model, not this card)="
          f"{serving['modelled_time_s_v5e_cost_model']:.6e}")
    print(f"[serve] wall_s={serving['wall_s']:.3f} (synchronised) "
          f"tokens/s={serving['tokens_per_s']:.2f} "
          f"ms/decode_step={serving['ms_per_decode_step']:.4f} "
          f"(weight-read floor {floor_ms:.4f} ms = 0.928 GB / 3.35 TB/s) "
          f"max_memory_allocated={serving['max_memory_allocated_bytes']}")

    # full-width replay of request 0: finite logits, the served token
    rng = np.random.default_rng(0)
    plen = int(rng.integers(4, max(5, 512 // 4)))
    prompt = rng.integers(0, cfg_full.vocab, size=plen)
    params = T.init(cfg_full, seed=0, device=dev)
    require(T.count_params(params) == n_params, "full qwen parameter count")
    cache = T.init_cache(cfg_full, 1, 512, device=dev)
    with torch.inference_mode():
        for pos, tok in enumerate(prompt):
            logits, cache = T.decode_step(
                params, cfg_full, torch.tensor([int(tok)], device=dev),
                cache, pos)
    require(tuple(logits.shape) == (1, cfg_full.vocab),
            f"logits shape {tuple(logits.shape)}")
    require(bool(torch.isfinite(logits).all()), "non-finite logits")
    first = int(torch.argmax(logits[0]))
    require(first == outputs[0][0],
            f"replayed first token {first} != served {outputs[0][0]}")
    print(f"[serve] full-width replay of request 0: logits (1, "
          f"{cfg_full.vocab}) finite, first token {first} as served")

    # 6. profile of full-width decode steps ------------------------------
    n_prof = 16
    with torch.inference_mode():   # the same steps, unprofiled
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n_prof):
            logits, cache = T.decode_step(
                params, cfg_full, torch.tensor([first], device=dev),
                cache, plen + i)
        torch.cuda.synchronize()
        wall_plain = time.perf_counter() - t0
    next_pos = [plen + n_prof]

    def steps():   # n_prof more steps, each session at new positions
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n_prof):
            T.decode_step(params, cfg_full,
                          torch.tensor([first], device=dev), cache,
                          next_pos[0] + i)
        torch.cuda.synchronize()
        next_pos[0] += n_prof
        return time.perf_counter() - t0
    with torch.inference_mode():
        rows, wall, _ = profiled(steps)
    busy_us = sum(r[1] for r in rows)
    da = [r for r in rows if "decode_attention" in r[0]]
    require(bool(da), "profile: no decode-attention launch in the steps")
    da_us = sum(r[1] for r in da)
    prof_rep = {"steps": n_prof,
                "decode_attention_device_us_per_launch":
                    da_us / sum(r[2] for r in da),
                "decode_attention_launches_per_step":
                    sum(r[2] for r in da) / n_prof,
                "decode_attention_device_ms_per_step": da_us / 1e3 / n_prof,
                "decode_attention_share_of_device_time": da_us / busy_us,
                "unprofiled_wall_ms_per_step": wall_plain * 1e3 / n_prof,
                "wall_ms_per_step": wall * 1e3 / n_prof,
                "device_busy_ms_per_step": busy_us / 1e3 / n_prof,
                "device_events_per_step": sum(r[2] for r in rows) / n_prof,
                "device_busy_share": busy_us / 1e6 / wall_plain,
                "top": [{"name": n[:80], "device_us_per_step": t / n_prof,
                         "calls_per_step": c / n_prof}
                        for n, t, c in rows[:12]]}
    print(f"[profile] {n_prof} steps: wall {wall_plain * 1e3 / n_prof:.3f}"
          f" ms/step ({wall * 1e3 / n_prof:.3f} under the profiler), "
          f"device busy {prof_rep['device_busy_share']:.1%} of it: "
          f"{busy_us / 1e3 / n_prof:.3f} ms/step in "
          f"{prof_rep['device_events_per_step']:.0f} kernels and copies")
    print(f"[profile] decode attention: "
          f"{prof_rep['decode_attention_device_us_per_launch']:.2f} us per "
          f"launch, {prof_rep['decode_attention_launches_per_step']:.0f} "
          f"launches per step, "
          f"{prof_rep['decode_attention_device_ms_per_step']:.4f} ms per "
          f"step, {prof_rep['decode_attention_share_of_device_time']:.1%} "
          f"of device time")
    for r in prof_rep["top"][:8]:
        print(f"[profile]   {r['device_us_per_step']:9.2f} us/step "
              f"x{r['calls_per_step']:.0f}  {r['name']}")
    report["profile"] = prof_rep
    del cache

    # 7. prefill at full width ---------------------------------------------
    print(f"[prefill] qwen1.5-0.5b full, bf16, seed 0: prefill_logits at "
          f"B 8 x S 4096 and B 1 x S {spec_32k.seq_len} ({spec_32k.name}'s "
          f"sequence, its global batch {spec_32k.global_batch} cut to 1)")
    prefill_rep = {}
    reset_launch_counts()
    n_calls = 0
    for B, S in ((8, 4096), (1, spec_32k.seq_len)):
        toks = torch.randint(0, cfg_full.vocab, (B, S), generator=gen)
        toks = toks.to(dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        with torch.inference_mode():
            for _ in range(4):   # the first call warms up, three are timed
                t0 = time.perf_counter()
                logits = T.prefill_logits(params, cfg_full, toks)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            def call():
                t0 = time.perf_counter()
                T.prefill_logits(params, cfg_full, toks)
                torch.cuda.synchronize()
                return time.perf_counter() - t0
            rows, wall_prof, sessions = profiled(call)
        n_calls += 4 + sessions
        counts = launch_counts()
        require(counts == {"rmsnorm": 49 * n_calls, "decode_attention": 0,
                           "flash_attention": 24 * n_calls,
                           "event_scan": 0, "mamba_scan": 0},
                f"prefill B {B} x S {S}: launches {counts} after {n_calls} "
                "calls; want 24 flash and 49 RMSNorm per call")
        require(tuple(logits.shape) == (B, cfg_full.vocab),
                f"prefill logits shape {tuple(logits.shape)}")
        require(bool(torch.isfinite(logits).all()),
                "non-finite prefill logits")
        fl = [r for r in rows if "flash_attention" in r[0]]
        require(len(fl) >= 1 and sum(r[2] for r in fl) == 24,
                f"profile: flash launches {[(r[0][:40], r[2]) for r in fl]}")
        flash_us = sum(r[1] for r in fl)
        busy_us = sum(r[1] for r in rows)
        ms = float(np.median(walls[1:])) * 1e3
        rep = {"B": B, "S": S, "wall_ms_median_of_3": ms,
               "wall_ms": [w * 1e3 for w in walls],
               "prompt_tokens_per_s": B * S / ms * 1e3,
               "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
               "profiled_wall_ms": wall_prof * 1e3,
               "device_busy_ms": busy_us / 1e3,
               "flash_device_us_per_launch": flash_us / 24,
               "flash_share_of_device_time": flash_us / busy_us,
               "top": [{"name": n[:80], "device_us": t, "calls": c}
                       for n, t, c in rows[:10]]}
        prefill_rep[f"B{B}xS{S}"] = rep
        print(f"[prefill] B {B} x S {S}: {ms:.1f} ms per call (median of 3, "
              f"synchronised; first call {walls[0] * 1e3:.1f} ms), "
              f"{rep['prompt_tokens_per_s']:.0f} prompt tokens/s, peak "
              f"memory {rep['max_memory_allocated_bytes']} bytes, logits "
              f"{tuple(logits.shape)} finite")
        print(f"[prefill]   profiled call: {wall_prof * 1e3:.1f} ms wall, "
              f"device busy {busy_us / 1e3:.1f} ms, flash attention "
              f"{flash_us / 24:.1f} us per launch x24 "
              f"({rep['flash_share_of_device_time']:.1%} of device time)")
        if ms > 10_000:
            print(f"[prefill]   slow: {ms / 1e3:.1f} s per call")
        del toks, logits
    prefill_counts = launch_counts()
    print(f"[prefill] launches over {n_calls} calls: {prefill_counts}")
    report["prefill"] = prefill_rep
    del params

    # 8. forward checks ---------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[forward] TF32 off (matmul and cuDNN): f32 computes f32")
    fwd_rep = {}
    cfg32 = cfg_full.replace(dtype="float32")
    params32 = T.init(cfg32, seed=0, device=dev)
    toks = torch.randint(0, cfg32.vocab, (2, 1024), generator=gen).to(dev)
    with torch.inference_mode():
        a = T.prefill_logits(params32, cfg32, toks)
        b = T.prefill_logits(params32, cfg32, toks, impl="xla")
    diff = (a - b).abs().max().item()
    same = bool((a.argmax(-1) == b.argmax(-1)).all())
    print(f"[forward] qwen full f32 B 2 x S 1024: prefill_logits kernels vs "
          f"impl='xla' max diff {diff:.3e} (bound 1e-3), same argmax {same}")
    require(diff < 1e-3 and same, "prefill_logits: kernels vs xla differ")
    fwd_rep["kernel_vs_xla_max_diff"] = diff

    # kernel 3 (whole prompt) against kernel 2 (one position at a time)
    prompt = torch.randint(0, cfg32.vocab, (1, 64), generator=gen).to(dev)
    with torch.inference_mode():
        full = T.prefill_logits(params32, cfg32, prompt)
        # prefill()'s replay into an f32 cache: the same arithmetic
        cache = T.init_cache(cfg32, 1, 64, dtype=torch.float32, device=dev)
        for pos in range(64):
            last, cache = T.decode_step(params32, cfg32, prompt[:, pos],
                                        cache, pos)
        # prefill() itself, into its bf16 cache
        last_bf16, _ = T.prefill(params32, cfg32, prompt, 64)
    diff = (full - last).abs().max().item()
    same = bool((full.argmax(-1) == last.argmax(-1)).all())
    diff16 = (full - last_bf16).abs().max().item()
    same16 = bool((full.argmax(-1) == last_bf16.argmax(-1)).all())
    spread = full.std().item()
    print(f"[forward] 64-token prompt: prefill_logits vs decode replay (f32 "
          f"cache) max diff {diff:.3e} (bound 1e-3), same argmax {same}; vs "
          f"prefill() (bf16 cache) max diff {diff16:.3e} (bound 5% of the "
          f"logits' std {spread:.3f}), same argmax {same16}")
    require(diff < 1e-3 and same, "prefill_logits vs decode replay differ")
    require(diff16 < 0.05 * spread and same16,
            "prefill_logits vs prefill() differ beyond bf16 cache rounding")
    fwd_rep.update(replay_f32_cache_max_diff=diff,
                   replay_bf16_cache_max_diff=diff16, logits_std=spread)
    del params32, cache

    cfg_h = get_config("hubert-xlarge", "full")
    params_h = T.init(cfg_h, seed=0, device=dev)
    frames = randn(1, 1000, cfg_h.d_model, dtype=cfg_h.compute_dtype)
    reset_launch_counts()
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, aux = T.forward(params_h, cfg_h, frames)
        torch.cuda.synchronize()
        hub_ms = (time.perf_counter() - t0) * 1e3
    hub_counts = launch_counts()
    print(f"[forward] hubert-xlarge full bf16 B 1 x S 1000: logits "
          f"{tuple(logits.shape)}, {hub_ms:.1f} ms (one call, cold), "
          f"launches {hub_counts}")
    require(hub_counts["flash_attention"] == 48,
            f"hubert forward: {hub_counts['flash_attention']} flash launches, "
            "want 48")
    require(tuple(logits.shape) == (1, 1000, cfg_h.vocab)
            and bool(torch.isfinite(logits).all())
            and all(float(v) == 0.0 for v in aux.values()),
            "hubert forward: bad logits or aux")
    fwd_rep["hubert"] = {"launches": hub_counts, "wall_ms_cold": hub_ms}
    report["forward"] = fwd_rep
    del params_h, frames, logits

    # 9. card vs CPU, smoke configs in f32 --------------------------------
    # the flat engine on four archs; the dependency-aware one
    # (respect_deps) on the three traced archs, whose tokens must be the
    # flat path's.  MLA's decode rounds its softmax weights to the cache
    # dtype (as the reference does), so on deepseek a bf16 cache turns a
    # last-bit difference of the two devices' sums into a bf16 rounding
    # flip: its replay is held at 1e-3 in an f32 cache and at 1e-2 in the
    # bf16 one
    report["card_vs_cpu"] = {}
    tiny_slots = make_serving_device(token_budget=6)
    deps_policies = {
        "unsliced": {},
        "sliced": {"slice_policy": SlicePolicy(), "dag_guard": "gated"},
        "incremental_sliced": {"slice_policy": SlicePolicy(),
                               "dag_guard": "gated",
                               "composition": "incremental"}}
    for arch in ("qwen1.5-0.5b", "jamba-v0.1-52b", "mixtral-8x7b",
                 "deepseek-v2-236b"):
        cfg = get_config(arch, "smoke").replace(dtype="float32")
        deps = arch != "jamba-v0.1-52b"
        mla = cfg.attn_type == "mla"
        side = {}
        for where in ("cuda", "cpu"):
            params = T.init(cfg, seed=0, device=where)
            rng = np.random.default_rng(1)
            reqs = [Request(i, rng.integers(0, cfg.vocab,
                                            size=int(rng.integers(4, 16))),
                            max_new_tokens=8) for i in range(4)]
            eng = ServingEngine(cfg, params, max_len=64,
                                policy=SchedulerPolicy(kind="symbiotic"))
            eng.submit(reqs)
            out = eng.run()
            out_d = None
            if deps:
                # respect_deps unsliced, then sliced and sliced through the
                # live composition, two requests arriving at iteration 2
                # so that prefills meet decodes; the sliced ones on a
                # 6-token slot budget (the smoke prompts' prefill stages
                # oversized) under the gated guard, the currency in which
                # slices co-executing with decodes win; a trace counts
                # the rounds that hold a slice
                out_d = {}
                for key, kw in deps_policies.items():
                    eng = ServingEngine(cfg, params, max_len=64,
                                        device=(tiny_slots if "slice_policy"
                                                in kw else None),
                                        trace=ScheduleTrace(),
                                        policy=SchedulerPolicy(
                                            kind="symbiotic",
                                            respect_deps=True, **kw))
                    fresh = [Request(r.rid, r.prompt, max_new_tokens=8)
                             for r in reqs]
                    eng.submit(fresh[:2])
                    out_d[key] = eng.run(arrivals=[(2, fresh[2:])])
                    out_d[key]["slice_rounds"] = slice_rounds(eng.trace)
                    require(out_d[key]["outputs"] == out["outputs"],
                            f"{arch} on {where}: respect_deps ({key}) tokens "
                            "differ from the flat path's")

            def replay(dtype):
                cache = T.init_cache(cfg, 1, 64, dtype, device=where)
                lg = []
                for pos, tok in enumerate(reqs[0].prompt.tolist() +
                                          out["outputs"][0][:-1]):
                    logits, cache = T.decode_step(
                        params, cfg, torch.tensor([tok], device=where),
                        cache, pos)
                    lg.append(logits.cpu())
                return torch.cat(lg)
            with torch.inference_mode():
                lg = replay(torch.float32 if mla else torch.bfloat16)
                lg16 = replay(torch.bfloat16) if mla else None
                toks = torch.from_numpy(rng.integers(0, cfg.vocab,
                                                     size=(2, 48)))
                pre = T.prefill_logits(params, cfg, toks.to(where)).cpu()
            side[where] = (out, lg, pre, out_d, lg16)
        ((o_gpu, l_gpu, p_gpu, d_gpu, l16_gpu),
         (o_cpu, l_cpu, p_cpu, d_cpu, l16_cpu)) = side["cuda"], side["cpu"]
        diff = (l_gpu - l_cpu).abs().max().item()
        pdiff = (p_gpu - p_cpu).abs().max().item()
        cache_kind = "f32" if mla else "bf16"
        print(f"[card/cpu] {arch} smoke: tokens identical: "
              f"{o_gpu['outputs'] == o_cpu['outputs']}; rounds "
              f"{o_gpu['rounds']} vs {o_cpu['rounds']}; max logit diff "
              f"{diff:.3e} (bound 1e-3, {cache_kind} cache) over "
              f"{l_gpu.shape[0]} positions; prefill_logits B 2 x S 48 max "
              f"diff {pdiff:.3e} (bound 1e-3)")
        require(o_gpu["outputs"] == o_cpu["outputs"],
                f"{arch}: card and CPU tokens differ")
        require(o_gpu["rounds"] == o_cpu["rounds"] and
                o_gpu["modelled_time_s"] == o_cpu["modelled_time_s"],
                f"{arch}: card and CPU compose different rounds")
        require(diff < 1e-3, f"{arch}: card and CPU logits differ by {diff}")
        require(pdiff < 1e-3,
                f"{arch}: card and CPU prefill logits differ by {pdiff}")
        rec = {"max_logit_diff": diff, "replay_cache": cache_kind,
               "prefill_logits_max_diff": pdiff,
               "positions": int(l_gpu.shape[0])}
        if mla:
            diff16 = (l16_gpu - l16_cpu).abs().max().item()
            print(f"[card/cpu] {arch} smoke: bf16-cache replay max logit "
                  f"diff {diff16:.3e} (bound 1e-2)")
            require(diff16 < 1e-2, f"{arch}: card and CPU logits differ by "
                    f"{diff16} with a bf16 cache")
            rec["max_logit_diff_bf16_cache"] = diff16
        for key in (d_gpu or {}):
            g, c = d_gpu[key], d_cpu[key]
            sc = g["schedule_cache"]
            print(f"[card/cpu] {arch} smoke respect_deps {key}: tokens "
                  f"identical on both devices and to the flat path's: "
                  f"{g['outputs'] == c['outputs']}; rounds {g['rounds']} vs "
                  f"{c['rounds']} (flat {o_gpu['rounds']}), slice rounds "
                  f"{g['slice_rounds']} vs {c['slice_rounds']}; modelled_time_s "
                  f"equal: {g['modelled_time_s'] == c['modelled_time_s']}; "
                  f"stats equal: {sc == c['schedule_cache']} (dag_hits "
                  f"{sc['dag_hits']}, incremental_joins "
                  f"{sc['incremental_joins']}, incremental_leaves "
                  f"{sc['incremental_leaves']}, frontier_rebuilds "
                  f"{sc['frontier_rebuilds']})")
            require(g["outputs"] == c["outputs"]
                    and g["rounds"] == c["rounds"]
                    and g["slice_rounds"] == c["slice_rounds"]
                    and g["modelled_time_s"] == c["modelled_time_s"]
                    and g["schedule_cache"] == c["schedule_cache"],
                    f"{arch}: respect_deps ({key}) differs between card and "
                    "CPU")
            rec[f"respect_deps_{key}"] = {
                "rounds": g["rounds"], "slice_rounds": g["slice_rounds"],
                "modelled_time_s_v5e_cost_model": g["modelled_time_s"],
                "schedule_cache": sc}
        if d_gpu:
            require(d_gpu["incremental_sliced"]["schedule_cache"]
                    ["incremental_joins"] >= 1
                    and d_gpu["sliced"]["slice_rounds"] >= 1
                    and d_gpu["incremental_sliced"]["slice_rounds"] >= 1,
                    f"{arch}: the live composition joined no chain, or no "
                    "stage was sliced")
        report["card_vs_cpu"][arch] = rec
        del side, params, eng

    # 10. the design space of the six experiments ------------------------
    print("[design_space] the paper's Fig. 1 / Table 3 protocol on the "
          "GTX580 model: every launch order, Algorithm 1's and the refined "
          "one, one event-scan launch per experiment")
    reset_launch_counts()
    t0 = time.perf_counter()
    space_rep = design_space(core, event_scan, dev, errs["event_scan"])
    space_s = time.perf_counter() - t0
    space_counts = launch_counts()
    print(f"[design_space] launches {space_counts} in {space_s:.1f} s "
          "(with the checks)")
    require(space_counts == {"rmsnorm": 0, "decode_attention": 0,
                             "flash_attention": 0,
                             "event_scan": len(core.EXPERIMENTS),
                             "mamba_scan": 0},
            "the design space did not run one event scan per experiment")
    report["design_space"] = space_rep

    # 11. refined serving at full width ----------------------------------
    refined_rep = {}
    for kw in ({}, {"refine_model": "event", "refine_backend": "batched"}):
        label = ", ".join(f"{k}={v}" for k, v in kw.items()) or \
            "refine_model=rounds (default)"
        print(f"[serve-refined] qwen1.5-0.5b full, §5's 8 requests, policy "
              f"refined, {label}")
        reset_launch_counts()
        st = serve("qwen1.5-0.5b", variant="full", n_requests=8,
                   max_len=512, max_new_tokens=32, policy="refined", **kw)
        counts = launch_counts()
        steps = st["prompt_tokens"] + sum(len(t) - 1
                                          for t in st["outputs"].values())
        require(st["outputs"] == outputs,
                f"refined serving ({label}): tokens differ from §5's")
        require(st["latency"]["completed"] == 8,
                f"refined serving ({label}): not every request finished")
        require(counts == {"rmsnorm": 49 * steps,
                           "decode_attention": 24 * steps,
                           "flash_attention": 0, "event_scan": 0,
                           "mamba_scan": 0},
                f"refined serving ({label}): launches {counts}")
        ph = st["phases"]
        eng_steps = max(ph["compose"]["calls"], 1)
        rep = {"rounds": st["rounds"],
               "modelled_time_s_v5e_cost_model": st["modelled_time_s"],
               "phase_refine_ms_per_step":
                   ph["refine"]["total_s"] * 1e3 / eng_steps,
               "phase_refine_calls": ph["refine"]["calls"],
               "engine_steps": eng_steps,
               "wall_s": st["wall_s"],
               "ms_per_decode_step": st["wall_s"] * 1e3 / steps,
               "new_tokens": st["total_new_tokens"],
               "tokens_per_s": st["total_new_tokens"] / st["wall_s"],
               "schedule_cache": st["schedule_cache"],
               "launches": counts}
        refined_rep[kw.get("refine_model", "rounds")] = rep
        print(f"[serve-refined]   rounds={rep['rounds']} (symbiotic "
              f"{serving['rounds']}), modelled_time_s (TPU v5e round cost "
              f"model, not this card)="
              f"{rep['modelled_time_s_v5e_cost_model']:.6e} "
              f"(symbiotic {serving['modelled_time_s_v5e_cost_model']:.6e}); "
              f"phase_refine {rep['phase_refine_ms_per_step']:.3f} ms per "
              f"engine step ({rep['phase_refine_calls']} refinements over "
              f"{eng_steps} steps); wall_s={rep['wall_s']:.3f} "
              f"tokens/s={rep['tokens_per_s']:.2f} "
              f"ms/decode_step={rep['ms_per_decode_step']:.4f}; tokens "
              "identical to §5's")
    report["serve_refined"] = refined_rep

    # full-width models (§12–§18): seeded weights drawn on the card, prefill
    # calls and served requests with exact launch counts, decode profiles
    def draw(cfg, tag: str):
        """Seeded weights drawn on the card (the previous model freed)."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        p = T.init(cfg, seed=0, device=dev, draw_device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n = T.count_params(p)
        esize = torch.empty(0, dtype=cfg.compute_dtype).element_size()
        print(f"[{tag}] init {init_s:.2f} s, {n} parameters "
              f"({esize * n / 1e9:.2f} GB in {cfg.dtype}), card memory "
              f"allocated {torch.cuda.memory_allocated()} bytes")
        return p, n, init_s

    def prefill_runs(tag, params, cfg, B, S, want, on_prof=None):
        """Four ``prefill_logits`` calls (the first warms up) and one
        profiled, the launch counters set to 0 just before and read just
        after: each must equal ``want`` per call."""
        toks = torch.randint(0, cfg.vocab, (B, S), generator=gen).to(dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        walls = []
        with torch.inference_mode():
            for _ in range(4):
                t0 = time.perf_counter()
                logits = T.prefill_logits(params, cfg, toks)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)

            def call():
                t0 = time.perf_counter()
                T.prefill_logits(params, cfg, toks)
                torch.cuda.synchronize()
                return time.perf_counter() - t0
            rows, wall_prof, sessions = profiled(call, on_prof=on_prof)
        n_calls = 4 + sessions
        counts = launch_counts()
        full = {k: want.get(k, 0) * n_calls for k in counts}
        require(counts == full, f"{tag} prefill B {B} x S {S}: launches "
                f"{counts} after {n_calls} calls; want {want} per call")
        require(tuple(logits.shape) == (B, cfg.vocab)
                and bool(torch.isfinite(logits).all()),
                f"{tag} prefill logits {tuple(logits.shape)} not finite")
        ms = float(np.median(walls[1:])) * 1e3
        busy_us = sum(r[1] for r in rows)
        # bytes: every weight read once (the embedding's rows are
        # gathered, not read), 2 bytes each in bf16
        esize = torch.empty(0, dtype=cfg.compute_dtype).element_size()
        w_bytes = esize * (T.count_params(params) - cfg.vocab * cfg.d_model)
        b_ms, b_by = bound(w_bytes, prefill_ops(cfg, params, B, S),
                           cfg.compute_dtype)
        rep = {"B": B, "S": S, "wall_ms_median_of_3": ms,
               "wall_ms": [w * 1e3 for w in walls],
               "prompt_tokens_per_s": B * S / ms * 1e3,
               "bound_ms": b_ms, "bound_by": b_by,
               "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
               "profiled_wall_ms": wall_prof * 1e3,
               "device_busy_ms": busy_us / 1e3,
               "launches_per_call": want, "launches": counts,
               "top": [{"name": n[:80], "device_us": t, "calls": c}
                       for n, t, c in rows[:10]]}
        print(f"[{tag}] prefill_logits B {B} x S {S}: {ms:.1f} ms per call "
              f"(median of 3, synchronised; first call {walls[0] * 1e3:.1f} "
              f"ms) against a {b_ms:.1f} ms bound ({b_by}: 3.35 TB/s, "
              f"989 TFLOP/s), "
              f"{rep['prompt_tokens_per_s']:.0f} prompt tokens/s, peak "
              f"memory {rep['max_memory_allocated_bytes']} bytes, logits "
              f"{tuple(logits.shape)} finite; launches per call {want}")
        print(f"[{tag}]   profiled call: {wall_prof * 1e3:.1f} ms wall, "
              f"device busy {busy_us / 1e3:.1f} ms; top device kernels:")
        for r in rep["top"][:8]:
            print(f"[{tag}]     {r['device_us'] / 1e3:9.3f} ms "
                  f"x{r['calls']:<4d} {r['name']}")
        return rep, rows

    def serve_runs(tag, params, cfg, want):
        """§5's 8 requests through ServingEngine (symbiotic, max_len 512,
        32 new tokens), the counters set to 0 just before and read just
        after: ``want`` launches per ``decode_step``."""
        rng = np.random.default_rng(0)
        reqs = []
        for i in range(8):   # serve()'s seeded requests, as in §5
            plen = int(rng.integers(4, max(5, 512 // 4)))
            reqs.append(Request(i, rng.integers(0, cfg.vocab, size=plen),
                                max_new_tokens=32))
        eng = ServingEngine(cfg, params, max_len=512,
                            policy=SchedulerPolicy(kind="symbiotic"))
        eng.submit(reqs)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        st = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        outs = st["outputs"]
        steps = sum(len(r.prompt) for r in reqs) + sum(len(t) - 1
                                                       for t in outs.values())
        require(len(outs) == 8 and all(len(t) == 32 for t in outs.values()),
                f"{tag}: not every request finished: {outs}")
        full = {k: want.get(k, 0) * steps for k in counts}
        require(counts == full, f"{tag}: launches {counts} over {steps} "
                f"decode steps; want {want} per step")
        n = T.count_params(params)
        floor_ms = 2 * (n - cfg.vocab * cfg.d_model) / HBM_BPS * 1e3
        rep = {"rounds": st["rounds"],
               "modelled_time_s_v5e_cost_model": st["modelled_time_s"],
               "wall_s": wall, "decode_steps": steps,
               "ms_per_decode_step": wall * 1e3 / steps,
               "new_tokens": st["total_new_tokens"],
               "tokens_per_s": st["total_new_tokens"] / wall,
               "weight_read_floor_ms": floor_ms,
               "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
               "launches": counts}
        print(f"[{tag}] rounds={st['rounds']} modelled_time_s (TPU v5e round "
              f"cost model, not this card)={st['modelled_time_s']:.6e}; "
              f"wall_s={wall:.3f} (synchronised) tokens/s="
              f"{rep['tokens_per_s']:.2f} ms/decode_step="
              f"{rep['ms_per_decode_step']:.4f} over {steps} steps against "
              f"a {floor_ms:.4f} ms weight-read floor (every weight but the "
              f"embedding rows, 2 bytes each, at 3.35 TB/s; static-capacity "
              f"MoE reads every expert); launches {counts}")
        return rep, outs

    def step_profile(tag, params, cfg, n_steps=16):
        """Device busy share of ``n_steps`` batch-1 ``decode_step``s on a
        512-slot cache after 8 warm steps."""
        cache = T.init_cache(cfg, 1, 512, device=dev)
        tok = torch.zeros((1,), dtype=torch.long, device=dev)
        with torch.inference_mode():
            for pos in range(8):
                _, cache = T.decode_step(params, cfg, tok, cache, pos)
            torch.cuda.synchronize()

            def steps():
                t0 = time.perf_counter()
                c = cache
                for pos in range(8, 8 + n_steps):
                    _, c = T.decode_step(params, cfg, tok, c, pos)
                torch.cuda.synchronize()
                return time.perf_counter() - t0
            rows, wall, _ = profiled(steps)
        busy_us = sum(r[1] for r in rows)
        rep = {"steps": n_steps, "wall_ms_per_step": wall * 1e3 / n_steps,
               "device_busy_ms_per_step": busy_us / 1e3 / n_steps,
               "device_busy_share": busy_us / 1e6 / wall,
               "device_events_per_step": sum(r[2] for r in rows) / n_steps,
               "top": [{"name": n[:80], "device_us_per_step": t / n_steps,
                        "calls_per_step": c / n_steps}
                       for n, t, c in rows[:10]]}
        print(f"[{tag}] profile of {n_steps} decode steps: "
              f"{rep['wall_ms_per_step']:.3f} ms per step wall, device busy "
              f"{rep['device_busy_ms_per_step']:.3f} ms per step "
              f"({rep['device_busy_share']:.1%}), "
              f"{rep['device_events_per_step']:.0f} kernels and copies per "
              f"step; top:")
        for r in rep["top"][:6]:
            print(f"[{tag}]   {r['device_us_per_step']:9.2f} us/step "
                  f"x{r['calls_per_step']:.0f}  {r['name']}")
        return rep

    def op_device_us(prof, key: str) -> float:
        """Device time of every kernel launched under the CPU op ``key``
        (e.g. ``aten::einsum``: MLA's attention products in a prefill)."""
        return sum(e.device_time_total for e in prof.key_averages()
                   if e.key == key)

    # 12. jamba at full width, one period of depth ------------------------
    cfg_j = get_config("jamba-v0.1-52b", "full").replace(n_layers=8)
    print("[jamba] jamba-v0.1-52b full width, depth cut from 32 to 8 layers "
          "(one period: seven Mamba, one attention, four MoE), bf16, "
          "weights drawn on the card from seed 0")
    params, n_params_j, init_s = draw(cfg_j, "jamba")
    require(n_params_j == 13_295_235_072, f"jamba depth-8 parameters "
            f"{n_params_j}")
    jamba_rep = {"init_s": init_s, "n_params": n_params_j}
    jamba_counts = {}
    for B, S in ((1, 4096), (8, 4096)):
        rep, rows = prefill_runs("jamba", params, cfg_j, B, S,
                                 {"rmsnorm": 17, "flash_attention": 1,
                                  "mamba_scan": 7})
        sc = [r for r in rows if "mamba_scan" in r[0]]
        require(sum(r[2] for r in sc) == 7,
                f"profile: scan launches {[(r[0][:40], r[2]) for r in sc]}")
        scan_us = sum(r[1] for r in sc)
        fl = [r for r in rows if "flash_attention" in r[0]]
        require(sum(r[2] for r in fl) == 1,
                f"profile: flash launches {[(r[0][:40], r[2]) for r in fl]}")
        flash_us = sum(r[1] for r in fl)
        busy_us = rep["device_busy_ms"] * 1e3
        rep.update(mamba_scan_device_us_per_launch=scan_us / 7,
                   mamba_scan_share_of_device_time=scan_us / busy_us,
                   flash_device_us=flash_us,
                   flash_share_of_device_time=flash_us / busy_us)
        print(f"[jamba]   selective scan {scan_us / 7:.1f} us per launch x7 "
              f"({rep['mamba_scan_share_of_device_time']:.1%} of device "
              f"time), flash attention {flash_us:.1f} us x1 "
              f"({rep['flash_share_of_device_time']:.1%})")
        jamba_rep[f"B{B}xS{S}"] = rep
        for k, v in rep["launches"].items():
            jamba_counts[k] = jamba_counts.get(k, 0) + v
    print(f"[jamba] launches over both shapes: {jamba_counts}")

    # 13. jamba served ----------------------------------------------------
    print("[serve-jamba] the same model through ServingEngine: §5's 8 "
          "requests, max_len 512, 32 new tokens each, policy symbiotic")
    jamba_rep["serving"], _ = serve_runs(
        "serve-jamba", params, cfg_j, {"rmsnorm": 17, "decode_attention": 1})

    # 14. jamba in f32: the kernels against the plain twins ---------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg_j32 = cfg_j.replace(dtype="float32")

    def to_f32(tree):   # leaf by leaf, so each bf16 leaf is freed in turn
        for k, v in (tree.items() if isinstance(tree, dict)
                     else enumerate(tree)):
            if isinstance(v, (dict, list)):
                to_f32(v)
            else:
                tree[k] = v.float()

    to_f32(params)
    torch.cuda.empty_cache()
    toks = torch.randint(0, cfg_j.vocab, (1, 512), generator=gen).to(dev)
    with torch.inference_mode():
        a = T.prefill_logits(params, cfg_j32, toks)
        b = T.prefill_logits(params, cfg_j32, toks, impl="xla")
    diff = (a - b).abs().max().item()
    same = bool((a.argmax(-1) == b.argmax(-1)).all())
    print(f"[jamba] f32 (the same weights cast, TF32 off) B 1 x S 512: "
          f"prefill_logits kernels vs impl='xla' max diff {diff:.3e} (bound "
          f"1e-3), same argmax {same}, logits std {a.std().item():.4f}")
    require(bool(torch.isfinite(a).all()) and diff < 1e-3 and same,
            "jamba f32: kernels vs xla differ")
    jamba_rep["f32_kernel_vs_xla_max_diff"] = diff
    report["jamba"] = jamba_rep
    del params, a, b, toks
    torch.cuda.empty_cache()

    # 15. deepseek-v2 at full width, depth cut to 8 layers ----------------
    cfg_d = get_config("deepseek-v2-236b", "full").replace(n_layers=8)
    print("[deepseek] deepseek-v2-236b full width, depth cut from 60 to 8 "
          "layers (one dense, seven MoE of 160 experts, top 6, 2 shared), "
          "bf16, weights drawn on the card from seed 0")
    params, n_params_d, init_s = draw(cfg_d, "deepseek")
    require(n_params_d == 29_191_377_920,
            f"deepseek depth-8 parameters {n_params_d}")
    ds_rep = {"init_s": init_s, "n_params": n_params_d}
    want_d = {"rmsnorm": 4 * cfg_d.n_layers + 1}   # norm1/2, q_norm, kv_norm
    for B, S in ((1, 4096), (4, 1024)):   # blockwise_sdpa, then sdpa
        einsum_us = []
        rep, rows = prefill_runs(
            "deepseek", params, cfg_d, B, S, want_d,
            on_prof=lambda prof: einsum_us.append(
                op_device_us(prof, "aten::einsum")))
        rep["mla_einsum_device_us"] = einsum_us[-1]
        rep["mla_einsum_share_of_device_time"] = (
            einsum_us[-1] / (rep["device_busy_ms"] * 1e3))
        print(f"[deepseek]   MLA attention einsums (aten::einsum): "
              f"{einsum_us[-1] / 1e3:.1f} ms, "
              f"{rep['mla_einsum_share_of_device_time']:.1%} of device time "
              f"({'blockwise_sdpa' if S > 2048 else 'sdpa'} branch)")
        ds_rep[f"B{B}xS{S}"] = rep

    # 16. deepseek served -------------------------------------------------
    print("[serve-deepseek] the same model through ServingEngine: §5's 8 "
          "requests, max_len 512, 32 new tokens each, policy symbiotic")
    ds_rep["serving"], _ = serve_runs("serve-deepseek", params, cfg_d, want_d)
    ds_serve_counts = ds_rep["serving"]["launches"]
    ds_rep["decode_profile"] = step_profile("serve-deepseek", params, cfg_d)
    del params
    report["deepseek"] = ds_rep

    # 17. deepseek in f32: forward (non-absorbed) against absorbed decode --
    cfg_d32 = cfg_d.replace(n_layers=2, dtype="float32")
    print("[deepseek] f32, TF32 off, depth 2 (one dense layer, one MoE "
          "layer): prefill_logits (MLA.fwd) against prefill's replay into "
          "an f32 cache (the absorbed MLA.decode) on a 64-token prompt")
    params, n32, _ = draw(cfg_d32, "deepseek")
    require(n32 == 5_358_679_040, f"deepseek depth-2 parameters {n32}")
    prompt = torch.randint(0, cfg_d32.vocab, (1, 64), generator=gen).to(dev)
    # capacity_factor raised a slot group of 8 at a time until the forward
    # drops no token: static capacity drops overflow, and a token dropped
    # in the forward is not dropped in decode (one token, 8 slots an expert)
    C = MoE.capacity(cfg_d32, 64)
    with torch.inference_mode():
        while True:
            _, aux = T.forward_features(params, cfg_d32, prompt)
            if float(aux["moe_drop_frac"]) == 0.0:
                break
            C += 8
            cfg_d32 = cfg_d32.replace(
                capacity_factor=(C - 0.5) * cfg_d32.n_experts
                / (64 * cfg_d32.top_k))
            require(MoE.capacity(cfg_d32, 64) == C, "capacity step")
        full = T.prefill_logits(params, cfg_d32, prompt)
        drops = []
        moe_fwd = MoE.fwd

        def spy(p, cfg, x):   # the decode path discards its aux terms
            y, aux = moe_fwd(p, cfg, x)
            drops.append(float(aux["moe_drop_frac"]))
            return y, aux
        MoE.fwd = staticmethod(spy)
        try:
            cache = T.init_cache(cfg_d32, 1, 64, dtype=torch.float32,
                                 device=dev)
            for pos in range(64):
                last, cache = T.decode_step(params, cfg_d32, prompt[:, pos],
                                            cache, pos)
        finally:
            MoE.fwd = staticmethod(moe_fwd)
    diff = (full - last).abs().max().item()
    same = bool((full.argmax(-1) == last.argmax(-1)).all())
    print(f"[deepseek] f32: capacity_factor {cfg_d32.capacity_factor:.4f} "
          f"(C {C} slots an expert at 64 tokens; 1.25 gives "
          f"{MoE.capacity(cfg_d, 64)}), forward drop fraction 0, decode "
          f"drop fraction max {max(drops)} over {len(drops)} MoE calls; "
          f"prefill_logits vs replay max diff {diff:.3e} (bound 1e-3), same "
          f"argmax {same}, logits std {full.std().item():.4f}")
    require(len(drops) == 64 and max(drops) == 0.0,
            "deepseek f32: decode dropped tokens")
    require(bool(torch.isfinite(full).all()) and diff < 1e-3 and same,
            "deepseek f32: forward and absorbed decode differ")
    ds_rep["f32"] = {"capacity_factor": cfg_d32.capacity_factor,
                     "capacity_slots": C, "max_diff": diff,
                     "same_argmax": same}
    del params, cache, full, last

    # 18. mixtral at full width, depth cut to 16 layers --------------------
    cfg_m = get_config("mixtral-8x7b", "full").replace(n_layers=16)
    print("[mixtral] mixtral-8x7b full width, depth cut from 32 to 16 "
          "layers (8 experts, top 2, window 4096), bf16, weights drawn on "
          "the card from seed 0")
    params, n_params_m, init_s = draw(cfg_m, "mixtral")
    require(n_params_m == 23_482_470_400,
            f"mixtral depth-16 parameters {n_params_m}")
    mx_rep = {"init_s": init_s, "n_params": n_params_m}
    want_m = {"rmsnorm": 2 * cfg_m.n_layers + 1,
              "flash_attention": cfg_m.n_layers}
    rep, rows = prefill_runs("mixtral", params, cfg_m, 1, 8192, want_m)
    fl = [r for r in rows if "flash_attention" in r[0]]
    require(sum(r[2] for r in fl) == cfg_m.n_layers,
            f"profile: flash launches {[(r[0][:40], r[2]) for r in fl]}")
    rep["flash_device_us_per_launch"] = sum(r[1] for r in fl) / cfg_m.n_layers
    rep["flash_share_of_device_time"] = (
        sum(r[1] for r in fl) / (rep["device_busy_ms"] * 1e3))
    print(f"[mixtral]   flash attention (window 4096 active at S 8192): "
          f"{rep['flash_device_us_per_launch']:.1f} us per launch "
          f"x{cfg_m.n_layers} ({rep['flash_share_of_device_time']:.1%} of "
          f"device time)")
    mx_rep["B1xS8192"] = rep
    mixtral_prefill_counts = rep["launches"]
    # served: §5's 8 requests, as §13 and §16 serve theirs
    print("[serve-mixtral] the same model through ServingEngine: §5's 8 "
          "requests, max_len 512, 32 new tokens each, policy symbiotic")
    want_md = {"rmsnorm": 2 * cfg_m.n_layers + 1,
               "decode_attention": cfg_m.n_layers}
    mx_rep["serving"], _ = serve_runs("serve-mixtral", params, cfg_m, want_md)
    mixtral_decode_counts = mx_rep["serving"]["launches"]
    mx_rep["decode_profile"] = step_profile("mixtral", params, cfg_m)
    report["mixtral"] = mx_rep
    del params
    torch.cuda.empty_cache()

    # 19. the sliced, incremental front end at full width ------------------
    # Two seeded workloads (Poisson, bursty) of LIVE_REQUESTS requests each
    # through ServingFrontend over 2 replicas: respect_deps over every
    # layer's stages, slicing under the gated guard on a LIVE_SLOTS-token
    # slot budget (prompts above it are oversized stages, so cutting
    # triggers), the live composition.  The arrival rate puts
    # LIVE_ARRIVALS_PER_STEP arrivals into the modelled time of the
    # cheapest solo prefill, so requests arrive while a replica's step is
    # in flight and join the next one.  Every request's tokens must equal
    # a flat ServingEngine's (batch composition, no slicing); the Poisson
    # workload also runs with composition "batch" for the compose cost;
    # a short bursty workload (LIVE_PROFILED) runs under the profiler for
    # the device's busy share.
    cfg_q = get_config("qwen1.5-0.5b", "full")
    print(f"[serve-live] qwen1.5-0.5b full width, bf16, weights drawn on "
          f"the card from seed 0; ServingFrontend over 2 replicas, "
          f"respect_deps (dag_max_stages {LIVE_MAX_STAGES}: every layer's "
          f"two stages), slicing under the gated guard on a {LIVE_SLOTS}-"
          f"token slot budget, composition incremental; {LIVE_REQUESTS} "
          f"requests a workload, prompts {LIVE_PROMPT[0]}-{LIVE_PROMPT[1]} "
          f"tokens, {LIVE_NEW[0]}-{LIVE_NEW[1]} new tokens")
    params, n_q, _ = draw(cfg_q, "serve-live")
    require(n_q == 463_987_712, f"qwen parameters {n_q}")
    live_dev = make_serving_device(token_budget=LIVE_SLOTS)

    def live_policy(composition):
        return SchedulerPolicy(kind="symbiotic", respect_deps=True,
                               slice_policy=SlicePolicy(), dag_guard="gated",
                               composition=composition,
                               dag_max_stages=LIVE_MAX_STAGES)

    def workload(process, rate, seed, shape=(LIVE_REQUESTS, LIVE_PROMPT,
                                             LIVE_NEW)):
        n, prompt_len, new = shape
        return make_workload(process, n, rate, seed=seed,
                             prompt_len=prompt_len, max_new_tokens=new,
                             vocab=cfg_q.vocab)

    def live_run(process, composition, rate, seed, **kw):
        """One frontend run, the launch counters set to 0 just before and
        read just after; a schedule trace on each replica, one flight
        recorder for the pool."""
        rec = FlightRecorder()
        fe = ServingFrontend.build(cfg_q, params, n_replicas=2,
                                   max_len=512, device=live_dev,
                                   recorder=rec,
                                   policy=live_policy(composition))
        for i, eng in enumerate(fe.engines):
            eng.trace = ScheduleTrace(label=f"replica {i}")
        wl = workload(process, rate, seed, **kw)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        st = fe.run(wl)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return fe, wl, st, rec, launch_counts(), wall

    live_rep = {}
    live_counts = {}

    def check_live(label, wl, st, outs, counts) -> int:
        """Every request finished, and the counters saw exactly 49
        RMSNorm and 24 decode-attention launches per decode step (the
        prompt replays' and the decodes'); returns the decode steps."""
        reqs = [r for _, r in wl]
        steps = sum(len(r.prompt) for r in reqs) + sum(
            len(t) - 1 for t in outs.values())
        require(st["rejected"] == 0 and len(outs) == len(reqs)
                and all(len(outs[r.rid]) == r.max_new_tokens for r in reqs),
                f"serve-live {label}: not every request finished: "
                f"{st['rejected']} rejected, {outs}")
        full = {"rmsnorm": 49 * steps, "decode_attention": 24 * steps,
                "flash_attention": 0, "event_scan": 0, "mamba_scan": 0}
        require(counts == full, f"serve-live {label}: launches {counts} "
                f"over {steps} decode steps; want 49 RMSNorm and 24 decode "
                "attention per step")
        for kk, v in counts.items():
            live_counts[kk] = live_counts.get(kk, 0) + v
        return steps
    for k, process in enumerate(("poisson", "bursty")):
        seed = 19 + k
        probe = ServingFrontend.build(cfg_q, params, n_replicas=2,
                                      max_len=512, device=live_dev,
                                      policy=live_policy("incremental"))
        solo = min(probe.solo_cost_s(0, r)
                   for _, r in workload(process, 1.0, seed))
        rate = LIVE_ARRIVALS_PER_STEP / solo
        del probe
        fe, wl, st, rec, counts, wall = live_run(process, "incremental",
                                                 rate, seed)
        outs = fe.outputs()
        steps = check_live(process, wl, st, outs, counts)
        # the same requests through a flat engine: the same tokens
        flat = ServingEngine(cfg_q, params, max_len=512,
                             policy=SchedulerPolicy(kind="symbiotic"))
        flat.submit([r for _, r in workload(process, rate, seed)])
        flat_out = flat.run()["outputs"]
        require(flat_out == outs, f"serve-live {process}: tokens differ "
                "from the flat engine's")
        sc = [e.schedule_cache.stats() for e in fe.engines]
        live_stats = {key: sum(s[key] for s in sc)
                      for key in ("incremental_joins", "incremental_leaves",
                                  "frontier_rebuilds", "dag_hits")}
        n_rounds = sum(len(e._round_times) for e in fe.engines)
        n_slice_rounds = sum(slice_rounds(e.trace) for e in fe.engines)
        eng_steps = sum(fe._steps)
        compose_s = sum(e.metrics.histogram("phase_compose").total
                        for e in fe.engines)
        execute_s = sum(e.metrics.histogram("phase_execute").total
                        for e in fe.engines)
        require(live_stats["incremental_joins"] >= 1
                and live_stats["incremental_leaves"] >= 1
                and n_slice_rounds >= 1,
                f"serve-live {process}: the live frontier joined or retired "
                f"nothing, or no stage was sliced ({live_stats}, "
                f"{n_slice_rounds} slice rounds)")
        rep = {"process": process, "seed": seed,
               "rate_per_modelled_s": rate, "solo_prefill_modelled_s": solo,
               "requests": LIVE_REQUESTS,
               "prompt_tokens": sum(len(r.prompt) for _, r in wl),
               "new_tokens": sum(len(t) for t in outs.values()),
               "decode_steps": steps, "engine_steps": eng_steps,
               "ticks": st["ticks"], "rounds": n_rounds,
               "slice_rounds": n_slice_rounds, **live_stats,
               "wall_s": wall, "ms_per_decode_step": wall * 1e3 / steps,
               "execute_ms_per_decode_step": execute_s * 1e3 / steps,
               "phase_compose_ms_per_step": compose_s * 1e3 / eng_steps,
               "launches": counts,
               "modelled_v5e": {
                   "virtual_time_s": st["virtual_time_s"],
                   "p50_s": st["latency"]["p50_s"],
                   "p99_s": st["latency"]["p99_s"],
                   "queue_p99_s": st["latency"]["queue_p99_s"],
                   "goodput_tokens_per_s":
                       st["latency"]["goodput_tokens_per_s"],
                   "queue_depth_max": st["queue_depth_max"],
                   "deferred_events": st["deferred_events"]}}
        print(f"[serve-live] {process} (seed {seed}, {rate:.5g} arrivals "
              f"per modelled second, {LIVE_ARRIVALS_PER_STEP} in the "
              f"cheapest solo prefill's {solo:.4g} s): every request "
              f"finished with the flat engine's tokens; {steps} decode "
              f"steps, {eng_steps} engine steps over {st['ticks']} ticks, "
              f"{n_rounds} rounds ({n_slice_rounds} holding a slice); "
              f"incremental_joins {live_stats['incremental_joins']}, "
              f"incremental_leaves {live_stats['incremental_leaves']}, "
              f"frontier_rebuilds {live_stats['frontier_rebuilds']}; "
              f"launches {counts} (49 RMSNorm and 24 decode attention a "
              f"decode step)")
        print(f"[serve-live]   wall {wall:.3f} s: "
              f"{rep['ms_per_decode_step']:.4f} ms per decode step "
              f"({rep['execute_ms_per_decode_step']:.4f} ms in "
              f"phase_execute; weight-read floor {floor_ms:.4f} ms), "
              f"phase_compose {rep['phase_compose_ms_per_step']:.3f} ms per "
              f"engine step; modelled on the TPU v5e cost model (virtual "
              f"seconds, not this card): p50 {st['latency']['p50_s']:.4g} s, "
              f"p99 {st['latency']['p99_s']:.4g} s, queue p99 "
              f"{st['latency']['queue_p99_s']:.4g} s, queue depth max "
              f"{st['queue_depth_max']}")
        if process == "bursty":
            # the device's busy share on a short bursty workload under the
            # profiler (a session that records nothing reruns it on a
            # fresh pool, the counters set to 0 again)
            rows, (fe_p, wl_p, st_p, _, counts_p, wall_p), _ = profiled(
                lambda: live_run(process, "incremental", rate, seed,
                                 shape=LIVE_PROFILED))
            steps_p = check_live(f"{process} profiled", wl_p, st_p,
                                 fe_p.outputs(), counts_p)
            busy_us = sum(r[1] for r in rows)
            rep["profiled"] = {
                "requests": LIVE_PROFILED[0], "decode_steps": steps_p,
                "wall_s": wall_p,
                "ms_per_decode_step": wall_p * 1e3 / steps_p,
                "device_busy_ms_per_decode_step": busy_us / 1e3 / steps_p,
                "device_busy_share": busy_us / 1e6 / wall_p,
                "device_events_per_decode_step":
                    sum(r[2] for r in rows) / steps_p,
                "top": [{"name": n[:80], "device_us": tt, "calls": c}
                        for n, tt, c in rows[:8]]}
            pr = rep["profiled"]
            print(f"[serve-live]   profiled ({LIVE_PROFILED[0]} bursty "
                  f"requests, {steps_p} decode steps, {wall_p:.3f} s under "
                  f"the profiler, {pr['ms_per_decode_step']:.4f} ms per "
                  f"decode step): device busy "
                  f"{pr['device_busy_ms_per_decode_step']:.3f} ms per decode "
                  f"step, {pr['device_busy_share']:.1%} of the wall, "
                  f"{pr['device_events_per_decode_step']:.0f} kernels and "
                  "copies per decode step; top:")
            for r in pr["top"][:6]:
                print(f"[serve-live]     {r['device_us'] / steps_p:9.2f} "
                      f"us/decode step x{r['calls'] / steps_p:.0f}  "
                      f"{r['name']}")
        if process == "poisson":
            # the same workload composed "batch": tokens and compose cost
            fe_b, wl_b, st_b, _, counts_b, wall_b = live_run(
                process, "batch", rate, seed)
            require(fe_b.outputs() == outs, "serve-live: batch and "
                    "incremental compositions served different tokens")
            check_live(f"{process} batch", wl_b, st_b, fe_b.outputs(),
                       counts_b)
            compose_b = sum(e.metrics.histogram("phase_compose").total
                            for e in fe_b.engines)
            rep["batch"] = {
                "engine_steps": sum(fe_b._steps),
                "phase_compose_ms_per_step":
                    compose_b * 1e3 / sum(fe_b._steps),
                "wall_s": wall_b, "launches": counts_b,
                "dag_hits": sum(e.schedule_cache.stats()["dag_hits"]
                                for e in fe_b.engines)}
            print(f"[serve-live]   phase_compose ms per engine step "
                  f"(host): incremental "
                  f"{rep['phase_compose_ms_per_step']:.3f}, batch "
                  f"{rep['batch']['phase_compose_ms_per_step']:.3f} "
                  f"(dag_hits {rep['batch']['dag_hits']}); batch served "
                  f"the same tokens")
            # obs round trip: the trace to Chrome/Perfetto JSON, the
            # registries through the Prometheus text, the recorder's
            # events through JSONL
            tr = fe.engines[0].trace
            doc = json.loads(json.dumps(tr.to_chrome()))
            xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
            require(len(xs) == len(tr.spans) > 0,
                    "serve-live: the Chrome trace lost spans")
            n_checked = 0
            for reg in [fe.metrics] + [e.metrics for e in fe.engines]:
                parsed = parse_prometheus_text(prometheus_text(reg))
                for key, v in reg.snapshot().items():
                    series, _, field = key.partition(".")
                    if not field:
                        pk = "repro_" + re.sub(r"=([^,}]*)", r'="\1"',
                                               series)
                        require(parsed.get(pk) == v, f"serve-live: "
                                f"Prometheus round trip of {key}: "
                                f"{parsed.get(pk)} != {v}")
                        n_checked += 1
            events = rec.events
            kinds = {}
            for e in events:
                kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
            require(FlightRecorder.load(rec.to_jsonl()) == events
                    and kinds.get("admit") == LIVE_REQUESTS
                    and kinds.get("frontend_step") == st["ticks"]
                    and kinds.get("schedule", 0) >= 1,
                    f"serve-live: flight recorder events {kinds}")
            rep["obs"] = {"chrome_events": len(doc["traceEvents"]),
                          "spans": len(tr.spans),
                          "prometheus_samples_checked": n_checked,
                          "recorder_events": kinds}
            print(f"[serve-live]   obs: replica 0's trace -> "
                  f"{len(doc['traceEvents'])} Chrome trace events "
                  f"({len(tr.spans)} spans); {n_checked} counter and gauge "
                  f"samples equal after prometheus_text -> "
                  f"parse_prometheus_text; flight recorder {kinds}, equal "
                  f"after its JSONL round trip")
            if args.report is not None:
                args.report.parent.mkdir(parents=True, exist_ok=True)
                tr.dump(str(args.report.with_name("serve_live_trace.json")))
        live_rep[process] = rep
    live_rep["launches"] = live_counts
    report["serve_live"] = live_rep
    del params
    torch.cuda.empty_cache()

    # record ----------------------------------------------------------------
    # launches on the main paths: qwen, deepseek and mixtral decode steps
    # (§5, §16, §18), qwen and mixtral prefills (§7, §18), and the sliced,
    # incremental front end's decode steps (§19)
    sources = {"rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                           "src/repro/kernels/rmsnorm.py:26",
                           serve_counts["rmsnorm"]
                           + ds_serve_counts["rmsnorm"]
                           + mixtral_decode_counts["rmsnorm"]
                           + live_counts["rmsnorm"]),
               "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                                    "src/repro/kernels/decode_attention.py:68",
                                    serve_counts["decode_attention"]
                                    + mixtral_decode_counts[
                                        "decode_attention"]
                                    + live_counts["decode_attention"]),
               "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:79",
                                   prefill_counts["flash_attention"]
                                   + mixtral_prefill_counts[
                                       "flash_attention"]),
               "event_scan": ("src/repro_torch/csrc/event_scan.cu",
                              "src/repro/kernels/event_scan.py:295",
                              space_counts["event_scan"]),
               "mamba_scan": ("src/repro_torch/csrc/mamba_scan.cu",
                              "src/repro/kernels/mamba_scan.py:63",
                              jamba_counts["mamba_scan"])}
    line = {"kernels": [
        {"name": nm, "route": "cuda", "source": src, "replaces": rep,
         "launches": n, "max_abs_err": max(errs[nm]),
         "ms": kern[nm]["ms"], "plain_ms": kern[nm]["plain_ms"],
         "bound_ms": kern[nm]["bound_ms"], "bound_by": kern[nm]["bound_by"],
         "library_ms": kern[nm]["library_ms"]}
        for nm, (src, rep, n) in sources.items()]}
    # the event scan's error is relative (makespans span decades)
    line["kernels"][3]["error"] = "relative"
    report["kernels"] = line["kernels"]
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(report, indent=1))
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
