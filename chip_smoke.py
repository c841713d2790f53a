#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--report PATH]

Phases, in order; any failure exits non-zero before the last line:

1. device   — the card's name and count, and ``nvidia-smi``'s name and
              power limit;
2. build    — the CUDA kernels from ``src/repro_torch/csrc`` (``nvcc``,
              ``sm_90a``), with the compiler's register/spill report;
3. kernels  — each kernel against its plain PyTorch version on the card,
              at the serving path's shapes and a GQA shape, within f32 2e-5
              / bf16 2e-2 (the reference's ``tests/test_kernels.py``);
4. times    — CUDA-event times at the serving path's shapes: kernel, plain
              version, one library call computing the same function
              (yardstick only; the port never calls it), and the bound;
5. serving  — ``repro_torch.launch.serve.serve`` on qwen1.5-0.5b at full
              width (8 requests, bf16, seeded weights): every request
              finishes, and the launch counters show 49 RMSNorm and 24
              decode-attention launches per ``decode_step``; a full-width
              replay gives finite logits and the served first token;
6. profile  — ``torch.profiler`` over full-width decode steps: device
              time by kernel and the device's busy share (informational);
7. card/CPU — the smoke config in f32 served on the card and on the CPU
              (plain versions) from the same seeded weights, TF32 off:
              identical tokens, logits within 1e-3.

The last lines are the kernels' JSON record, ``nvidia-smi``'s line and
``{"ok": true, "device": {...}}``.  ``--report PATH`` also writes a
fuller JSON report (every timing repeat, the profile's top kernels).
Exits 1 at once where ``torch.cuda.is_available()`` is false.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
SRC = HERE / "src"

#: H100 SXM data-sheet peaks (dense): HBM bytes/s, bf16 tensor-core and
#: f32 (non-tensor) operations/s.  A card set below 700 W runs slower.
HBM_BPS = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


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


def compare(label: str, got, want, dtype, errs: list) -> None:
    tol = TOL[dtype]
    err = (got.float() - want.float()).abs().max().item()
    ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
    print(f"  {label}: max_abs_err={err:.3e} tol={tol:g} "
          f"{'ok' if ok else 'MISS'}")
    errs.append(err)
    require(ok, f"{label}: kernel disagrees with its plain version")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", type=Path, default=None,
                    help="also write the full report as JSON to this path")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.kernels import (build, decode_attention,
                                     decode_attention_plain, launch_counts,
                                     reset_launch_counts, rmsnorm_rows,
                                     rmsnorm_rows_plain)
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as T
    from repro_torch.serve import Request, SchedulerPolicy, ServingEngine

    import torch.nn.functional as F

    report: dict = {}
    dev = torch.device("cuda")

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
    report["build_s"] = build_s

    # 3. kernels vs plain on the card ------------------------------------
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, dtype=torch.float32, scale=1.0, shift=0.0):
        x = torch.randn(shape, generator=gen) * scale + shift
        return x.to(dev, dtype)

    errs = {"rmsnorm": [], "decode_attention": []}
    print("[kernels] RMSNorm vs plain")
    for rows in (1, 64):
        for dt in (torch.bfloat16, torch.float32):
            x = randn(rows, 1024, dtype=dt)
            s = randn(1024, scale=0.1, shift=1.0)
            compare(f"rmsnorm ({rows}, 1024) {dt}", rmsnorm_rows(x, s),
                    rmsnorm_rows_plain(x, s), dt, errs["rmsnorm"])
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
    torch.cuda.synchronize()

    # 4. times at the serving path's shapes --------------------------------
    print("[times] CUDA events: median of 5 repeats of 200 calls, after "
          "20 warm-up calls")
    kern = {}
    repeats: dict = {}

    def timed(name, fn):
        return time_ms(fn, runs_out=repeats.setdefault(name, []))

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
    B, H, Hkv, Tc, D = 1, 16, 16, 512, 64
    q = randn(B, H, D, dtype=torch.bfloat16)
    k = randn(B, Tc, Hkv, D, dtype=torch.bfloat16)
    v = randn(B, Tc, Hkv, D, dtype=torch.bfloat16)
    att = {}
    for L in (128, 512):
        ln = torch.full((B,), L, dtype=torch.int32, device=dev)
        q4 = q.view(B, H, 1, D)
        k4, v4 = k[:, :L].transpose(1, 2), v[:, :L].transpose(1, 2)
        try:
            lib = timed(f"decode_attention.L{L}.sdpa",
                        lambda: F.scaled_dot_product_attention(q4, k4, v4))
        except RuntimeError as e:   # a yardstick, not the port
            print(f"[times]   sdpa unavailable: {e}")
            lib = None
        a_bytes = 2 * q.numel() * 2 + 2 * B * L * Hkv * D * 2 + 4 * B
        a_bound, a_by = bound(a_bytes, 4 * B * H * L * D + 3 * B * H * L,
                              torch.bfloat16)
        att[L] = {
            "ms": timed(f"decode_attention.L{L}",
                        lambda: decode_attention(q, k, v, ln)),
            "plain_ms": timed(f"decode_attention.L{L}.plain",
                              lambda: decode_attention_plain(q, k, v, ln)),
            "library_ms": lib, "bound_ms": a_bound, "bound_by": a_by,
            "shape": f"q (1, 16, 64) bf16, cache (1, 512, 16, 64) bf16, L={L}"}
    kern["decode_attention"] = att[128]
    report["times"] = {"rmsnorm": kern["rmsnorm"],
                       "decode_attention": {str(L): a for L, a in att.items()},
                       "repeats_ms": repeats}
    for label, t in [("rmsnorm", kern["rmsnorm"]),
                     ("decode_attention L=128", att[128]),
                     ("decode_attention L=512", att[512])]:
        lib = "n/a" if t["library_ms"] is None else f"{t['library_ms']:.5f}"
        print(f"[times] {label}: kernel {t['ms']:.5f} ms, plain "
              f"{t['plain_ms']:.5f} ms, library {lib} ms, bound "
              f"{t['bound_ms']:.3e} ms ({t['bound_by']}) [{t['shape']}]")

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
                       "decode_attention": 24 * n_steps},
            "the main path did not run the kernels once per layer")
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
    try:
        from torch.profiler import ProfilerActivity, profile
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
        with torch.inference_mode(), profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(n_prof):
                logits, cache = T.decode_step(
                    params, cfg_full, torch.tensor([first], device=dev),
                    cache, plen + n_prof + i)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0

        # Device-side events only: CPU ops (aten::mm) also report the
        # device time of the kernels they launch, which would count twice.
        rows = [(e.key, e.self_device_time_total, e.count)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
        rows.sort(key=lambda r: -r[1])
        busy_us = sum(r[1] for r in rows)
        prof_rep = {"steps": n_prof,
                    "unprofiled_wall_ms_per_step": wall_plain * 1e3 / n_prof,
                    "wall_ms_per_step": wall * 1e3 / n_prof,
                    "device_busy_ms_per_step": busy_us / 1e3 / n_prof,
                    "device_events_per_step":
                        sum(r[2] for r in rows) / n_prof,
                    "top": [{"name": n[:80], "device_us_per_step": t / n_prof,
                             "calls_per_step": c / n_prof}
                            for n, t, c in rows[:12]]}
        prof_rep["device_busy_share"] = busy_us / 1e6 / wall_plain
        print(f"[profile] {n_prof} steps: wall {wall_plain * 1e3 / n_prof:.3f}"
              f" ms/step ({wall * 1e3 / n_prof:.3f} under the profiler), "
              f"device busy {prof_rep['device_busy_share']:.1%} of it: "
              f"{busy_us / 1e3 / n_prof:.3f} ms/step in "
              f"{prof_rep['device_events_per_step']:.0f} kernels and copies")
        for r in prof_rep["top"][:8]:
            print(f"[profile]   {r['device_us_per_step']:9.2f} us/step "
                  f"x{r['calls_per_step']:.0f}  {r['name']}")
    except Exception as e:  # informational phase: the port is checked above
        prof_rep = {"error": f"{type(e).__name__}: {e}"}
        print(f"[profile] not measured: {prof_rep['error']}")
    report["profile"] = prof_rep
    del params, cache

    # 7. card vs CPU, smoke config in f32 ---------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[card/cpu] TF32 off (matmul and cuDNN): both sides compute f32")
    cfg = get_config("qwen1.5-0.5b", "smoke").replace(dtype="float32")
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
        cache = T.init_cache(cfg, 1, 64, device=where)
        lg = []
        with torch.inference_mode():
            for pos, tok in enumerate(reqs[0].prompt.tolist() +
                                      out["outputs"][0][:-1]):
                logits, cache = T.decode_step(
                    params, cfg, torch.tensor([tok], device=where), cache,
                    pos)
                lg.append(logits.cpu())
        side[where] = (out, torch.cat(lg))
    (o_gpu, l_gpu), (o_cpu, l_cpu) = side["cuda"], side["cpu"]
    diff = (l_gpu - l_cpu).abs().max().item()
    print(f"[card/cpu] tokens identical: "
          f"{o_gpu['outputs'] == o_cpu['outputs']}; rounds "
          f"{o_gpu['rounds']} vs {o_cpu['rounds']}; max logit diff "
          f"{diff:.3e} (bound 1e-3) over {l_gpu.shape[0]} positions")
    require(o_gpu["outputs"] == o_cpu["outputs"], "card and CPU tokens differ")
    require(o_gpu["rounds"] == o_cpu["rounds"] and
            o_gpu["modelled_time_s"] == o_cpu["modelled_time_s"],
            "card and CPU compose different rounds")
    require(diff < 1e-3, f"card and CPU logits differ by {diff}")
    report["card_vs_cpu"] = {"max_logit_diff": diff,
                             "positions": int(l_gpu.shape[0])}

    # record ----------------------------------------------------------------
    sources = {"rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                           "src/repro/kernels/rmsnorm.py:26"),
               "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                                    "src/repro/kernels/decode_attention.py:68")}
    line = {"kernels": [
        {"name": nm, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[nm], "max_abs_err": max(errs[nm]),
         "ms": kern[nm]["ms"], "plain_ms": kern[nm]["plain_ms"],
         "bound_ms": kern[nm]["bound_ms"], "bound_by": kern[nm]["bound_by"],
         "library_ms": kern[nm]["library_ms"]}
        for nm, (src, rep) in sources.items()]}
    report["kernels"] = line["kernels"]
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(report, indent=1))
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
