#!/usr/bin/env python3
"""Times the decode-attention kernel in turns with an earlier commit's, on
one GPU.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 tools/decode_turns.py --parent build/parent [--out PATH]

Kernels, each called through its C entry point on the same inputs:

- ``this``: the checkout's (``repro_torch.kernels.decode_attention``'s
  split-KV cluster kernel, with :func:`decode_plan`'s plan);
- ``earlier``: the earlier tree's, built from its own sources by its own
  ``kernels/build.py`` into ``<parent>/build/kernels`` and called with the
  argument list that module declares (20 arguments before the plan, 25
  with it).

Measured:

1. each kernel's max abs error against ``decode_attention_plain`` at every
   shape below, and whether two calls give the same bits;
2. at ``chip_smoke.py`` §4's shapes (qwen's q (1, 16, 64) at L 128 and
   512 on a 512-slot cache and at L 4096 and 32,768 on a 32,768-slot one;
   jamba's q (8, 32, 128) on an (8, 4096, 8, 128) cache at L 4096; bf16):
   CUDA-event ms per call in the order this, earlier, earlier, this
   (median of 5 repeats of n calls each, the mean of the two turns), the
   device µs per launch of each from ``torch.profiler``, and SDPA's call
   ms and device µs beside, with the bytes bound;
3. full-width qwen1.5-0.5b ``decode_step`` (bf16, weights drawn on the
   card from seed 0) at a 512- and a 32,768-slot cache, the last 32
   positions of each, ``ops.decode_attention`` pointed at each kernel in
   the order earlier, this, this, earlier: wall ms per step (16 steps,
   synchronised), then a profile of 16 more: the device's busy ms per
   step and decode attention's device µs per launch and share of it.

Prints one JSON object as its last line; ``--out`` also writes it.
Exits 1 where ``torch.cuda.is_available()`` is false.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from turns import HERE, device_events, nvidia_smi, parent_library, time_ms

HBM_BPS = 3.35e12

#: (q shape (B, H, D), cache shape (B, T, Hkv, D), L), as chip_smoke.py §4
SHAPES = {"L128": ((1, 16, 64), (1, 512, 16, 64), 128),
          "L512": ((1, 16, 64), (1, 512, 16, 64), 512),
          "L4096": ((1, 16, 64), (1, 32768, 16, 64), 4096),
          "L32768": ((1, 16, 64), (1, 32768, 16, 64), 32768),
          "jamba_L4096": ((8, 32, 128), (8, 4096, 8, 128), 4096)}


def caller(entry, plan):
    """A decode-attention call through ``entry`` (q (B, H, D); k, v
    (B, T, Hkv, D); int32 lengths), with ``plan``'s launch where its
    argument list takes one."""
    with_plan = len(entry.argtypes) >= 25
    with_lse = len(entry.argtypes) == 26
    codes = {torch.float32: 0, torch.bfloat16: 1}

    def run(q, k, v, lengths):
        B, H, D = q.shape
        T, Hkv = k.shape[1], k.shape[2]
        out = torch.empty_like(q)
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                out.data_ptr(), *([None] if with_lse else []), B, H, Hkv,
                T, D, *k.stride()[:3],
                *v.stride()[:3], 1.0 / math.sqrt(D), codes[q.dtype],
                codes[k.dtype]]
        if with_plan:
            p = plan(B, H, Hkv, T, D, q.dtype, k.dtype)
            args += [p.tile, p.stages, p.cluster, p.grid, p.smem]
        rc = entry(*args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"decode kernel launch failed: CUDA error {rc}")
        return out
    return run


def decode_us(events) -> tuple[float, int]:
    """Mean device µs per decode-attention launch in ``events``, and the
    launches."""
    da = [t for name, t in events if "decode_attention" in name]
    if not da:
        raise RuntimeError("the profile has no decode-attention launch")
    return sum(da) / len(da), len(da)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="an unpacked tree of the earlier commit")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_turns: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, decode_attention_plain, ops
    from repro_torch.kernels.decode_attention import decode_plan
    from repro_torch.models import transformer as T

    smi = nvidia_smi()
    print(f"[turns] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    t0 = time.perf_counter()
    kernels = {"this": caller(build.library().repro_decode_attention,
                              decode_plan),
               "earlier": caller(
                   parent_library(args.parent).repro_decode_attention,
                   decode_plan)}
    print(f"[turns] kernels built in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    rep: dict = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                 "kernel": {}, "decode_step": {}}

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev, torch.bfloat16)

    for key, (qs, cs, L) in SHAPES.items():
        q, k, v = randn(*qs), randn(*cs), randn(*cs)
        B, H, D = qs
        Hkv = cs[2]
        ln = torch.full((B,), L, dtype=torch.int32, device=dev)
        want = decode_attention_plain(q, k, v, ln).float()
        err, same = {}, {}
        for name, fn in kernels.items():
            a, b = fn(q, k, v, ln), fn(q, k, v, ln)
            err[name] = (a.float() - want).abs().max().item()
            same[name] = bool(torch.equal(a, b))
        q4 = q.view(B, H, 1, D)
        k4, v4 = k[:, :L].transpose(1, 2), v[:, :L].transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(q4, k4, v4,
                                                  enable_gqa=H != Hkv)

        n = 200 if L <= 4096 else 50
        turns = {name: [] for name in kernels}
        for name in ("this", "earlier", "earlier", "this"):
            turns[name].append(time_ms(
                lambda: kernels[name](q, k, v, ln), n, warm=10))
        dev_us = {name: decode_us(device_events(lambda: fn(q, k, v, ln),
                                                20))[0]
                  for name, fn in kernels.items()}
        sdpa_rows = device_events(sdpa, 20)
        n_bytes = 2 * q.numel() * 2 + 2 * B * L * Hkv * D * 2 + 4 * B
        r = {"q": list(qs), "cache": list(cs), "L": L,
             "ms": {name: float(np.mean(t)) for name, t in turns.items()},
             "turns_ms": turns, "device_us": dev_us,
             "sdpa_ms": time_ms(sdpa, n, warm=10),
             "sdpa_device_us": sum(x[1] for x in sdpa_rows) / 20,
             "bound_us": n_bytes / HBM_BPS * 1e6, "bound_by": "bytes",
             "max_abs_err": err, "same_bits_twice": same}
        rep["kernel"][key] = r
        print(f"[turns] decode {key} q {qs} cache {cs} L {L}: " + ", ".join(
            f"{name} {r['ms'][name]:.5f} ms / {dev_us[name]:.2f} us device "
            f"(err {err[name]:.3e}, same bits {same[name]})"
            for name in kernels) + f", SDPA {r['sdpa_ms']:.5f} ms / "
            f"{r['sdpa_device_us']:.2f} us device, bound "
            f"{r['bound_us']:.3f} us")
        del q, k, v, want
        torch.cuda.empty_cache()

    cfg = get_config("qwen1.5-0.5b", "full")
    params = T.init(cfg, seed=0, device=dev, draw_device="cuda")
    tok = torch.tensor([1], device=dev)
    this_op = ops.decode_attention
    try:
        for ctx in (512, 32768):
            cache = T.init_cache(cfg, 1, ctx, device=dev)
            res = {"earlier": [], "this": []}
            with torch.inference_mode():
                for name in ("earlier", "this", "this", "earlier"):
                    ops.decode_attention = kernels[name]
                    for pos in range(ctx - 36, ctx - 32):   # warm-up
                        T.decode_step(params, cfg, tok, cache, pos)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for pos in range(ctx - 32, ctx - 16):
                        T.decode_step(params, cfg, tok, cache, pos)
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) * 1e3 / 16
                    steps = iter(range(ctx - 16, ctx))
                    rows = device_events(lambda: T.decode_step(
                        params, cfg, tok, cache, next(steps)), 16)
                    us, launches = decode_us(rows)
                    busy = sum(x[1] for x in rows)
                    da = us * launches
                    res[name].append({
                        "wall_ms_per_step": wall,
                        "device_busy_ms_per_step": busy / 1e3 / 16,
                        "decode_attention_device_us_per_launch": us,
                        "decode_attention_launches": launches,
                        "decode_attention_ms_per_step": da / 1e3 / 16,
                        "decode_attention_share": da / busy})
            rep["decode_step"][f"ctx{ctx}"] = res
            for name, runs in res.items():
                print(f"[turns] qwen decode_step, {ctx}-slot cache, {name}: "
                      + "; ".join(
                          f"{x['wall_ms_per_step']:.3f} ms/step, busy "
                          f"{x['device_busy_ms_per_step']:.4f} ms/step, "
                          f"decode attention "
                          f"{x['decode_attention_device_us_per_launch']:.2f}"
                          f" us x {x['decode_attention_launches']} "
                          f"({x['decode_attention_share']:.1%})"
                          for x in runs))
            del cache
            torch.cuda.empty_cache()
    finally:
        ops.decode_attention = this_op
    line = json.dumps(rep)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
