#!/usr/bin/env python3
"""Times the bf16 flash-attention kernel in turns with an earlier commit's
and with two ablated builds of itself, on one GPU.

    git archive <commit> | tar -x -C build/parent
    python3 tools/flash_turns.py [--parent build/parent] [--out PATH]

Kernels, each called through its C entry point on the same inputs:

- ``this``: the checkout's (``repro_torch.kernels.flash_attention``'s
  kernel);
- ``earlier`` (with ``--parent``): the earlier tree's, built from its own
  sources by its own ``kernels/build.py`` into ``<parent>/build/kernels``
  and called with the argument list that module declares (24 arguments
  before the 128-row plan, 26 with it);
- ``one_part``, ``no_exp`` and ``three_parts``: the checkout's
  ``csrc/flash_attention.cu`` built with ``-DREPRO_FA_ABLATE=1`` (P.V
  with the weights' high bf16 part alone), ``=2`` (no exp2) and ``=3``
  (each weight as three bf16 parts whose sum is exact) into
  ``build/variants``.  The first two are wrong by design; their times say
  what the second part and the exp cost.  The third isolates what two
  parts do to the error: it differs from ``this`` in the split alone.

Measured:

1. each kernel's error against ``flash_attention_plain`` at the shapes
   ``chip_smoke.py``'s §4 times (one KV head per plain call where the
   scores would not fit): the max and mean abs error, and the share of
   bf16 outputs that differ from the plain version's;
2. CUDA-event times at those shapes, the kernels in one order and then in
   the reverse one (median of 5 repeats of 20 calls each, the mean of the
   two turns), SDPA's beside;
3. with ``--parent``, qwen1.5-0.5b ``prefill_logits`` at full width (bf16,
   weights drawn on the card from seed 0) at B 8 x S 4096 and B 1 x
   S 32768, ``ops.flash_attention`` pointed at the earlier kernel and at
   this one in the order earlier, this, this, earlier (a warm-up call and
   the median of 3 timed calls per turn).

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

from turns import (HERE, nvidia_smi, parent_library, start_variants,
                   time_ms, variant_entry)


#: (B, S, H, Hkv, D, causal, window), as ``chip_smoke.py`` §4 times them
SHAPES = {"qwen": (1, 4096, 16, 16, 64, True, None),
          "qwen_B8": (8, 4096, 16, 16, 64, True, None),
          "gqa_window": (1, 2048, 32, 8, 128, True, 1024),
          "hubert": (1, 1000, 16, 16, 80, False, None),
          "jamba": (8, 4096, 32, 8, 128, True, None)}
#: the ablated builds: csrc/flash_attention.cu with -DREPRO_FA_ABLATE=mode
ABLATIONS = {name: ((f"-DREPRO_FA_ABLATE={mode}",), ())
             for name, mode in (("one_part", 1), ("no_exp", 2),
                                ("three_parts", 3))}


def caller(entry, plan):
    """A flash call through ``entry`` (q, k, v of one dtype, D a multiple
    of 8), with the 128-row plan where its argument list has one."""
    with_plan = len(entry.argtypes) == 26

    def run(q, k, v, causal=True, window=None):
        B, S, H, D = q.shape
        T, Hkv = k.shape[1], k.shape[2]
        out = torch.empty_like(q)
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                S, T, H, Hkv, D, *q.stride()[:3], *k.stride()[:3],
                *v.stride()[:3], 1.0 / math.sqrt(D), int(causal),
                window or 0]
        if with_plan:
            p = plan(S, H, Hkv)
            args += [p.G, p.P]
        rc = entry(*args, 1, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"flash kernel launch failed: CUDA error {rc}")
        return out
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="an unpacked tree of the earlier commit")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_turns: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE / "src"))
    from repro_torch.configs import SHAPES as CFG_SHAPES, get_config
    from repro_torch.kernels import (build, flash_attention_plain,
                                     flash_plan, ops)
    from repro_torch.models import transformer as T

    smi = nvidia_smi()
    print(f"[turns] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    t0 = time.perf_counter()
    procs = start_variants(build, "flash_attention.cu", ABLATIONS)
    lib = build.library()
    kernels = {"this": caller(lib.repro_flash_attention, flash_plan)}
    if args.parent is not None:
        kernels["earlier"] = caller(
            parent_library(args.parent).repro_flash_attention, flash_plan)
    for name, (proc, path) in procs.items():
        kernels[name] = caller(variant_entry(
            proc, path, "repro_flash_attention",
            lib.repro_flash_attention.argtypes), flash_plan)
    print(f"[turns] kernels {list(kernels)} built in "
          f"{time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    rep: dict = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                 "flash": {}, "prefill": {}}

    for key, (B, S, H, Hkv, D, causal, window) in SHAPES.items():
        q = torch.randn(B, S, H, D, generator=gen).to(dev, torch.bfloat16)
        k, v = (torch.randn(B, S, Hkv, D, generator=gen)
                .to(dev, torch.bfloat16) for _ in range(2))
        kw = dict(causal=causal, window=window)
        g = H // Hkv
        step = Hkv if B * H * S * S <= 8 * 16 * 4096 * 4096 else 1
        want = torch.cat([flash_attention_plain(
            q[:, :, g * h:g * (h + step)], k[:, :, h:h + step],
            v[:, :, h:h + step], **kw) for h in range(0, Hkv, step)], dim=2)
        errs = {}
        for name, fn in kernels.items():
            diff = (fn(q, k, v, **kw).float() - want.float()).abs()
            errs[name] = {"max": diff.max().item(),
                          "mean": diff.mean().item(),
                          "mismatch_share": (diff > 0).float().mean().item()}
            del diff
        del want
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (t.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
                  for t in (k, v))
        mask = None
        if window is not None:
            i = torch.arange(S, device=dev)
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
        times = {name: [] for name in kernels}
        for order in (list(kernels), list(kernels)[::-1]):
            for name in order:
                times[name].append(time_ms(
                    lambda: kernels[name](q, k, v, **kw)))
        sdpa = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None))
        ms = {name: float(np.mean(t)) for name, t in times.items()}
        rep["flash"][key] = {
            "shape": [B, S, H, Hkv, D], "causal": causal, "window": window,
            "err": errs, "ms": ms, "turns_ms": times,
            "sdpa_ms": sdpa}
        print(f"[turns] flash {key} {[B, S, H, Hkv, D]} causal={causal} "
              f"window={window}: " + ", ".join(
                  f"{name} {ms[name]:.5f} ms (err max {errs[name]['max']:.3e}"
                  f" mean {errs[name]['mean']:.3e} differing "
                  f"{errs[name]['mismatch_share']:.3%})"
                  for name in kernels) + f", SDPA {sdpa:.5f} ms")
        del q, k, v, qt, kt, vt, mask
        torch.cuda.empty_cache()

    if args.parent is not None:
        cfg = get_config("qwen1.5-0.5b", "full")
        params = T.init(cfg, seed=0, device=dev, draw_device="cuda")
        this_op = ops.flash_attention
        try:
            for B, S in ((8, 4096), (1, CFG_SHAPES["prefill_32k"].seq_len)):
                toks = torch.randint(0, cfg.vocab, (B, S),
                                     generator=gen).to(dev)
                ms = {"earlier": [], "this": []}
                with torch.inference_mode():
                    for name in ("earlier", "this", "this", "earlier"):
                        ops.flash_attention = kernels[name]
                        walls = []
                        for _ in range(4):   # a warm-up call, three timed
                            t0 = time.perf_counter()
                            T.prefill_logits(params, cfg, toks)
                            torch.cuda.synchronize()
                            walls.append(time.perf_counter() - t0)
                        ms[name].append(float(np.median(walls[1:])) * 1e3)
                r = {"turns_ms": ms,
                     "earlier_ms": float(np.mean(ms["earlier"])),
                     "this_ms": float(np.mean(ms["this"]))}
                rep["prefill"][f"B{B}xS{S}"] = r
                print(f"[turns] qwen prefill_logits B {B} x S {S}: earlier "
                      f"{r['earlier_ms']:.1f} ms {ms['earlier']}, this "
                      f"{r['this_ms']:.1f} ms {ms['this']}")
                del toks
        finally:
            ops.flash_attention = this_op
    line = json.dumps(rep)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
