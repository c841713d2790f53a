"""ScoreGen / ProfileCombine — lines 14-27 of Algorithm 1 in the paper.

The score between two kernels (or a virtual combined kernel and a
candidate) rewards

1. *balanced residual capacity*: for every resource dimension, the
   fraction of the per-unit capacity left over after co-residency adds
   to the score (clamped at 0), and
2. *opposing compute/memory character*: if one kernel sits on each side
   of the balanced ratio ``R_B``, the score additionally rewards a
   block-weighted combined ratio close to ``R_B``.

Pairs that cannot co-reside within one execution round score 0.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

from .resources import DeviceModel, KernelProfile

__all__ = [
    "pair_score",
    "score_matrix",
    "score_vector",
    "profile_combine",
    "fits_together",
    "fits_alone",
    "combined_ratio",
]


def _per_unit(k: KernelProfile, device: DeviceModel) -> dict[str, float]:
    return k.per_unit_demand(device)


def fits_alone(k: KernelProfile, device: DeviceModel) -> bool:
    d = _per_unit(k, device)
    return all(d[dim] <= device.cap(dim) for dim in device.caps)


def fits_together(a: KernelProfile, b: KernelProfile,
                  device: DeviceModel) -> bool:
    da, db = _per_unit(a, device), _per_unit(b, device)
    if a.blocks_per_unit(device) + b.blocks_per_unit(device) > device.max_resident:
        return False
    return all(da[dim] + db[dim] <= device.cap(dim) for dim in device.caps)


def combined_ratio(a: KernelProfile, b: KernelProfile,
                   mode: str = "block_mean") -> float:
    """Combined inst/bytes ratio of a co-scheduled pair.

    "block_mean" — the paper's ProfileCombine (line 26): block-weighted
    average of R_i.  "harmonic" — total work / total bytes, the
    physically correct combined intensity (beyond-paper; required when
    R_i span orders of magnitude)."""
    if mode == "harmonic":
        # Guard r == 0 (pure-memory kernels report zero intensity): the
        # clamped denominator keeps the combined ratio finite and ~0,
        # i.e. the pair is treated as memory-bound, which is the
        # physically right limit.
        work = a.inst_per_block * a.n_blocks + b.inst_per_block * b.n_blocks
        byts = (a.inst_per_block * a.n_blocks / max(a.r, 1e-30) +
                b.inst_per_block * b.n_blocks / max(b.r, 1e-30))
        return work / max(byts, 1e-30)
    w = a.n_blocks + b.n_blocks
    return (a.n_blocks * a.r + b.n_blocks * b.r) / w


def pair_score(a: KernelProfile, b: KernelProfile,
               device: DeviceModel) -> float:
    """Score of co-scheduling ``a`` and ``b`` (Algorithm 1 lines 17-22)."""
    if not fits_together(a, b, device):
        return 0.0
    da, db = _per_unit(a, device), _per_unit(b, device)
    s = 0.0
    for dim in device.caps:
        cap = device.cap(dim)
        s += device.residual_weight * max((cap - da[dim] - db[dim]) / cap,
                                          0.0)
    rb = device.r_balanced
    if (a.r <= rb <= b.r) or (b.r <= rb <= a.r):
        rc = combined_ratio(a, b, device.combined_r)
        s += device.r_weight * max(1.0 - abs(rc - rb) / rb, 0.0)
    return s


def score_matrix(ks_m: Sequence[KernelProfile], ks_n: Sequence[KernelProfile],
                 device: DeviceModel) -> list[list[float]]:
    """ScoreGen(K_M, K_N): full pairwise score matrix."""
    return [[pair_score(a, b, device) for b in ks_n] for a in ks_m]


def score_vector(comb: KernelProfile, candidates: Sequence[KernelProfile],
                 device: DeviceModel) -> list[float]:
    """ScoreGen with a 1-D result: virtual combined kernel vs candidates."""
    return [pair_score(comb, c, device) for c in candidates]


def profile_combine(a: KernelProfile, b: KernelProfile,
                    device: DeviceModel) -> KernelProfile:
    """ProfileCombine (Algorithm 1 lines 25-27).

    Produces the virtual kernel representing the whole execution round:
    its per-unit footprint is the *sum* of its members' per-unit
    footprints (stored pre-aggregated so it is never re-multiplied by a
    block count).  Block counts add; the ratio combines block-weighted.
    """
    da, db = a.per_unit_demand(device), b.per_unit_demand(device)
    demands = {k: da[k] + db[k] for k in da}
    return KernelProfile(
        name=f"({a.name}+{b.name})",
        n_blocks=a.n_blocks + b.n_blocks,
        demands=demands,
        inst_per_block=a.inst_per_block + b.inst_per_block,
        r=combined_ratio(a, b, device.combined_r),
        agg_blocks_per_unit=a.blocks_per_unit(device) + b.blocks_per_unit(device),
    )
