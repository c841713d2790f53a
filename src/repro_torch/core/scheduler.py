"""Algorithm 1 — Concurrent Kernel Launch Order Algorithm.

Greedy round construction exactly as published:

* pick the highest-scoring *pair* of remaining kernels to seed a round,
* order members within a round by decreasing shared-memory demand (so
  the heaviest shm consumer is launched first and releases earliest),
* virtually combine the round's profile (ProfileCombine) and keep
  absorbing the highest-scoring kernel that still fits,
* when nothing fits, open the next round.

The output is the flat launch order ``Rd_0 ++ Rd_1 ++ ...``.

Two baseline order generators (identity, random) and an exhaustive
permutation search are provided for design-space evaluation.

Complexity / when to use which path
-----------------------------------
This module is the **test-only oracle**: pure Python over
``KernelProfile`` objects, kept deliberately close to the paper's
pseudocode so property tests can diff the production path against it.
Each round re-scans the remaining pairs (``O(n^2)`` ``pair_score``
calls per round, each building per-unit demand dicts), so a full
schedule costs ``O(R * n^2)`` scored pairs — ``O(n^3)`` and beyond in
wall time: minutes at ``n = 1024`` (``BENCH_scheduler_scaling.json``).

:mod:`repro_torch.core.fastscore` is the production path: it packs profiles
into NumPy arrays once, computes the pairwise matrix a single time
with broadcasting (``O(n^2 * D)``), and maintains only the 1xn score
vector of the current round's combined profile between absorptions
(``O(n * D)`` per absorption), for ``O(n^2 * D)`` total.  It produces
*identical* schedules (verified in ``tests/test_fastscore.py``).
Every non-test caller — the serving engine, the TPU round composer,
the train-side overlap scheduler, the examples and the paper-figure
benchmarks — goes through ``fastscore.greedy_order_fast``; new code
should never call :func:`greedy_order` outside a test or an explicit
oracle comparison (``benchmarks/scaling.py``'s reference path).

Both this oracle and the fast path assume every kernel is free to
co-schedule with every other.  When precedence edges exist (per-layer
chains of a traced model graph, producer/consumer kernels), use
:mod:`repro.graph` instead: ``greedy_order_dag`` is the ready-set
variant of the same algorithm (identical to the flat path on an empty
edge set), ``refine_order_dag`` the legal local search — with
``model="gated"`` it optimizes the gated makespan model
(``DagEventSimulator``, checkpointable) directly via
``repro.graph.delta.GatedDeltaEvaluator``.  When a workload carries
stages too large to pack at all, go one layer further up to
:mod:`repro.slice` (lazy Kernelet-style slicing over the same greedy).
"""

from __future__ import annotations

import itertools
import random as _random
from dataclasses import dataclass, field
from typing import Callable, Sequence

from .resources import DeviceModel, KernelProfile
from .scorer import (fits_together, pair_score, profile_combine,
                     score_vector)

__all__ = [
    "Round",
    "Schedule",
    "greedy_order",
    "exhaustive_search",
    "random_orders",
    "percentile_rank",
]

#: Resource dimension used for the intra-round sort (paper: N_shm).  For
#: profiles lacking it the first declared dimension is used.
_SORT_DIM = "shm"


def _sort_key(k: KernelProfile, device: DeviceModel):
    d = k.per_unit_demand(device)
    if _SORT_DIM in d:
        return d[_SORT_DIM]
    return next(iter(d.values()), 0.0)


@dataclass
class Round:
    """One execution round: an ordered list of kernels."""

    kernels: list[KernelProfile] = field(default_factory=list)

    def insert_sorted(self, k: KernelProfile, device: DeviceModel) -> None:
        """Insert keeping decreasing shared-memory order (Alg. 1 line 6/10)."""
        key = _sort_key(k, device)
        for i, existing in enumerate(self.kernels):
            if key > _sort_key(existing, device):
                self.kernels.insert(i, k)
                return
        self.kernels.append(k)

    @property
    def names(self) -> list[str]:
        return [k.name for k in self.kernels]


@dataclass
class Schedule:
    rounds: list[Round]

    @property
    def order(self) -> list[KernelProfile]:
        return [k for rd in self.rounds for k in rd.kernels]

    @property
    def names(self) -> list[str]:
        return [k.name for k in self.order]


def greedy_order(kernels: Sequence[KernelProfile],
                 device: DeviceModel) -> Schedule:
    """Algorithm 1 of the paper — test-only oracle.

    Production callers use :func:`repro_torch.core.fastscore.greedy_order_fast`,
    which is property-tested to produce identical schedules in
    ``O(n^2 * D)`` instead of ``O(R * n^2)`` Python ScoreGen reruns.
    """
    remaining = list(kernels)
    rounds: list[Round] = []
    while remaining:
        rd = Round()
        if len(remaining) == 1:
            rd.kernels.append(remaining.pop())
            rounds.append(rd)
            break
        # Seed the round with the highest-scoring pair.  pair_score is
        # symmetric, so scanning i < j only halves the ScoreGen work;
        # the selection is unchanged because the first strict maximum
        # of a symmetric matrix in row-major order always has i < j.
        best, best_pair = -1.0, (0, 1)
        n = len(remaining)
        for i in range(n):
            for j in range(i + 1, n):
                s = pair_score(remaining[i], remaining[j], device)
                if s > best:
                    best, best_pair = s, (i, j)
        i, j = best_pair
        ka, kb = remaining[i], remaining[j]
        if best <= 0.0 and not fits_together(ka, kb, device):
            # Nothing pairs (every kernel saturates a unit on its own):
            # the kernel runs in a round by itself.
            solo = max(remaining, key=lambda k: _sort_key(k, device))
            remaining.remove(solo)
            rd.kernels.append(solo)
            rounds.append(rd)
            continue
        for k in (ka, kb):
            rd.insert_sorted(k, device)
        remaining = [k for t, k in enumerate(remaining) if t not in (i, j)]
        comb = profile_combine(ka, kb, device)
        # Keep absorbing the best-fitting kernel (Alg. 1 lines 8-11).
        while True:
            fits = [k for k in remaining if fits_together(comb, k, device)]
            if not fits:
                break
            scores = score_vector(comb, fits, device)
            kc = fits[max(range(len(fits)), key=scores.__getitem__)]
            rd.insert_sorted(kc, device)
            comb = profile_combine(comb, kc, device)
            remaining.remove(kc)
        rounds.append(rd)
    return Schedule(rounds)


# ---------------------------------------------------------------------------
# Design-space evaluation helpers
# ---------------------------------------------------------------------------

def exhaustive_search(
    kernels: Sequence[KernelProfile],
    time_fn: Callable[[Sequence[KernelProfile]], float],
    limit: int | None = None,
) -> list[tuple[float, tuple[int, ...]]]:
    """Evaluate ``time_fn`` on every permutation (or the first ``limit``).

    Returns ``[(time, perm_indices)]`` sorted ascending by time.
    """
    idx = range(len(kernels))
    out: list[tuple[float, tuple[int, ...]]] = []
    for c, perm in enumerate(itertools.permutations(idx)):
        if limit is not None and c >= limit:
            break
        out.append((time_fn([kernels[p] for p in perm]), perm))
    out.sort(key=lambda t: t[0])
    return out


def random_orders(kernels: Sequence[KernelProfile], n: int,
                  seed: int = 0) -> list[list[KernelProfile]]:
    rng = _random.Random(seed)
    outs = []
    for _ in range(n):
        p = list(kernels)
        rng.shuffle(p)
        outs.append(p)
    return outs


def percentile_rank(value: float, population: Sequence[float]) -> float:
    """Percentile (0-100) of the population that is *no better* (>=)
    than ``value``.

    Matches the paper's usage: a launch order at ``percentile_rank ==
    96.0`` beats 96% of all permutations (lower time is better).  The
    return value is a percentage, **not** a 0-1 fraction — pinned by
    ``tests/test_fastscore.py::test_percentile_rank_convention``.
    """
    population = list(population)
    if not population:
        return 0.0
    worse_or_equal = sum(1 for v in population if v >= value)
    return 100.0 * worse_or_equal / len(population)
