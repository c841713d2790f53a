"""Vectorized scoring core + incremental greedy scheduler.

The reference implementation (:mod:`repro_torch.core.scheduler`) follows the
paper's pseudocode: every round re-runs ScoreGen over all remaining
pairs in pure Python, which is ``O(R * n^2)`` scored pairs and
unusable beyond a few dozen kernels.  This module is the production
hot path:

* :class:`ProfileTable` packs ``KernelProfile`` demand dicts into
  NumPy arrays **once** (per-unit demands in ``device.caps`` order,
  block counts, intensities),
* :func:`pair_score_matrix` computes the full pairwise score matrix
  with broadcasting in ``O(n^2 * D)``, and
* :func:`greedy_order_fast` runs Algorithm 1 *incrementally*: the
  pairwise matrix is computed a single time (pair scores between
  original kernels never change between rounds — only membership
  does), and during round construction only the 1xn score vector of
  the current round's combined profile against the remaining kernels
  is recomputed, ``O(n * D)`` per absorption.

The fast path reproduces the reference scheduler's output *exactly* —
same rounds, same intra-round order — including tie-breaking (first
strict maximum in remaining-order row-major scan).  This is enforced
by ``tests/test_fastscore.py`` on randomized profile sets; the
arithmetic is kept operation-for-operation identical to
:mod:`repro_torch.core.scorer` so even near-ties resolve the same way.

This module schedules *independent* kernel batches.  When the kernels
carry precedence edges (traced per-layer model chains — see
``repro.graph.trace_arch``), call
:func:`repro.graph.greedy_order_dag`: it reuses this module's
``ProfileTable``/``pair_score_matrix`` machinery, restricts candidate
scans to the ready frontier, and degenerates to
:func:`greedy_order_fast` bit-for-bit on an empty edge set.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from .resources import DeviceModel, KernelProfile
from .scheduler import Round, Schedule, _sort_key

__all__ = ["ProfileTable", "pair_score_matrix", "score_matrix_fast",
           "greedy_order_fast", "warm_start_insert"]


@dataclass
class ProfileTable:
    """Array-backed view of a kernel set against one device model."""

    device: DeviceModel
    kernels: list[KernelProfile]
    dims: tuple[str, ...]
    caps: np.ndarray       # (D,) per-unit capacity, caps order
    per_unit: np.ndarray   # (n, D) per-unit aggregate demand
    bpu: np.ndarray        # (n,) resident blocks per unit
    n_blocks: np.ndarray   # (n,) grid size
    inst: np.ndarray       # (n,) work units per block
    r: np.ndarray          # (n,) intensity R_i
    sort_key: np.ndarray   # (n,) intra-round sort key (paper: N_shm)

    @classmethod
    def build(cls, kernels: Sequence[KernelProfile],
              device: DeviceModel) -> "ProfileTable":
        ks = list(kernels)
        dims = tuple(device.caps)
        n, D = len(ks), len(dims)
        per_unit = np.zeros((n, D), dtype=np.float64)
        bpu = np.zeros(n, dtype=np.float64)
        n_blocks = np.zeros(n, dtype=np.float64)
        inst = np.zeros(n, dtype=np.float64)
        r = np.zeros(n, dtype=np.float64)
        for i, k in enumerate(ks):
            d = k.per_unit_demand(device)
            for j, dim in enumerate(dims):
                per_unit[i, j] = d[dim]
            bpu[i] = k.blocks_per_unit(device)
            n_blocks[i] = k.n_blocks
            inst[i] = k.inst_per_block
            r[i] = k.r
        # The reference's own sort key, per kernel: its fallback (no
        # "shm" dimension) reads the *kernel's* first declared demand,
        # which need not be the first device.caps dimension.
        sort_key = np.asarray([_sort_key(k, device) for k in ks],
                              dtype=np.float64)
        caps = np.asarray([device.cap(d) for d in dims], dtype=np.float64)
        return cls(device=device, kernels=ks, dims=dims, caps=caps,
                   per_unit=per_unit, bpu=bpu, n_blocks=n_blocks,
                   inst=inst, r=r, sort_key=sort_key)

    def __len__(self) -> int:
        return len(self.kernels)


def _combined_ratio_arrays(table: ProfileTable) -> np.ndarray:
    """(n, n) combined-ratio matrix per ``device.combined_r`` —
    operation-for-operation the same arithmetic as
    :func:`repro_torch.core.scorer.combined_ratio`."""
    if table.device.combined_r == "harmonic":
        work = table.inst * table.n_blocks
        byts = work / np.maximum(table.r, 1e-30)
        return (work[:, None] + work[None, :]) / \
            np.maximum(byts[:, None] + byts[None, :], 1e-30)
    nbr = table.n_blocks * table.r
    return (nbr[:, None] + nbr[None, :]) / \
        (table.n_blocks[:, None] + table.n_blocks[None, :])


def pair_score_matrix(table: ProfileTable) -> np.ndarray:
    """Full pairwise ScoreGen matrix, elementwise equal to the
    reference ``score_matrix(ks, ks, device)`` (diagonal included)."""
    dev = table.device
    d = table.per_unit
    sum_d = d[:, None, :] + d[None, :, :]                      # (n,n,D)
    fits = table.bpu[:, None] + table.bpu[None, :] <= dev.max_resident
    fits &= np.all(sum_d <= table.caps, axis=-1)
    # ((cap - da) - db), matching the reference's float association —
    # cap - (da + db) can differ in the last ulp and flip near-ties.
    resid = np.sum(
        dev.residual_weight * np.maximum(
            (table.caps - d[:, None, :] - d[None, :, :]) / table.caps,
            0.0), axis=-1)
    rb = dev.r_balanced
    ri, rj = table.r[:, None], table.r[None, :]
    gate = ((ri <= rb) & (rb <= rj)) | ((rj <= rb) & (rb <= ri))
    with np.errstate(divide="ignore", invalid="ignore"):
        rc = _combined_ratio_arrays(table)
    rterm = dev.r_weight * np.maximum(1.0 - np.abs(rc - rb) / rb, 0.0)
    score = resid + np.where(gate, rterm, 0.0)
    return np.where(fits, score, 0.0)


def score_matrix_fast(kernels: Sequence[KernelProfile],
                      device: DeviceModel) -> np.ndarray:
    """Vectorized ScoreGen(K, K); drop-in for the reference
    ``score_matrix`` on a single kernel set."""
    return pair_score_matrix(ProfileTable.build(kernels, device))


@dataclass
class _CombState:
    """The round's virtual combined profile, in array form.

    Mirrors ``profile_combine`` exactly: per-unit demands add, block
    counts and per-block work add, the ratio combines per
    ``device.combined_r`` sequentially (pair by pair, matching the
    reference's left fold)."""

    demand: np.ndarray   # (D,) aggregated per-unit demand
    bpu: float
    n_blocks: float
    inst: float
    r: float


def _comb_ratio_scalar(dev: DeviceModel, nb_a: float, inst_a: float,
                       r_a: float, nb_b: float, inst_b: float,
                       r_b: float) -> float:
    if dev.combined_r == "harmonic":
        work = inst_a * nb_a + inst_b * nb_b
        byts = (inst_a * nb_a / max(r_a, 1e-30) +
                inst_b * nb_b / max(r_b, 1e-30))
        return work / max(byts, 1e-30)
    return (nb_a * r_a + nb_b * r_b) / (nb_a + nb_b)


def _comb_scores(comb: _CombState, table: ProfileTable,
                 idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """ScoreGen of the combined profile vs ``table[idx]``: the 1xm
    score vector plus the fits mask, ``O(m * D)``."""
    dev = table.device
    d = table.per_unit[idx]
    sum_d = comb.demand + d                                    # (m, D)
    fits = comb.bpu + table.bpu[idx] <= dev.max_resident
    fits &= np.all(sum_d <= table.caps, axis=-1)
    # ((cap - da) - db) association, as in the reference (a = comb).
    resid = np.sum(
        dev.residual_weight * np.maximum(
            ((table.caps - comb.demand) - d) / table.caps, 0.0),
        axis=-1)
    rb = dev.r_balanced
    rc_ = table.r[idx]
    gate = ((comb.r <= rb) & (rb <= rc_)) | ((rc_ <= rb) & (rb <= comb.r))
    if dev.combined_r == "harmonic":
        work_c = table.inst[idx] * table.n_blocks[idx]
        byts_c = work_c / np.maximum(table.r[idx], 1e-30)
        work = comb.inst * comb.n_blocks + work_c
        byts = comb.inst * comb.n_blocks / max(comb.r, 1e-30) + byts_c
        rc = work / np.maximum(byts, 1e-30)
    else:
        rc = (comb.n_blocks * comb.r +
              table.n_blocks[idx] * table.r[idx]) / \
            (comb.n_blocks + table.n_blocks[idx])
    rterm = dev.r_weight * np.maximum(1.0 - np.abs(rc - rb) / rb, 0.0)
    return resid + np.where(gate, rterm, 0.0), fits


def _absorb(comb: _CombState, table: ProfileTable, c: int,
            dev: DeviceModel) -> _CombState:
    new_r = _comb_ratio_scalar(
        dev, comb.n_blocks, comb.inst, comb.r,
        table.n_blocks[c], table.inst[c], table.r[c])
    return _CombState(demand=comb.demand + table.per_unit[c],
                      bpu=comb.bpu + table.bpu[c],
                      n_blocks=comb.n_blocks + table.n_blocks[c],
                      inst=comb.inst + table.inst[c],
                      r=new_r)


def warm_start_insert(rounds: Sequence[Sequence[KernelProfile]],
                      extra: KernelProfile,
                      device: DeviceModel) -> int:
    """Greedy ScoreGen placement of one extra kernel into an existing
    round composition.

    Returns the index of the best-scoring round whose combined profile
    (ProfileCombine fold, exactly as the incremental greedy maintains
    it) still fits together with ``extra``, or ``-1`` when no round
    fits and the kernel must open a new round.

    This is the ScheduleCache warm-start primitive: a near-miss cached
    composition (one request joined the mix since the cached step) is
    adapted by absorbing the newcomer where Algorithm 1's own scoring
    would put it, instead of recomputing the whole composition from
    scratch.
    """
    rounds = [rd for rd in rounds if rd]
    if not rounds:
        return -1
    all_ks = [k for rd in rounds for k in rd] + [extra]
    table = ProfileTable.build(all_ks, device)
    extra_idx = np.asarray([len(all_ks) - 1])
    best_i, best_s = -1, -np.inf
    base = 0
    for i, rd in enumerate(rounds):
        comb = _CombState(demand=table.per_unit[base].copy(),
                          bpu=float(table.bpu[base]),
                          n_blocks=float(table.n_blocks[base]),
                          inst=float(table.inst[base]),
                          r=float(table.r[base]))
        for c in range(base + 1, base + len(rd)):
            comb = _absorb(comb, table, c, device)
        base += len(rd)
        scores, fits = _comb_scores(comb, table, extra_idx)
        if bool(fits[0]) and float(scores[0]) > best_s:
            best_i, best_s = i, float(scores[0])
    return best_i


def greedy_order_fast(kernels: Sequence[KernelProfile],
                      device: DeviceModel,
                      table: ProfileTable | None = None) -> Schedule:
    """Algorithm 1, incremental: identical schedules to
    ``scheduler.greedy_order`` in ``O(n^2 * D)`` instead of
    ``O(R * n^2)`` Python-level ScoreGen reruns.

    ``table`` accepts an already-built :class:`ProfileTable` for the
    same ``(kernels, device)`` so a greedy + refine pipeline
    (:func:`repro.core.refine.refined_schedule`) packs exactly once."""
    n = len(kernels)
    if n == 0:
        return Schedule([])
    if table is None:
        table = ProfileTable.build(kernels, device)
    mat = pair_score_matrix(table)
    # Mask the lower triangle and diagonal: pair_score(a, b) and
    # pair_score(b, a) can differ in the last ulp (the residual term's
    # float association is order-dependent), so the argmax must scan
    # exactly the i < j entries the reference scan evaluates.  Dead
    # rows/cols are masked the same way as kernels leave.
    mat[np.tril_indices(n)] = -1.0
    alive = np.ones(n, dtype=bool)
    rounds: list[Round] = []
    n_alive = n

    def kill(i: int) -> None:
        nonlocal n_alive
        alive[i] = False
        mat[i, :] = -1.0
        mat[:, i] = -1.0
        n_alive -= 1

    while n_alive:
        rd = Round()
        if n_alive == 1:
            rd.kernels.append(table.kernels[int(np.nonzero(alive)[0][0])])
            rounds.append(rd)
            break
        # Seed pair: first strict maximum over the remaining i < j
        # entries in row-major order — the same pair the reference's
        # i < j scan picks.
        flat = int(np.argmax(mat))
        i, j = divmod(flat, n)
        best = mat[i, j]
        fits_pair = (
            table.bpu[i] + table.bpu[j] <= device.max_resident and
            bool(np.all(table.per_unit[i] + table.per_unit[j] <=
                        table.caps)))
        if best <= 0.0 and not fits_pair:
            # Nothing pairs: the heaviest (sort-key) kernel runs alone.
            idx = np.nonzero(alive)[0]
            solo = int(idx[int(np.argmax(table.sort_key[idx]))])
            kill(solo)
            rd.kernels.append(table.kernels[solo])
            rounds.append(rd)
            continue
        rd.insert_sorted(table.kernels[i], device)
        rd.insert_sorted(table.kernels[j], device)
        comb = _CombState(
            demand=table.per_unit[i] + table.per_unit[j],
            bpu=table.bpu[i] + table.bpu[j],
            n_blocks=table.n_blocks[i] + table.n_blocks[j],
            inst=table.inst[i] + table.inst[j],
            r=_comb_ratio_scalar(device, table.n_blocks[i], table.inst[i],
                                 table.r[i], table.n_blocks[j],
                                 table.inst[j], table.r[j]))
        kill(i)
        kill(j)
        # Absorb best-fitting kernels: only the 1xm combined-vs-rest
        # vector is recomputed per absorption (incremental ScoreGen).
        while n_alive:
            idx = np.nonzero(alive)[0]
            scores, fits = _comb_scores(comb, table, idx)
            if not fits.any():
                break
            scores = np.where(fits, scores, -np.inf)
            c = int(idx[int(np.argmax(scores))])
            rd.insert_sorted(table.kernels[c], device)
            comb = _absorb(comb, table, c, device)
            kill(c)
        rounds.append(rd)
    return Schedule(rounds)
