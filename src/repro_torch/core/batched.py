"""Batched candidate evaluation: score and refine many orders per
dispatch.

The refinement loop (:mod:`repro_torch.core.refine`) was the optimizer's own
bottleneck: `pair_score_matrix` is host float64 NumPy and the fast
simulators are pure-Python tuple loops, so every candidate suffix is
re-simulated one at a time.  Following the dispatch discipline of the
gstaichi exemplar (each device dispatch must carry enough work to hide
its launch cost) and the batched-over-sequential argument of Pati et
al. (arXiv 2409.02227), this module evaluates **B candidate orders per
dispatch**:

* :func:`pair_score_matrix_batched` — the ScoreGen pair matrix in
  float32 in PyTorch on ``device`` (the card unless the caller asks
  for the CPU; packed once per
  :class:`~repro_torch.core.fastscore.ProfileTable`),
  with the NumPy float32 path kept and a documented tolerance audit
  (:func:`audit_pair_scores`) against the float64 reference.  The
  greedy itself keeps consuming the float64 matrix — its tie-breaking
  is bit-exact by contract — so the f32 path is for batched evaluation
  and device-resident scoring only.
* :class:`BatchedRoundSim` / :class:`BatchedEventSim` — lockstep
  vectorized twins of :class:`repro_torch.core.refine._FastRoundSim` /
  ``_FastEventSim`` (and, with precedence arrays, of
  :class:`repro.graph.delta._FastGatedSim`): all B candidates advance
  together through admission/completion steps on ``(B, U, C)`` state
  arrays, resuming from per-candidate checkpoint-stitched suffixes.
  The round engine replays the reference float64 accumulation
  operation-for-operation (exact); the event/gated engines vectorize
  the round-robin first-fit block admission as *cyclic dealing* (see
  :meth:`BatchedEventSim._deal`) whose allocation provably equals the
  reference's block-by-block placement — only the float accumulation
  *order* differs (``used += k * dem`` vs k sequential adds), bounded
  by :data:`EVENT_TIME_RTOL`.
* :func:`refine_order_batched` — the batched move evaluator behind
  ``refine_order(..., batch_size=)`` and its DAG/slice counterparts:
  the swap/reinsert neighborhood is generated as a ``(B, n)`` order
  batch, all B candidates are delta-evaluated in one vectorized pass,
  and the **best improving move per batch** is accepted instead of the
  first-improving one.  Budget accounting is unchanged (every
  candidate charged its suffix fraction in full-simulation
  equivalents).  Because the vectorized times are used only to *rank*
  moves, every acceptance is re-verified by the sequential
  :class:`~repro_torch.core.refine.DeltaEvaluator` before it lands — the
  accepted trajectory stays in the exact simulator currency, which is
  what pins refined quality at no-worse-than-input and keeps the
  round-model result set bit-equal to sequential evaluation.

The compiled counterpart of the event engine — the admission/
completion scan as a CUDA kernel with a plain PyTorch version — lives
in :mod:`repro_torch.kernels.event_scan`; the simulators here are NumPy
only, so the tests never require a device.
"""

from __future__ import annotations

from time import perf_counter
from typing import Callable, Sequence

import numpy as np
import torch

from .fastscore import ProfileTable
from .resources import DeviceModel, KernelProfile
from .simulator import EventCheckpoint, RoundCheckpoint

__all__ = ["F32_SCORE_RTOL", "EVENT_TIME_RTOL",
           "pair_score_matrix_batched", "audit_pair_scores",
           "PackedKernels", "BatchedRoundSim", "BatchedEventSim",
           "refine_order_batched"]

#: Documented float32 tolerance of :func:`pair_score_matrix_batched`
#: against the float64 reference ``pair_score_matrix``: scores are
#: sums of O(D) ratio terms of well-scaled magnitudes, so the f32
#: relative error stays within a few ulps (audited by
#: :func:`audit_pair_scores`; property-tested in tests/test_batched.py).
F32_SCORE_RTOL = 1e-5

#: Documented tolerance of the vectorized event/gated engines against
#: the sequential fast simulators: the dealing step accumulates
#: ``used`` and cohort work sums with a different float association
#: than the reference's block-by-block loop, so modelled times agree
#: to this *relative* tolerance rather than bit-exactly (the round
#: engine, which replays the reference op order, is exact).
EVENT_TIME_RTOL = 1e-9


# --------------------------------------------------------------------
# float32 pair scoring (PyTorch, with the NumPy path kept)
# --------------------------------------------------------------------

def _pair_scores_f32(xp, caps, per_unit, bpu, n_blocks, inst, r, *,
                     max_resident, residual_weight, r_weight,
                     r_balanced, combined_r):
    """ScoreGen(K, K) in float32 on backend ``xp``: numpy, or a
    :class:`_TorchXp` for torch tensors.

    Same term structure as :func:`repro_torch.core.fastscore.pair_score_matrix`
    including the ``((cap - da) - db)`` residual association; only the
    dtype differs."""
    d = per_unit
    fits = (bpu[:, None] + bpu[None, :]) <= max_resident
    sum_d = d[:, None, :] + d[None, :, :]
    fits = fits & xp.all(sum_d <= caps, axis=-1)
    resid = xp.sum(
        residual_weight * xp.maximum(
            (caps - d[:, None, :] - d[None, :, :]) / caps,
            xp.float32(0.0)), axis=-1)
    rb = xp.float32(r_balanced)
    ri, rj = r[:, None], r[None, :]
    gate = ((ri <= rb) & (rb <= rj)) | ((rj <= rb) & (rb <= ri))
    tiny = xp.float32(1e-30)
    if combined_r == "harmonic":
        work = inst * n_blocks
        byts = work / xp.maximum(r, tiny)
        rc = (work[:, None] + work[None, :]) / \
            xp.maximum(byts[:, None] + byts[None, :], tiny)
    else:
        nbr = n_blocks * r
        rc = (nbr[:, None] + nbr[None, :]) / \
            (n_blocks[:, None] + n_blocks[None, :])
    rterm = xp.float32(r_weight) * xp.maximum(
        xp.float32(1.0) - xp.abs(rc - rb) / rb, xp.float32(0.0))
    score = resid + xp.where(gate, rterm, xp.float32(0.0))
    return xp.where(fits, score, xp.float32(0.0))


class _TorchXp:
    """The handful of NumPy calls :func:`_pair_scores_f32` makes, on
    torch tensors of one device: one scoring body serves both paths."""

    def __init__(self, device):
        self.device = device

    def float32(self, v):
        return torch.tensor(v, dtype=torch.float32, device=self.device)

    @staticmethod
    def all(x, axis):
        return torch.all(x, dim=axis)

    @staticmethod
    def sum(x, axis):
        return torch.sum(x, dim=axis)

    maximum = staticmethod(torch.maximum)
    abs = staticmethod(torch.abs)
    where = staticmethod(torch.where)


def _f32_pack(table: ProfileTable) -> dict:
    """float32 views of the table's arrays, packed once per table."""
    pack = getattr(table, "_f32_pack", None)
    if pack is None:
        pack = {
            "caps": np.asarray(table.caps, dtype=np.float32),
            "per_unit": np.asarray(table.per_unit, dtype=np.float32),
            "bpu": np.asarray(table.bpu, dtype=np.float32),
            "n_blocks": np.asarray(table.n_blocks, dtype=np.float32),
            "inst": np.asarray(table.inst, dtype=np.float32),
            "r": np.asarray(table.r, dtype=np.float32),
        }
        table._f32_pack = pack
    return pack


def _torch_pack(table: ProfileTable, device: torch.device) -> dict:
    """The f32 pack as tensors on ``device``, moved there once per
    table and device."""
    packs = getattr(table, "_f32_torch", None)
    if packs is None:
        packs = table._f32_torch = {}
    pack = packs.get(device)
    if pack is None:
        pack = packs[device] = {k: torch.from_numpy(v).to(device)
                                for k, v in _f32_pack(table).items()}
    return pack


def pair_score_matrix_batched(table: ProfileTable, backend: str = "auto",
                              device="cuda") -> np.ndarray:
    """Full pairwise ScoreGen matrix in float32 in PyTorch on
    ``device`` (``backend="auto"``; the card unless the caller asks for
    the CPU), equal to the float64
    ``pair_score_matrix`` within :data:`F32_SCORE_RTOL`.
    ``backend="numpy"`` is the reference's host path, kept as its
    bit-for-bit twin — same arithmetic, same dtype.  Returns a NumPy
    array either way."""
    if backend not in ("auto", "numpy"):
        raise ValueError(f"unknown backend {backend!r}")
    dev = table.device
    kw = dict(max_resident=float(dev.max_resident),
              residual_weight=float(dev.residual_weight),
              r_weight=float(dev.r_weight),
              r_balanced=float(dev.r_balanced),
              combined_r=dev.combined_r)
    if backend == "numpy":
        host = _f32_pack(table)
        return _pair_scores_f32(np, host["caps"], host["per_unit"],
                                host["bpu"], host["n_blocks"],
                                host["inst"], host["r"], **kw)
    device = torch.device(device)
    pack = _torch_pack(table, device)
    out = _pair_scores_f32(_TorchXp(device), pack["caps"], pack["per_unit"],
                           pack["bpu"], pack["n_blocks"], pack["inst"],
                           pack["r"], **kw)
    return out.cpu().numpy()


def audit_pair_scores(table: ProfileTable, backend: str = "auto",
                      device="cuda") -> dict:
    """Tolerance audit of the f32 score matrix against the float64
    reference: returns max absolute/relative error and whether both
    stay within :data:`F32_SCORE_RTOL` (relative to the score scale).
    The greedy never consumes the f32 matrix — near-tie argmax
    decisions must replay the reference bit-for-bit — so this audit is
    the documented contract of the batched scoring path."""
    from .fastscore import pair_score_matrix
    ref = pair_score_matrix(table)
    f32 = pair_score_matrix_batched(table, backend=backend, device=device)
    err = np.abs(f32.astype(np.float64) - ref)
    scale = max(float(np.max(np.abs(ref))), 1.0)
    max_abs = float(np.max(err)) if err.size else 0.0
    return {"max_abs_err": max_abs,
            "max_rel_err": max_abs / scale,
            "scale": scale,
            "rtol": F32_SCORE_RTOL,
            "within_tol": max_abs <= F32_SCORE_RTOL * scale}


# --------------------------------------------------------------------
# packed kernel universe (one pack per ProfileTable)
# --------------------------------------------------------------------

class PackedKernels:
    """Per-block kernel arrays for the batched simulators, packed once
    per :class:`ProfileTable` (cached on the table, so the greedy ->
    refine pipeline packs exactly once — the pack-count probe in
    tests/test_batched.py pins this).

    Per-kernel rows, float64: ``dem`` (K, D) per-*block* demands in
    ``device.caps`` order, ``nbk`` grid sizes, ``bpu`` resident blocks
    per unit (round model), ``inst_b``/``mem_b`` per-block work, and
    ``zero`` flags for zero-work synchronisation markers (slice
    joins).  ``id2idx`` maps kernel object identity to its row."""

    def __init__(self, table: ProfileTable):
        self.table = table
        dev = table.device
        dims = table.dims
        ks = table.kernels
        K, D = len(ks), len(dims)
        self.caps = np.asarray(table.caps, dtype=np.float64)
        self.dem = np.zeros((K, D), dtype=np.float64)
        self.nbk = np.zeros(K, dtype=np.int64)
        self.bpu = np.zeros(K, dtype=np.int64)
        self.inst_b = np.zeros(K, dtype=np.float64)
        self.mem_b = np.zeros(K, dtype=np.float64)
        self.zero = np.zeros(K, dtype=bool)
        for i, k in enumerate(ks):
            for j, dim in enumerate(dims):
                self.dem[i, j] = k.demands[dim]
            self.nbk[i] = int(k.n_blocks)
            self.bpu[i] = int(k.blocks_per_unit(dev))
            self.inst_b[i] = k.inst_per_block
            self.mem_b[i] = k.mem_per_block()
            self.zero[i] = (k.inst_per_block == 0.0 and
                            all(v == 0.0 for v in k.demands.values()))
        self.id2idx = {id(k): i for i, k in enumerate(ks)}
        self.sat_idx = (dims.index(dev.sat_dim)
                        if dev.sat_dim in dims else -1)
        self.device = dev

    @classmethod
    def for_table(cls, table: ProfileTable) -> "PackedKernels":
        packed = getattr(table, "_packed_kernels", None)
        if packed is None:
            packed = cls(table)
            table._packed_kernels = packed
        return packed

    def rows(self, order: Sequence[KernelProfile]) -> np.ndarray:
        return np.asarray([self.id2idx[id(k)] for k in order],
                          dtype=np.int64)


def _eff_arr(occ: np.ndarray, sat: float, sat_idx: int,
             eps: float) -> np.ndarray:
    if sat_idx < 0:
        return np.ones_like(occ)
    return np.maximum(np.minimum(1.0, occ / sat), eps)


# --------------------------------------------------------------------
# batched round model (exact float64 lockstep)
# --------------------------------------------------------------------

class BatchedRoundSim:
    """Lockstep vectorized :class:`repro_torch.core.refine._FastRoundSim`:
    all B candidates advance one admission step per iteration on (B,)
    state arrays, replaying the reference's float accumulation in the
    reference's order — times are *exactly* equal to the sequential
    simulator (property-tested), because every candidate performs the
    identical scalar op sequence, merely alongside B - 1 others."""

    _EPS = 1e-12

    def __init__(self, packed: PackedKernels):
        self.packed = packed
        dev = packed.device
        self.device = dev
        self._satc = dev.sat_compute
        self._satm = dev.sat_memory
        self._crate = dev.compute_rate
        self._mbw = dev.mem_bw

    def times(self, orders: np.ndarray, start_pos: np.ndarray,
              head_blocks: np.ndarray, t0: np.ndarray) -> np.ndarray:
        """Round-model times of ``orders`` (B, n), candidate b resumed
        at position ``start_pos[b]`` with ``head_blocks[b]`` blocks
        left on its head kernel and ``t0[b]`` elapsed time — the
        :class:`~repro_torch.core.simulator.RoundCheckpoint` resume state."""
        pk = self.packed
        dev = self.device
        eps = self._EPS
        caps = pk.caps
        B, n = orders.shape
        D = caps.shape[0]
        max_res = dev.max_resident
        sat_idx = pk.sat_idx

        head = np.asarray(start_pos, dtype=np.int64).copy()
        t = np.asarray(t0, dtype=np.float64).copy()
        bleft = np.where(head < n, head_blocks, 0).astype(np.int64)
        used = np.zeros((B, D), dtype=np.float64)
        blocks = np.zeros(B, dtype=np.int64)
        inst = np.zeros(B, dtype=np.float64)
        mem = np.zeros(B, dtype=np.float64)
        open_rd = np.zeros(B, dtype=bool)   # current round has blocks
        done = head >= n
        bidx = np.arange(B)

        guard = 0
        while not done.all():
            guard += 1
            if guard > 1_000_000:
                raise RuntimeError("BatchedRoundSim failed to converge")
            act = ~done
            kid = orders[bidx, np.minimum(head, n - 1)]
            dem = pk.dem[kid]                                  # (B, D)
            # fit: min over demanded dims of floor((cap - used + eps)
            # / dem), clipped by the head's remaining blocks and the
            # resident-block budget — the reference's admission test.
            with np.errstate(divide="ignore", invalid="ignore"):
                per_dim = np.floor_divide(caps - used + eps,
                                          np.where(dem > 0, dem, 1.0))
            per_dim = np.where(dem > 0, per_dim, np.inf)
            fit = np.minimum(per_dim.min(axis=1), bleft.astype(np.float64))
            fit = np.maximum(np.minimum(fit, max_res - blocks), 0.0)
            fit = fit.astype(np.int64)
            oversized = act & (fit == 0) & (blocks == 0)
            fit = np.where(oversized, 1, fit)
            closing = act & (fit == 0)     # head closes the round
            placing = act & (fit > 0)

            used += np.where(placing[:, None], dem * fit[:, None], 0.0)
            blocks += np.where(placing, fit, 0)
            inst += np.where(placing, pk.inst_b[kid] * fit, 0.0)
            mem += np.where(placing, pk.mem_b[kid] * fit, 0.0)
            open_rd |= placing
            new_bleft = bleft - np.where(placing, fit, 0)
            # Partially admitted head: the unit is full, the round
            # closes (the reference's `pending[head][0] is k` break).
            closing |= placing & (new_bleft > 0)
            advanced = placing & (new_bleft == 0)
            head = head + np.where(advanced, 1, 0)
            at_end = act & (head >= n)
            closing |= at_end & open_rd
            done = done | (at_end & ~open_rd & ~closing)
            nxt = orders[bidx, np.minimum(head, n - 1)]
            # The round queue dispatches blocks-per-unit, not grid
            # blocks (the reference's pending entries carry bpu).
            bleft = np.where(advanced & (head < n), pk.bpu[nxt],
                             new_bleft)

            if closing.any():
                occ = used[:, sat_idx] if sat_idx >= 0 \
                    else np.zeros(B)
                eff_c = _eff_arr(occ, self._satc, sat_idx, eps)
                eff_m = _eff_arr(occ, self._satm, sat_idx, eps)
                rd_t = np.maximum(inst / (self._crate * eff_c),
                                  mem / (self._mbw * eff_m))
                t = np.where(closing, t + rd_t, t)
                used[closing] = 0.0
                blocks[closing] = 0
                inst[closing] = 0.0
                mem[closing] = 0.0
                open_rd[closing] = False
                done = done | (closing & (head >= n))
        return t

    def times_from_checkpoints(
            self, orders: np.ndarray,
            cps: Sequence[RoundCheckpoint | None]) -> np.ndarray:
        B, n = orders.shape
        start = np.zeros(B, dtype=np.int64)
        hb = np.zeros(B, dtype=np.int64)
        t0 = np.zeros(B, dtype=np.float64)
        for b, cp in enumerate(cps):
            if cp is None:
                hb[b] = self.packed.bpu[orders[b, 0]] if n else 0
            else:
                start[b] = cp.pos
                hb[b] = cp.blocks_left
                t0[b] = cp.time
        # The round queue dispatches blocks-per-unit, not grid blocks.
        fresh = np.asarray([cp is None for cp in cps])
        if fresh.any() and n:
            hb = np.where(fresh, self.packed.bpu[orders[:, 0]], hb)
        return self.times(orders, start, hb, t0)


# --------------------------------------------------------------------
# batched event / gated-event model (lockstep dealing)
# --------------------------------------------------------------------

class BatchedEventSim:
    """Lockstep vectorized event dispatcher: B candidates advance
    together through admission instants and completion events on
    ``(B, U, C)`` state arrays (C = ``min(max_resident, n)`` cohort
    slots per unit — each cohort holds >= 1 resident block of a
    kernel admitted exactly once, so slots never overflow).

    Admission vectorizes the reference's round-robin first-fit
    block-by-block loop as **cyclic dealing**: per admission instant
    each unit u can hold ``c_u = min(min_d floor((cap_d + eps -
    used_d) / dem_d), max_resident - n_res_u)`` more blocks of the
    head kernel, and placing m blocks one at a time in cyclic
    first-fit order from the round-robin pointer provably gives unit u
    exactly ``min(c_u, L)`` blocks plus one extra for the first
    ``m - sum_u min(c_u, L)`` units with ``c_u > L`` in cyclic order
    (L the deepest fully dealt level); the pointer ends one past the
    last placed block.  The allocation, admission decisions and event
    ordering therefore match the reference exactly; only the float
    *association* of ``used``/work-sum accumulation differs (one
    multiply per dealing vs per-block adds), bounded by
    :data:`EVENT_TIME_RTOL` (property-tested).

    With ``edge_ids`` (precedence as ``(id(u), id(v))`` pairs over the
    packed kernel universe) the same engine enforces the ready-set
    admission gate of :class:`repro.graph.delta._FastGatedSim`:
    per-kernel retired-block counts gate the head, zero-work join
    markers retire instantly, and an unready head at drain marks the
    candidate's time ``+inf`` (the sequential simulator raises — such
    candidates are filtered by the legality check before simulation).
    """

    _EPS = 1e-12

    def __init__(self, packed: PackedKernels,
                 edge_ids: set | None = None):
        self.packed = packed
        dev = packed.device
        self.device = dev
        self.gated = edge_ids is not None
        K = len(packed.nbk)
        if self.gated:
            preds: list[list[int]] = [[] for _ in range(K)]
            for u, v in edge_ids:
                preds[packed.id2idx[v]].append(packed.id2idx[u])
            P = max((len(p) for p in preds), default=0)
            self.preds_pad = np.full((K, max(P, 1)), -1, dtype=np.int64)
            for i, p in enumerate(preds):
                self.preds_pad[i, :len(p)] = sorted(p)

    def _rates(self, used, cin, cmb, cnb, occm):
        """Per-unit rates, sums recomputed fresh from the live cohort
        slots (matching the reference's recompute_rate).  ``cin`` /
        ``cmb`` are the per-slot inst/mem per-block caches (stale
        entries masked by ``cnb == 0``), so no kernel-table gather is
        needed per event."""
        pk = self.packed
        dev = self.device
        eps = self._EPS
        sum_c = (cin * cnb).sum(axis=2)
        sum_m = (cmb * cnb).sum(axis=2)
        if pk.sat_idx >= 0:
            occ = used[:, :, pk.sat_idx]
            eff_c = np.maximum(np.minimum(1.0, occ / dev.sat_compute),
                               eps)
            eff_m = np.maximum(np.minimum(1.0, occ / dev.sat_memory),
                               eps)
        else:
            eff_c = eff_m = np.ones(used.shape[:2])
        lam = np.minimum(dev.compute_rate * eff_c / np.maximum(sum_c, eps),
                         dev.mem_bw * eff_m / np.maximum(sum_m, eps))
        return np.where(occm.any(axis=2), lam, 0.0)

    def times(self, orders: np.ndarray,
              cps: Sequence[EventCheckpoint | None]) -> np.ndarray:
        """Event-model (or gated, when constructed with edges) times
        of ``orders`` (B, n); candidate b resumes from checkpoint
        ``cps[b]`` (None = fresh start).  Gate state for gated resumes
        is derived exactly as the sequential simulator derives it:
        positions before the checkpoint are fully retired minus the
        blocks still resident in its cohorts."""
        pk = self.packed
        dev = self.device
        eps = self._EPS
        caps = pk.caps
        B, n = orders.shape
        D = caps.shape[0]
        U = dev.n_units
        # Cohort slots: one dealing per (kernel, unit) at most, and a
        # kernel is admitted exactly once, so n slots always suffice —
        # serving devices advertise effectively-unbounded residency
        # (max_resident in the thousands), and sizing C to it would
        # blow the (B, U, C) state arrays up ~30x past what any
        # schedule can occupy.
        C = max(min(int(dev.max_resident), n), 1)
        max_res = dev.max_resident
        sat_idx = pk.sat_idx
        gated = self.gated
        bidx = np.arange(B)

        head = np.zeros(B, dtype=np.int64)
        rr = np.zeros(B, dtype=np.int64)
        t = np.zeros(B, dtype=np.float64)
        used = np.zeros((B, U, D), dtype=np.float64)
        nres = np.zeros((B, U), dtype=np.int64)
        ckn = np.full((B, U, C), -1, dtype=np.int64)
        cnb = np.zeros((B, U, C), dtype=np.int64)
        cfr = np.zeros((B, U, C), dtype=np.float64)
        # per-slot caches of the occupying kernel's per-block inst /
        # mem / demands, written once at placement so the event loop
        # never gathers from the kernel table (cnb == 0 masks stale
        # slots after retirement).
        cin = np.zeros((B, U, C), dtype=np.float64)
        cmb = np.zeros((B, U, C), dtype=np.float64)
        cdm = np.zeros((B, U, C, D), dtype=np.float64)
        failed = np.zeros(B, dtype=bool)
        if gated:
            retired = np.zeros((B, len(pk.nbk)), dtype=np.int64)
        for b, cp in enumerate(cps):
            if cp is None:
                continue
            head[b], rr[b], t[b] = cp.pos, cp.rr, cp.time
            if gated:
                for p in range(cp.pos):
                    retired[b, orders[b, p]] = pk.nbk[orders[b, p]]
            for ui, (u_used, u_nres, cohorts) in enumerate(cp.units):
                used[b, ui, :] = u_used
                nres[b, ui] = u_nres
                for si, (k, nb_c, fl, _ta) in enumerate(cohorts):
                    kidx = pk.id2idx[id(k)]
                    ckn[b, ui, si] = kidx
                    cnb[b, ui, si] = nb_c
                    cfr[b, ui, si] = fl
                    cin[b, ui, si] = pk.inst_b[kidx]
                    cmb[b, ui, si] = pk.mem_b[kidx]
                    cdm[b, ui, si, :] = pk.dem[kidx]
                    if gated:
                        retired[b, kidx] -= nb_c
        occm = ckn >= 0
        bleft = np.where(head < n,
                         pk.nbk[orders[bidx, np.minimum(head, n - 1)]],
                         0).astype(np.int64)
        done = (head >= n) & (nres.sum(axis=1) == 0)

        guard = 0
        while not done.all():
            guard += 1
            if guard > 1_000_000:
                raise RuntimeError("BatchedEventSim failed to converge")
            # -- admission: deal the head kernel while it places ------
            deal = ~done & (head < n)
            while deal.any():
                kid = orders[bidx, np.minimum(head, n - 1)]
                if gated:
                    pr = self.preds_pad[kid]                 # (B, P)
                    ready = np.all((pr < 0) |
                                   (retired[bidx[:, None],
                                            np.maximum(pr, 0)] >=
                                    pk.nbk[np.maximum(pr, 0)]), axis=1)
                    deal &= ready
                    zw = deal & pk.zero[kid]
                    if zw.any():
                        # Zero-work joins retire the instant their
                        # predecessors drain, occupying no unit.
                        retired[zw, kid[zw]] = pk.nbk[kid[zw]]
                        head = np.where(zw, head + 1, head)
                        nk = orders[bidx, np.minimum(head, n - 1)]
                        bleft = np.where(zw & (head < n), pk.nbk[nk],
                                         bleft)
                        deal &= head < n
                        continue
                if not deal.any():
                    break
                dem = pk.dem[kid]                            # (B, D)
                with np.errstate(divide="ignore", invalid="ignore"):
                    per_dim = np.floor((caps + eps - used) /
                                       np.where(dem[:, None, :] > 0,
                                                dem[:, None, :], 1.0))
                per_dim = np.where(dem[:, None, :] > 0, per_dim, np.inf)
                cap_u = np.minimum(per_dim.min(axis=2),
                                   (max_res - nres).astype(np.float64))
                cap_u = np.maximum(cap_u, 0.0)
                cap_u = np.where(deal[:, None], cap_u, 0.0)
                cap_u = cap_u.astype(np.int64)               # (B, U)
                m = np.minimum(bleft, cap_u.sum(axis=1))
                m = np.where(deal, m, 0)
                place, rr_deal = self._deal(cap_u, m, rr)    # (B, U)
                placing = m > 0
                if placing.any():
                    used += dem[:, None, :] * place[:, :, None]
                    nres += place
                    # one fresh cohort per (candidate, unit) dealing —
                    # candidate orders hold distinct kernel objects and
                    # admission instants strictly increase, so the
                    # reference's same-instant merge can never fire
                    # across dealings.
                    slot = np.argmin(occm, axis=2)           # first free
                    pb, pu = np.nonzero(place > 0)
                    ps = slot[pb, pu]
                    ckn[pb, pu, ps] = kid[pb]
                    cnb[pb, pu, ps] = place[pb, pu]
                    cfr[pb, pu, ps] = 1.0
                    cin[pb, pu, ps] = pk.inst_b[kid[pb]]
                    cmb[pb, pu, ps] = pk.mem_b[kid[pb]]
                    cdm[pb, pu, ps, :] = pk.dem[kid[pb]]
                    occm = ckn >= 0
                    # round-robin pointer: one past the last placed
                    # block (see _deal).
                    rr = np.where(placing, rr_deal, rr)
                    bleft = bleft - m
                adv = placing & (bleft == 0)
                head = head + np.where(adv, 1, 0)
                nk = orders[bidx, np.minimum(head, n - 1)]
                bleft = np.where(adv & (head < n), pk.nbk[nk], bleft)
                # blocked: head kernel still has blocks but nothing
                # placed (strict FIFO) — or the queue is drained.
                deal = deal & adv & (head < n)
            lam = self._rates(used, cin, cmb, cnb, occm)
            nres_tot = nres.sum(axis=1)
            done = done | ((head >= n) & (nres_tot == 0) & ~failed)

            # -- oversized heads run alone (drained units) -----------
            over = ~done & (nres_tot == 0) & (head < n)
            if gated and over.any():
                kid = orders[bidx, np.minimum(head, n - 1)]
                pr = self.preds_pad[kid]
                ready = np.all((pr < 0) |
                               (retired[bidx[:, None],
                                        np.maximum(pr, 0)] >=
                                pk.nbk[np.maximum(pr, 0)]), axis=1)
                bad = over & ~ready
                if bad.any():
                    # The sequential simulator raises ValueError here;
                    # batched candidates are pre-filtered for legality,
                    # so this only flags defensive +inf times.
                    failed |= bad
                    t = np.where(bad, np.inf, t)
                    done |= bad
                    over &= ready
            if over.any():
                kid = orders[bidx, np.minimum(head, n - 1)]
                dem = pk.dem[kid]
                occ = dem[:, sat_idx] if sat_idx >= 0 else np.zeros(B)
                eff_c = _eff_arr(occ, dev.sat_compute, sat_idx, eps)
                eff_m = _eff_arr(occ, dev.sat_memory, sat_idx, eps)
                t1 = np.maximum(pk.inst_b[kid] / (dev.compute_rate * eff_c),
                                pk.mem_b[kid] / (dev.mem_bw * eff_m))
                passes = np.ceil(bleft / U).astype(np.int64)
                t = np.where(over, t + passes * t1, t)
                if gated:
                    retired[over, kid[over]] = pk.nbk[kid[over]]
                head = head + np.where(over, 1, 0)
                nk = orders[bidx, np.minimum(head, n - 1)]
                bleft = np.where(over & (head < n), pk.nbk[nk], bleft)
                done = done | (over & (head >= n))

            # -- completion: advance to the next retirement ----------
            run = ~done & (nres_tot > 0)
            if run.any():
                with np.errstate(divide="ignore", invalid="ignore"):
                    ttf = np.where(occm, cfr / lam[:, :, None], np.inf)
                dt = ttf.min(axis=(1, 2))                    # (B,)
                dt = np.where(run, dt, 0.0)
                t = np.where(run, t + dt, t)
                dec = lam[:, :, None] * dt[:, None, None]
                cfr = np.where(occm & run[:, None, None], cfr - dec,
                               cfr)
                fin = occm & run[:, None, None] & (cfr <= 1e-9)
                if fin.any():
                    nb_f = np.where(fin, cnb, 0)
                    used -= (cdm * nb_f[:, :, :, None]).sum(axis=2)
                    nres -= nb_f.sum(axis=2)
                    if gated:
                        fb, fu, fs = np.nonzero(fin)
                        np.add.at(retired, (fb, ckn[fb, fu, fs]),
                                  cnb[fb, fu, fs])
                    ckn = np.where(fin, -1, ckn)
                    cnb = np.where(fin, 0, cnb)
                    occm = ckn >= 0
        return t

    @staticmethod
    def _deal(cap: np.ndarray, m: np.ndarray,
              rr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Allocation of ``m[b]`` blocks over units with capacities
        ``cap[b, :]`` by cyclic first-fit dealing from ``rr[b]`` —
        the closed form of the reference's block-by-block round-robin
        placement (see class docstring).  Returns ``(place, rr_new)``
        where ``rr_new`` points one past the unit that received the
        last block (meaningful only where m > 0; callers mask)."""
        B, U = cap.shape
        # deepest fully dealt level L: largest L with
        # sum_u min(cap_u, L) <= m (vectorized binary search).
        lo = np.zeros(B, dtype=np.int64)
        hi = cap.max(axis=1)
        while (lo < hi).any():
            mid = (lo + hi + 1) // 2
            f = np.minimum(cap, mid[:, None]).sum(axis=1)
            take = f <= m
            lo = np.where(take, mid, lo)
            hi = np.where(take, hi, mid - 1)
        L = lo
        base = np.minimum(cap, L[:, None])
        rem = m - base.sum(axis=1)
        # one extra block for the first `rem` units with cap > L in
        # cyclic order from rr.
        off = (np.arange(U)[None, :] + rr[:, None]) % U      # (B, U)
        cap_cyc = np.take_along_axis(cap, off, axis=1)
        elig = cap_cyc > L[:, None]
        rank = np.cumsum(elig, axis=1) - elig
        extra_cyc = elig & (rank < rem[:, None])
        extra = np.zeros_like(cap)
        np.put_along_axis(extra, off, extra_cyc.astype(np.int64),
                          axis=1)
        # rem > 0: the last block is the last extra; rem == 0: it is
        # the last unit dealt its L-th block (cap >= L) in cyclic order.
        offs = np.arange(U)[None, :]
        lvl = cap_cyc >= np.maximum(L, 1)[:, None]
        last_src = np.where((rem > 0)[:, None], extra_cyc, lvl)
        last_off = np.where(last_src, offs, -1).max(axis=1)
        last_off = np.maximum(last_off, 0)
        return base + extra, (rr + last_off + 1) % U


# --------------------------------------------------------------------
# batched move evaluator
# --------------------------------------------------------------------

def refine_order_batched(
    order: Sequence[KernelProfile],
    device: DeviceModel,
    *,
    model: str = "event",
    budget: int = 2000,
    neighborhood: str = "full",
    batch_size: int = 128,
    table: ProfileTable | None = None,
    edge_ids: set | None = None,
    delta=None,
    legal: Callable[[Sequence[KernelProfile]], bool] | None = None,
    verify_k: int = 8,
    rescore: bool | None = None,
    metrics=None,
) -> tuple[list[KernelProfile], float, int]:
    """Batched counterpart of :func:`repro_torch.core.refine.refine_order`:
    generates the move neighborhood as ``(B, n)`` candidate batches,
    delta-evaluates each batch in one vectorized pass from
    checkpoint-stitched suffixes, and accepts the **best improving
    move per batch** (exactly re-verified by the sequential
    :class:`~repro_torch.core.refine.DeltaEvaluator` before it lands, so the
    trajectory stays in the exact simulator currency and is never
    worse than the input order).

    Budget accounting matches the sequential path: every candidate —
    including acceptance re-verifications — is charged its suffix
    fraction in full-simulation equivalents, with the same ``10 *
    budget`` evaluation cap.

    ``rescore`` selects the quality contract.  ``True`` (the default
    under ``model="gated"``) re-scores the chunk remainder against
    the new base after every acceptance, so the walk makes the same
    skip/accept decisions as the sequential first-improving sweep
    wherever the engine classifies improving/non-improving correctly
    — refined makespans then match the *sequential refiner's* (the
    traced-arch quality pin), at the cost of one extra engine pass
    per acceptance.  ``False`` (the default under
    ``model="round"``/``"event"``) keeps the single scoring pass per
    chunk — maximum effective-move throughput, quality pinned to
    never-worse-than-the-input-order only.

    ``model="gated"`` callers (:func:`repro.graph.refine_order_dag`)
    pass their own sequential ``delta``
    (:class:`repro.graph.delta.GatedDeltaEvaluator`) plus ``edge_ids``
    and a ``legal`` pre-filter; this module stays import-free of the
    graph layer.  ``table`` threads an already packed
    :class:`ProfileTable` through so greedy + refine packs exactly
    once."""
    from .refine import DeltaEvaluator, _apply, _moves

    t_wall = perf_counter()
    n = len(order)
    if neighborhood == "auto":
        neighborhood = "full" if n <= 128 else "adjacent"
    if table is None:
        table = ProfileTable.build(order, device)
    packed = PackedKernels.for_table(table)
    if delta is None:
        if model == "gated":
            raise ValueError("model='gated' requires the caller's "
                             "GatedDeltaEvaluator (see "
                             "repro.graph.refine_order_dag)")
        delta = DeltaEvaluator(device, model=model)
    if model == "round":
        engine: BatchedRoundSim | BatchedEventSim = \
            BatchedRoundSim(packed)
    elif model == "event":
        engine = BatchedEventSim(packed)
    elif model == "gated":
        engine = BatchedEventSim(packed, edge_ids=edge_ids or set())
    else:
        raise ValueError(f"unknown model {model!r}")

    if rescore is None:
        rescore = model == "gated"
    best = list(order)
    best_t = delta.rebase(best)
    cost = 1.0
    evals = 1
    eval_cap = 10 * budget
    batch_size = max(int(batch_size), 1)

    def _cp_for(first: int):
        """(checkpoint, frac) for a candidate first changed at
        ``first`` — the same resume state the sequential evaluator
        would pick."""
        if delta._per_position:
            if first < len(delta._ckpts):
                cp = delta._ckpts[first]
                return cp, (n - cp.pos) / max(n, 1)
            return None, 1.0
        bestcp = None
        for cp in delta._ckpts:
            if cp.pos < first:
                bestcp = cp
            else:
                break
        if bestcp is None:
            return None, 1.0
        return bestcp, (n - bestcp.pos) / max(n, 1)

    improved = True
    while improved and cost < budget and evals < eval_cap:
        improved = False
        moves = _moves(n, neighborhood)
        if neighborhood == "adjacent":
            bounds = delta.boundaries()
            if bounds is None:
                moves.sort(key=lambda m: -m[0])
            else:
                near = [False] * (n + 1)
                for b in bounds:
                    for p in (b - 1, b, b + 1):
                        if 0 <= p < n:
                            near[p] = True
                moves.sort(key=lambda m: (not (near[m[2]] or near[m[3]]),
                                          -m[0]))
        mi = 0
        while mi < len(moves) and cost < budget and evals < eval_cap:
            cands: list[list[KernelProfile]] = []
            chunk_moves: list[tuple[int, str, int, int]] = []
            cps: list = []
            while (mi < len(moves) and len(cands) < batch_size and
                   cost < budget and evals + len(cands) < eval_cap):
                first, kind, i, j = moves[mi]
                mi += 1
                cand = _apply(best, kind, i, j)
                if legal is not None and not legal(cand):
                    continue  # rejected before simulation: free
                cp, frac = _cp_for(first)
                cands.append(cand)
                chunk_moves.append((first, kind, i, j))
                cps.append(cp)
                cost += frac
            if not cands:
                continue
            rows = np.stack([packed.rows(c) for c in cands])
            if model == "round":
                ts = engine.times_from_checkpoints(rows, cps)
            else:
                ts = engine.times(rows, cps)
            evals += len(cands)
            # Predicted-improving candidates are re-verified in *move
            # order* — the order the sequential first-improving sweep
            # evaluates them — each re-applied (moves are
            # position-based) to the evolving best and exactly
            # re-simulated before acceptance.
            #
            # The chunk's predictions are against the chunk-start
            # base.  With ``rescore`` the chunk remainder is
            # *re-scored* against the new base after every acceptance
            # (each candidate stays charged exactly once — the stale
            # pass is wasted wall-clock, not wasted budget), so the
            # walk makes the same skip/accept decisions the
            # sequential sweep makes wherever the engine classifies
            # improving/non-improving correctly.  That is what pins
            # batched gated refinement to the sequential refiner's
            # makespans on the traced archs.  Without it the skip
            # test uses the frozen chunk-start time, which stays the
            # right admission test under the additive shift an
            # acceptance applies to non-interacting candidates —
            # maximum throughput, quality pinned to the input order.
            chunk_t = best_t
            tried = 0
            for ci in range(len(cands)):
                # Budget/eval-cap exhaustion does NOT gate this loop:
                # every candidate here already paid its suffix
                # fraction when the chunk was scored, and acceptance
                # verification is the sequential path's free rebase —
                # skipping it would silently discard the last chunk's
                # improvements (exactly the chunk most likely to hold
                # them, since the fill stops on the budget).
                if tried >= verify_k:
                    break
                if ts[ci] >= (best_t if rescore else chunk_t) - 1e-15:
                    continue
                first, kind, i, j = chunk_moves[ci]
                cand = _apply(best, kind, i, j)
                if legal is not None and not legal(cand):
                    continue
                # Not charged: each candidate already paid its suffix
                # fraction in the batch, and the sequential path's
                # budget prices candidate evaluations only — its
                # acceptance rebase is free, and this verification
                # doubles as exactly that rebase.  Only *misses*
                # (verified not-improving — mispredictions) count
                # against verify_k, so a chunk dense in real
                # improvements accepts them all, matching the
                # sequential sweep's acceptance density, while
                # mispredictions stay bounded and wall time stays
                # proportional to the budget.
                t_exact, _ = delta.evaluate_costed(cand, first)
                evals += 1
                if t_exact < best_t - 1e-15:
                    best, best_t, improved = cand, t_exact, True
                    delta.rebase_incremental(best, first)
                    if rescore and ci + 1 < len(cands):
                        rem_rows, rem_idx, rem_cps = [], [], []
                        for cj in range(ci + 1, len(cands)):
                            fj, kj, ij, jj = chunk_moves[cj]
                            cand_j = _apply(best, kj, ij, jj)
                            if legal is not None and not legal(cand_j):
                                ts[cj] = np.inf
                                continue
                            cp, _ = _cp_for(fj)
                            rem_rows.append(packed.rows(cand_j))
                            rem_idx.append(cj)
                            rem_cps.append(cp)
                        if rem_idx:
                            ts[rem_idx] = engine.times(
                                np.stack(rem_rows), rem_cps)
                else:
                    tried += 1
    if metrics is not None:
        metrics.counter("refine_evals").inc(evals)
        metrics.counter("refine_cost").inc(cost)
        metrics.histogram("refine_score_s").observe(
            perf_counter() - t_wall)
    return best, best_t, evals
