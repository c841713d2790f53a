"""Gated-event delta evaluation: suffix re-simulation for DAG orders.

Dependency-carrying schedules have their own makespan currency — the
ready-set gated dispatcher
(:class:`repro_torch.graph.streams.DagEventSimulator`) — but the local
search (:func:`repro_torch.graph.constrained.refine_order_dag`,
:func:`repro.slice.constrained.refine_order_slices`) could only
delta-evaluate the *ungated* event model.  Refined orders therefore
had to fall back to the greedy whenever the gated currency disagreed
with the ungated proxy, which on traced-arch workloads was nearly
always (the gate serializes every intra-request chain, a constraint
the proxy never sees).  This module closes that gap — mirroring ACS
(arXiv:2401.12377): scheduling decisions on irregular dependency
graphs must be evaluated in the dependency-aware cost model itself:

* :class:`_FastGatedSim` — an operation-for-operation port of
  ``DagEventSimulator`` over flat tuples (the same technique
  :class:`repro_torch.core.refine._FastEventSim` applies to
  ``EventSimulator``), bit-identical in its float accumulation and
  checkpoint-interchangeable with the reference.  Both produce and
  consume the plain :class:`~repro_torch.core.simulator.EventCheckpoint`:
  the gate's retired-block state is *derived* on resume (a kernel
  before the resume position has retired ``grid - blocks still in
  cohorts``), so no gated-specific checkpoint type is needed.
* :class:`GatedDeltaEvaluator` — the
  :class:`repro_torch.core.refine.DeltaEvaluator` discipline (one
  checkpoint per order position, candidate cost charged as the suffix
  fraction) under the gated model.  Moves that would invert a
  precedence edge are rejected *before* any simulation
  (:meth:`GatedDeltaEvaluator.legal`, the same O(n + E) position-map
  scan ``refine_order_dag`` applies); legal candidates resume from
  the latest checkpoint at suffix cost.

Exactness is property-tested in ``tests/test_gated_delta.py``:
suffix re-simulation equals full gated re-simulation float-for-float
on randomized DAGs, slice/join graphs (zero-work join markers) and
the 0-edge degeneration, where the gated pipeline reproduces the
ungated ``EventSimulator`` identity.

The batched evaluator (:mod:`repro_torch.core.batched`, reached through
``refine_order_dag(..., batch_size=...)``) scores legal gated
candidates in vectorized lockstep from this module's checkpoints and
re-verifies every acceptance through :class:`GatedDeltaEvaluator`, so
the batched trajectory stays in this exact currency.
"""

from __future__ import annotations

import math
from typing import Sequence

from ..core.refine import DeltaEvaluator
from ..core.resources import DeviceModel, KernelProfile
from ..core.simulator import EventCheckpoint

__all__ = ["GatedDeltaEvaluator", "_FastGatedSim"]


class _FastGatedSim:
    """DagEventSimulator with per-kernel profile data precomputed once.

    Bit-identical arithmetic to
    :class:`repro_torch.graph.streams.DagEventSimulator` — the same
    operations on the same floats in the same order — over flat tuples
    instead of demand dicts and dataclasses, exactly as
    :class:`repro_torch.core.refine._FastEventSim` ports ``EventSimulator``.
    Unit state is a list ``[used, n_resident, cohorts, lam]``; a cohort
    is ``[kernel, n_blocks, frac_left, t_admit, inst_per_block,
    mem_per_block, demands, inst * n_blocks, mem * n_blocks]``.  The
    ready-set gate keys per-kernel retired-block counts by object
    identity; zero-work kernels (slice join markers) retire instantly
    without occupying a unit.  Produces and consumes the same
    :class:`EventCheckpoint` format as the reference, so checkpoints
    are interchangeable between the two implementations
    (property-tested in ``tests/test_gated_delta.py``).
    """

    _EPS = 1e-12

    def __init__(self, device: DeviceModel, edge_ids: set = frozenset()):
        self.device = device
        self.edge_ids = set(edge_ids)
        self._preds: dict[int, list[int]] = {}
        for u, v in self.edge_ids:
            self._preds.setdefault(v, []).append(u)
        self._dims = tuple(device.caps)
        self._caps = tuple(device.cap(d) for d in self._dims)
        self._sat_idx = (self._dims.index(device.sat_dim)
                         if device.sat_dim in self._dims else -1)
        self._crate = device.compute_rate
        self._mbw = device.mem_bw
        self._satc = device.sat_compute
        self._satm = device.sat_memory
        self._info: dict[int, tuple] = {}

    def _kinfo(self, k: KernelProfile) -> tuple:
        # Keyed by id(k) — the cached entry holds a strong reference
        # to k so its id can never be recycled by a different profile.
        v = self._info.get(id(k))
        if v is None:
            dem = tuple(k.demands[d] for d in self._dims)
            zero = (k.inst_per_block == 0.0 and
                    all(x == 0.0 for x in dem))
            v = (k, dem, k.n_blocks, k.inst_per_block, k.mem_per_block(),
                 zero)
            self._info[id(k)] = v
        return v

    def _eff(self, occ: float, sat: float) -> float:
        if self._sat_idx < 0:
            return 1.0
        return min(1.0, occ / sat)

    def _rate(self, u: list) -> None:
        cohorts = u[2]
        if not cohorts:
            u[3] = 0.0
            return
        eps = self._EPS
        sum_c = sum([c[7] for c in cohorts])
        sum_m = sum([c[8] for c in cohorts])
        si = self._sat_idx
        if si < 0:
            eff_c = eff_m = 1.0
        else:
            occ = u[0][si]
            eff_c = max(min(1.0, occ / self._satc), eps)
            eff_m = max(min(1.0, occ / self._satm), eps)
        u[3] = min(self._crate * eff_c / max(sum_c, eps),
                   self._mbw * eff_m / max(sum_m, eps))

    def simulate(self, order: Sequence[KernelProfile],
                 start_state: EventCheckpoint | None = None,
                 record: bool = False, trace=None
                 ) -> tuple[float, list[EventCheckpoint]]:
        dev = self.device
        dims_n = len(self._dims)
        caps = self._caps
        eps = self._EPS
        n_units = dev.n_units
        max_res = dev.max_resident
        preds = self._preds
        grid: dict[int, int] = {}
        for k in order:
            grid[id(k)] = self._kinfo(k)[2]
        if start_state is None:
            units = [[[0.0] * dims_n, 0, [], 0.0] for _ in range(n_units)]
            start_pos, rr, t = 0, 0, 0.0
            retired: dict[int, int] = {id(k): 0 for k in order}
        else:
            units = []
            for used, n_res, cohorts in start_state.units:
                cs = []
                for k, nb, fl, ta in cohorts:
                    _, dem, _, inst_b, mem_b, _ = self._kinfo(k)
                    cs.append([k, nb, fl, ta, inst_b, mem_b, dem,
                               inst_b * nb, mem_b * nb])
                u = [list(used), n_res, cs, 0.0]
                self._rate(u)
                units.append(u)
            start_pos, rr, t = (start_state.pos, start_state.rr,
                                start_state.time)
            # Derived gate state, as in DagEventSimulator.simulate:
            # positions < start_pos were fully dispatched, so retired
            # = grid minus blocks still resident in the checkpoint.
            retired = {id(k): 0 for k in order}
            for p in range(start_pos):
                retired[id(order[p])] = grid[id(order[p])]
            for _, _, cohorts in start_state.units:
                for k, nb, _, _ in cohorts:
                    retired[id(k)] -= nb

        def ready(k: KernelProfile) -> bool:
            return all(retired.get(p, 0) >= grid.get(p, 0)
                       for p in preds.get(id(k), []))

        # Strict-FIFO queue of [kernel, blocks left, pos, dem, inst,
        # mem, zero_work].
        pending: list[list] = []
        for p in range(start_pos, len(order)):
            k = order[p]
            _, dem, nb, inst_b, mem_b, zero = self._kinfo(k)
            pending.append([k, nb, p, dem, inst_b, mem_b, zero])
        head = 0
        n_pend = len(pending)
        ckpts: list[EventCheckpoint] = []
        next_ckpt = start_pos
        n_res_total = sum(u[1] for u in units)

        def snapshot(pos: int, blocks_left: int) -> EventCheckpoint:
            return EventCheckpoint(
                pos=pos, blocks_left=blocks_left, time=t, rr=rr,
                units=tuple((tuple(u[0]), u[1],
                             tuple((c[0], c[1], c[2], c[3])
                                   for c in u[2]))
                            for u in units))

        def try_admit(pending=pending, units=units, caps=caps,
                      dims_r=range(dims_n), units_r=range(n_units),
                      n_units=n_units, max_res=max_res, eps=eps,
                      record=record, rate=self._rate) -> None:
            # Same closure-bound hot path as _FastEventSim.try_admit,
            # plus the ready gate and the zero-work fast retirement.
            nonlocal rr, head, next_ckpt, n_res_total
            touched: set[int] = set()
            cur_k = None
            rejected: set[int] = set()
            while head < n_pend:
                e = pending[head]
                k, pos, dem = e[0], e[2], e[3]
                if k is not cur_k:
                    cur_k = k
                    rejected = set()
                if record and pos == next_ckpt:
                    # Captured before the ready gate: its verdict
                    # depends only on earlier positions' retired state.
                    ckpts.append(snapshot(pos, e[1]))
                    next_ckpt = pos + 1
                if not ready(k):
                    break  # admission gate: predecessors still in flight
                if e[6]:
                    # Zero-work synchronisation marker (slice join):
                    # retires the instant its predecessors drain.
                    retired[id(k)] = grid[id(k)]
                    head += 1
                    if trace is not None:
                        trace.instant(k.name, t, unit=None, cat="join")
                    continue
                placed = False
                for off in units_r:
                    ui = rr + off
                    if ui >= n_units:
                        ui -= n_units
                    if ui in rejected:
                        continue
                    u = units[ui]
                    if u[1] + 1 > max_res:
                        rejected.add(ui)
                        continue
                    used = u[0]
                    ok = True
                    for di in dims_r:
                        if not used[di] + dem[di] <= caps[di] + eps:
                            ok = False
                            break
                    if not ok:
                        rejected.add(ui)
                        continue
                    for di in dims_r:
                        used[di] += dem[di]
                    u[1] += 1
                    n_res_total += 1
                    for c in reversed(u[2]):
                        if c[0] is k and c[3] == t:
                            c[1] += 1
                            c[7] = c[4] * c[1]
                            c[8] = c[5] * c[1]
                            break
                    else:
                        u[2].append([k, 1, 1.0, t, e[4], e[5], dem,
                                     e[4], e[5]])
                    touched.add(ui)
                    rr = ui + 1
                    if rr >= n_units:
                        rr -= n_units
                    e[1] -= 1
                    if e[1] == 0:
                        head += 1
                    placed = True
                    break
                if not placed:
                    break  # head blocks the queue (strict FIFO)
            for ui in touched:
                rate(units[ui])

        try_admit()
        guard = 0
        while head < n_pend or n_res_total:
            guard += 1
            if guard > 1_000_000:
                raise RuntimeError("_FastGatedSim failed to converge")
            if not n_res_total:
                e = pending[head]
                k = e[0]
                if not ready(k):
                    # Units drained => every dispatched block retired;
                    # an unready head means a predecessor was launched
                    # after it.
                    raise ValueError(
                        f"launch order violates precedence at {k.name!r}")
                # Oversized head runs alone (see DagEventSimulator).
                head += 1
                nb, dem, inst_b, mem_b = e[1], e[3], e[4], e[5]
                occ = dem[self._sat_idx] if self._sat_idx >= 0 else 0.0
                eff_c = max(self._eff(occ, dev.sat_compute), eps)
                eff_m = max(self._eff(occ, dev.sat_memory), eps)
                t1 = max(inst_b / (dev.compute_rate * eff_c),
                         mem_b / (dev.mem_bw * eff_m))
                for p in range(math.ceil(nb / n_units)):
                    t += t1
                    if trace is not None:
                        for ui in range(min(n_units, nb - p * n_units)):
                            trace.span(ui, k.name, t - t1, t,
                                       blocks=1, cat="solo")
                            trace.add_busy(ui, t1)
                retired[id(k)] = grid[id(k)]
                try_admit()
                continue
            dt = min([c[2] / u[3] for u in units if u[2] for c in u[2]])
            t += dt
            freed = False
            for ui, u in enumerate(units):
                cohorts = u[2]
                if not cohorts:
                    continue
                if trace is not None:
                    trace.add_busy(ui, dt)
                lam = u[3]
                done = []
                for c in cohorts:
                    c[2] -= lam * dt
                    if c[2] <= 1e-9:
                        done.append(c)
                if done:
                    freed = True
                    used = u[0]
                    for c in done:
                        cohorts.remove(c)
                        dem, nb = c[6], c[1]
                        for di in range(dims_n):
                            used[di] -= dem[di] * nb
                        u[1] -= nb
                        n_res_total -= nb
                        retired[id(c[0])] = (
                            retired.get(id(c[0]), 0) + nb)
                        if trace is not None:
                            trace.span(ui, c[0].name, c[3], t,
                                       blocks=nb)
                    self._rate(u)
            if freed:
                try_admit()
        return t, ckpts


class GatedDeltaEvaluator(DeltaEvaluator):
    """Suffix re-simulation of locally modified *topological* orders
    under the gated event model.

    The checkpoint discipline is the event model's — one
    :class:`EventCheckpoint` per order position, captured before any
    block of that position is dispatched — so a candidate differing
    first at position ``p`` resumes from the checkpoint at ``p``
    itself.  The gate state is derived from the checkpoint on resume
    (see :class:`_FastGatedSim`), which is why the evaluator needs no
    gated-specific checkpoint format.

    Candidates must be topological; :meth:`legal` is the pre-simulation
    edge-inversion filter (O(n + E) position-map scan, the same check
    ``refine_order_dag`` applies before charging any simulation cost).
    A non-topological candidate that slipped past the filter deadlocks
    the gate and raises ``ValueError`` rather than returning a bogus
    time.
    """

    def __init__(self, device: DeviceModel, edge_ids: set):
        # Bypasses DeltaEvaluator.__init__ (which only knows the flat
        # round/event simulators) but keeps its entire evaluation
        # discipline: _per_position selects the event-style paths.
        self.sim = _FastGatedSim(device, edge_ids)
        self.model = "gated"
        self._per_position = True
        self.edge_ids = self.sim.edge_ids
        self._base: list[KernelProfile] = []
        self._ckpts: list = []
        self._total = 0.0

    def legal(self, cand: Sequence[KernelProfile]) -> bool:
        """True iff every precedence edge points forward in ``cand``
        — the pre-simulation move filter: an edge-inverting move is
        rejected before it costs any simulation."""
        pos = {id(k): p for p, k in enumerate(cand)}
        return all(pos[u] < pos[v] for u, v in self.edge_ids)
