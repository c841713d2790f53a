"""Beyond-paper: simulator-guided local refinement of the launch order.

Algorithm 1 is profile-greedy — it never consults a timing model.  When
a timing model *is* available at scheduling time (always true for the
TPU serving/training substrates, where the roofline cost of every task
is known), the launch order can be polished by local search around the
greedy solution:

* pairwise swaps,
* single-kernel reinsertions (remove + insert at every position),

accepting strict improvements until a local optimum or the evaluation
budget is reached.  The greedy order is both the starting point and the
fallback, so the refined order is never worse than Algorithm 1's.

This mirrors what the paper's own Fig. 1 suggests: the greedy lands
above the 90th percentile, and a small neighbourhood search closes most
of the remaining gap to the optimum at negligible cost (the simulator
evaluates an 8-kernel order in well under a millisecond, against a
40,320-point design space).

Complexity / when to use which path
-----------------------------------
A naive candidate evaluation re-simulates the whole order: ``O(n)``
rounds (or all dispatch events) per candidate, ``O(n^3)`` per full
neighbourhood sweep.  Two levers make refinement affordable at serving
scale:

* **Delta evaluation** (automatic for ``model="round"`` *and*
  ``model="event"`` with no custom ``time_fn``): the
  :class:`DeltaEvaluator` caches the simulator's admission checkpoints
  for the incumbent order, so a candidate differing only at positions
  >= p re-simulates just the suffix from the last checkpoint before p
  — ``O(n - p)`` instead of ``O(n)``.  Under the round model the
  checkpoints are the :class:`~repro_torch.core.simulator.RoundCheckpoint`
  round boundaries; under the event model every order position gets an
  :class:`~repro_torch.core.simulator.EventCheckpoint` capturing the full
  dispatcher state (per-unit residency, cohort fractions, round-robin
  pointer) at the instant that position is first examined.  The budget
  is charged in full-simulation equivalents (a suffix re-sim costs its
  fraction), so the default serving budget buys roughly an order of
  magnitude more effective moves; on the adjacent move set, moves
  straddling a round boundary are tried first, cheapest (latest
  suffix) first within each class ("early-exit ordering" — under the
  event model every position is a boundary, so moves are simply tried
  cheapest first).
* **``neighborhood="adjacent"``**: restrict moves to adjacent swaps
  and short-range reinsertions — ``O(n)`` candidates per sweep instead
  of ``O(n^2)``.  This is the right regime on a serving hot path
  (``n`` in the hundreds): a fixed budget spent on ``(0, j)`` swaps of
  a full sweep barely touches the order, while adjacent moves spread
  it across every round boundary.  ``"auto"`` picks ``"full"`` up to
  128 kernels (where it still dominates the reference within a
  serving budget) and ``"adjacent"`` above; ``"full"`` remains the
  offline default.

Delta-evaluated times are *exactly* equal to full re-simulation
(property-tested in ``tests/test_fastscore.py`` for the round model
and ``tests/test_event_delta.py`` for the event model): resuming from
a checkpoint replays the identical float accumulation.  The fast
simulators in this module (:class:`_FastRoundSim`,
:class:`_FastEventSim`) are operation-for-operation ports of their
reference oracles with per-kernel profile data resolved to flat tuples
once, which is what makes thousands of suffix re-simulations per
refinement affordable.

Both built-in models here are *flat* — every kernel free to
co-schedule.  Dependency-carrying orders have their own currency (the
ready-set gated dispatcher) and their own evaluator built on this
module's discipline: :class:`repro.graph.delta.GatedDeltaEvaluator`
subclasses :class:`DeltaEvaluator` with a gated fast simulator, and
:func:`repro.graph.constrained.refine_order_dag` (``model="gated"``)
is the precedence-respecting counterpart of :func:`refine_order`.
"""

from __future__ import annotations

import math
from time import perf_counter
from typing import Callable, Sequence

from .fastscore import greedy_order_fast
from .resources import DeviceModel, KernelProfile
from .scheduler import Schedule
from .simulator import EventCheckpoint, RoundCheckpoint, simulate

__all__ = ["refine_order", "refined_schedule", "DeltaEvaluator",
           "DeltaRoundEvaluator"]


class _FastRoundSim:
    """RoundSimulator with per-kernel profile data precomputed once.

    Bit-identical arithmetic to :class:`RoundSimulator.simulate` —
    the same operations on the same floats in the same order — but
    demand dicts, per-unit block counts and per-block memory traffic
    are resolved to flat tuples a single time per kernel object, which
    is what makes thousands of suffix re-simulations per refinement
    affordable."""

    _EPS = 1e-12

    def __init__(self, device: DeviceModel):
        self.device = device
        self._dims = tuple(device.caps)
        self._caps = tuple(device.cap(d) for d in self._dims)
        self._sat_idx = (self._dims.index(device.sat_dim)
                         if device.sat_dim in self._dims else -1)
        self._info: dict[int, tuple] = {}

    def _kinfo(self, k: KernelProfile) -> tuple:
        # Keyed by id(k) — the cached entry holds a strong reference
        # to k so its id can never be recycled by a different profile.
        v = self._info.get(id(k))
        if v is None:
            v = (k, tuple(k.demands[d] for d in self._dims),
                 k.blocks_per_unit(self.device),
                 k.inst_per_block, k.mem_per_block())
            self._info[id(k)] = v
        return v

    def _eff(self, occ: float, sat: float) -> float:
        # Mirrors DeviceModel.compute_efficiency/memory_efficiency
        # exactly: a sat_dim that is not a tracked capacity dimension
        # (_sat_idx < 0 covers both sat_dim == "" and sat_dim not in
        # caps) carries no occupancy signal — run at peak.
        if self._sat_idx < 0:
            return 1.0
        return min(1.0, occ / sat)

    def simulate(self, order: Sequence[KernelProfile],
                 start_pos: int = 0, head_blocks: int | None = None,
                 t0: float = 0.0, record: bool = False, trace=None
                 ) -> tuple[float, list[RoundCheckpoint]]:
        dev = self.device
        dims_n = len(self._dims)
        caps = self._caps
        eps = self._EPS
        pending: list[list] = []
        for p in range(start_pos, len(order)):
            k = order[p]
            _, dem, bpu, inst_b, mem_b = self._kinfo(k)
            nb = head_blocks if (p == start_pos and
                                 head_blocks is not None) else bpu
            pending.append([k, nb, p, dem, inst_b, mem_b])
        total = t0
        ckpts: list[RoundCheckpoint] = []
        head = 0
        n_pend = len(pending)
        r_idx = 0
        while head < n_pend:
            if record:
                e = pending[head]
                ckpts.append(RoundCheckpoint(pos=e[2], blocks_left=e[1],
                                             time=total))
            used = [0.0] * dims_n
            blocks, inst, mem = 0, 0.0, 0.0
            members: list = []
            while head < n_pend:
                e = pending[head]
                k, nb, _, dem, inst_b, mem_b = e
                fit = nb
                for di in range(dims_n):
                    dv = dem[di]
                    if dv > 0:
                        fit = min(fit, int((caps[di] - used[di] + eps)
                                           // dv))
                fit = max(min(fit, dev.max_resident - blocks), 0)
                if fit == 0:
                    if blocks == 0:
                        fit = 1  # oversized block: runs alone regardless
                    else:
                        break  # strict FIFO: head closes the round
                for di in range(dims_n):
                    used[di] += dem[di] * fit
                blocks += fit
                inst += inst_b * fit
                mem += mem_b * fit
                if trace is not None:
                    members.append((k.name, fit))
                e[1] -= fit
                if e[1] == 0:
                    head += 1
                if head < n_pend and pending[head][0] is k:
                    break  # partially admitted head: unit is full
            occ = used[self._sat_idx] if self._sat_idx >= 0 else 0.0
            eff_c = max(self._eff(occ, dev.sat_compute), eps)
            eff_m = max(self._eff(occ, dev.sat_memory), eps)
            r_start = total
            total += max(inst / (dev.compute_rate * eff_c),
                         mem / (dev.mem_bw * eff_m))
            if trace is not None:
                for name, fit_ in members:
                    trace.span(0, name, r_start, total, blocks=fit_,
                               cat="round-member")
                trace.instant(f"round {r_idx}", total, unit=0,
                              cat="round")
                trace.add_busy(0, total - r_start)
            r_idx += 1
        return total, ckpts


class _FastEventSim:
    """EventSimulator with per-kernel profile data precomputed once.

    Bit-identical arithmetic to :class:`EventSimulator.simulate` — the
    same operations on the same floats in the same order — over flat
    tuples instead of demand dicts and dataclasses.  Unit state is a
    list ``[used, n_resident, cohorts, lam]`` (``used`` a list in
    ``device.caps`` order); a cohort is a list ``[kernel, n_blocks,
    frac_left, t_admit, inst_per_block, mem_per_block, demands,
    inst * n_blocks, mem * n_blocks]`` — the two trailing work
    products are refreshed on merge by the same multiplication the
    reference performs inside ``recompute_rate``, so caching them
    changes no float.  Produces and consumes the same
    :class:`EventCheckpoint` format as the reference, so checkpoints
    are interchangeable between the two implementations
    (property-tested in ``tests/test_event_delta.py``).
    """

    _EPS = 1e-12

    def __init__(self, device: DeviceModel):
        self.device = device
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
        v = self._info.get(id(k))
        if v is None:
            v = (k, tuple(k.demands[d] for d in self._dims),
                 k.n_blocks, k.inst_per_block, k.mem_per_block())
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
        # sum() over a list is the same left fold (0 + x0 + x1 + ...)
        # as the reference's generator sum — identical floats.
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
        if start_state is None:
            units = [[[0.0] * dims_n, 0, [], 0.0] for _ in range(n_units)]
            start_pos, rr, t = 0, 0, 0.0
        else:
            units = []
            for used, n_res, cohorts in start_state.units:
                cs = []
                for k, nb, fl, ta in cohorts:
                    _, dem, _, inst_b, mem_b = self._kinfo(k)
                    cs.append([k, nb, fl, ta, inst_b, mem_b, dem,
                               inst_b * nb, mem_b * nb])
                u = [list(used), n_res, cs, 0.0]
                self._rate(u)
                units.append(u)
            start_pos, rr, t = (start_state.pos, start_state.rr,
                                start_state.time)
        # Strict-FIFO queue of [kernel, blocks left, pos, dem, inst, mem].
        pending: list[list] = []
        for p in range(start_pos, len(order)):
            k = order[p]
            _, dem, nb, inst_b, mem_b = self._kinfo(k)
            pending.append([k, nb, p, dem, inst_b, mem_b])
        head = 0
        n_pend = len(pending)
        ckpts: list[EventCheckpoint] = []
        next_ckpt = start_pos
        # Total resident blocks across units: an integer mirror of
        # "any unit has cohorts", maintained incrementally so the event
        # loop avoids a per-event generator scan.
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
            # Closure-invariant state is bound as defaults (LOAD_FAST)
            # — this function dominates the suffix re-simulation cost.
            nonlocal rr, head, next_ckpt, n_res_total
            touched: set[int] = set()
            # Within one call, per-unit capacity only shrinks, so a
            # unit that rejected the current head kernel rejects it for
            # the rest of the call: remember and skip (first-fit order
            # is unchanged — skipped units would reject again).
            cur_k = None
            rejected: set[int] = set()
            while head < n_pend:
                e = pending[head]
                k, pos, dem = e[0], e[2], e[3]
                if k is not cur_k:
                    cur_k = k
                    rejected = set()
                if record and pos == next_ckpt:
                    ckpts.append(snapshot(pos, e[1]))
                    next_ckpt = pos + 1
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
                    # Merge only into a same-instant cohort; scanned in
                    # reverse because a (kernel, instant) cohort is
                    # unique per unit and recent cohorts sit at the
                    # tail.  The work products (c[7], c[8]) are
                    # refreshed by the same multiplication the
                    # reference's recompute_rate performs.
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
                raise RuntimeError("_FastEventSim failed to converge")
            if not n_res_total:
                # Oversized head runs alone (see EventSimulator).
                e = pending[head]
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
                            trace.span(ui, e[0].name, t - t1, t,
                                       blocks=1, cat="solo")
                            trace.add_busy(ui, t1)
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
                        if trace is not None:
                            trace.span(ui, c[0].name, c[3], t,
                                       blocks=nb)
                    self._rate(u)
            if freed:
                try_admit()
        return t, ckpts


class DeltaEvaluator:
    """Suffix re-simulation of locally modified orders against a
    cached base order, generic over the timing model.

    ``model="round"`` caches :class:`RoundCheckpoint` round boundaries
    (one per round; a checkpoint at position p is usable for candidates
    changed strictly after p, because the round that closed at p did so
    by examining the old kernel there).  ``model="event"`` caches one
    :class:`EventCheckpoint` per order position, captured before any
    block of that position is dispatched — so the checkpoint *at* the
    first changed position is itself usable, and every move resumes
    from the latest possible dispatcher state.

    The gated DAG currency reuses the event discipline through the
    subclass :class:`repro.graph.delta.GatedDeltaEvaluator` (its
    simulator enforces the ready-set admission gate; checkpoints stay
    plain :class:`EventCheckpoint`).
    """

    def __init__(self, device: DeviceModel, model: str = "round"):
        if model == "round":
            self.sim: _FastRoundSim | _FastEventSim = _FastRoundSim(device)
        elif model == "event":
            self.sim = _FastEventSim(device)
        else:
            raise ValueError(f"unknown model {model!r} "
                             "(expected 'round' or 'event'; for the "
                             "gated DAG model use "
                             "repro.graph.delta.GatedDeltaEvaluator)")
        self.model = model
        #: one checkpoint per order position (event-style models) vs
        #: one per round boundary; subclasses with their own simulator
        #: (repro.graph.delta.GatedDeltaEvaluator) set this directly.
        self._per_position = model == "event"
        self._base: list[KernelProfile] = []
        self._ckpts: list = []
        self._total = 0.0

    def rebase(self, order: Sequence[KernelProfile],
               trace=None) -> float:
        """Full simulation of ``order``; caches its checkpoints.
        ``trace`` forwards to the fast simulator's recorder hook."""
        self._base = list(order)
        self._total, self._ckpts = self.sim.simulate(self._base,
                                                     record=True,
                                                     trace=trace)
        return self._total

    def rebase_incremental(self, order: Sequence[KernelProfile],
                           first_changed: int) -> float:
        """Rebase onto ``order``, which must equal the current base at
        every position < ``first_changed`` (an accepted local move).

        The checkpoint prefix before the resume point is still valid
        for the new base — the simulation up to it examined only
        unchanged positions — so only the suffix is re-simulated with
        recording and the two checkpoint lists are stitched.  Produces
        bit-identical state to a full :meth:`rebase` (property-tested)
        at suffix cost, which keeps accepted moves as cheap as
        evaluating them.
        """
        if self._per_position:
            if first_changed < len(self._ckpts):
                cp = self._ckpts[first_changed]
                t, suffix = self.sim.simulate(order, start_state=cp,
                                              record=True)
                self._base = list(order)
                self._ckpts = self._ckpts[:first_changed] + suffix
                self._total = t
                return t
            return self.rebase(order)
        best: RoundCheckpoint | None = None
        idx = 0
        for i, cp in enumerate(self._ckpts):
            if cp.pos < first_changed:
                best, idx = cp, i
            else:
                break
        if best is None:
            return self.rebase(order)
        t, suffix = self.sim.simulate(order, start_pos=best.pos,
                                      head_blocks=best.blocks_left,
                                      t0=best.time, record=True)
        self._base = list(order)
        self._ckpts = self._ckpts[:idx] + suffix
        self._total = t
        return t

    def evaluate(self, cand: Sequence[KernelProfile],
                 first_changed: int) -> float:
        """Time of ``cand``, which must equal the base order at every
        position < ``first_changed``.  Exactly equal to a full
        re-simulation of ``cand`` under the evaluator's model."""
        return self.evaluate_costed(cand, first_changed)[0]

    def evaluate_costed(self, cand: Sequence[KernelProfile],
                        first_changed: int,
                        trace=None) -> tuple[float, float]:
        """As :meth:`evaluate`, plus the evaluation's cost as a
        fraction of a full re-simulation (suffix length / n).

        ``trace`` forwards to the suffix re-simulation (the batched
        engines' exact verification re-sims attach their recorder
        here); a checkpoint-resumed suffix only records spans from the
        resume point on.
        """
        if self._per_position:
            # One checkpoint per position, captured before any block
            # of that position was dispatched: the checkpoint at
            # first_changed depends only on earlier positions.
            if first_changed < len(self._ckpts):
                cp = self._ckpts[first_changed]
                frac = (len(cand) - cp.pos) / max(len(cand), 1)
                return self.sim.simulate(cand, start_state=cp,
                                         trace=trace)[0], frac
            return self.sim.simulate(cand, trace=trace)[0], 1.0
        # Round model: only checkpoints strictly before the first
        # changed position are safe — the round preceding a checkpoint
        # at position p closed by examining the kernel at p (failed or
        # partial admission), so a checkpoint at p == first_changed
        # encodes a decision taken against the *old* kernel there.
        best: RoundCheckpoint | None = None
        for cp in self._ckpts:
            if cp.pos < first_changed:
                best = cp
            else:
                break
        if best is None:
            return self.sim.simulate(cand, trace=trace)[0], 1.0
        frac = (len(cand) - best.pos) / max(len(cand), 1)
        t = self.sim.simulate(cand, start_pos=best.pos,
                              head_blocks=best.blocks_left,
                              t0=best.time, trace=trace)[0]
        return t, frac

    def boundaries(self) -> list[int] | None:
        """Admission-boundary positions of the base order, or ``None``
        when every position is one (event-style models)."""
        if self._per_position:
            return None
        return [cp.pos for cp in self._ckpts]

    def round_boundaries(self) -> list[int]:
        """Order positions at which the base's rounds open (round
        model; kept for backward compatibility)."""
        return [cp.pos for cp in self._ckpts]


class DeltaRoundEvaluator(DeltaEvaluator):
    """Backward-compatible alias: the round-model delta evaluator."""

    def __init__(self, device: DeviceModel):
        super().__init__(device, model="round")


def _moves(n: int, neighborhood: str) -> list[tuple[int, str, int, int]]:
    """Candidate moves as (first_changed, kind, i, j)."""
    moves: list[tuple[int, str, int, int]] = []
    if neighborhood == "adjacent":
        for i in range(n - 1):
            moves.append((i, "swap", i, i + 1))
        for i in range(n):
            for j in (i - 2, i + 2):
                if 0 <= j < n:
                    moves.append((min(i, j), "move", i, j))
        return moves
    if neighborhood != "full":
        raise ValueError(f"unknown neighborhood {neighborhood!r} "
                         "(expected 'full', 'adjacent' or 'auto')")
    for i in range(n - 1):
        for j in range(i + 1, n):
            moves.append((i, "swap", i, j))
    for i in range(n):
        for j in range(n):
            if i != j:
                moves.append((min(i, j), "move", i, j))
    return moves


def _apply(base: list[KernelProfile], kind: str, i: int,
           j: int) -> list[KernelProfile]:
    cand = list(base)
    if kind == "swap":
        cand[i], cand[j] = cand[j], cand[i]
    else:
        k = cand.pop(i)
        cand.insert(j, k)
    return cand


def refine_order(
    order: Sequence[KernelProfile],
    device: DeviceModel,
    *,
    time_fn: Callable[[Sequence[KernelProfile]], float] | None = None,
    budget: int = 2000,
    model: str = "event",
    neighborhood: str = "full",
    batch_size: int | None = None,
    table=None,
    metrics=None,
) -> tuple[list[KernelProfile], float, int]:
    """Hill-climb ``order`` under ``time_fn``.

    ``metrics`` (a :class:`repro_torch.obs.MetricsRegistry`) records the
    refinement's budget accounting — candidate evaluations under
    ``refine_evals``, charged full-simulation-equivalent cost under
    ``refine_cost``, and the scoring pass's wall clock under the
    ``refine_score_s`` histogram.  Purely additive: the search
    trajectory is unchanged.

    With the default ``time_fn``, candidates are delta-evaluated
    (suffix re-simulation from cached admission checkpoints) under
    both built-in models — ``model="round"`` and ``model="event"``;
    any custom ``time_fn`` falls back to full evaluation per candidate.

    ``batch_size`` routes to the batched evaluator
    (:func:`repro_torch.core.batched.refine_order_batched`): the move
    neighborhood is scored in vectorized ``(B, n)`` passes and the
    improving moves re-verified exactly, same budget accounting.
    Requires the default ``time_fn``.  ``table`` threads an
    already-built :class:`~repro_torch.core.fastscore.ProfileTable` through
    so a greedy + refine pipeline packs the kernel set exactly once.

    ``budget`` is charged in *full-simulation equivalents*: a delta
    evaluation that re-simulates only the last k of n positions costs
    ``k/n``, so the same budget buys roughly an order of magnitude
    more candidate moves on the delta path (the count of candidates
    actually tried is the third return value, can exceed ``budget``,
    and is capped at ``10 * budget`` so wall time stays proportional
    to the budget).

    With ``neighborhood="adjacent"`` moves are tried boundary-first:
    only moves that straddle a round boundary of the incumbent order
    can change round composition under the round model, so they are
    evaluated before intra-round shuffles, cheapest (latest suffix)
    first within each class.  Under the event model every position is
    an admission boundary, so moves are simply tried cheapest first.
    The "full" move set keeps plain enumeration order so the delta
    path retraces the reference trajectory exactly.

    Returns ``(best_order, best_time, evaluations_used)``.
    """
    n = len(order)
    if batch_size is not None and time_fn is None \
            and model in ("round", "event"):
        from .batched import refine_order_batched

        return refine_order_batched(
            order, device, model=model, budget=budget,
            neighborhood=neighborhood, batch_size=batch_size,
            table=table, metrics=metrics)
    t_wall = perf_counter()
    if neighborhood == "auto":
        # Full neighbourhood while it still dominates the reference
        # within a serving budget; past that, local (adjacent) moves
        # spread a small budget across every round boundary instead of
        # burning it on early-position swaps.
        neighborhood = "full" if n <= 128 else "adjacent"
    use_delta = time_fn is None and model in ("round", "event")
    delta = DeltaEvaluator(device, model=model) if use_delta else None
    if time_fn is None:
        time_fn = lambda o: simulate(o, device, model=model)  # noqa: E731
    best = list(order)
    best_t = delta.rebase(best) if use_delta else time_fn(best)
    cost = 1.0
    evals = 1
    eval_cap = 10 * budget if use_delta else budget
    improved = True
    while improved and cost < budget and evals < eval_cap:
        improved = False
        moves = _moves(n, neighborhood)
        if use_delta and neighborhood == "adjacent":
            bounds = delta.boundaries()
            if bounds is None:
                # Event model: every position is a boundary — try the
                # cheapest (latest-suffix) moves first.
                moves.sort(key=lambda m: -m[0])
            else:
                near = [False] * (n + 1)
                for b in bounds:
                    for p in (b - 1, b, b + 1):
                        if 0 <= p < n:
                            near[p] = True
                moves.sort(key=lambda m: (not (near[m[2]] or near[m[3]]),
                                          -m[0]))
        for first, kind, i, j in moves:
            if cost >= budget or evals >= eval_cap:
                break
            cand = _apply(best, kind, i, j)
            if use_delta:
                t, frac = delta.evaluate_costed(cand, first)
                cost += frac
            else:
                t = time_fn(cand)
                cost += 1.0
            evals += 1
            if t < best_t - 1e-15:
                best, best_t, improved = cand, t, True
                if use_delta:
                    # Rebasing is not charged: the budget prices
                    # candidate evaluations only, so on the full move
                    # set the delta path's cumulative cost is <= the
                    # reference's at every trajectory point — it
                    # retraces the reference trajectory and then keeps
                    # going, guaranteeing a result no worse.  The
                    # incremental rebase stitches the still-valid
                    # checkpoint prefix with a recorded suffix re-sim,
                    # so acceptance costs no more than evaluation did.
                    delta.rebase_incremental(best, first)
    if metrics is not None:
        metrics.counter("refine_evals").inc(evals)
        metrics.counter("refine_cost").inc(cost)
        metrics.histogram("refine_score_s").observe(
            perf_counter() - t_wall)
    return best, best_t, evals


def refined_schedule(
    kernels: Sequence[KernelProfile],
    device: DeviceModel,
    *,
    budget: int = 2000,
    model: str = "event",
    neighborhood: str = "full",
    batch_size: int | None = None,
) -> tuple[list[KernelProfile], float]:
    """Algorithm 1 (incremental fast path — identical schedules to the
    reference) followed by local search.  Returns (order, time).

    The :class:`~repro_torch.core.fastscore.ProfileTable` built for the
    greedy is threaded into the refiner, so the pipeline packs the
    kernel set exactly once (the batched path reuses its cached device
    arrays too)."""
    from .fastscore import ProfileTable

    table = ProfileTable.build(kernels, device)
    sched: Schedule = greedy_order_fast(kernels, device, table=table)
    order, t, _ = refine_order(sched.order, device, budget=budget,
                               model=model, neighborhood=neighborhood,
                               batch_size=batch_size, table=table)
    return order, t
