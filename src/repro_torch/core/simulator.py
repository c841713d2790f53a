"""Execution-time models for a launch order on a multi-unit device.

``RoundSimulator``
    The paper's strict *execution round* abstraction, scalar per unit:
    kernels are admitted in launch order until one fails to fit, which
    closes the round.  A round's duration is its occupancy-adjusted
    roofline time and rounds run back to back.  This is the model the
    paper's narrative reasons with.

``EventSimulator``
    The reference timing model: an event-driven simulation of the
    GigaThread-style block dispatcher over ``n_units`` *individual*
    execution units.  Blocks are dispatched strictly in launch order
    (no lookahead — the false serialisation the paper exploits) to the
    next unit with available resources, round-robin.  Each unit
    progresses at its own occupancy-adjusted roofline rate
    ``lam = min(eff_c * compute_rate / sum_c, eff_m * mem_bw / sum_m)``
    over its resident mix, so

    * compute-bound and memory-bound blocks genuinely overlap,
    * under-occupied units run below peak (latency hiding needs
      parallel slack, and the memory system needs much more of it than
      the ALUs), and
    * heterogeneous block placement causes per-unit load imbalance and
      resource fragmentation — the order-dependent effects that create
      the multi-x spreads of the paper's Table 3.

Both models charge a block's compute and memory work concurrently
(within-block overlap), so a kernel alone runs at its roofline time.

Both models are *checkpointable*: they can record their full dispatcher
state at admission boundaries (:class:`RoundCheckpoint` /
:class:`EventCheckpoint`) and resume a simulation from a recorded
checkpoint.  A candidate order that agrees with the recorded order on
every position before the checkpoint replays the identical float
accumulation from there on, which is what makes suffix re-simulation
(:class:`repro_torch.core.refine.DeltaEvaluator`) exact.

Both models treat every kernel as free to co-schedule with every
other.  Orders that carry precedence edges are scored by the gated
extension of the event model —
:class:`repro.graph.streams.DagEventSimulator`, which holds a kernel
at the queue head until its predecessors drain, shares this module's
:class:`EventCheckpoint` format (the gate state is derived on resume)
and is delta-evaluated by :class:`repro.graph.delta.GatedDeltaEvaluator`.

Both models also have *batched* twins that evaluate whole ``(B, n)``
candidate batches at once from checkpoint-stitched suffixes —
:class:`repro_torch.core.batched.BatchedRoundSim` (bit-exact against the
round model) and :class:`repro_torch.core.batched.BatchedEventSim` (within
pure summation-order float noise of the event/gated models) — plus an
f32 scan of the event dispatcher over many orders at once,
:func:`repro_torch.kernels.event_scan.event_times` (a CUDA kernel, with
a plain PyTorch version).  This module stays the semantic definition:
every batched/kernel path is tested against the simulators here
(``tests/test_torch_core.py``, ``tests/test_torch_kernels.py``).
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field
from typing import Sequence

from .resources import DeviceModel, KernelProfile

__all__ = ["RoundSimulator", "RoundCheckpoint", "EventSimulator",
           "EventCheckpoint", "simulate"]

_EPS = 1e-12


@dataclass(frozen=True)
class RoundCheckpoint:
    """Admission state at one round boundary of a round-model run.

    ``pos`` is the order index of the head kernel when the round
    opened, ``blocks_left`` how many of its per-unit blocks were still
    undispatched (== its full count when the previous round did not
    split it), and ``time`` the cumulative time of all earlier rounds.
    A candidate order that only differs from the recorded one at
    positions >= p can resume from the latest checkpoint whose
    consumed prefix lies strictly before p (produced and consumed by
    :class:`repro_torch.core.refine.DeltaEvaluator`).
    """

    pos: int
    blocks_left: int
    time: float


@dataclass
class RoundSimulator:
    """Reference round model, kept deliberately simple: it is the
    oracle the optimized delta evaluator
    (:class:`repro_torch.core.refine.DeltaEvaluator`) is
    property-tested against for exact equality."""

    device: DeviceModel

    def simulate(self, order: Sequence[KernelProfile], *,
                 trace=None) -> float:
        """Execution time of ``order`` under the round model.

        ``trace`` (a :class:`repro.obs.ScheduleTrace`) records one
        span per kernel per round — the round model is scalar per
        unit, so all spans land on unit 0 — plus a round-boundary
        instant when each round closes.  Tracing only reads state:
        the returned float is bit-identical with and without it.
        """
        dev = self.device
        # FIFO of [kernel, blocks still to dispatch on this unit].
        pending: deque[list] = deque(
            [k, k.blocks_per_unit(dev)] for k in order)
        total = 0.0
        r_idx = 0
        while pending:
            used = {d: 0.0 for d in dev.caps}
            blocks, inst, mem = 0, 0.0, 0.0
            members: list = []
            while pending:
                k, nb = pending[0]
                d = k.demands
                fit = nb
                for dim in dev.caps:
                    if d[dim] > 0:
                        fit = min(fit, int((dev.cap(dim) - used[dim] + _EPS)
                                           // d[dim]))
                fit = max(min(fit, dev.max_resident - blocks), 0)
                if fit == 0:
                    if blocks == 0:
                        fit = 1  # oversized block: runs alone regardless
                    else:
                        break  # strict FIFO: head closes the round
                for dim in dev.caps:
                    used[dim] += d[dim] * fit
                blocks += fit
                inst += k.inst_per_block * fit
                mem += k.mem_per_block() * fit
                if trace is not None:
                    members.append((k.name, fit))
                pending[0][1] -= fit
                if pending[0][1] == 0:
                    pending.popleft()
                if pending and pending[0][0] is k:
                    break  # partially admitted head: unit is full
            eff_c = max(dev.compute_efficiency(used), _EPS)
            eff_m = max(dev.memory_efficiency(used), _EPS)
            r_start = total
            total += max(inst / (dev.compute_rate * eff_c),
                         mem / (dev.mem_bw * eff_m))
            if trace is not None:
                for name, nb in members:
                    trace.span(0, name, r_start, total, blocks=nb,
                               cat="round-member")
                trace.instant(f"round {r_idx}", total, unit=0,
                              cat="round")
                trace.add_busy(0, total - r_start)
            r_idx += 1
        return total


@dataclass
class _Cohort:
    """Blocks of one kernel admitted to one unit at the same instant.

    ``t_admit`` tags the admission instant: blocks only merge into a
    cohort admitted at the *same* simulation time.  (Merging on
    ``frac_left == 1.0`` alone — the pre-fix behaviour — let a block
    admitted at a later instant join an old cohort whose progress had
    underflowed to zero, violating the same-instant invariant and
    making checkpoint resume non-reproducible.)
    """

    kernel: KernelProfile
    n_blocks: int
    frac_left: float = 1.0
    t_admit: float = 0.0


@dataclass
class _Unit:
    used: dict[str, float]
    n_resident: int = 0
    cohorts: list[_Cohort] = field(default_factory=list)
    lam: float = 0.0

    def recompute_rate(self, dev: DeviceModel) -> None:
        if not self.cohorts:
            self.lam = 0.0
            return
        sum_c = sum(c.kernel.inst_per_block * c.n_blocks for c in self.cohorts)
        sum_m = sum(c.kernel.mem_per_block() * c.n_blocks for c in self.cohorts)
        eff_c = max(dev.compute_efficiency(self.used), _EPS)
        eff_m = max(dev.memory_efficiency(self.used), _EPS)
        self.lam = min(dev.compute_rate * eff_c / max(sum_c, _EPS),
                       dev.mem_bw * eff_m / max(sum_m, _EPS))


@dataclass(frozen=True)
class EventCheckpoint:
    """Full dispatcher state at the instant the event-model dispatcher
    first examines the kernel at order position ``pos``.

    At that instant no block of position ``pos`` has been placed
    (``blocks_left`` equals its full grid size), so the captured state
    — per-unit ``used`` vectors, resident-block counts, cohort
    fractions with their admission instants, the round-robin pointer
    and the cumulative time — depends only on kernels at positions
    ``< pos``.  A candidate order agreeing with the recorded one at
    every position ``< first_changed`` can therefore resume from the
    checkpoint at ``pos == first_changed`` (or any earlier one) and
    replay the identical float accumulation.

    ``units`` is a tuple with one entry per execution unit::

        (used, n_resident, cohorts)

    where ``used`` is a tuple of floats in ``device.caps`` order and
    ``cohorts`` is a tuple of ``(kernel, n_blocks, frac_left,
    t_admit)`` tuples.  Unit rates (``lam``) are derived state and are
    recomputed on resume.
    """

    pos: int
    blocks_left: int
    time: float
    rr: int
    units: tuple

    @staticmethod
    def capture(pos: int, blocks_left: int, time: float, rr: int,
                units: Sequence[_Unit], dims: Sequence[str]
                ) -> "EventCheckpoint":
        return EventCheckpoint(
            pos=pos, blocks_left=blocks_left, time=time, rr=rr,
            units=tuple(
                (tuple(u.used[d] for d in dims), u.n_resident,
                 tuple((c.kernel, c.n_blocks, c.frac_left, c.t_admit)
                       for c in u.cohorts))
                for u in units))


@dataclass
class EventSimulator:
    """Reference event-driven per-unit dispatcher model.

    This is the oracle implementation: deliberately dict-based and
    close to the prose description above.  The optimized twin
    (:class:`repro_torch.core.refine._FastEventSim`) replays the identical
    arithmetic over pre-resolved tuples and is property-tested against
    this class for exact float equality, full runs and checkpoint
    resumes alike.
    """

    device: DeviceModel

    def simulate(self, order: Sequence[KernelProfile], *,
                 start_state: EventCheckpoint | None = None,
                 record: bool = False, trace=None):
        """Execution time of ``order``.

        ``start_state`` resumes from a previously recorded
        :class:`EventCheckpoint`; ``order`` must agree with the
        checkpoint's source order at every position before
        ``start_state.pos`` (positions from there on are re-dispatched
        with their full block counts, so the kernel *at*
        ``start_state.pos`` may differ).  With ``record=True`` returns
        ``(time, checkpoints)`` — one checkpoint per order position,
        captured the first time the dispatcher examines it; otherwise
        returns the time alone.

        ``trace`` (a :class:`repro.obs.ScheduleTrace`) records one
        span per drained cohort — kernel name, unit, admission
        instant to drain instant, block count — plus per-unit busy
        time for every ``dt`` the dispatcher advances.  Tracing only
        reads state (every hook is ``if trace is not None``), so
        modelled times are bit-identical with and without it.  On a
        ``start_state`` resume, cohorts restored from the checkpoint
        keep their original (pre-resume) admission instants while
        busy time accrues only from the resume point, so the
        span/busy conservation property only holds for fresh runs.
        """
        dev = self.device
        dims = tuple(dev.caps)
        if start_state is None:
            units = [_Unit(used={d: 0.0 for d in dims})
                     for _ in range(dev.n_units)]
            start_pos, rr, t = 0, 0, 0.0
        else:
            units = []
            for used, n_res, cohorts in start_state.units:
                u = _Unit(used=dict(zip(dims, used)), n_resident=n_res,
                          cohorts=[_Cohort(k, nb, fl, ta)
                                   for k, nb, fl, ta in cohorts])
                u.recompute_rate(dev)
                units.append(u)
            start_pos, rr, t = (start_state.pos, start_state.rr,
                                start_state.time)
        # Strict-FIFO dispatch queue of [kernel, blocks left, position].
        pending: deque[list] = deque(
            [order[p], order[p].n_blocks, p]
            for p in range(start_pos, len(order)))
        ckpts: list[EventCheckpoint] = []
        next_ckpt = start_pos  # first order position not yet examined

        def fits(u: _Unit, k: KernelProfile) -> bool:
            if u.n_resident + 1 > dev.max_resident:
                return False
            return all(u.used[dim] + k.demands[dim] <= dev.cap(dim) + _EPS
                       for dim in dev.caps)

        def try_admit() -> None:
            nonlocal rr, next_ckpt
            touched: set[int] = set()
            while pending:
                k, _, pos = pending[0]
                if record and pos == next_ckpt:
                    # First examination of position ``pos``: no block
                    # of it placed yet, state depends only on earlier
                    # positions — the admission boundary a suffix
                    # re-simulation can resume from.
                    ckpts.append(EventCheckpoint.capture(
                        pos, pending[0][1], t, rr, units, dims))
                    next_ckpt = pos + 1
                placed = False
                for off in range(dev.n_units):
                    ui = (rr + off) % dev.n_units
                    u = units[ui]
                    if fits(u, k):
                        for dim in dev.caps:
                            u.used[dim] += k.demands[dim]
                        u.n_resident += 1
                        # Merge only into a cohort admitted at this
                        # same instant (see _Cohort.t_admit).
                        for c in u.cohorts:
                            if c.kernel is k and c.t_admit == t:
                                c.n_blocks += 1
                                break
                        else:
                            u.cohorts.append(_Cohort(k, 1, t_admit=t))
                        touched.add(ui)
                        rr = (ui + 1) % dev.n_units
                        pending[0][1] -= 1
                        if pending[0][1] == 0:
                            pending.popleft()
                        placed = True
                        break
                if not placed:
                    break  # head blocks the queue (strict FIFO)
            for ui in touched:
                units[ui].recompute_rate(dev)

        try_admit()
        guard = 0
        while any(u.cohorts for u in units) or pending:
            guard += 1
            if guard > 1_000_000:
                raise RuntimeError("EventSimulator failed to converge")
            if not any(u.cohorts for u in units):
                # Head block larger than an empty unit: it runs alone,
                # one block per unit per pass, at the occupancy a
                # single resident block achieves — the same
                # "oversized block runs alone" rule (and the same
                # float accumulation) as RoundSimulator's forced
                # single-block rounds.
                k, nb, pos = pending.popleft()
                used1 = {dim: k.demands[dim] for dim in dev.caps}
                eff_c = max(dev.compute_efficiency(used1), _EPS)
                eff_m = max(dev.memory_efficiency(used1), _EPS)
                t1 = max(k.inst_per_block / (dev.compute_rate * eff_c),
                         k.mem_per_block() / (dev.mem_bw * eff_m))
                for p in range(math.ceil(nb / dev.n_units)):
                    t += t1
                    if trace is not None:
                        for ui in range(min(dev.n_units,
                                            nb - p * dev.n_units)):
                            trace.span(ui, k.name, t - t1, t,
                                       blocks=1, cat="solo")
                            trace.add_busy(ui, t1)
                try_admit()
                continue
            dt = min(c.frac_left / u.lam
                     for u in units if u.cohorts for c in u.cohorts)
            t += dt
            freed = False
            for ui, u in enumerate(units):
                if not u.cohorts:
                    continue
                if trace is not None:
                    trace.add_busy(ui, dt)
                done = []
                for c in u.cohorts:
                    c.frac_left -= u.lam * dt
                    if c.frac_left <= 1e-9:
                        done.append(c)
                if done:
                    freed = True
                    for c in done:
                        u.cohorts.remove(c)
                        for dim in dev.caps:
                            u.used[dim] -= c.kernel.demands[dim] * c.n_blocks
                        u.n_resident -= c.n_blocks
                        if trace is not None:
                            trace.span(ui, c.kernel.name, c.t_admit, t,
                                       blocks=c.n_blocks)
                    u.recompute_rate(dev)
            if freed:
                try_admit()
        if record:
            return t, ckpts
        return t


def simulate(order: Sequence[KernelProfile], device: DeviceModel,
             model: str = "event", trace=None) -> float:
    """Convenience wrapper: execution time of ``order`` on ``device``.
    ``trace`` forwards to the chosen simulator's recorder hook."""
    if model == "event":
        return EventSimulator(device).simulate(order, trace=trace)
    if model == "round":
        return RoundSimulator(device).simulate(order, trace=trace)
    raise ValueError(f"unknown model {model!r}")
