"""Launch queues and gated makespan for DAG schedules.

The paper's launch-order semantics assume one in-order launch queue
whose false serialisation the reordering exploits.  With precedence
edges in play a runtime typically exposes ``k`` hardware queues
(CUDA streams, TPU async collectives): kernels on different queues may
be admitted concurrently, kernels on one queue stay ordered.  This
module generalizes the flat round order to that setting:

* :func:`assign_streams` maps a round-structured schedule onto ``k``
  launch queues — members of one round are mutually independent (the
  ready-set greedy guarantees it), so they interleave round-robin
  across the queues, while a kernel with predecessors pins to the
  queue of its latest-launched predecessor, keeping each dependent
  chain on a single queue (intra-queue ordering then enforces the
  chain for free, no cross-queue event needed);
* :class:`DagEventSimulator` extends the reference
  :class:`~repro_torch.core.simulator.EventSimulator` with a **ready-set
  admission gate**: the dispatcher holds a kernel at the head of the
  queue until every one of its predecessors has fully drained from the
  units.  With an empty edge set the gate never fires and the
  simulation is float-for-float identical to ``EventSimulator``
  (property-tested in ``tests/test_graph.py``), so DAG schedules get
  the same modelled-makespan currency as flat ones.  Like the
  reference, it is *checkpointable*: ``record=True`` captures one
  :class:`~repro_torch.core.simulator.EventCheckpoint` per order position
  and ``start_state=`` resumes from one, replaying the identical
  float accumulation.  The gate's own state (per-kernel retired-block
  counts) is **derived** from the checkpoint rather than stored in
  it: at the instant position ``p`` is first examined, every earlier
  position has been fully dispatched, so a kernel's retired count is
  its grid size minus the blocks still resident in the checkpoint's
  cohorts — which is what lets gated suffix re-simulation
  (:class:`repro_torch.graph.delta.GatedDeltaEvaluator`) share the flat
  checkpoint format;
* :func:`fifo_rounds_dag` is the dependency-aware arrival-order
  baseline: capacity packing that also closes a round whenever the
  next item depends on a member of the open round (the round model's
  notion of "predecessor has not completed yet").
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field
from typing import Sequence

from ..core.resources import DeviceModel, KernelProfile
from ..core.scheduler import Schedule
from ..core.simulator import _EPS, EventCheckpoint, _Cohort, _Unit

__all__ = ["StreamAssignment", "assign_streams", "DagEventSimulator",
           "fifo_rounds_dag"]


@dataclass
class StreamAssignment:
    """``k`` in-order launch queues plus the kernel -> queue map
    (keyed by object identity, aligned with ``flat_order``)."""

    streams: list[list[KernelProfile]]
    stream_of: dict[int, int]
    flat_order: list[KernelProfile]

    @property
    def k(self) -> int:
        return len(self.streams)

    def occupancy(self) -> list[int]:
        return [len(s) for s in self.streams]


def assign_streams(schedule: Schedule | Sequence[Sequence[KernelProfile]],
                   edge_ids: set, k: int) -> StreamAssignment:
    """Map a round-structured schedule onto ``k`` launch queues.

    ``edge_ids`` is the identity-keyed edge set
    (:meth:`repro_torch.graph.kernel_graph.KernelGraph.edges_by_id`).
    Kernels without predecessors round-robin across queues so
    independent work interleaves; a kernel with predecessors joins the
    queue of its latest-launched predecessor, so every dependent chain
    is pinned to one queue and needs no cross-queue synchronisation.
    Relative launch order within a queue follows the flat round order.
    """
    if k < 1:
        raise ValueError(f"need k >= 1 queues, got {k}")
    rounds = (schedule.rounds if isinstance(schedule, Schedule)
              else list(schedule))
    preds: dict[int, list[int]] = {}
    for u, v in edge_ids:
        preds.setdefault(v, []).append(u)
    streams: list[list[KernelProfile]] = [[] for _ in range(k)]
    stream_of: dict[int, int] = {}
    flat: list[KernelProfile] = []
    launch_pos: dict[int, int] = {}
    rr = 0
    for rd in rounds:
        kernels = rd.kernels if hasattr(rd, "kernels") else rd
        for kern in kernels:
            kid = id(kern)
            ps = [p for p in preds.get(kid, []) if p in stream_of]
            if ps:
                latest = max(ps, key=launch_pos.__getitem__)
                s = stream_of[latest]
            else:
                s = rr
                rr = (rr + 1) % k
            stream_of[kid] = s
            launch_pos[kid] = len(flat)
            streams[s].append(kern)
            flat.append(kern)
    return StreamAssignment(streams=streams, stream_of=stream_of,
                            flat_order=flat)


def fifo_rounds_dag(items: Sequence, device: DeviceModel,
                    edge_ids: set,
                    demands_of=lambda it: it.profile().demands
                    ) -> list[list]:
    """Arrival-order round packing that respects precedence: a round
    also closes when the next item depends on a member of the open
    round (its predecessor has not completed).  ``items`` must arrive
    in a topological order; generic over item type via ``demands_of``
    (pass ``lambda k: k.demands`` for raw profiles)."""
    rounds: list[list] = []
    cur: list = []
    cur_ids: set[int] = set()
    done_ids: set[int] = set()
    known = {id(it) for it in items}
    used = {d: 0.0 for d in device.caps}
    preds: dict[int, list[int]] = {}
    for u, v in edge_ids:
        if u in known:
            preds.setdefault(v, []).append(u)

    def close():
        nonlocal cur, cur_ids, used
        rounds.append(cur)
        done_ids.update(cur_ids)
        cur, cur_ids = [], set()
        used = {d: 0.0 for d in device.caps}

    for it in items:
        dem = demands_of(it)
        ps = preds.get(id(it), [])
        blocked = any(p in cur_ids or p not in done_ids for p in ps)
        fits = all(used[k] + dem[k] <= device.cap(k) for k in used)
        if (blocked or not fits) and cur:
            close()
        if any(p not in done_ids for p in ps):
            raise ValueError("items are not in topological order")
        cur.append(it)
        cur_ids.add(id(it))
        for k in used:
            used[k] += dem[k]
    if cur:
        rounds.append(cur)
    return rounds


@dataclass
class DagEventSimulator:
    """Event-driven dispatcher model with a ready-set admission gate.

    Identical dispatch arithmetic to
    :class:`~repro_torch.core.simulator.EventSimulator` — same unit state,
    same cohort bookkeeping, same float accumulation — plus one rule:
    the head kernel is held at the queue until every predecessor in
    ``edge_ids`` has *completed* (all of its blocks dispatched and
    drained).  Launch order must therefore be topological; a
    non-topological order deadlocks the gate and raises ``ValueError``
    instead of spinning.

    Zero-work kernels (no instructions, no demands — the synthetic
    join markers slice expansion introduces, see
    :func:`repro.slice.slicer.join_profile`) are pure synchronisation
    points: once their predecessors have drained they retire
    *instantly* without occupying a unit or joining a cohort, so a
    join never inflates the gated makespan.  No kernel outside the
    slice subsystem is zero-work, so ungated runs (the 0-edge
    float-identity pin vs ``EventSimulator``) are unaffected.

    This is the oracle implementation of the gated model; the
    optimized twin with flat-tuple state is
    :class:`repro_torch.graph.delta._FastGatedSim`, property-tested against
    this class for exact float equality
    (``tests/test_gated_delta.py``), full runs and checkpoint resumes
    alike.
    """

    device: DeviceModel
    edge_ids: set = field(default_factory=set)

    def simulate(self, order: Sequence[KernelProfile], *,
                 start_state: EventCheckpoint | None = None,
                 record: bool = False, trace=None):
        """Gated execution time of ``order``.

        ``start_state`` resumes from a previously recorded
        :class:`~repro_torch.core.simulator.EventCheckpoint`; ``order`` must
        agree with the checkpoint's source order at every position
        before ``start_state.pos``.  With ``record=True`` returns
        ``(time, checkpoints)`` — one checkpoint per order position,
        captured the first time the dispatcher examines it (before the
        ready gate consults predecessor state, which itself depends
        only on earlier positions); otherwise returns the time alone.

        ``trace`` (a :class:`repro_torch.obs.ScheduleTrace`) records one
        span per drained cohort and per-unit busy time, exactly like
        the flat reference, plus a device-scoped **instant** per
        zero-work join retirement (category ``"join"``).  Tracing
        only reads state, so gated times are bit-identical with and
        without it; the span/busy conservation property holds for
        fresh (non-resumed) runs.
        """
        dev = self.device
        dims = tuple(dev.caps)
        preds: dict[int, list[int]] = {}
        for u, v in self.edge_ids:
            preds.setdefault(v, []).append(u)
        grid: dict[int, int] = {id(k): k.n_blocks for k in order}
        if start_state is None:
            units = [_Unit(used={d: 0.0 for d in dims})
                     for _ in range(dev.n_units)]
            start_pos, rr, t = 0, 0, 0.0
            retired: dict[int, int] = {id(k): 0 for k in order}
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
            # Derived gate state: every position < start_pos was fully
            # dispatched before the checkpoint was captured, so its
            # retired count is its grid size minus the blocks still
            # resident in the checkpoint's cohorts (zero-work joins
            # never enter a cohort, so they derive fully retired).
            retired = {id(k): 0 for k in order}
            for p in range(start_pos):
                retired[id(order[p])] = grid[id(order[p])]
            for _, _, cohorts in start_state.units:
                for k, nb, _, _ in cohorts:
                    retired[id(k)] -= nb

        def ready(k: KernelProfile) -> bool:
            return all(retired.get(p, 0) >= grid.get(p, 0)
                       for p in preds.get(id(k), []))

        def zero_work(k: KernelProfile) -> bool:
            return (k.inst_per_block == 0.0 and
                    all(k.demands.get(d, 0.0) == 0.0 for d in dev.caps))

        pending: deque[list] = deque(
            [order[p], order[p].n_blocks, p]
            for p in range(start_pos, len(order)))
        ckpts: list[EventCheckpoint] = []
        next_ckpt = start_pos

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
                    # of it placed yet, and the ready gate's verdict
                    # depends only on earlier positions — capture
                    # before consulting it.
                    ckpts.append(EventCheckpoint.capture(
                        pos, pending[0][1], t, rr, units, dims))
                    next_ckpt = pos + 1
                if not ready(k):
                    break  # admission gate: predecessors still in flight
                if zero_work(k):
                    # Synchronisation marker (slice join): retires the
                    # instant its predecessors drain, occupying nothing.
                    retired[id(k)] = grid[id(k)]
                    pending.popleft()
                    if trace is not None:
                        trace.instant(k.name, t, unit=None, cat="join")
                    continue
                placed = False
                for off in range(dev.n_units):
                    ui = (rr + off) % dev.n_units
                    u = units[ui]
                    if fits(u, k):
                        for dim in dev.caps:
                            u.used[dim] += k.demands[dim]
                        u.n_resident += 1
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
                raise RuntimeError("DagEventSimulator failed to converge")
            if not any(u.cohorts for u in units):
                k, nb, _ = pending[0]
                if not ready(k):
                    # Units are drained, so every dispatched block has
                    # retired; an unready head means a predecessor was
                    # launched after it.
                    raise ValueError(
                        f"launch order violates precedence at {k.name!r}")
                # Oversized head runs alone (same accumulation as
                # EventSimulator's forced single-block passes).
                pending.popleft()
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
                retired[id(k)] = grid[id(k)]
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
                        retired[id(c.kernel)] = (
                            retired.get(id(c.kernel), 0) + c.n_blocks)
                        if trace is not None:
                            trace.span(ui, c.kernel.name, c.t_admit, t,
                                       blocks=c.n_blocks)
                    u.recompute_rate(dev)
            if freed:
                try_admit()
        if record:
            return t, ckpts
        return t
