"""Async continuous-batching serving front end (the port of
the reference's ``repro.serve.frontend``, host code, bit-equal to it).

The paper's launch-order wins are reported by the engine in modelled
makespan; the north star ("heavy traffic from millions of users") needs
them as *request latency* under a real arrival process.  This module is
that lift: an arrival queue with cost-modelled admission control, a
continuous-batching dispatch loop over one-or-more
:class:`~repro_torch.serve.engine.ServingEngine` replicas, and a management
plane with cache-aware routing — all on a deterministic **virtual
clock**, so the same seeded workload produces the same p50/p99 report
on every run and platform.

Design
------

* **Admission is priced in the composer's currency.**  A queued
  request is admitted to a replica only if the replica's *modelled
  next-step cost* — :func:`repro_torch.core.tpu.fifo_rounds` packing of its
  live work items plus the candidate, each round priced by
  :func:`repro_torch.core.tpu.round_time` — stays within
  :attr:`AdmissionPolicy.round_cost_budget_s`.  Requests are never
  counted; they are costed.  A request whose *solo* round cost exceeds
  the budget on every replica can never be admitted and is rejected at
  ingest (``reason="oversized"``), as is any arrival past
  :attr:`AdmissionPolicy.max_queue_depth` (``reason="queue_full"``).

* **Deferral is bounded (no starvation).**  Admission scans the wait
  queue in FIFO order and lets younger requests bypass a deferred head
  — but only :attr:`AdmissionPolicy.max_defer` times.  A request
  deferred that often *blocks* the queue: nothing behind it is
  admitted until it lands.  Because replicas drain (every dispatched
  step advances every live request by one token) and an idle replica
  has modelled cost 0, the blocked head is admitted as soon as any
  replica's queue drains far enough — bounded wait, pinned by
  ``tests/test_frontend.py``.

* **Continuous batching through the engine's own step loop.**  Admitted
  requests ``submit()`` into the chosen replica mid-flight; the next
  ``step()`` composes them into rounds with whatever is already live.
  With ``SchedulerPolicy.composition="incremental"`` the join flows
  through the :class:`~repro_torch.serve.live.LiveComposition` frontier
  (``incremental_joins``/``incremental_leaves``); with the default
  ``"batch"`` composition each step recomposes from scratch — the
  fallback path.  Either way execution is exact per request, so
  frontend-served tokens are **bit-identical** to a synchronous
  ``step()`` loop over the same requests.

* **Virtual time.**  The dispatch loop is a discrete-event simulation:
  replica ``i``'s clock advances by the *modelled* round times of each
  step it runs (the same ``_round_times`` the engine reports), arrivals
  occur at their seeded instants, and the frontend's own
  :class:`~repro_torch.obs.LatencyTracker` is fed explicit virtual
  timestamps.  No wall clock is read anywhere on the report path.

* **Cache-aware routing.**  ``route="cache_affinity"`` routes requests
  with the same prefill signature (the :class:`ScheduleCache` key
  currency) to the same replica so its pattern store stays warm;
  first-seen signatures fall back to the least-loaded replica (by
  modelled cost, deterministic index tie-break).  Replicas may share
  one :class:`~repro_torch.serve.cache.ScheduleCache`
  (``ServingFrontend.build(..., shared_cache=True)``) or keep their
  own; ``tests/test_frontend.py`` pins lookup conservation across both
  modes.

Observability: the frontend owns a :class:`MetricsRegistry` with
``frontend_submitted`` / ``frontend_admitted`` / ``frontend_deferred``
/ ``frontend_rejected{reason=...}`` counters, a
``frontend_queue_depth`` gauge (plus depth histogram), per-replica
``replica_steps{replica=...}`` / ``replica_busy_s{replica=...}``
series, and the latency histograms on virtual time.  With a
:class:`~repro_torch.obs.FlightRecorder` attached it emits ``arrival`` /
``admit`` / ``defer`` / ``reject`` / ``frontend_step`` events; each
``frontend_step`` carries both the global dispatch ``tick`` and the
replica's **engine-local** step count, and audit sampling keys on the
latter (each replica's own ``QualityAuditor``), so ``audit_frac``
semantics are unchanged per replica.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

from ..core.tpu import (decode_profile, fifo_rounds, prefill_profile,
                        round_time)
from ..obs import LatencyTracker, MetricsRegistry

__all__ = ["AdmissionPolicy", "VirtualClock", "ServingFrontend"]


class VirtualClock:
    """Deterministic virtual time source.

    Advances only by explicit modelled durations — never reads the wall
    clock — and enforces monotonicity: a negative ``advance`` raises,
    ``advance_to`` a past instant is a no-op.  Bound ``now`` is a valid
    ``clock=`` for :class:`repro_torch.obs.LatencyTracker`.
    """

    __slots__ = ("_t",)

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"virtual clock cannot go backwards (dt={dt})")
        self._t += dt
        return self._t

    def advance_to(self, t: float) -> float:
        if t > self._t:
            self._t = float(t)
        return self._t


@dataclass
class AdmissionPolicy:
    """Knobs for cost-modelled admission (see module docstring).

    ``round_cost_budget_s`` is in the composer's currency — modelled
    seconds of the replica's next step under the TPU round cost model —
    NOT a request count.
    """

    #: ceiling on a replica's modelled next-step cost (seconds under
    #: :func:`repro_torch.core.tpu.round_time` over fifo-packed rounds);
    #: admission keeps every replica at or below it.
    round_cost_budget_s: float = 0.5
    #: arrivals beyond this many waiting requests are rejected
    #: (``reason="queue_full"``).
    max_queue_depth: int = 64
    #: how many times a waiting request may be bypassed by younger
    #: arrivals before it blocks the queue (starvation bound).
    max_defer: int = 8
    #: replica routing: ``cache_affinity`` (sticky by prefill
    #: signature, least-loaded for first-seen), ``least_loaded``
    #: (modelled cost argmin), or ``round_robin``.
    route: str = "cache_affinity"


class _Waiting:
    """A request in the frontend arrival queue."""

    __slots__ = ("req", "t_arrive", "deferrals")

    def __init__(self, req, t_arrive: float):
        self.req = req
        self.t_arrive = t_arrive
        self.deferrals = 0


class ServingFrontend:
    """Management plane over one-or-more engine replicas.

    ``engines`` are pre-built :class:`ServingEngine` replicas (use
    :meth:`build` for the common pool shapes, including a shared
    :class:`ScheduleCache`).  Drive it with :meth:`run` over a
    ``[(t_arrive, Request), ...]`` workload — e.g. from
    :func:`repro_torch.serve.loadgen.make_workload` — then read
    :meth:`stats` / :meth:`outputs`.
    """

    def __init__(self, engines, admission: AdmissionPolicy | None = None,
                 *, metrics: MetricsRegistry | None = None,
                 recorder=None, clock: VirtualClock | None = None):
        if not engines:
            raise ValueError("ServingFrontend needs at least one engine")
        self.engines = list(engines)
        self.admission = admission or AdmissionPolicy()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.recorder = recorder
        self.clock = clock or VirtualClock()
        #: virtual-time latency spans (arrival → admission → completion)
        self.latency = LatencyTracker(self.metrics, clock=self.clock.now)
        self.queue: deque[_Waiting] = deque()
        #: virtual instant at which each replica's last step finishes
        self._t_replica = [0.0] * len(self.engines)
        self._busy_s = [0.0] * len(self.engines)
        self._steps = [0] * len(self.engines)
        self._tick = 0
        self._affinity: dict[tuple, int] = {}
        self._rr = 0
        self._done: set[int] = set()
        #: ``(rid, t_complete, replica)`` in dispatch order — the
        #: monotonicity property in ``tests/test_loadgen.py`` reads it.
        self.completions: list[tuple[int, float, int]] = []
        self._queue_depth_max = 0
        self._max_deferrals = 0

    # -- construction ---------------------------------------------------
    @classmethod
    def build(cls, cfg, params, *, n_replicas: int = 1, policy=None,
              admission: AdmissionPolicy | None = None,
              shared_cache: bool = False, max_len: int = 256,
              device=None, recorder=None, metrics=None, **engine_kw):
        """Build a replica pool over one model.

        ``shared_cache=True`` gives every replica the same
        :class:`ScheduleCache` (with its own registry); otherwise each
        engine keeps its per-replica cache in its own registry.
        """
        from .cache import ScheduleCache
        from .engine import SchedulerPolicy, ServingEngine

        policy = policy or SchedulerPolicy()
        shared = (ScheduleCache(kv_bucket=policy.kv_bucket)
                  if shared_cache else None)
        engines = [ServingEngine(cfg, params, max_len=max_len,
                                 policy=policy, device=device,
                                 recorder=recorder, schedule_cache=shared,
                                 **engine_kw)
                   for _ in range(n_replicas)]
        return cls(engines, admission, metrics=metrics,
                   recorder=recorder)

    # -- cost model (the composer's currency) ---------------------------
    def _item_of(self, eng, req):
        kvb = eng._kv_bytes_per_token()
        if req.cache is None:
            return prefill_profile(f"prefill:{req.rid}",
                                   n_params=eng.n_params,
                                   seq_len=int(len(req.prompt)),
                                   kv_bytes_per_token=kvb)
        return decode_profile(f"decode:{req.rid}", n_params=eng.n_params,
                              kv_len=req.pos, kv_bytes_per_token=kvb)

    def solo_cost_s(self, i: int, req) -> float:
        """Modelled round cost of ``req`` alone on replica ``i``."""
        eng = self.engines[i]
        return round_time([self._item_of(eng, req)], eng.device,
                          eng.weights_bytes)

    def step_cost_s(self, i: int, extra=()) -> float:
        """Modelled cost of replica ``i``'s next step: fifo-packed
        rounds over its live work items (plus ``extra`` candidate
        requests), each priced by :func:`round_time` with the weight
        stream charged once per round."""
        eng = self.engines[i]
        items = [t[0] for t in eng._work_items()]
        items += [self._item_of(eng, r) for r in extra]
        if not items:
            return 0.0
        return sum(round_time(rd, eng.device, eng.weights_bytes)
                   for rd in fifo_rounds(items, eng.device))

    # -- admission ------------------------------------------------------
    def _note(self, kind: str, **fields) -> None:
        if self.recorder is not None:
            self.recorder.event(kind, **fields)

    def _ingest(self, req) -> None:
        """Arrival at the current virtual instant: reject or enqueue."""
        self.metrics.counter("frontend_submitted").inc()
        now = self.clock.now()
        if len(self.queue) >= self.admission.max_queue_depth:
            self._reject(req, "queue_full", now)
            return
        if min(self.solo_cost_s(i, req)
               for i in range(len(self.engines))) > \
                self.admission.round_cost_budget_s:
            self._reject(req, "oversized", now)
            return
        self.queue.append(_Waiting(req, now))
        self._queue_depth_max = max(self._queue_depth_max, len(self.queue))
        self._depth()
        self.latency.arrive(req.rid, t=now)
        self._note("arrival", rid=req.rid, t=now)

    def _reject(self, req, reason: str, now: float) -> None:
        self.metrics.counter("frontend_rejected", reason=reason).inc()
        self._note("reject", rid=req.rid, reason=reason, t=now)

    def _depth(self) -> None:
        self.metrics.gauge("frontend_queue_depth").set(len(self.queue))
        self.metrics.histogram("frontend_queue_depth_hist").observe(
            float(len(self.queue)))

    def _route(self, req) -> int:
        a = self.admission
        if a.route == "round_robin":
            i = self._rr % len(self.engines)
            self._rr += 1
            return i
        by_load = min(range(len(self.engines)),
                      key=lambda j: (self.step_cost_s(j), j))
        if a.route == "least_loaded":
            return by_load
        if a.route != "cache_affinity":
            raise ValueError(f"unknown route {a.route!r}")
        # prefill signature: the ScheduleCache key currency for the
        # work the request brings on admission.
        sig = ("p", int(len(req.prompt)))
        if sig not in self._affinity:
            self._affinity[sig] = by_load
        return self._affinity[sig]

    def _admit(self) -> None:
        """One admission pass: FIFO scan with bounded bypass.

        Invariant (pinned by tests): a request is admitted to replica
        ``i`` only if ``step_cost_s(i, extra=(req,)) <=
        round_cost_budget_s``.  A head deferred ``max_defer`` times
        blocks all younger requests until it is admitted.
        """
        budget = self.admission.round_cost_budget_s
        out: deque[_Waiting] = deque()
        blocked = False
        while self.queue:
            w = self.queue.popleft()
            if blocked:
                out.append(w)
                continue
            routed = self._route(w.req)
            order = [routed] + sorted(
                (j for j in range(len(self.engines)) if j != routed),
                key=lambda j: (self.step_cost_s(j), j))
            target = None
            est_with = None
            for i in order:
                est_with = self.step_cost_s(i, extra=(w.req,))
                if est_with <= budget:
                    target = i
                    break
            if target is not None:
                self.engines[target].submit([w.req])
                self.metrics.counter("frontend_admitted",
                                     replica=str(target)).inc()
                now = self.clock.now()
                # close the queue span at the admission instant
                self.latency.attribute([w.req.rid], {}, t=now)
                self._note("admit", rid=w.req.rid, replica=target,
                           est_with=est_with, budget=budget, t=now,
                           waited=now - w.t_arrive,
                           deferrals=w.deferrals)
            else:
                w.deferrals += 1
                self._max_deferrals = max(self._max_deferrals,
                                          w.deferrals)
                self.metrics.counter("frontend_deferred").inc()
                self._note("defer", rid=w.req.rid,
                           deferrals=w.deferrals, t=self.clock.now())
                out.append(w)
                if w.deferrals >= self.admission.max_defer:
                    blocked = True
        self.queue = out
        self._depth()

    # -- dispatch -------------------------------------------------------
    @staticmethod
    def _live(eng) -> bool:
        return any(not r.done for r in eng.queue)

    def _dispatch(self, i: int) -> None:
        """Run one engine step on replica ``i`` at virtual ``now``."""
        eng = self.engines[i]
        n0 = len(eng._round_times)
        ran = eng.step()
        dt = float(sum(eng._round_times[n0:]))
        start = max(self._t_replica[i], self.clock.now())
        t_end = start + dt
        self._t_replica[i] = t_end
        self._busy_s[i] += dt
        self._steps[i] += 1
        self._tick += 1
        self.metrics.counter("replica_steps", replica=str(i)).inc()
        self.metrics.gauge("replica_busy_s", replica=str(i)).set(
            self._busy_s[i])
        # engine-local step count — the auditor keys its sampling on
        # this (each replica's own QualityAuditor), never on the
        # global tick.
        engine_step = int(eng.metrics.counter("engine_steps").value)
        self._note("frontend_step", replica=i, tick=self._tick,
                   engine_step=engine_step, rounds=ran, dt=dt,
                   t_start=start, t_end=t_end)
        for r in eng.queue:
            if r.done and r.rid not in self._done:
                self._done.add(r.rid)
                self.completions.append((r.rid, t_end, i))
                self.latency.complete(r.rid, tokens=len(r.generated),
                                      t=t_end)

    def run(self, workload, *, max_ticks: int = 100_000) -> dict:
        """Discrete-event loop over ``[(t_arrive, Request), ...]``.

        Events are processed in virtual-time order: an arrival at or
        before the next step's start is ingested (and admission
        re-tried) first, then the busiest-soonest replica runs one
        step.  Returns :meth:`stats`.
        """
        pending = deque(sorted(workload,
                               key=lambda p: (p[0], p[1].rid)))
        while self._tick < max_ticks:
            busy = [i for i in range(len(self.engines))
                    if self._live(self.engines[i])]
            t_arr = pending[0][0] if pending else None
            if busy:
                i = min(busy, key=lambda j: (self._t_replica[j], j))
                t_step = max(self._t_replica[i], self.clock.now())
            else:
                i, t_step = None, None
            if t_arr is not None and (t_step is None or t_arr <= t_step):
                t, req = pending.popleft()
                self.clock.advance_to(t)
                self._ingest(req)
                self._admit()
                continue
            if i is None:
                if not self.queue:
                    break                       # fully drained
                self._admit()                   # idle pool: must progress
                if not any(self._live(e) for e in self.engines):
                    break                       # nothing admissible left
                continue
            self.clock.advance_to(t_step)
            self._admit()
            self._dispatch(i)
        # report at the instant the last replica finishes
        self.clock.advance_to(max(self._t_replica))
        return self.stats()

    # -- reporting ------------------------------------------------------
    def outputs(self) -> dict:
        """``{rid: generated tokens}`` across the pool — the
        bit-identity comparison key against a synchronous run."""
        out = {}
        for eng in self.engines:
            for r in eng.queue:
                out[r.rid] = list(r.generated)
        return out

    def stats(self) -> dict:
        """Deterministic (virtual-time) serving report."""
        m = self.metrics
        submitted = int(m.counter("frontend_submitted").value)
        admitted = sum(
            int(m.counter("frontend_admitted", replica=str(i)).value)
            for i in range(len(self.engines)))
        rejected = sum(
            int(m.counter("frontend_rejected", reason=r).value)
            for r in ("queue_full", "oversized"))
        return {
            "virtual_time_s": self.clock.now(),
            "ticks": self._tick,
            "submitted": submitted,
            "admitted": admitted,
            "rejected": rejected,
            "deferred_events": int(
                m.counter("frontend_deferred").value),
            "max_deferrals": self._max_deferrals,
            "rejection_rate": rejected / max(submitted, 1),
            "queue_depth_max": self._queue_depth_max,
            "latency": self.latency.stats(max(self.clock.now(), 1e-12)),
            "replicas": [
                {"replica": i,
                 "steps": self._steps[i],
                 "busy_s": self._busy_s[i],
                 "t_done_s": self._t_replica[i],
                 "schedule_cache": eng.schedule_cache.stats()}
                for i, eng in enumerate(self.engines)],
        }
