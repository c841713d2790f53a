"""Per-request latency accounting and replay-drift monitoring.

The ROADMAP's async-serving north star needs p50/p99 latency and
goodput instrumentation to exist *before* the pipelined front end that
reports them can be built.  This module provides both halves:

* :class:`LatencyTracker` — per-request arrival→completion wall-clock
  spans inside :class:`repro_torch.serve.engine.ServingEngine`, with
  queue/compose/guard/refine/execute attribution.  Queue time is
  arrival→first-scheduled; each engine step's measured phase wall
  times are split evenly across the requests served that step (the
  synchronous engine runs one step at a time, so an even split is the
  honest attribution — no request makes progress outside its step).
  Completions feed the ``request_latency_s`` / ``request_queue_s`` /
  ``request_phase_s{phase=...}`` histograms, whose seeded reservoirs
  give p50/p95/p99 in :meth:`stats` and in
  ``ServingEngine.stats()["latency"]``.

* :class:`DriftMonitor` — the EWMA modelled-vs-revalidated drift
  monitor per cache namespace.  The stale-replay check
  (:meth:`repro_torch.serve.composer.Composer.replay_ok`) and the live
  frontier's ratio backstop already *reject* drifted replays; this
  monitor surfaces *how wrong* replayed compositions are — every
  re-validation feeds ``|t_now/t_stored - 1|`` into the
  ``replay_drift{namespace=...}`` histogram and the
  ``replay_drift_ewma{namespace=...}`` gauge, so a cache whose
  patterns are aging badly is visible before the reject counter
  climbs.

Both are pure observers: they read wall clocks and already-computed
modelled times, never the composition itself, so served tokens are
bit-identical with tracking on or off.
"""

from __future__ import annotations

import time

__all__ = ["LatencyTracker", "DriftMonitor"]

#: phase attribution keys, in pipeline order (queue is derived from
#: arrival→first-scheduled, the rest from engine phase wall deltas)
ATTRIB_PHASES = ("compose", "guard", "refine", "execute")


class _Span:
    """Open per-request span: arrival wall time, first-scheduled wall
    time, and accumulated per-phase attribution."""

    __slots__ = ("t_arrive", "t_first", "phases")

    def __init__(self, t_arrive: float):
        self.t_arrive = t_arrive
        self.t_first: float | None = None
        self.phases = {ph: 0.0 for ph in ATTRIB_PHASES}


class LatencyTracker:
    """Arrival→completion span tracker for the serving engine.

    ``clock`` is injectable for tests (defaults to
    ``time.perf_counter``).  All histograms land in the shared
    registry, so ``MetricsRegistry.snapshot()`` carries the latency
    series alongside the cache and phase series.
    """

    def __init__(self, metrics, clock=time.perf_counter):
        self.metrics = metrics
        self.clock = clock
        self._open: dict[int, _Span] = {}

    def arrive(self, rid: int, t: float | None = None) -> None:
        """A request entered the queue (``ServingEngine.submit``)."""
        if rid not in self._open:
            self._open[rid] = _Span(self.clock() if t is None else t)

    def attribute(self, rids, phase_s: dict,
                  t: float | None = None) -> None:
        """One engine step served ``rids``; split each measured phase
        wall time (``phase_s``, seconds per phase) evenly across
        them.  First-time-scheduled requests get their queue span
        closed at ``t``."""
        rids = [r for r in rids if r in self._open]
        if not rids:
            return
        now = self.clock() if t is None else t
        share = {ph: s / len(rids) for ph, s in phase_s.items() if s}
        for rid in rids:
            span = self._open[rid]
            if span.t_first is None:
                span.t_first = now
            for ph, s in share.items():
                if ph in span.phases:
                    span.phases[ph] += s

    def complete(self, rid: int, *, tokens: int = 0,
                 t: float | None = None) -> None:
        """Close a request's span and feed the latency histograms."""
        span = self._open.pop(rid, None)
        if span is None:
            return
        now = self.clock() if t is None else t
        m = self.metrics
        m.histogram("request_latency_s").observe(now - span.t_arrive)
        t_first = span.t_first if span.t_first is not None else now
        m.histogram("request_queue_s").observe(t_first - span.t_arrive)
        for ph, s in span.phases.items():
            m.histogram("request_phase_s", phase=ph).observe(s)
        m.counter("requests_completed").inc()
        m.counter("tokens_completed").inc(tokens)

    def stats(self, wall_s: float) -> dict:
        """The latency/goodput block of ``ServingEngine.stats()``:
        completion count, reservoir p50/p95/p99 (plus mean/max) of
        arrival→completion and queue spans, mean per-phase
        attribution, and goodput over ``wall_s`` (completed requests
        and tokens per wall second)."""
        m = self.metrics
        lat = m.histogram("request_latency_s")
        queue = m.histogram("request_queue_s")
        completed = m.counter("requests_completed").value
        tokens = m.counter("tokens_completed").value
        wall = max(wall_s, 1e-12)
        return {
            "completed": int(completed),
            "in_flight": len(self._open),
            "wall_s": wall_s,
            "p50_s": lat.quantile(0.50),
            "p95_s": lat.quantile(0.95),
            "p99_s": lat.quantile(0.99),
            "mean_s": lat.mean,
            "max_s": lat.vmax if lat.count else 0.0,
            "queue_p50_s": queue.quantile(0.50),
            "queue_p99_s": queue.quantile(0.99),
            "phase_mean_s": {
                ph: m.histogram("request_phase_s", phase=ph).mean
                for ph in ATTRIB_PHASES},
            "goodput_rps": completed / wall,
            "goodput_tokens_per_s": tokens / wall,
        }


class DriftMonitor:
    """EWMA of modelled-vs-revalidated drift per cache namespace.

    ``observe(namespace, rel_err)`` feeds the absolute relative error
    of a replayed (or incrementally maintained) composition's current
    modelled time against its stored baseline.  ``alpha`` is the EWMA
    smoothing weight of the newest observation.
    """

    def __init__(self, metrics, alpha: float = 0.2):
        self.metrics = metrics
        self.alpha = alpha
        self._ewma: dict[str, float] = {}

    def observe(self, namespace: str, rel_err: float) -> None:
        rel_err = abs(rel_err)
        prev = self._ewma.get(namespace)
        cur = (rel_err if prev is None
               else prev + self.alpha * (rel_err - prev))
        self._ewma[namespace] = cur
        m = self.metrics
        m.histogram("replay_drift", namespace=namespace) \
            .observe(rel_err)
        m.gauge("replay_drift_ewma", namespace=namespace).set(cur)

    def ewma(self, namespace: str) -> float:
        """Current EWMA drift for ``namespace`` (0.0 if never fed)."""
        return self._ewma.get(namespace, 0.0)
