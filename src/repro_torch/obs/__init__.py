"""Observability for the port's serving stack (host-only copies of the
reference's ``repro.obs``).

* :mod:`.metrics` — :class:`MetricsRegistry` with counters / gauges /
  histograms; the single sink behind ``ScheduleCache.stats()`` and the
  engine's phase timers.
* :mod:`.profile` — phase-timing conventions (:data:`PHASES`) and
  :func:`phase_breakdown`.
* :mod:`.audit`   — :class:`QualityAuditor`, the online Fig.-1 sampler
  (flat steps, and traced ``respect_deps`` steps in the gated
  currency).
* :mod:`.latency` — :class:`LatencyTracker` and :class:`DriftMonitor`.

Schedule tracing, Prometheus export and the flight recorder come with
a later slice (ROADMAP); the engine keeps its duck-typed ``trace=`` /
``recorder=`` hooks for them.
"""

from .audit import QualityAuditor
from .latency import DriftMonitor, LatencyTracker
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .profile import PHASES, phase_breakdown

__all__ = ["Counter", "DriftMonitor", "Gauge", "Histogram",
           "LatencyTracker", "MetricsRegistry", "PHASES",
           "QualityAuditor", "phase_breakdown"]
