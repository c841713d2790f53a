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
* :mod:`.trace`   — :class:`ScheduleTrace`, the per-kernel
  admission/completion recorder the simulators and the engine feed via
  ``trace=``; exports Chrome-trace-event JSON (Perfetto) and a terminal
  Gantt.
* :mod:`.export`  — :func:`prometheus_text` exposition for any registry
  (and :func:`parse_prometheus_text` back), and :class:`FlightRecorder`,
  the JSONL event log the engine, composer, live frontier and front end
  write through ``recorder=``.

A ``None`` recorder is zero-cost, and an attached one never changes
modelled times or served tokens: it only reads simulator state.
"""

from .audit import QualityAuditor
from .export import FlightRecorder, parse_prometheus_text, prometheus_text
from .latency import DriftMonitor, LatencyTracker
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .profile import PHASES, phase_breakdown
from .trace import ScheduleTrace

__all__ = ["Counter", "DriftMonitor", "FlightRecorder", "Gauge",
           "Histogram", "LatencyTracker", "MetricsRegistry", "PHASES",
           "QualityAuditor", "ScheduleTrace", "parse_prometheus_text",
           "phase_breakdown", "prometheus_text"]
