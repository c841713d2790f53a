"""Profiling hooks: phase names and breakdown views.

The engine and composer time their work with
:meth:`repro_torch.obs.metrics.MetricsRegistry.timer` under the
``phase_<name>`` histogram names listed in :data:`PHASES`:

* ``phase_compose`` — everything between "step has a live mix" and
  "rounds are composed" (cache lookups, greedy, guard, refine, warm
  adaptation; recorded by ``ServingEngine.step``);
* ``phase_guard``   — gated/flat guard admission decisions inside the
  composer (a sub-interval of compose);
* ``phase_refine``  — refinement passes inside the composer (also a
  sub-interval of compose, so guard+refine <= compose);
* ``phase_execute`` — running the composed rounds (prefill/decode
  execution; recorded by ``ServingEngine.step``);
* ``phase_audit``   — online quality audits
  (:class:`repro_torch.obs.audit.QualityAuditor`) on the sampled steps —
  kept outside ``phase_compose`` so audit cost never pollutes the
  compose-time series the churn benchmarks guard.

:func:`phase_breakdown` turns a registry into the per-step view
``benchmarks/serving.py`` prints.  Refiners report their own scoring
work under ``refine_evals`` / ``refine_score_s`` when handed a
``metrics=`` registry.
"""

from __future__ import annotations

from .metrics import Histogram, MetricsRegistry

__all__ = ["PHASES", "phase_breakdown"]

#: engine-step phases, in pipeline order; guard and refine are
#: sub-intervals of compose, audit runs on sampled steps only
PHASES = ("compose", "guard", "refine", "execute", "audit")


def phase_breakdown(metrics: MetricsRegistry) -> dict:
    """``{phase: {"calls", "total_s", "mean_s"}}`` for every phase in
    :data:`PHASES` (zeros for phases never entered, so the shape is
    stable across policies)."""
    out = {}
    for ph in PHASES:
        h = metrics.histogram(f"phase_{ph}")
        assert isinstance(h, Histogram)
        out[ph] = {"calls": h.count, "total_s": h.total,
                   "mean_s": h.mean}
    return out
