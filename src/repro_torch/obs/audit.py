"""Online quality auditing: the paper's Fig.-1 percentile claim as a
live serving SLO (the port of the reference's ``repro.obs.audit``).

The headline result of the source paper is a *percentile*: a reordered
launch sequence lands "well above the 90 percentile mark" of the
design space of all (legal) launch orders.  This module re-runs that
protocol *inside* the serving loop so a regression below the paper's
claim is a counter, not a rerun of a benchmark:

* :class:`QualityAuditor` deterministically samples an ``audit_frac``
  fraction of served steps (the integer-crossing rule, so runs
  reproduce without an RNG in the hot path),
* scores the *served* composition against ``audit_k`` seeded random
  orders of the same kernel set, under the step's own currency:

  - traced (``respect_deps``) steps score the gated-event makespan of
    the flat launch order via one
    :class:`repro_torch.graph.delta.GatedDeltaEvaluator` ``rebase`` on
    the served order; every random topological baseline then resumes
    from the checkpoint at its first divergence and pays only a suffix
    fraction of a full simulation (saved fractions accumulate in the
    ``audit_sims_saved`` counter);
  - flat steps score the round cost model over capacity-packed rounds
    of each shuffled order (the flat path's serving currency).

* records the served order's :func:`repro_torch.core.percentile_rank`
  into the ``audit_quality_percentile{arch,kind}`` histogram and bumps
  ``audit_below_floor`` whenever it lands under ``audit_floor``
  (default 90.0 — the paper's claim as a live SLO).

The auditor also owns the warm-start regret audit
(``SchedulerPolicy.warm_audit_frac``), so the ``warm_regret_mean`` /
``warm_sampled`` stats keys report as in the reference.

Auditing is strictly read-only over already-composed rounds: it never
mutates the composition, the cache, or request state, so served
tokens are bit-identical with auditing on or off.
"""

from __future__ import annotations

import random

from ..core.fastscore import greedy_order_fast
from ..core.scheduler import percentile_rank
from ..core.tpu import fifo_rounds, round_time
from ..graph.delta import GatedDeltaEvaluator

__all__ = ["QualityAuditor"]


class QualityAuditor:
    """Budget-capped, seeded Fig.-1 sampler for served compositions.

    One instance per :class:`repro_torch.serve.composer.Composer`;
    shares the policy object (so runtime knob flips are seen
    immediately) and writes to the engine-shared
    :class:`repro_torch.obs.MetricsRegistry`.  ``recorder`` optionally
    gets one ``"audit"`` event per verdict.
    """

    def __init__(self, policy, device, metrics, recorder=None):
        self.policy = policy
        self.device = device
        self.metrics = metrics
        self.recorder = recorder
        #: steps offered to :meth:`sample_step` (audited or not) —
        #: the denominator of the deterministic sampling rule and the
        #: per-step component of the baseline seed.
        self._steps_seen = 0
        # Pre-register the unlabelled audit series so snapshots are
        # schema-stable whether or not any step was ever audited.
        for name in ("audit_steps", "audit_baselines",
                     "audit_below_floor", "audit_sims_saved"):
            metrics.counter(name)

    # -- deterministic sampling ----------------------------------------
    @staticmethod
    def crossed(seen: int, frac: float) -> bool:
        """Sample iff the running count just crossed a multiple of
        ``1/frac``.  No RNG, so a given workload audits the same steps
        every run."""
        return frac > 0 and int(seen * frac) > int((seen - 1) * frac)

    def sample_step(self) -> bool:
        """True iff the step being served should be audited
        (deterministic ``audit_frac`` sampling)."""
        frac = getattr(self.policy, "audit_frac", 0.0)
        if frac <= 0:
            return False
        self._steps_seen += 1
        return self.crossed(self._steps_seen, frac)

    def _seed(self) -> int:
        """Per-audited-step baseline seed: deterministic, distinct
        across steps so consecutive audits don't re-score the same
        random orders."""
        return (getattr(self.policy, "audit_seed", 0) * 1_000_003
                + self._steps_seen)

    # -- verdict recording ---------------------------------------------
    def _record(self, pct: float, t_served: float, k: int,
                saved: float, *, arch: str, kind: str,
                currency: str) -> dict:
        floor = getattr(self.policy, "audit_floor", 90.0)
        below = pct < floor
        m = self.metrics
        m.histogram("audit_quality_percentile",
                    arch=arch, kind=kind).observe(pct)
        m.counter("audit_steps").inc()
        m.counter("audit_baselines").inc(k)
        if saved:
            m.counter("audit_sims_saved").inc(saved)
        if below:
            m.counter("audit_below_floor").inc()
        verdict = {"percentile": pct, "t_served": t_served, "k": k,
                   "below_floor": below, "floor": floor,
                   "currency": currency, "arch": arch,
                   "policy_kind": kind, "sims_saved": saved}
        if self.recorder is not None:
            self.recorder.event("audit", **verdict)
        return verdict

    def _skip(self, reason: str) -> None:
        self.metrics.counter("audit_skipped", reason=reason).inc()

    # -- traced (respect_deps) steps: gated currency --------------------
    def audit_dag(self, rounds, traced, *, arch: str,
                  kind: str) -> dict | None:
        """Score a served traced composition against ``audit_k``
        random topological orders of its kernel graph under the
        gated-event makespan (the offline Fig.-1 protocol,
        ``benchmarks/dag.py``).

        One ``rebase`` on the served flat order caches per-position
        checkpoints; each baseline is delta-evaluated from its first
        divergence, so K baselines cost far less than K full
        simulations.  Sliced compositions are skipped (their kernel
        set differs from the traced graph's; counted under
        ``audit_skipped{reason=sliced}``)."""
        graph = traced.graph
        by_name = {p.name: p for p in graph.kernels}
        served = []
        for rd in rounds:
            for it, _, _ in rd:
                p = by_name.get(it.name)
                if p is None:
                    self._skip("sliced")
                    return None
                served.append(p)
        if (len(served) != graph.n
                or len({id(p) for p in served}) != graph.n):
            self._skip("partial")
            return None
        ev = GatedDeltaEvaluator(self.device, graph.edges_by_id())
        try:
            t_served = ev.rebase(served)
        except ValueError:
            self._skip("illegal")
            return None
        k = int(getattr(self.policy, "audit_k", 50))
        baselines = graph.random_topological_orders(k,
                                                    seed=self._seed())
        times = []
        saved = 0.0
        for cand in baselines:
            first = len(cand)
            for i, (a, b) in enumerate(zip(served, cand)):
                if a is not b:
                    first = i
                    break
            if first == len(cand):
                times.append(t_served)
                saved += 1.0
                continue
            t, frac = ev.evaluate_costed(cand, first)
            saved += max(0.0, 1.0 - frac)
            times.append(t)
        pct = percentile_rank(t_served, times)
        return self._record(pct, t_served, len(times), saved,
                            arch=arch, kind=kind, currency="gated")

    # -- flat steps: round currency -------------------------------------
    def audit_flat(self, rounds, *, weights_bytes: float, arch: str,
                   kind: str) -> dict | None:
        """Score a served flat composition against ``audit_k`` seeded
        shuffles of its work items, each capacity-packed by
        ``fifo_rounds`` and timed under the round cost model — the
        flat path's own serving currency (every launch order is legal:
        flat items carry no precedence edges)."""
        items = [trip[0] for rd in rounds for trip in rd]
        if not items:
            self._skip("empty")
            return None
        t_served = sum(round_time([t[0] for t in rd], self.device,
                                  weights_bytes) for rd in rounds)
        k = int(getattr(self.policy, "audit_k", 50))
        rng = random.Random(self._seed())
        times = []
        for _ in range(k):
            perm = list(items)
            rng.shuffle(perm)
            times.append(sum(round_time(rd, self.device, weights_bytes)
                             for rd in fifo_rounds(perm, self.device)))
        pct = percentile_rank(t_served, times)
        return self._record(pct, t_served, len(times), 0.0,
                            arch=arch, kind=kind, currency="round")

    # -- warm-start regret audit ----------------------------------------
    def warm_audit(self, cache, items, t_warm: float, t_fifo: float,
                   weights_bytes: float) -> None:
        """``SchedulerPolicy.warm_audit_frac``: on the sampled fraction
        of warm hits (same crossing rule, keyed on ``cache.warm_hits``),
        recompute the cold greedy composition and record the modelled
        regret through
        :meth:`repro_torch.serve.cache.ScheduleCache.record_warm_regret`."""
        frac = getattr(self.policy, "warm_audit_frac", 0.0)
        if frac <= 0 or not self.crossed(cache.warm_hits, frac):
            return
        sched = greedy_order_fast([t[0].profile() for t in items],
                                  self.device)
        nm = {t[0].name: t[0] for t in items}
        t_cold = min(t_fifo, sum(
            round_time([nm[p.name] for p in rd.kernels],
                       self.device, weights_bytes)
            for rd in sched.rounds))
        regret = t_warm / max(t_cold, 1e-30) - 1.0
        cache.record_warm_regret(regret)
        if self.recorder is not None:
            self.recorder.event("warm_audit", regret=regret,
                                t_warm=t_warm, t_cold=t_cold)
