"""Round composition for the serving engine: the flat half of the
reference's ``repro.serve.composer``.

:class:`Composer` is the per-step composition pipeline, parameterized
by :class:`~repro_torch.serve.engine.SchedulerPolicy`: it turns the
engine's pending work items into execution rounds — fifo packing,
Algorithm 1 greedy, the arrival-order cost-model guard, and the
:class:`ScheduleCache` replay / warm-start paths.  It owns no queue and
runs nothing: the engine keeps the step loop and exact execution.

Refinement (``kind="refined"``) and the dependency-aware DAG path come
with later slices.
"""

from __future__ import annotations

from collections import deque

from ..core import Schedule
from ..core.fastscore import greedy_order_fast, warm_start_insert
from ..core.tpu import fifo_rounds, round_time
from ..obs import DriftMonitor, QualityAuditor
from .cache import ScheduleCache

__all__ = ["Composer"]


class Composer:
    """The per-step round-composition pipeline (flat path).

    Stateless across steps apart from the shared
    :class:`ScheduleCache` (and the counters it carries); the policy
    object is shared with the engine, so runtime knob changes are seen
    immediately.
    """

    def __init__(self, policy, device, weights_bytes: float,
                 cache: ScheduleCache, recorder=None):
        if policy.kind == "refined":
            raise NotImplementedError(
                "kind='refined' needs core.refine and core.simulator, "
                "which are not ported yet (ROADMAP: 'Host scheduler "
                "core' and the event-scan kernel)")
        self.policy = policy
        self.device = device
        self.weights_bytes = weights_bytes
        self.cache = cache
        #: optional flight recorder — schedule decisions and cache
        #: outcomes are emitted as discrete events when set (``None``
        #: is the zero-cost null path).
        self.recorder = recorder
        #: the online Fig.-1 sampler; also owns the ``warm_audit_frac``
        #: warm-regret path.
        self.auditor = QualityAuditor(policy, device, cache.metrics,
                                      recorder=recorder)
        #: EWMA modelled-vs-revalidated drift per cache namespace, fed
        #: by :meth:`replay_ok`.
        self.drift = DriftMonitor(cache.metrics)

    def _note(self, kind: str, **fields) -> None:
        """Flight-recorder emission (no-op without a recorder)."""
        if self.recorder is not None:
            self.recorder.event(kind, **fields)

    def flat_round_time(self, rd) -> float:
        return round_time([t[0] for t in rd], self.device,
                          self.weights_bytes)

    def round_fits(self, rd) -> bool:
        """Capacity re-check of one replayed round on actual demands
        (solo rounds are always legal — oversized stages run alone)."""
        if len(rd) <= 1:
            return True
        used = {d: 0.0 for d in self.device.caps}
        for it, _, _ in rd:
            for d, v in it.profile().demands.items():
                if d in used:  # items may demand untracked dims
                    used[d] += v
        return all(used[d] <= self.device.cap(d) * (1 + 1e-9)
                   for d in used)

    def replay_ok(self, key, rounds, time_of) -> bool:
        """Stale-replay re-validation: a replayed pattern whose
        modelled time drifts beyond ``policy.replay_drift_tol`` from
        the stored composition's — or that violates capacity on actual
        demands — is rejected and the step recomposes cold.  Every
        re-validation feeds the per-namespace :class:`DriftMonitor`
        with how far the replay drifted (accepted or not)."""
        tol = self.policy.replay_drift_tol
        if tol is None or tol <= 0:
            return True            # optimistic replay
        cache = self.cache
        t0 = cache.time_of(key)
        t_now = sum(time_of(rd) for rd in rounds)
        rel = (abs(t_now / t0 - 1.0)
               if t0 is not None and t0 > 0 else None)
        if rel is not None:
            self.drift.observe(key[0], rel)
        drifted = rel is not None and rel > tol
        if drifted or not all(self.round_fits(rd) for rd in rounds):
            cache.replay_revalidations += 1
            self._note("cache", namespace=key[0], outcome="revalidated",
                       drift=rel, reason=("drift" if drifted
                                          else "capacity"))
            return False
        return True

    # -- flat path ------------------------------------------------------
    def compose(self, items) -> list[list]:
        """Group pending work items into execution rounds per policy.

        Returns a list of rounds; each round is a list of
        (TpuWorkItem, Request, kind) triples."""
        by_name = {it.name: trip for trip in items for it in (trip[0],)}
        if self.policy.kind == "fifo":
            rounds = fifo_rounds([t[0] for t in items], self.device)
            return [[by_name[it.name] for it in rd] for rd in rounds]
        sigs = [self.signature_of(trip) for trip in items]
        key = None
        stale = False
        if self.policy.cache:
            key = ("flat", self.policy.kind, ScheduleCache.key_of(sigs))
            pattern = self.cache.lookup(key, namespace="flat")
            if pattern is not None:
                replay = self.apply_pattern(pattern, items, sigs)
                if self.replay_ok(key, replay, self.flat_round_time):
                    self._note("schedule", path="flat",
                               served="replay", rounds=len(replay))
                    return replay
                # Stale replay: recompose cold (the fresh composition
                # re-stores under the same key).  Warm-start adaptation
                # is skipped too — a one-signature-away pattern shares
                # the rejected pattern's staleness and performs no
                # capacity/drift re-validation of its own.
                stale = True
            if self.policy.warm_start and not stale:
                warm = self.cache.near_miss(key)
                if warm is not None:
                    result = self.warm_adapt(warm, items, sigs)
                    if result is not None:
                        self._note("schedule", path="flat",
                                   served="warm", rounds=len(result))
                        return self.cache_store(key, result, items, sigs)
        profs = [t[0].profile() for t in items]
        sched: Schedule = greedy_order_fast(profs, self.device)
        composed = [[by_name[p.name] for p in rd.kernels]
                    for rd in sched.rounds]
        # Cost-model guard: Algorithm 1 is profile-greedy; never accept
        # a composition the round cost model says is worse than arrival
        # order (the scheduler's own timing model is always available).
        with self.cache.metrics.timer("phase_guard"):
            t_alg = sum(round_time([t[0] for t in rd], self.device,
                                   self.weights_bytes)
                        for rd in composed)
            fifo = fifo_rounds([t[0] for t in items], self.device)
            t_fifo = sum(round_time(r, self.device, self.weights_bytes)
                         for r in fifo)
        if t_fifo < t_alg:
            result = [[by_name[it.name] for it in rd] for rd in fifo]
        else:
            result = composed
        self._note("schedule", path="flat",
                   served=("fifo" if t_fifo < t_alg else "cold"),
                   rounds=len(result))
        return self.cache_store(key, result, items, sigs)

    def signature_of(self, trip) -> tuple[str, int]:
        it, r, kind = trip
        length = r.pos if kind == "decode" else it.tokens
        return self.cache.signature(kind, length)

    def cache_store(self, key, result, items, sigs):
        if key is not None:
            name_sig = {trip[0].name: s for trip, s in zip(items, sigs)}
            pattern = tuple(tuple(name_sig[t[0].name] for t in rd)
                            for rd in result)
            t_model = sum(self.flat_round_time(rd) for rd in result)
            self.cache.store(key, pattern, t_model)
        return result

    def apply_pattern(self, pattern, items, sigs):
        """Replay a cached round pattern onto the current (signature-
        equivalent) work items."""
        groups: dict[tuple[str, int], deque] = {}
        for trip, s in zip(items, sigs):
            groups.setdefault(s, deque()).append(trip)
        return [[groups[s].popleft() for s in rd] for rd in pattern]

    def warm_adapt(self, warm, items, sigs):
        """Seed this step's composition from a near-miss cached one.

        One request left: drop its signature's occurrence from the
        cached pattern and replay.  One request joined: replay the
        pattern on the matching items, then place the newcomer into
        the round Algorithm 1's own scoring picks
        (:func:`repro_torch.core.fastscore.warm_start_insert`).  The
        result still passes the fifo cost-model guard; returns None
        when the adaptation cannot be applied.
        """
        pattern, added, removed = warm
        pat = [list(rd) for rd in pattern]
        if removed:
            s = removed[0]
            for rd in pat:
                if s in rd:
                    rd.remove(s)
                    break
            pat = [rd for rd in pat if rd]
        groups: dict[tuple[str, int], deque] = {}
        for trip, s in zip(items, sigs):
            groups.setdefault(s, deque()).append(trip)
        if added:
            extra = groups[added[0]].popleft()
        try:
            result = [[groups[s].popleft() for s in rd] for rd in pat]
        except (KeyError, IndexError):
            return None  # stale pattern shape: fall back to recompute
        if added:
            ri = warm_start_insert(
                [[t[0].profile() for t in rd] for rd in result],
                extra[0].profile(), self.device)
            if ri >= 0:
                result[ri].append(extra)
            else:
                result.append([extra])
        # Same guard as the cold path: never accept a composition the
        # round cost model says is worse than arrival order.
        t_warm = sum(round_time([t[0] for t in rd], self.device,
                                self.weights_bytes) for rd in result)
        fifo = fifo_rounds([t[0] for t in items], self.device)
        t_fifo = sum(round_time(r, self.device, self.weights_bytes)
                     for r in fifo)
        if t_fifo < t_warm:
            by_name = {t[0].name: t for t in items}
            result = [[by_name[it.name] for it in rd] for rd in fifo]
        else:
            self.cache.warm_hits += 1
            self.auditor.warm_audit(self.cache, items, t_warm, t_fifo,
                                    self.weights_bytes)
        return result
