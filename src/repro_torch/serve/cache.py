"""The serving ``ScheduleCache``: memoised round compositions.

The cache knows nothing
about models or execution — it stores round *patterns* (partitions of
work-item signatures) keyed on the multiset of signatures in the step,
plus the counters the engine layers above it increment
(``dag_hits``, ``replay_revalidations``, the warm-start audit, and
the live-composition and gated-guard counters).

Keys are explicitly namespaced: every key is a 3-tuple
``(namespace, kind, sigs)`` with ``namespace`` one of

* ``"flat"`` — the per-request work-item path
  (:meth:`repro_torch.serve.composer.Composer.compose`), ``sigs`` the sorted
  per-item signature tuple, and
* ``"dag"``  — the ``respect_deps`` traced-chain path
  (:meth:`repro_torch.serve.composer.Composer.compose_dag`), ``sigs`` the
  sorted per-request *chain*-signature tuple.

The namespaces make a cache bypass structurally
impossible: a flat-signature pattern can never be consulted on a
traced step (and vice versa) because the key spaces are disjoint, and
:meth:`lookup` asserts the caller names the namespace it expects.
:meth:`near_miss` only ever scans the flat namespace — a one-request
warm adaptation of a *chain* pattern is the live-composition layer's
job (:class:`repro.serve.live.LiveComposition`), not the cache's.
"""

from __future__ import annotations

from collections import Counter, OrderedDict

from ..obs.metrics import MetricsRegistry

__all__ = ["ScheduleCache", "Signature"]


def _metric(name: str, cast=int, doc: str | None = None) -> property:
    """Registry-backed counter exposed as a plain attribute.

    The cache's counters live on the
    :class:`repro_torch.obs.MetricsRegistry`, but every call
    site (composer, live composition, tests) reads and increments
    them as attributes — ``cache.dag_hits += 1``.  These properties
    keep that surface byte-for-byte: the getter reads the registry
    series (cast back to the legacy type), the setter makes augmented
    assignment work unchanged.
    """

    def fget(self):
        return cast(self.metrics.counter(name).value)

    def fset(self, v):
        self.metrics.counter(name).value = float(v)

    return property(fget, fset, doc=doc)

#: Work-item signature: what makes two items schedule-equivalent.
#: Prefill chunks are keyed by exact token count (compiled geometry);
#: decode steps by their kv-len bucket — within a bucket the demand
#: vectors are close enough that the greedy + guard + refine pipeline
#: composes the same round structure.
Signature = tuple[str, int]


class ScheduleCache:
    """Memoised round compositions keyed on the multiset of work-item
    signatures.

    Steady-state decode-heavy serving repeats near-identical
    compositions every ``step()``: the same live requests, each one
    kv-token longer.  Quantizing decode kv-lens into buckets makes
    consecutive steps hash to the same key, so the engine replays the
    cached round *pattern* (a partition of signatures) instead of
    re-running greedy + guard + refine.  Patterns are applied by
    matching signatures, never by request identity, so any same-mix
    step can reuse them; generated tokens are unaffected because
    execution is exact per request regardless of round membership.
    """

    #: near-miss adaptations that seeded a composition (see
    #: :meth:`near_miss`); every warm hit is also counted a miss,
    #: since :meth:`lookup` failed first.
    warm_hits = _metric("cache_warm_hits")
    #: hits served on the respect_deps path (coarsened per-request
    #: chain-signature keys); a subset of ``hits``.
    dag_hits = _metric("cache_dag_hits")
    #: replays rejected by the stale-replay re-validation (modelled
    #: drift above ``SchedulerPolicy.replay_drift_tol`` or a
    #: capacity violation on actual demands) and recomposed cold.
    replay_revalidations = _metric("cache_replay_revalidations")
    #: warm-start quality audit (ROADMAP item): on a sampled
    #: fraction of warm hits the engine also recomputes the cold
    #: greedy composition and records the modelled regret
    #: ``t_warm / t_cold - 1`` (round cost model; negative means
    #: the adapted composition modelled *better* than cold).
    warm_sampled = _metric("cache_warm_sampled")
    warm_regret_total = _metric("cache_warm_regret_total", cast=float)
    #: live-composition counters (
    #: ``SchedulerPolicy.composition="incremental"``): chains
    #: extended into / retired from the live frontier, and cold
    #: recompositions forced by the drift backstop.
    incremental_joins = _metric("cache_incremental_joins")
    incremental_leaves = _metric("cache_incremental_leaves")
    frontier_rebuilds = _metric("cache_frontier_rebuilds")
    #: full gated simulations *not* paid because the per-step
    #: gated guard resumed from a checkpointed prefix instead of
    #: re-simulating from scratch (fractional — each delta
    #: evaluation saves ``1 - suffix_fraction`` of a full sim).
    gated_sims_saved = _metric("cache_gated_sims_saved", cast=float)

    def __init__(self, kv_bucket: int = 256, max_entries: int = 256,
                 metrics: MetricsRegistry | None = None):
        self.kv_bucket = kv_bucket
        self.max_entries = max_entries
        #: the registry behind every counter attribute on this class;
        #: pass the engine's shared registry so cache series land in
        #: the same snapshot as the phase timers.
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        # Per-namespace hit/miss series, resolved once (lookup() is a
        # hot path): the legacy flat ``hits``/``misses`` totals are
        # derived sums over these.
        self._hit_c = {ns: self.metrics.counter("cache_hits",
                                                namespace=ns)
                       for ns in ("flat", "dag")}
        self._miss_c = {ns: self.metrics.counter("cache_misses",
                                                 namespace=ns)
                        for ns in ("flat", "dag")}
        self._store: OrderedDict[tuple, tuple[tuple[Signature, ...], ...]] \
            = OrderedDict()
        #: modelled time of the composition each pattern was stored
        #: from (same key space as ``_store``); the baseline the
        #: stale-replay drift check compares against.
        self._times: dict[tuple, float | None] = {}

    @property
    def hits(self) -> int:
        """Total lookup hits across both namespaces (legacy key)."""
        return int(self._hit_c["flat"].value + self._hit_c["dag"].value)

    @property
    def misses(self) -> int:
        """Total lookup misses across both namespaces (legacy key)."""
        return int(self._miss_c["flat"].value
                   + self._miss_c["dag"].value)

    def hit_breakdown(self) -> dict:
        """Per-namespace hit/miss counts (the satellite breakdown
        surfaced in :meth:`stats` under ``"by_namespace"``)."""
        return {ns: {"hits": int(self._hit_c[ns].value),
                     "misses": int(self._miss_c[ns].value)}
                for ns in ("flat", "dag")}

    def reset(self, *, store: bool = True) -> None:
        """Zero every counter; with ``store=True`` (default) also drop
        the cached patterns and their stored times.  Only the cache's
        own series (``cache_*``) are zeroed, so an engine-shared
        registry keeps its phase timers; the registry keeps its
        registered series (references held by the composer and
        live-composition layers stay valid)."""
        self.metrics.reset(prefix="cache_")
        if store:
            self._store.clear()
            self._times.clear()

    def signature(self, kind: str, length: int) -> Signature:
        if kind == "decode":
            return ("d", length // self.kv_bucket)
        return ("p", length)

    @staticmethod
    def key_of(sigs: list[Signature]) -> tuple:
        return tuple(sorted(sigs))

    def lookup(self, key: tuple, namespace: str | None = None):
        """Pattern stored under ``key``, bumping hit/miss counters.

        ``namespace`` asserts the key belongs to the path consulting
        it (``"flat"`` or ``"dag"``): a traced step consulting a
        flat-signature key — a cache bypass — is a programming
        error, caught here instead of silently replaying a pattern
        from the wrong key space."""
        assert key[0] in ("flat", "dag"), f"un-namespaced cache key {key!r}"
        if namespace is not None:
            assert key[0] == namespace, \
                f"{namespace} path consulted a {key[0]!r} key"
        pat = self._store.get(key)
        if pat is None:
            self._miss_c[key[0]].inc()
            return None
        self._store.move_to_end(key)
        self._hit_c[key[0]].inc()
        return pat

    def store(self, key: tuple,
              pattern: tuple[tuple[Signature, ...], ...],
              t_model: float | None = None) -> None:
        assert key[0] in ("flat", "dag"), f"un-namespaced cache key {key!r}"
        self._store[key] = pattern
        self._times[key] = t_model
        # Assigning to an existing key does NOT reorder an OrderedDict:
        # without this, a refreshed entry keeps its stale position and
        # is evicted as if it were never re-stored.
        self._store.move_to_end(key)
        if len(self._store) > self.max_entries:
            old, _ = self._store.popitem(last=False)
            self._times.pop(old, None)

    def time_of(self, key: tuple) -> float | None:
        """Modelled time recorded when ``key``'s pattern was stored
        (None for patterns stored without one)."""
        return self._times.get(key)

    def near_miss(self, key: tuple):
        """Cached **flat** entry whose signature multiset differs from
        ``key`` by exactly one occurrence — one request joined or one
        left the mix since the cached step.

        ``key`` must have the engine's shape ``("flat", kind, sigs)``
        with ``sigs`` the sorted signature tuple from :meth:`key_of`.
        Returns ``(pattern, added, removed)`` — ``added`` the
        signatures present now but not in the cached mix (the joined
        request), ``removed`` the cached-only ones (the departed
        request) — or ``None``.  Most recently used entries are
        preferred.  Only the ``"flat"`` namespace is scanned: chain
        patterns adapt through the live frontier
        (:class:`repro.serve.live.LiveComposition`), not here.  Does
        not bump hit counters: callers count ``warm_hits`` only when
        the adaptation is actually used.
        """
        ns, kind, sigs = key
        assert ns == "flat", f"near_miss on a {ns!r} key"
        want = Counter(sigs)
        n = len(sigs)
        for k2 in reversed(self._store):
            if (k2[0] != "flat" or k2[1] != kind or k2 == key
                    or abs(len(k2[2]) - n) != 1):
                continue
            have = Counter(k2[2])
            added = list((want - have).elements())
            removed = list((have - want).elements())
            if len(added) + len(removed) == 1:
                return self._store[k2], added, removed
        return None

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def record_warm_regret(self, regret: float) -> None:
        self.warm_sampled += 1
        self.warm_regret_total += regret

    @property
    def warm_regret_mean(self) -> float:
        return (self.warm_regret_total / self.warm_sampled
                if self.warm_sampled else 0.0)

    def stats(self) -> dict:
        """Legacy-keyed counter snapshot (the reference's keys,
        verbatim) plus the per-namespace ``by_namespace``
        hit/miss breakdown and the per-namespace EWMA replay
        drift — how wrong replayed/maintained compositions currently
        are, fed by the composer's re-validation path and the live
        frontier's ratio backstop.  All values are served by the
        :class:`repro_torch.obs.MetricsRegistry` behind :attr:`metrics`."""
        self.metrics.gauge("cache_entries").set(len(self._store))
        return {"hits": self.hits, "misses": self.misses,
                "warm_hits": self.warm_hits,
                "dag_hits": self.dag_hits,
                "replay_revalidations": self.replay_revalidations,
                "warm_sampled": self.warm_sampled,
                "warm_regret_mean": self.warm_regret_mean,
                "incremental_joins": self.incremental_joins,
                "incremental_leaves": self.incremental_leaves,
                "frontier_rebuilds": self.frontier_rebuilds,
                "gated_sims_saved": self.gated_sims_saved,
                "hit_rate": self.hit_rate, "entries": len(self._store),
                "by_namespace": self.hit_breakdown(),
                "drift_ewma": {
                    ns: self.metrics.gauge("replay_drift_ewma",
                                           namespace=ns).value
                    for ns in ("flat", "dag", "live")}}
