"""Live incremental composition
(``SchedulerPolicy.composition="incremental"``; the port of the
reference's ``repro.serve.live``, host NumPy, bit-equal to it).

The batch pipeline recomposes every ``step()`` from scratch even
though consecutive serving steps differ by one or two requests: a
join, a leave, a prefill chain turning into a decode chain.  This
module keeps the ready-set greedy's round-frontier state alive across
steps (:class:`repro_torch.graph.constrained.GreedyFrontier`) and edits it:

* a **join** places the new request's chain stage by stage where
  Algorithm 1's own scoring puts it (the ``warm_start_insert`` rule
  generalized to precedence chains), slice-expanding a stage that fits
  nowhere when the policy allows
  (:func:`repro_torch.slice.constrained.frontier_solo_expander`);
* a **leave** retires the chain's stages and re-folds the affected
  rounds' ProfileCombine states;
* every other chain is **refreshed** in place — swapped to the
  current step's drifted profiles (decode kv growth) without moving.

A request's phase change (prefill chain → decode chain) is a
leave + join pair: the chains are different workloads, not a drifted
copy of one.

Identity anchoring: :func:`repro_torch.graph.kernel_graph.trace_arch` names
stages by the request's *index in the traced list* (``r0:d:L0:attn``),
so every leave renames all later requests' stages.  The frontier is
therefore tracked by **stable labels** ``(Request.rid, phase,
chain_pos, slice_sub)``; each step the previous step's member names
are translated through the labels onto the current step's items, and
slice cuts are re-applied to the current (drifted) stage before
refresh so the re-cut parts stay exact-accounting.

Backstops — any of these forces a cold recomposition
(``frontier_rebuilds`` in ``ScheduleCache.stats()``) and re-seeds the
frontier from its result:

* label bookkeeping fails to map (an untracked topology change);
* a frontier round violates device capacity on current demands;
* the incremental composition's modelled-time ratio against dep-aware
  arrival order drifts beyond ``policy.replay_drift_tol`` of the
  ratio recorded at the last cold (re)build — the same knob, and the
  same "validate against your own recorded baseline" discipline, as
  the stale-replay check;
* the step guard (``policy.dag_guard`` currency) prefers arrival
  order over the incremental composition.

Tokens are unaffected by any of this: execution is exact per request,
so ``composition="incremental"`` is bit-identical to ``"batch"`` (the
property ``tests/test_live.py`` pins across all traced archs).

On traced steps this layer *is* the cross-step memo, so it bypasses
the :class:`~repro_torch.serve.cache.ScheduleCache` pattern store entirely
(no ``dag_hits`` accrue); the cache object still carries the
counters.
"""

from __future__ import annotations

from ..graph.constrained import GreedyFrontier
from ..slice import KernelSlicer, join_item
from ..slice.constrained import frontier_solo_expander

__all__ = ["LiveComposition"]

#: stable member label: (Request.rid, phase, chain_pos, slice_sub)
#: with phase in ("prefill", "decode") and slice_sub "" for a whole
#: stage, "s{j}of{k}" for a slice, "join" for a slice join.
Label = tuple[int, str, int, str]


class _Drift(Exception):
    """Internal: label bookkeeping failed to map the current step —
    fall back to a cold rebuild."""


class LiveComposition:
    """Resumable round composition over the traced (respect_deps)
    serving path.  One instance per engine; composes via the shared
    :class:`~repro_torch.serve.composer.Composer` on cold (re)builds and by
    frontier editing otherwise."""

    def __init__(self, composer):
        self.composer = composer
        self.frontier = GreedyFrontier(composer.device)
        self._seeded = False
        #: previous step's frontier member names -> stable labels
        self._label_of: dict[str, Label] = {}
        #: tracked chains: (rid, phase) -> stage count
        self._chains: dict[tuple[int, str], int] = {}
        #: modelled-time ratio (composition / dep-aware fifo, round
        #: currency) at the last cold (re)build — the drift baseline.
        self._ratio0: float | None = None

    # -- step decomposition --------------------------------------------
    @staticmethod
    def _chain_view(triples, traced):
        """Current step as chains: per traced request index, its
        ``(rid, phase)`` key, Request, and item indices in stage
        order."""
        n_req = len(traced.tail_of)
        chain_items: list[list[int]] = [[] for _ in range(n_req)]
        for i, o in enumerate(traced.owners):
            chain_items[o].append(i)
        chains = []
        for ridx in range(n_req):
            it, r, kind = triples[traced.tail_of[ridx]]
            chains.append(((r.rid, kind), r, chain_items[ridx]))
        return chains

    def compose_dag(self, triples, traced) -> list[list]:
        composer = self.composer
        policy = composer.policy
        if policy.kind == "fifo" or not triples:
            return composer.dag_fifo(triples, traced)
        chains = self._chain_view(triples, traced)
        if not self._seeded:
            return self._rebuild(triples, traced, chains, count=False,
                                 reason="seed")
        cur = {key: len(items) for key, _, items in chains}
        left = [key for key, n in self._chains.items()
                if cur.get(key) != n]
        joined = [key for key, n in cur.items()
                  if self._chains.get(key) != n]
        cache = composer.cache
        try:
            trip_by_name, fresh = self._map_step(triples, traced,
                                                 chains, set(left))
            if left:
                gone = {name for name, lab in self._label_of.items()
                        if (lab[0], lab[1]) in
                        {(k[0], k[1]) for k in left}}
                self.frontier.remove(gone)
                cache.incremental_leaves += len(left)
            self.frontier.refresh(fresh)
            if joined:
                on_solo = self._expander(trip_by_name)
                want = set(joined)
                for key, _, items in chains:
                    if key not in want:
                        continue
                    profs = [traced.graph.kernels[i] for i in items]
                    self.frontier.insert_chain(profs, on_solo=on_solo)
                    cache.incremental_joins += 1
            rounds = self._materialize(triples, trip_by_name)
        except _Drift:
            return self._rebuild(triples, traced, chains, count=True,
                                 reason="label_drift")
        # -- backstops: capacity, modelled-ratio drift, step guard ----
        fifo = composer.dag_fifo(triples, traced)
        with cache.metrics.timer("phase_guard"):
            t_inc = sum(composer.dag_round_time(rd) for rd in rounds)
            t_fifo = sum(composer.dag_round_time(rd) for rd in fifo)
        ratio = t_inc / max(t_fifo, 1e-30)
        tol = policy.replay_drift_tol
        if self._ratio0 is not None and self._ratio0 > 0:
            # "live" namespace drift: how far the maintained frontier's
            # modelled ratio has wandered from its last cold baseline.
            composer.drift.observe("live",
                                   ratio / self._ratio0 - 1.0)
        drifted = (tol is not None and tol > 0
                   and self._ratio0 is not None
                   and ratio > self._ratio0 * (1.0 + tol))
        if drifted:
            return self._rebuild(triples, traced, chains, count=True,
                                 reason="ratio_drift")
        if not all(composer.round_fits(rd) for rd in rounds):
            return self._rebuild(triples, traced, chains, count=True,
                                 reason="capacity")
        if policy.dag_guard == "gated":
            guard = composer.dag_guard_fn(traced)
            guard_rejects = guard(fifo) < guard(rounds)
        else:
            # the "rounds" guard currency is exactly the sums already
            # computed for the drift ratio — don't re-sum them
            guard_rejects = t_fifo < t_inc
        if guard_rejects:
            # The frontier produced a composition the guard rejects:
            # its state is stale relative to what a cold composition
            # would serve — rebuild rather than silently serving fifo
            # forever off a losing frontier.
            return self._rebuild(triples, traced, chains, count=True,
                                 reason="guard")
        if composer.recorder is not None:
            composer.recorder.event("schedule", path="live",
                                    served="incremental",
                                    rounds=len(rounds))
        self._commit(chains, rounds,
                     self._stable_items(chains, traced.graph.kernels))
        return rounds

    # -- label bookkeeping ---------------------------------------------
    @staticmethod
    def _stable_items(chains, kernels):
        """item name -> (rid, phase, chain_pos) for the current step."""
        out = {}
        for (rid, phase), _, items in chains:
            for pos, i in enumerate(items):
                out[kernels[i].name] = (rid, phase, pos)
        return out

    def _map_step(self, triples, traced, chains, left):
        """Translate the previous step's frontier member names onto
        the current step.

        Returns ``(trip_by_name, fresh)``: the current step's
        name -> (item, Request, kind) map (slice re-cuts included) and
        the old-member-name -> current-profile map for
        :meth:`GreedyFrontier.refresh`.  Raises :class:`_Drift` when a
        surviving label has no current counterpart."""
        kernels = traced.graph.kernels
        trip_by_name = {t[0].name: t for t in triples}
        by_stable = {}
        for (rid, phase), _, items in chains:
            for pos, i in enumerate(items):
                by_stable[(rid, phase, pos)] = trip_by_name[
                    kernels[i].name]
        # surviving slice cuts, grouped by parent stable label
        cuts: dict[tuple[int, str, int], int] = {}
        for name, (rid, phase, pos, sub) in self._label_of.items():
            if (rid, phase) in {(k[0], k[1]) for k in left}:
                continue
            if sub.startswith("s"):
                try:
                    cuts[(rid, phase, pos)] = int(sub.split("of", 1)[1])
                except (IndexError, ValueError):
                    raise _Drift from None
        new_prof_of: dict[Label, object] = {}
        if cuts:
            sp = self.composer.policy.slice_policy
            if sp is None:        # policy changed under a live cut
                raise _Drift
            slicer = KernelSlicer(sp, self.composer.device)
            for (rid, phase, pos), k in cuts.items():
                trip = by_stable.get((rid, phase, pos))
                if trip is None:
                    raise _Drift
                it, r, kind = trip
                parts = slicer.slice_item(it, k)
                if len(parts) != k:
                    raise _Drift  # stage no longer supports the cut
                for j, part in enumerate(parts):
                    trip_by_name[part.name] = (part, r, "frag")
                    new_prof_of[(rid, phase, pos, f"s{j}of{k}")] = \
                        part.profile()
                ji = join_item(it)
                trip_by_name[ji.name] = (ji, r, kind)
                new_prof_of[(rid, phase, pos, "join")] = ji.profile()
        fresh = {}
        gone_keys = {(k[0], k[1]) for k in left}
        for name, (rid, phase, pos, sub) in self._label_of.items():
            if (rid, phase) in gone_keys:
                continue
            if sub:
                prof = new_prof_of.get((rid, phase, pos, sub))
            else:
                trip = by_stable.get((rid, phase, pos))
                prof = None if trip is None else trip[0].profile()
            if prof is None:
                raise _Drift
            fresh[name] = prof
        return trip_by_name, fresh

    def _expander(self, trip_by_name):
        """Slice-expansion hook for live joins: cuts the backing work
        item (so the composed rounds stay executable) and registers
        the parts in this step's name map, exactly mirroring the
        engine's batch-path closures."""
        sp = self.composer.policy.slice_policy
        if sp is None:
            return None
        slicer = KernelSlicer(sp, self.composer.device)

        def mk_slices(prof, k):
            it, r, kind = trip_by_name[prof.name]
            parts = slicer.slice_item(it, k)
            for part in parts:
                trip_by_name[part.name] = (part, r, "frag")
            ji = join_item(it)
            # the chain tail's exact execution moves to the join
            trip_by_name[ji.name] = (ji, r, kind)
            return [part.profile() for part in parts]

        def mk_join(prof):
            return trip_by_name[prof.name.split("#", 1)[0]
                                + "#join"][0].profile()

        return frontier_solo_expander(slicer, mk_slices, mk_join)

    def _materialize(self, triples, trip_by_name) -> list[list]:
        """Frontier rounds -> executable (item, Request, kind) rounds,
        with a coverage check: every traced item appears exactly once
        (as itself, or fully expanded into slices + join)."""
        rounds = []
        seen: set[str] = set()
        parents: set[str] = set()
        for rd in self.frontier.rounds:
            row = []
            for k in rd.members:
                trip = trip_by_name.get(k.name)
                if trip is None or k.name in seen:
                    raise _Drift
                seen.add(k.name)
                parents.add(k.name.partition("#")[0])
                row.append(trip)
            rounds.append(row)
        if parents != {t[0].name for t in triples}:
            raise _Drift
        return rounds

    def _commit(self, chains, rounds, stable_by_name) -> None:
        """Refresh the stable-label map and tracked-chain set from the
        composition just served.  ``stable_by_name`` maps *parent*
        item names to their ``(rid, phase, pos)`` prefix
        (:meth:`_stable_items`); slice parts and joins inherit the
        prefix through the name before their ``#`` tag."""
        self._label_of = {}
        for rd in rounds:
            for it, _, _ in rd:
                parent, _, sub = it.name.partition("#")
                st = stable_by_name.get(parent)
                if st is None:
                    raise _Drift   # served an item no chain owns
                self._label_of[it.name] = st + (sub,)
        self._chains = {key: len(items) for key, _, items in chains}
        self._seeded = True

    # -- cold path ------------------------------------------------------
    def _rebuild(self, triples, traced, chains, *, count: bool,
                 reason: str = "unknown") -> list[list]:
        """Cold recomposition through the batch pipeline, re-seeding
        the frontier from whatever composition the guard serves.
        ``reason`` names the backstop that fired (``seed`` /
        ``label_drift`` / ``ratio_drift`` / ``capacity`` / ``guard``)
        — emitted to the flight recorder and counted per reason."""
        composer = self.composer
        cache = composer.cache
        if count:
            cache.metrics.counter("frontier_rebuild_reason",
                                  reason=reason).inc()
        if composer.recorder is not None:
            composer.recorder.event("rebuild", reason=reason,
                                    counted=count)
        self.frontier.reset()
        guard = composer.dag_guard_fn(traced)
        fifo = composer.dag_fifo(triples, traced)
        composed = composer.dag_cold(triples, traced,
                                     frontier=self.frontier)
        result = fifo if guard(fifo) < guard(composed) else composed
        want = [[t[0].name for t in rd] for rd in result]
        if self.frontier.round_names() != want:
            # refined re-rounding or a guard fifo win: the greedy's
            # own frontier doesn't match what is being served —
            # re-derive state from the served composition instead.
            self.frontier.seed([[t[0].profile() for t in rd]
                                for rd in result])
        t_res = sum(composer.dag_round_time(rd) for rd in result)
        t_fifo = sum(composer.dag_round_time(rd) for rd in fifo)
        self._ratio0 = t_res / max(t_fifo, 1e-30)
        if count:
            cache.frontier_rebuilds += 1
        self._commit(chains, result,
                     self._stable_items(chains, traced.graph.kernels))
        return result
