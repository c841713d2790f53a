"""Round composition for the serving engine (the port of the
reference's ``repro.serve.composer``, unsliced).

:class:`Composer` is the per-step composition pipeline, parameterized
by :class:`~repro_torch.serve.engine.SchedulerPolicy`: it turns the
engine's pending work items into execution rounds — fifo packing,
Algorithm 1 greedy (flat or ready-set DAG), optional refinement, the
arrival-order cost-model guard, and the :class:`ScheduleCache` replay /
warm-start paths.  It owns no queue and runs nothing: the engine keeps
the step loop and exact execution.

``kind="refined"`` polishes Algorithm 1's flat order by local search
(:func:`repro_torch.core.refine.refine_order`) under the policy's
``refine_model`` and re-rounds it by capacity; the refinement runs on
the host in float64, as in the reference.

:class:`GatedGuard` is the per-step gated-makespan oracle for
``dag_guard="gated"``: one object per compose step, reusing
:class:`~repro_torch.graph.delta.GatedDeltaEvaluator` checkpoints
across the step's candidate compositions.  Kernel slicing
(``policy.slice_policy``) and the live composition come with later
slices; the ``#join`` handling here is the reference's, ready for them.
"""

from __future__ import annotations

from collections import Counter, deque

from ..core import Schedule
from ..core.fastscore import greedy_order_fast, warm_start_insert
from ..core.refine import refine_order
from ..core.tpu import fifo_rounds, round_time
from ..graph.constrained import greedy_order_dag, refine_order_dag
from ..graph.delta import GatedDeltaEvaluator
from ..graph.streams import fifo_rounds_dag
from ..obs import DriftMonitor, QualityAuditor
from .cache import ScheduleCache

__all__ = ["Composer", "GatedGuard"]


class GatedGuard:
    """Per-compose-step gated-event makespan oracle with checkpoint
    reuse across the step's candidate compositions.

    Rebuilds the dependency structure from item names so replayed
    compositions — whose slices were re-cut from cached patterns —
    are scored too: parent edges come from the traced graph, a sliced
    parent's in-edges fan out to its slices, its out-edges hang off
    the ``#join`` marker, and slices close the diamond on the join.
    A flat order that is not topological (a corrupted replay) scores
    ``inf`` and is rejected by the guard.

    Item profiles are built once per step and one
    :class:`~repro_torch.graph.delta.GatedDeltaEvaluator` is kept per
    distinct kernel set: the first candidate over a set pays the
    full recorded simulation, every later candidate over the same set
    (e.g. the greedy composition scored right after the fifo baseline,
    on the unsliced path where both orders run over the same items)
    resumes from the checkpoint at its first divergence and pays only
    the suffix fraction.  ``1 - fraction`` accumulates per delta call
    in ``ScheduleCache.gated_sims_saved``.  Candidates over a
    *different* kernel set (a sliced composition vs the unsliced
    fifo) get their own evaluator, with no reuse.
    """

    def __init__(self, device, traced, cache: ScheduleCache):
        self.device = device
        self.traced = traced
        self.cache = cache
        #: id(item) -> (item, profile) — the item reference keeps the
        #: id from being recycled by a different object.
        self._profs: dict[int, tuple] = {}
        #: frozenset(profile ids) -> (evaluator, base order, base time)
        self._evals: dict[frozenset, tuple] = {}

    def _profile_of(self, it):
        v = self._profs.get(id(it))
        if v is None:
            v = (it, it.profile())
            self._profs[id(it)] = v
        return v[1]

    def _pairs(self, profs) -> set[tuple[int, int]]:
        names = {p.name: p for p in profs}
        slices: dict[str, list] = {}
        for p in profs:
            parent, sep, sub = p.name.partition("#")
            if sep and sub.startswith("s"):
                slices.setdefault(parent, []).append(p)
        ks = self.traced.graph.kernels
        pairs: set[tuple[int, int]] = set()
        for u, v in self.traced.graph.edges:
            a, b = ks[u].name, ks[v].name
            srcs = ([names.get(a + "#join")] if a in slices
                    else [names.get(a)])
            dsts = slices[b] if b in slices else [names.get(b)]
            for s in srcs:
                for d in dsts:
                    if s is not None and d is not None:
                        pairs.add((id(s), id(d)))
        for parent, parts in slices.items():
            j = names.get(parent + "#join")
            if j is not None:
                for s in parts:
                    pairs.add((id(s), id(j)))
        return pairs

    def time(self, rounds) -> float:
        """Gated-event makespan of a composition's flat launch order
        (``inf`` for a non-topological order)."""
        profs = [self._profile_of(trip[0]) for rd in rounds
                 for trip in rd]
        key = frozenset(id(p) for p in profs)
        ent = self._evals.get(key)
        if ent is None:
            ev = GatedDeltaEvaluator(self.device, self._pairs(profs))
            try:
                t = ev.rebase(profs)
            except ValueError:
                return float("inf")
            self._evals[key] = (ev, list(profs), t)
            return t
        ev, base, base_t = ent
        first = len(profs)
        for i, (a, b) in enumerate(zip(base, profs)):
            if a is not b:
                first = i
                break
        if first == len(profs):
            # Identical launch order: the cached total, a whole full
            # simulation saved.
            self.cache.gated_sims_saved += 1.0
            return base_t
        if not ev.legal(profs):
            return float("inf")
        try:
            t, frac = ev.evaluate_costed(profs, first)
        except ValueError:
            return float("inf")
        self.cache.gated_sims_saved += max(0.0, 1.0 - frac)
        return t


class Composer:
    """The per-step round-composition pipeline.

    Stateless across steps apart from the shared
    :class:`ScheduleCache` (and the counters it carries); the policy
    object is shared with the engine, so runtime knob changes are seen
    immediately.
    """

    def __init__(self, policy, device, weights_bytes: float,
                 cache: ScheduleCache, recorder=None):
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

    # -- shared currencies ---------------------------------------------
    @staticmethod
    def dag_stage_key(name: str) -> str:
        """``r3:d:L0:attn`` -> ``L0:attn``: the layer stage, dropping
        the owning request — co-scheduled copies of one stage share
        its weight stream.  Slice metadata after ``#``
        (``r3:d:L0:attn#s1of4``, ``...#join``) is stripped too: slices
        of one stage share the *parent's* stream, so a round charges
        it once per distinct parent stage, never per slice."""
        return name.split(":", 2)[2].split("#", 1)[0]

    def dag_round_time(self, rd) -> float:
        """Round time on the respect_deps path: the weight stream
        charged is the sum over the round's *distinct* layer stages of
        that stage's own parameter share (``TpuWorkItem.weight_bytes``,
        set by trace_arch; max across copies, so a prefill stage that
        touches the full expert bank dominates a routed decode copy).
        Charging the engine-wide ``weights_bytes`` here would bill the
        whole model once per stage round — many times per step."""
        shares: dict[str, float] = {}
        for it, _, _ in rd:
            key = self.dag_stage_key(it.name)
            shares[key] = max(shares.get(key, 0.0), it.weight_bytes)
        return round_time([t[0] for t in rd], self.device,
                          sum(shares.values()))

    def dag_gated_time(self, rounds, traced) -> float:
        """One-shot gated makespan of a composition (a fresh
        :class:`GatedGuard` with no reuse) — kept for callers scoring
        a single composition outside a compose step."""
        return GatedGuard(self.device, traced, self.cache).time(rounds)

    def dag_guard_fn(self, traced):
        """The guard currency for one compose step
        (``policy.dag_guard``): the round cost model, or a per-step
        :class:`GatedGuard` whose checkpoints are shared across every
        candidate the step scores.  Every call is timed into the
        ``phase_guard`` histogram (the profiling hook for the guard
        phase of a compose step)."""
        if self.policy.dag_guard == "gated":
            return self._timed_guard(
                GatedGuard(self.device, traced, self.cache).time)
        return self._timed_guard(
            lambda rounds: sum(self.dag_round_time(rd)
                               for rd in rounds))

    def _timed_guard(self, fn):
        """Wrap a guard currency so each candidate scoring lands in
        the ``phase_guard`` wall-clock histogram."""
        metrics = self.cache.metrics

        def timed(rounds):
            with metrics.timer("phase_guard"):
                return fn(rounds)

        return timed

    # -- DAG path -------------------------------------------------------
    def dag_fifo(self, triples, traced) -> list[list]:
        """Dependency-aware arrival-order packing of the traced step
        (the guard baseline; plain ``fifo_rounds`` could co-schedule a
        stage with its own predecessor)."""
        profs = traced.graph.kernels
        by_name = {p.name: trip for p, trip in zip(profs, triples)}
        dem = lambda k: k.demands  # noqa: E731 — profiles, not items
        return [[by_name[p.name] for p in rd]
                for rd in fifo_rounds_dag(profs, self.device,
                                          traced.graph.edges_by_id(),
                                          demands_of=dem)]

    def dag_cold(self, triples, traced, frontier=None) -> list[list]:
        """Cold composition of a traced step: the ready-set greedy
        (:func:`repro_torch.graph.greedy_order_dag`), plus the
        precedence-respecting local search for ``kind="refined"``.
        ``frontier`` threads a
        :class:`repro_torch.graph.constrained.GreedyFrontier` sink
        through to the greedy.  The reference's slice-aware branch
        (``policy.slice_policy``) comes with the slicing slice."""
        profs = traced.graph.kernels
        eids = traced.graph.edges_by_id()
        by_name = {p.name: trip for p, trip in zip(profs, triples)}
        dem = lambda k: k.demands  # noqa: E731 — profiles, not items
        sched = greedy_order_dag(profs, self.device,
                                 edges=traced.graph.edges,
                                 frontier=frontier)
        if self.policy.kind == "refined":
            model = (self.policy.refine_model
                     if self.policy.refine_model in ("round", "event",
                                                     "gated")
                     else "round")
            with self.cache.metrics.timer("phase_refine"):
                order, _, _ = refine_order_dag(
                    sched.order, self.device, edge_ids=eids,
                    model=model,
                    budget=self.policy.refine_budget,
                    neighborhood=self.policy.neighborhood,
                    batch_size=(self.policy.refine_batch
                                if self.policy.refine_backend == "batched"
                                else None),
                    metrics=self.cache.metrics)
            prof_rounds = fifo_rounds_dag(order, self.device, eids,
                                          demands_of=dem)
        else:
            prof_rounds = [rd.kernels for rd in sched.rounds]
        return [[by_name[p.name] for p in rd] for rd in prof_rounds]

    def compose_dag(self, triples, traced) -> list[list]:
        """Round composition over the per-layer dependency graph.

        The ready-set greedy (:func:`repro_torch.graph.greedy_order_dag`)
        composes rounds that mix stages of *different* requests while
        every chain stays ordered across rounds; ``kind="refined"``
        additionally runs the precedence-respecting local search on
        the flat order (see :meth:`dag_cold`).  The cost-model guard
        compares against the dependency-aware arrival-order packing
        in the currency ``policy.dag_guard`` selects: the round cost
        model, or the gated-event makespan (which is what lets slice
        rounds win, see :class:`GatedGuard`).

        The ScheduleCache participates with coarsened per-request
        *chain* signatures (kind, kv bucket, stage count) so that
        steady-state decode mixes replay cached DAG patterns
        (``dag_hits``); replayed patterns pass the same stale-replay
        re-validation as the flat path.  Only ``"dag"``-namespace keys
        are ever consulted here (asserted in
        :meth:`ScheduleCache.lookup` — the flat-signature key space is
        structurally unreachable from traced steps).
        """
        guard_time = self.dag_guard_fn(traced)
        fifo = self.dag_fifo(triples, traced)
        if self.policy.kind == "fifo":
            return fifo
        key = labels = None
        if self.policy.cache:
            key, labels = self.dag_key_and_labels(triples, traced)
            pattern = self.cache.lookup(key, namespace="dag")
            if pattern is not None:
                replay = self.dag_apply_pattern(pattern, triples,
                                                labels)
                if replay is not None and self.replay_ok(
                        key, replay, self.dag_round_time):
                    # Counted a hit only when the replay is actually
                    # served; rejected/failed replays recompose cold.
                    self.cache.dag_hits += 1
                    # The replay honours the same fifo guard as a cold
                    # composition, so the "never modelled-worse than
                    # dep-aware arrival order" invariant survives
                    # cache hits.
                    if guard_time(fifo) < guard_time(replay):
                        self._note("schedule", path="dag",
                                   served="fifo", source="replay",
                                   rounds=len(fifo))
                        return fifo
                    self._note("schedule", path="dag",
                               served="replay", rounds=len(replay))
                    return replay
                if pattern is not None:
                    self._note("cache", namespace="dag",
                               outcome=("stale" if replay is not None
                                        else "unmappable"))
        composed = self.dag_cold(triples, traced)
        # Same guard as the flat path: never accept a composition the
        # guard currency says is worse than (dep-aware) arrival order.
        result = fifo if guard_time(fifo) < guard_time(composed) \
            else composed
        self._note("schedule", path="dag",
                   served=("fifo" if result is fifo else "cold"),
                   rounds=len(result))
        if key is not None:
            self.dag_store(key, result, labels)
        return result

    # -- DAG-path ScheduleCache (coarsened chain signatures) -----------
    def dag_key_and_labels(self, triples, traced):
        """Cache key + per-item labels for the respect_deps path.

        Fine-grained layer-stage signatures re-key every step (kv-lens
        drift through every attention stage), so the key coarsens to
        the multiset of per-request *chain* signatures: (kind-bucketed
        length via :meth:`ScheduleCache.signature`, chain stage
        count).  Items are labelled ``(chain_sig, rank, chain_pos)``
        — requests with equal signatures are interchangeable, ranked
        by arrival order — which is what lets a cached round pattern
        replay onto a signature-equivalent step.
        """
        cache = self.cache
        owners = traced.owners
        n_req = len(traced.tail_of)
        chain_len = [0] * n_req
        for o in owners:
            chain_len[o] += 1
        chain_sig = []
        for rid in range(n_req):
            it, r, kind = triples[traced.tail_of[rid]]
            length = r.pos if kind == "decode" else it.tokens
            chain_sig.append((cache.signature(kind, length),
                              chain_len[rid]))
        seen = Counter()
        rank = []
        for s in chain_sig:
            rank.append(seen[s])
            seen[s] += 1
        labels = {}
        pos_ctr = [0] * n_req
        for i, (it, _, _) in enumerate(triples):
            rid = owners[i]
            labels[it.name] = (chain_sig[rid], rank[rid], pos_ctr[rid])
            pos_ctr[rid] += 1
        key = ("dag", self.policy.kind,
               ScheduleCache.key_of(chain_sig))
        return key, labels

    def dag_store(self, key, result, labels) -> None:
        """Store a DAG composition as a label pattern.  Sliced items
        record their slice tag alongside the parent stage's label so a
        replay can re-cut a signature-equivalent step identically."""
        def label_of(name):
            parent, _, sub = name.partition("#")
            return labels[parent] + (sub,)
        try:
            pattern = tuple(tuple(label_of(t[0].name) for t in rd)
                            for rd in result)
        except KeyError:           # defensive: unlabelled item
            return
        t_model = sum(self.dag_round_time(rd) for rd in result)
        self.cache.store(key, pattern, t_model)

    def dag_apply_pattern(self, pattern, triples, labels):
        """Replay a cached DAG pattern onto the current step.

        Whole-stage labels map straight onto the current traced items.
        Labels carrying slice tags (the reference re-cuts the stage
        with the cached slice count) need the slicing slice: such a
        pattern, like any other mismatch — a label the current step
        lacks — returns None and the engine recomposes cold."""
        by_label = {}
        for trip in triples:
            by_label[labels[trip[0].name]] = trip
        # slice counts demanded per parent label
        need: dict[tuple, int] = {}
        for rd in pattern:
            for lab in rd:
                *parent, sub = lab
                if sub.startswith("s"):
                    try:
                        k = int(sub.split("of", 1)[1])
                    except (IndexError, ValueError):
                        return None
                    need[tuple(parent)] = k
                elif sub not in ("", "join"):
                    return None
        if need:
            return None
        out = []
        used = set()
        for rd in pattern:
            row = []
            for lab in rd:
                if lab in used:
                    return None
                used.add(lab)
                *parent, sub = lab
                trip = None if sub else by_label.get(tuple(parent))
                if trip is None:
                    return None
                row.append(trip)
            out.append(row)
        # every current item must be covered exactly once
        want = {labels[t[0].name] + ("",) for t in triples}
        got = {(lab if lab[-1] == "" else tuple(lab[:-1]) + ("",))
               for lab in used}
        if got != want:
            return None
        return out

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
        if self.policy.kind == "refined":
            return self.refined(sched, by_name, key, items, sigs)
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

    def refined(self, sched: Schedule, by_name, key, items, sigs):
        """Local search over Algorithm 1's flat order, re-rounded by
        greedy capacity packing (:func:`fifo_rounds`).  ``refine_model``
        "event" / "round" refine under the core simulator,
        delta-evaluated (suffix re-simulation from cached admission
        checkpoints, or batched with ``refine_backend="batched"``);
        "rounds" re-rounds every candidate under the round cost
        model."""
        policy = self.policy
        with self.cache.metrics.timer("phase_refine"):
            if policy.refine_model in ("event", "round"):
                order, _, _ = refine_order(
                    sched.order, self.device, model=policy.refine_model,
                    budget=policy.refine_budget,
                    neighborhood=policy.neighborhood,
                    batch_size=(policy.refine_batch
                                if policy.refine_backend == "batched"
                                else None),
                    metrics=self.cache.metrics)
            else:
                def tfn(order_profs):
                    its = [by_name[p.name][0] for p in order_profs]
                    return sum(round_time(r, self.device, self.weights_bytes)
                               for r in fifo_rounds(its, self.device))

                order, _, _ = refine_order(
                    sched.order, self.device, time_fn=tfn,
                    budget=policy.refine_budget,
                    neighborhood=policy.neighborhood,
                    metrics=self.cache.metrics)
        its = [by_name[p.name][0] for p in order]
        result = [[by_name[it.name] for it in rd]
                  for rd in fifo_rounds(its, self.device)]
        self._note("schedule", path="flat", served="refined",
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
