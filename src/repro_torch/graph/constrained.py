"""Algorithm 1 under precedence constraints: ready-set greedy + legal
local search.

:func:`greedy_order_dag` is the DAG generalisation of the incremental
greedy (:func:`repro_torch.core.fastscore.greedy_order_fast`): it reuses the
same :class:`~repro_torch.core.fastscore.ProfileTable` packing and the
once-computed ``pair_score_matrix``, but restricts both the seed-pair
scan and the absorption candidates of every round to the current
*ready frontier* — nodes whose predecessors have all retired in
**earlier** rounds.  Successors of a round's members only become ready
when the round closes (co-scheduled kernels run concurrently, so a
dependent kernel can never share a round with its predecessor), which
makes the emitted flat order ``Rd_0 ++ Rd_1 ++ ...`` a valid
topological order by construction.  With an empty edge set the frontier
is always the whole alive set and the function reproduces
``greedy_order_fast`` round-for-round, tie-breaks included
(property-tested in ``tests/test_graph.py``).

:func:`refine_order_dag` is the precedence-respecting counterpart of
:func:`repro_torch.core.refine.refine_order`: the same swap/reinsertion move
sets, but moves that would invert an edge are rejected *before* any
simulation, and legal candidates are delta-evaluated.  Three objective
currencies are supported: ``model="round"``/``"event"`` run the flat
:class:`~repro_torch.core.refine.DeltaEvaluator` (those models ignore
precedence — useful as cheap proxies when the gate barely binds), and
``model="gated"`` runs the
:class:`repro_torch.graph.delta.GatedDeltaEvaluator`, optimizing the DAG
makespan of :class:`repro_torch.graph.streams.DagEventSimulator` *directly*
via gated suffix re-simulation — the currency DAG and slice schedules
are actually scored in (``benchmarks/dag.py``,
``benchmarks/slicing.py``, the serving gated guard).
"""

from __future__ import annotations

from time import perf_counter
from typing import Callable, Iterable, Sequence

import numpy as np

from ..core.fastscore import (ProfileTable, _absorb, _comb_ratio_scalar,
                                  _comb_scores, _CombState,
                                  pair_score_matrix)
from ..core.refine import DeltaEvaluator, _apply, _moves
from ..core.resources import DeviceModel, KernelProfile
from ..core.scheduler import Round, Schedule, _sort_key
from ..core.simulator import simulate

from .delta import GatedDeltaEvaluator

__all__ = ["GreedyFrontier", "greedy_order_dag", "refine_order_dag"]


class _FrontierRound:
    """One live round: member profiles plus the ProfileCombine state
    the incremental greedy maintained for it (the virtual combined
    profile new candidates are scored against)."""

    __slots__ = ("members", "comb")

    def __init__(self, members: list[KernelProfile], comb: _CombState):
        self.members = members
        self.comb = comb


def _single_comb(table: ProfileTable, i: int) -> _CombState:
    return _CombState(demand=table.per_unit[i].copy(),
                      bpu=float(table.bpu[i]),
                      n_blocks=float(table.n_blocks[i]),
                      inst=float(table.inst[i]),
                      r=float(table.r[i]))


def _fold_comb(table: ProfileTable, idxs: Sequence[int],
               device: DeviceModel) -> _CombState:
    """ProfileCombine left fold over ``table[idxs]`` — the same
    single-then-absorb arithmetic the incremental greedy applies, so a
    re-derived round comb scores candidates the way the greedy that
    built the round would have."""
    comb = _single_comb(table, idxs[0])
    for c in idxs[1:]:
        comb = _absorb(comb, table, c, device)
    return comb


class GreedyFrontier:
    """Checkpointable round-frontier state of the ready-set greedy.

    The batch greedy (:func:`greedy_order_dag`) discards its per-round
    ProfileCombine states when it returns; this class keeps them, so a
    *live* composition can be extended (a new request's chain placed
    stage by stage where Algorithm 1's own scoring puts it — the
    :func:`repro_torch.core.fastscore.warm_start_insert` rule, generalized
    to precedence chains) or shrunk (a finished request's stages
    retired, affected combs re-folded) without recomposing from
    scratch.  ``greedy_order_dag(..., frontier=...)`` grows one during
    a cold run; :meth:`seed` re-derives one from any finished round
    composition (e.g. a refined or guard-selected one).

    Precedence discipline: members of one round are mutually
    independent, and a chain's stage ``i+1`` is always placed in a
    strictly later round than stage ``i`` (``min_round`` in
    :meth:`insert_chain`), the same invariant the batch greedy
    enforces by closing rounds before unblocking successors.  Cross-
    chain edges are assumed absent — true for traced serving
    workloads, where edges connect stages of one request only.
    """

    def __init__(self, device: DeviceModel):
        self.device = device
        self.rounds: list[_FrontierRound] = []

    # -- construction ---------------------------------------------------
    def reset(self) -> None:
        self.rounds = []

    def _record(self, members: list[KernelProfile],
                comb: _CombState) -> None:
        """Append a closed round (used by ``greedy_order_dag``)."""
        self.rounds.append(_FrontierRound(list(members), comb))

    def seed(self, rounds: Sequence[Sequence[KernelProfile]]) -> None:
        """Re-derive frontier state from a finished composition."""
        self.reset()
        flat = [k for rd in rounds for k in rd]
        if not flat:
            return
        table = ProfileTable.build(flat, self.device)
        base = 0
        for rd in rounds:
            idxs = list(range(base, base + len(rd)))
            base += len(rd)
            if not idxs:
                continue
            self.rounds.append(_FrontierRound(
                list(rd), _fold_comb(table, idxs, self.device)))

    # -- inspection -----------------------------------------------------
    def round_names(self) -> list[list[str]]:
        return [[k.name for k in rd.members] for rd in self.rounds]

    def order(self) -> list[KernelProfile]:
        return [k for rd in self.rounds for k in rd.members]

    def _index_of(self, rd: _FrontierRound) -> int:
        for i, cand in enumerate(self.rounds):
            if cand is rd:
                return i
        raise ValueError("round no longer in frontier")

    def _insert_sorted(self, rd: _FrontierRound,
                       prof: KernelProfile) -> None:
        """Keep Alg. 1's intra-round dispatch order (decreasing
        shared-memory sort key, line 6/10) when a live placement joins
        an existing round — same rule as ``Round.insert_sorted``."""
        key = _sort_key(prof, self.device)
        for i, existing in enumerate(rd.members):
            if key > _sort_key(existing, self.device):
                rd.members.insert(i, prof)
                return
        rd.members.append(prof)

    # -- live mutation --------------------------------------------------
    def _place_one(self, prof: KernelProfile, min_round: int,
                   on_solo=None, max_round: int | None = None,
                   table: ProfileTable | None = None,
                   col: int = 0) -> _FrontierRound:
        """Place one kernel into the best-scoring fitting round at
        index >= ``min_round`` (the ``warm_start_insert`` rule against
        each round's maintained comb).  ``max_round`` (exclusive)
        bounds the scan so a chain's later stages keep existing rounds
        reachable (:meth:`insert_chain` sets it to reserve one round
        per remaining stage); when the bounded window has no fit the
        scan falls back to the full suffix before going solo.  No fit
        anywhere: ``on_solo``, when given, may expand the kernel into
        co-schedulable slices plus a join (returning ``(slices,
        join)``); otherwise a new solo round opens at ``min_round`` —
        leaving every later existing round reachable for the chain's
        later stages.  ``table``/``col`` let a caller placing many
        kernels (``insert_chain``) pack them once instead of building
        a one-row :class:`ProfileTable` per placement."""
        if table is None:
            table, col = ProfileTable.build([prof], self.device), 0
        idx = np.asarray([col])

        def scan(hi):
            best, best_s = None, -np.inf
            for rd in self.rounds[min_round:hi]:
                scores, fits = _comb_scores(rd.comb, table, idx)
                if bool(fits[0]) and float(scores[0]) > best_s:
                    best, best_s = rd, float(scores[0])
            return best

        best = scan(max_round)
        if (best is None and max_round is not None
                and max_round < len(self.rounds)):
            best = scan(None)
        if best is not None:
            self._insert_sorted(best, prof)
            best.comb = _absorb(best.comb, table, col, self.device)
            return best
        if on_solo is not None:
            exp = on_solo(prof)
            if exp is not None:
                parts, join = exp
                slice_at = [self._place_one(p, min_round) for p in parts]
                join_min = 1 + max(self._index_of(rd) for rd in slice_at)
                return self._place_one(join, join_min)
        rd = _FrontierRound([prof], _single_comb(table, col))
        self.rounds.insert(min_round, rd)
        return rd

    def insert_chain(self, profiles: Sequence[KernelProfile],
                     preds: Sequence[Sequence[int]] | None = None,
                     *, on_solo=None) -> None:
        """Extend the live composition with a new chain.

        ``profiles`` are the chain's kernels in intra-chain
        topological order; ``preds[i]`` lists indices (into
        ``profiles``) that must retire in strictly earlier rounds than
        stage ``i`` — default: the plain chain ``i-1 -> i``.
        ``on_solo`` is the slice-expansion hook
        (:func:`repro.slice.constrained.frontier_solo_expander`):
        called when a stage fits no existing round, it may return
        ``(slices, join)`` to place instead — slices share the stage's
        ``min_round`` floor and the join lands strictly after all of
        them, mirroring the lazy expansion of
        :func:`repro.slice.greedy_order_slices`.
        """
        profiles = list(profiles)
        if preds is None:
            preds = [[i - 1] if i else [] for i in range(len(profiles))]
        table = ProfileTable.build(profiles, self.device) \
            if profiles else None
        placed: list[_FrontierRound] = []
        for i, prof in enumerate(profiles):
            min_round = 0
            for p in preds[i]:
                min_round = max(min_round,
                                self._index_of(placed[p]) + 1)
            # Reserve one existing round per remaining stage: an
            # unbounded best-score scan happily parks stage 0 in the
            # *last* round, spilling the whole rest of the chain into
            # fresh solo rounds — under churn the frontier balloons
            # instead of threading the chain through the composition
            # the way the batch ready-set greedy would.
            remaining = len(profiles) - i - 1
            max_round = (max(min_round, len(self.rounds) - remaining)
                         if remaining else None)
            placed.append(self._place_one(prof, min_round,
                                          on_solo=on_solo,
                                          max_round=max_round,
                                          table=table, col=i))

    def remove(self, names: set[str]) -> None:
        """Retire kernels by name (a finished request's stages, slice
        parts included); affected rounds re-fold their combs over the
        surviving members, empty rounds close."""
        kept: list[_FrontierRound] = []
        dirty: list[_FrontierRound] = []
        for rd in self.rounds:
            before = len(rd.members)
            rd.members = [k for k in rd.members if k.name not in names]
            if not rd.members:
                continue
            if len(rd.members) != before:
                dirty.append(rd)
            kept.append(rd)
        self.rounds = kept
        for rd in dirty:
            table = ProfileTable.build(rd.members, self.device)
            rd.comb = _fold_comb(table, range(len(rd.members)),
                                 self.device)

    def refresh(self, profiles: dict[str, KernelProfile]) -> None:
        """Swap members to current (drifted) profile objects by name
        and re-fold every comb — O(n * D), run before scoring new
        insertions against a step whose demands moved (decode kv
        growth).  Names absent from ``profiles`` keep their old
        profile object."""
        for rd in self.rounds:
            rd.members = [profiles.get(k.name, k) for k in rd.members]
        flat = self.order()
        if not flat:
            return
        table = ProfileTable.build(flat, self.device)
        base = 0
        for rd in self.rounds:
            rd.comb = _fold_comb(
                table, range(base, base + len(rd.members)), self.device)
            base += len(rd.members)


def _edge_arrays(n: int, edges: Iterable[tuple[int, int]]
                 ) -> tuple[list[list[int]], np.ndarray]:
    succs: list[list[int]] = [[] for _ in range(n)]
    indeg = np.zeros(n, dtype=np.int64)
    for u, v in set(edges):
        if not (0 <= u < n and 0 <= v < n) or u == v:
            raise ValueError(f"bad edge ({u}, {v}) for n={n}")
        succs[u].append(v)
        indeg[v] += 1
    return succs, indeg


def greedy_order_dag(kernels: Sequence[KernelProfile],
                     device: DeviceModel,
                     *, edges: Iterable[tuple[int, int]] = (),
                     frontier: "GreedyFrontier | None" = None) -> Schedule:
    """Ready-set Algorithm 1 over a kernel DAG.

    ``edges`` are ``(u, v)`` index pairs into ``kernels``: u must
    complete before v starts.  Raises ``ValueError`` on a cycle.  With
    ``edges=()`` this is exactly ``greedy_order_fast`` — same rounds,
    same intra-round order, same tie-breaking.

    ``frontier`` grows a :class:`GreedyFrontier` during the run: every
    closed round is recorded with the exact ProfileCombine state the
    greedy maintained for it (reset first, so the sink always holds
    this run's composition).  A live caller
    (:class:`repro.serve.live.LiveComposition`) later extends or
    shrinks that state instead of re-running this function cold.

    A stage whose profile saturates a device capacity on its own can
    only ever land in a solo round here; callers with such oversized
    stages should use :func:`repro.slice.greedy_order_slices`, which
    wraps this greedy and lazily cuts exactly those stages into
    co-schedulable slices.
    """
    n = len(kernels)
    if frontier is not None:
        frontier.reset()
    if n == 0:
        return Schedule([])
    succs, indeg = _edge_arrays(n, edges)
    table = ProfileTable.build(kernels, device)
    mat = pair_score_matrix(table)
    # Same masking discipline as greedy_order_fast: lower triangle and
    # diagonal dead so the argmax scans exactly the i < j entries the
    # reference scan evaluates; rows/cols die as kernels retire.
    mat[np.tril_indices(n)] = -1.0
    alive = np.ones(n, dtype=bool)
    rounds: list[Round] = []
    n_alive = n

    def kill(i: int) -> None:
        nonlocal n_alive
        alive[i] = False
        mat[i, :] = -1.0
        mat[:, i] = -1.0
        n_alive -= 1

    while n_alive:
        ready = np.nonzero(alive & (indeg == 0))[0]
        if ready.size == 0:
            raise ValueError("precedence edges contain a cycle")
        rd = Round()
        members: list[int] = []
        comb: _CombState | None = None
        if ready.size == 1:
            solo = int(ready[0])
            kill(solo)
            rd.kernels.append(table.kernels[solo])
            members.append(solo)
        else:
            # Seed pair: first strict maximum over ready i < j entries
            # in row-major order — the submatrix scan preserves the
            # full-matrix scan order, so with no edges the selected
            # pair is identical to greedy_order_fast's.
            sub = mat[np.ix_(ready, ready)]
            flat = int(np.argmax(sub))
            si, sj = divmod(flat, ready.size)
            i, j = int(ready[si]), int(ready[sj])
            best = mat[i, j]
            fits_pair = (
                table.bpu[i] + table.bpu[j] <= device.max_resident and
                bool(np.all(table.per_unit[i] + table.per_unit[j] <=
                            table.caps)))
            if best <= 0.0 and not fits_pair:
                # Nothing pairs: heaviest (sort-key) ready kernel runs
                # alone, as in the unconstrained greedy.
                solo = int(ready[int(np.argmax(table.sort_key[ready]))])
                kill(solo)
                rd.kernels.append(table.kernels[solo])
                members.append(solo)
            else:
                rd.insert_sorted(table.kernels[i], device)
                rd.insert_sorted(table.kernels[j], device)
                comb = _CombState(
                    demand=table.per_unit[i] + table.per_unit[j],
                    bpu=table.bpu[i] + table.bpu[j],
                    n_blocks=table.n_blocks[i] + table.n_blocks[j],
                    inst=table.inst[i] + table.inst[j],
                    r=_comb_ratio_scalar(
                        device, table.n_blocks[i], table.inst[i],
                        table.r[i], table.n_blocks[j], table.inst[j],
                        table.r[j]))
                kill(i)
                kill(j)
                members += [i, j]
                # Absorb from the round-start frontier only: indeg is
                # not decremented until the round closes, so nodes
                # unblocked by this round's members never join it.
                while n_alive:
                    idx = np.nonzero(alive & (indeg == 0))[0]
                    if idx.size == 0:
                        break
                    scores, fits = _comb_scores(comb, table, idx)
                    if not fits.any():
                        break
                    scores = np.where(fits, scores, -np.inf)
                    c = int(idx[int(np.argmax(scores))])
                    rd.insert_sorted(table.kernels[c], device)
                    comb = _absorb(comb, table, c, device)
                    kill(c)
                    members.append(c)
        # Round closes: retire members, unblocking their successors
        # for subsequent rounds.
        for m in members:
            for v in succs[m]:
                indeg[v] -= 1
        if frontier is not None:
            # rd.kernels, not members: the frontier keeps Alg. 1's
            # intra-round dispatch order (decreasing shared memory),
            # not the absorption order.
            frontier._record(
                list(rd.kernels),
                comb if comb is not None
                else _single_comb(table, members[0]))
        rounds.append(rd)
    return Schedule(rounds)


def _legal_mask(order: Sequence[KernelProfile],
                edge_ids: set) -> Callable[[Sequence[KernelProfile]], bool]:
    """Fast topological check for candidate orders over the same
    kernel objects: position-map build + edge scan, O(n + E)."""
    def ok(cand: Sequence[KernelProfile]) -> bool:
        pos = {id(k): p for p, k in enumerate(cand)}
        return all(pos[u] < pos[v] for u, v in edge_ids)
    return ok


def refine_order_dag(
    order: Sequence[KernelProfile],
    device: DeviceModel,
    *,
    edges: Iterable[tuple[int, int]] = (),
    edge_ids: set | None = None,
    time_fn: Callable[[Sequence[KernelProfile]], float] | None = None,
    budget: int = 2000,
    model: str = "event",
    neighborhood: str = "full",
    batch_size: int | None = None,
    table=None,
    rescore: bool | None = None,
    metrics=None,
) -> tuple[list[KernelProfile], float, int]:
    """Precedence-respecting hill-climb of a topological launch order.

    ``batch_size`` routes to the batched evaluator
    (:func:`repro_torch.core.batched.refine_order_batched`): illegal
    candidates are filtered for free as in the sequential path, the
    legal neighborhood is scored in vectorized ``(B, n)`` passes
    (gated candidates on the lockstep gated engine) and improving
    moves are re-verified exactly before acceptance.  ``table``
    threads a pre-built :class:`~repro_torch.core.fastscore.ProfileTable`
    through so the pipeline packs once.  ``rescore`` picks the
    batched quality contract (sequential-parity vs
    max-throughput; see :func:`repro_torch.core.batched.refine_order_batched`
    — the default re-scores under ``model="gated"``).

    ``edges`` are index pairs into the *given* ``order``; callers that
    hold a :class:`~repro_torch.graph.kernel_graph.KernelGraph` over a
    permutation of these kernels pass
    ``edge_ids=graph.edges_by_id()`` instead.  The move sets, budget
    accounting (full-simulation equivalents) and delta evaluation are
    those of :func:`repro_torch.core.refine.refine_order`; the only
    difference is the legality filter: a candidate that would place a
    kernel before one of its predecessors is discarded before it costs
    any simulation.  The returned order is therefore always a valid
    topological order, and never modelled-worse than the input.

    ``model`` selects the objective currency: ``"round"``/``"event"``
    are the flat (precedence-blind) simulators, ``"gated"`` the
    dependency-aware :class:`~repro_torch.graph.streams.DagEventSimulator`
    makespan, delta-evaluated via
    :class:`~repro_torch.graph.delta.GatedDeltaEvaluator` — use it when the
    returned time must be the DAG schedule's own scoring currency
    (best_t then *is* the gated makespan of ``best_order``, so no
    greedy fallback is needed on the gated scoreboard).

    ``metrics`` (a :class:`repro_torch.obs.MetricsRegistry`) records
    ``refine_evals`` / ``refine_cost`` / ``refine_score_s`` exactly as
    :func:`repro_torch.core.refine.refine_order` does (and forwards to the
    batched route) — purely additive, the trajectory is unchanged.
    """
    n = len(order)
    base = list(order)
    if edge_ids is None:
        edge_ids = {(id(base[u]), id(base[v])) for u, v in set(edges)}
    if neighborhood == "auto":
        neighborhood = "full" if n <= 128 else "adjacent"
    legal = _legal_mask(base, edge_ids)
    if not legal(base):
        raise ValueError("input order violates the precedence edges")
    if batch_size is not None and time_fn is None \
            and model in ("round", "event", "gated"):
        from ..core.batched import refine_order_batched

        return refine_order_batched(
            base, device, model=model, budget=budget,
            neighborhood=neighborhood, batch_size=batch_size,
            table=table, edge_ids=edge_ids,
            delta=(GatedDeltaEvaluator(device, edge_ids)
                   if model == "gated" else None),
            legal=legal, rescore=rescore, metrics=metrics)
    t_wall = perf_counter()
    use_delta = time_fn is None and model in ("round", "event", "gated")
    if not use_delta:
        delta = None
    elif model == "gated":
        delta = GatedDeltaEvaluator(device, edge_ids)
    else:
        delta = DeltaEvaluator(device, model=model)
    if time_fn is None and not use_delta:
        # Only reachable with an unknown model string: simulate() then
        # raises on first evaluation.  Valid models always delta-eval.
        time_fn = lambda o: simulate(o, device, model=model)  # noqa: E731
    best = base
    best_t = delta.rebase(best) if use_delta else time_fn(best)
    cost = 1.0
    evals = 1
    eval_cap = 10 * budget if use_delta else budget
    improved = True
    while improved and cost < budget and evals < eval_cap:
        improved = False
        moves = _moves(n, neighborhood)
        if use_delta and neighborhood == "adjacent":
            bounds = delta.boundaries()
            if bounds is None:
                moves.sort(key=lambda m: -m[0])
            else:
                near = [False] * (n + 1)
                for b in bounds:
                    for p in (b - 1, b, b + 1):
                        if 0 <= p < n:
                            near[p] = True
                moves.sort(key=lambda m: (not (near[m[2]] or near[m[3]]),
                                          -m[0]))
        for first, kind, i, j in moves:
            if cost >= budget or evals >= eval_cap:
                break
            cand = _apply(best, kind, i, j)
            if not legal(cand):
                continue  # rejected before simulation: costs nothing
            if use_delta:
                t, frac = delta.evaluate_costed(cand, first)
                cost += frac
            else:
                t = time_fn(cand)
                cost += 1.0
            evals += 1
            if t < best_t - 1e-15:
                best, best_t, improved = cand, t, True
                if use_delta:
                    delta.rebase_incremental(best, first)
    if metrics is not None:
        metrics.counter("refine_evals").inc(evals)
        metrics.counter("refine_cost").inc(cost)
        metrics.histogram("refine_score_s").observe(
            perf_counter() - t_wall)
    return best, best_t, evals
