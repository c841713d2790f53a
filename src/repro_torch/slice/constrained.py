"""Lazy slice-aware ready-set greedy + legal local search.

:func:`greedy_order_slices` extends
:func:`repro_torch.graph.constrained.greedy_order_dag` with **lazy slice
expansion**: the graph is scheduled as-is, and a stage is only cut
when the greedy itself proves it cannot pack — it lands in a solo
round, i.e. its score vector showed no frontier peer it fits with (or
the frontier had no peers at all).  Triggered stages are expanded
through :func:`repro_torch.slice.graph.expand_nodes` (slices inherit the
parent's in-edges, successors hang off the synthetic join) and the
ready-set greedy re-runs over the rewired graph; passes repeat until
no solo round wants slicing.  Slices and joins are terminal — a pass
can only expand original stages — so the loop terminates after at
most one pass per sliceable stage (two passes in practice).

With a policy that triggers nothing (or ``policy=None``) the result
is exactly one ``greedy_order_dag`` pass: same rounds, same
intra-round order, same tie-breaking — the slice-factor-1 identity
pinned by ``tests/test_slice.py``.

:func:`refine_order_slices` is
:func:`repro_torch.graph.constrained.refine_order_dag` run over the expanded
order: legality extends to the slice/join edges automatically (a slice
can never move before its parent's predecessors, a successor never
before the join) because the move filter reads the expanded edge set.
With ``model="gated"`` it optimizes the sliced schedule's own scoring
currency — the gated DAG makespan
(:class:`repro_torch.graph.streams.DagEventSimulator`, which retires the
zero-work joins instantly) — directly via gated suffix re-simulation
(:class:`repro_torch.graph.delta.GatedDeltaEvaluator`), so the returned time
needs no greedy fallback on the gated scoreboard.
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence

from ..core.resources import DeviceModel, KernelProfile
from ..core.scheduler import Schedule
from ..graph.constrained import greedy_order_dag, refine_order_dag
from ..graph.kernel_graph import KernelGraph

from .graph import expand_nodes
from .slicer import KernelSlicer, SlicePolicy, join_profile

__all__ = ["SlicedSchedule", "frontier_solo_expander",
           "greedy_order_slices", "refine_order_slices"]


def frontier_solo_expander(slicer: KernelSlicer,
                           make_slices: Callable | None = None,
                           make_join: Callable | None = None):
    """``on_solo`` hook for
    :meth:`repro_torch.graph.constrained.GreedyFrontier.insert_chain`:
    slice-aware live joins.

    When a joining chain's stage fits no round of the live
    composition, the frontier asks this hook before opening a solo
    round — the live counterpart of the lazy expansion trigger in
    :func:`greedy_order_slices` (there, a stage is cut when the batch
    greedy lands it in a solo round; here, when the live placement
    scan finds no fitting peer round).  The policy decision is the
    slicer's (:meth:`~repro_torch.slice.slicer.KernelSlicer.slice_count`);
    ``make_slices(prof, k)`` / ``make_join(prof)`` override the
    expansion mechanics exactly as in :func:`greedy_order_slices` —
    the serving engine passes closures that also cut the backing
    work items so the composed rounds stay executable.  Returns
    ``(slices, join)`` or ``None`` (stage stays whole)."""
    if make_slices is None:
        make_slices = slicer.slice_profile
    if make_join is None:
        make_join = join_profile

    def on_solo(prof: KernelProfile):
        if "#" in prof.name:
            return None          # slices and joins are terminal
        k = slicer.slice_count(prof)
        if k <= 1:
            return None
        return list(make_slices(prof, k)), make_join(prof)

    return on_solo


class SlicedSchedule:
    """Result of the slice-aware greedy: the round schedule plus the
    expanded workload it is a schedule *of*.

    ``kernels``/``edges`` describe the expanded DAG (slices + joins);
    ``sliced`` maps each cut stage's name to its slice count;
    ``parent_of[j]`` maps expanded node ``j`` to its index in the
    caller's original kernel list.
    """

    def __init__(self, schedule: Schedule, kernels: list[KernelProfile],
                 edges: set, sliced: dict[str, int],
                 parent_of: list[int], passes: int):
        self.schedule = schedule
        self.kernels = kernels
        self.edges = edges
        self.sliced = sliced
        self.parent_of = parent_of
        self.passes = passes

    @property
    def order(self) -> list[KernelProfile]:
        return self.schedule.order

    @property
    def rounds(self):
        return self.schedule.rounds

    def graph(self) -> KernelGraph:
        return KernelGraph(self.kernels, self.edges)

    def edges_by_id(self) -> set:
        ks = self.kernels
        return {(id(ks[u]), id(ks[v])) for u, v in self.edges}


def greedy_order_slices(
    kernels: Sequence[KernelProfile],
    device: DeviceModel,
    *,
    edges: Iterable[tuple[int, int]] = (),
    policy: SlicePolicy | None = None,
    make_slices: Callable[[KernelProfile, int],
                          Sequence[KernelProfile]] | None = None,
    make_join: Callable[[KernelProfile], KernelProfile] | None = None,
    max_passes: int = 8,
    frontier=None,
) -> SlicedSchedule:
    """Ready-set Algorithm 1 with lazy Kernelet-style slicing.

    ``policy=None`` disables slicing entirely (one plain
    ``greedy_order_dag`` pass).  ``make_slices(prof, k)`` /
    ``make_join(prof)`` override the expansion mechanics — the serving
    engine supplies closures that also cut the backing
    :class:`~repro_torch.core.tpu.TpuWorkItem` so rounds stay executable;
    the *decision* (which stage, how many pieces) always comes from
    the policy via :class:`~repro_torch.slice.slicer.KernelSlicer`.

    ``frontier`` threads a
    :class:`repro_torch.graph.constrained.GreedyFrontier` sink through to
    the greedy passes; because each pass resets it, on return it holds
    the *final* pass's composition — the one this function's schedule
    reports — ready for live extension.
    """
    ks: list[KernelProfile] = list(kernels)
    es: set = {(u, v) for u, v in edges}
    parent_of = list(range(len(ks)))
    sliced: dict[str, int] = {}
    slicer = KernelSlicer(policy, device) if policy is not None else None
    if make_slices is None and slicer is not None:
        make_slices = slicer.slice_profile
    if make_join is None:
        make_join = join_profile
    passes = 0
    while True:
        sched = greedy_order_dag(ks, device, edges=es,
                                 frontier=frontier)
        if slicer is None or passes >= max_passes:
            break
        pos = {id(k): i for i, k in enumerate(ks)}
        trig: dict[int, int] = {}
        for rd in sched.rounds:
            if len(rd.kernels) != 1:
                continue
            k = rd.kernels[0]
            n_cut = slicer.slice_count(k)
            if n_cut > 1:
                trig[pos[id(k)]] = n_cut
        if not trig:
            break
        expansions = {i: (list(make_slices(ks[i], n)), make_join(ks[i]))
                      for i, n in trig.items()}
        for i, n in trig.items():
            sliced[ks[i].name] = len(expansions[i][0])
        exp = expand_nodes(ks, es, expansions)
        ks, es = exp.kernels, exp.edges
        parent_of = [parent_of[p] for p in exp.parent_of]
        passes += 1
    return SlicedSchedule(schedule=sched, kernels=ks, edges=es,
                          sliced=sliced, parent_of=parent_of,
                          passes=passes)


def refine_order_slices(
    result: SlicedSchedule,
    device: DeviceModel,
    *,
    budget: int = 2000,
    model: str = "event",
    neighborhood: str = "adjacent",
    batch_size: int | None = None,
    rescore: bool | None = None,
    metrics=None,
) -> tuple[list[KernelProfile], float, int]:
    """Precedence-respecting local search over a sliced schedule's
    flat order.  Slice/join edges participate in the legality filter
    like any other precedence edge, so every candidate keeps slices
    after their parent's predecessors and the join (hence all
    successors) after every slice.  ``model="gated"`` optimizes the
    gated DAG makespan directly (delta-evaluated suffix re-simulation,
    see :func:`repro_torch.graph.constrained.refine_order_dag`); ``"round"``
    and ``"event"`` remain the cheap precedence-blind proxies.
    ``batch_size`` selects the batched move evaluator
    (:func:`repro_torch.core.batched.refine_order_batched`) as in
    :func:`~repro_torch.graph.constrained.refine_order_dag`; ``metrics``
    forwards there too (``refine_evals`` / ``refine_cost`` /
    ``refine_score_s``)."""
    return refine_order_dag(result.order, device,
                            edge_ids=result.edges_by_id(),
                            budget=budget, model=model,
                            neighborhood=neighborhood,
                            batch_size=batch_size, rescore=rescore,
                            metrics=metrics)
