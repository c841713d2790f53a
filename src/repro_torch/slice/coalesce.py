"""Coalesce sibling slices the scheduler put back together.

Slicing (:mod:`repro_torch.slice.slicer`) cuts a stage so its pieces *can*
co-execute with other kernels.  When a composed schedule then lands
several siblings in the **same round anyway**, the cut bought nothing
for those pieces — they run side by side exactly as one bigger slice
would — while the extra nodes and diamond edges keep taxing everything
downstream: legality filtering, gated suffix re-simulation, and
especially the 200-order random-topological percentile sweeps the
benchmarks run (whose cost grows with node count, not work).

:func:`coalesce_rounds` is the inverse pass: siblings sharing a round
merge back into one node (:func:`~repro_torch.slice.slicer.merge_slice_profiles`
— the same exact-accounting conservation law slicing obeys, run
backwards), and a stage whose *every* slice merged back collapses
fully: the restored parent node takes the join's out-edges and the
zero-work join disappears.  Precedence is preserved by construction —
siblings share their in-edges (the parent's predecessors), their only
successor is the join, and a merged node sits exactly where its first
member sat in the round structure.
"""

from __future__ import annotations

from dataclasses import replace

from ..core.scheduler import Round, Schedule

from .constrained import SlicedSchedule
from .slicer import is_join, is_slice, merge_slice_profiles, parent_name

__all__ = ["coalesce_rounds"]


def coalesce_rounds(result: SlicedSchedule) -> SlicedSchedule:
    """Merge same-round sibling slices of ``result`` back into single
    nodes; fully re-merged stages drop their join.  Returns a new
    :class:`~repro_torch.slice.constrained.SlicedSchedule` over the shrunken
    graph (``result`` is untouched).  Resource totals are conserved
    exactly; the round structure is preserved (merged members are
    replaced in place, emptied rounds dropped)."""
    ks = result.kernels
    idx_of = {id(k): i for i, k in enumerate(ks)}

    # -- 1. merge groups: same-parent slices sharing a round ----------
    groups: list[list[int]] = []
    grouped: dict[int, int] = {}          # old idx -> group id
    for rd in result.rounds:
        per_parent: dict[str, list[int]] = {}
        for k in rd.kernels:
            if is_slice(k.name) and not is_join(k.name):
                per_parent.setdefault(parent_name(k.name),
                                      []).append(idx_of[id(k)])
        for sibs in per_parent.values():
            if len(sibs) > 1:
                gid = len(groups)
                groups.append(sorted(sibs))
                for i in sibs:
                    grouped[i] = gid
    if not groups:
        return result

    # -- 2. which stages collapse fully (single surviving slice)? ----
    slices_of: dict[str, list[int]] = {}
    join_of: dict[str, int] = {}
    for i, k in enumerate(ks):
        if is_join(k.name):
            join_of[parent_name(k.name)] = i
        elif is_slice(k.name):
            slices_of.setdefault(parent_name(k.name), []).append(i)
    survivors: dict[str, int] = {
        p: len({grouped.get(i, -1 - i) for i in sibs})
        for p, sibs in slices_of.items()}
    collapsed = {p for p, n_left in survivors.items()
                 if n_left == 1 and p in join_of}

    # -- 3. rebuild the node list (merged node at first member) ------
    new_ks: list = []
    new_parent_of: list[int] = []
    newidx: dict[int, int] = {}
    emitted: set[int] = set()
    dropped_joins: dict[int, str] = {
        join_of[p]: p for p in collapsed}
    for i, k in enumerate(ks):
        if i in dropped_joins:
            continue
        gid = grouped.get(i)
        if gid is None:
            newidx[i] = len(new_ks)
            new_ks.append(k)
            new_parent_of.append(result.parent_of[i])
            continue
        if gid in emitted:
            newidx[i] = newidx[groups[gid][0]]
            continue
        emitted.add(gid)
        members = groups[gid]
        merged = merge_slice_profiles([ks[m] for m in members])
        p = parent_name(k.name)
        if p in collapsed and is_slice(merged.name):
            # every sibling merged into this node: restore the parent
            # name so the graph carries no slice metadata for it
            # (merge_slice_profiles already does this when the indices
            # cover 0..k-1; this is the belt for exotic expansions).
            merged = replace(merged, name=p)
        newidx[i] = len(new_ks)
        new_ks.append(merged)
        new_parent_of.append(result.parent_of[i])
    # joins of collapsed stages route their edges through the restored
    # node.
    for j, p in dropped_joins.items():
        newidx[j] = newidx[slices_of[p][0]]

    new_edges = {(newidx[u], newidx[v]) for u, v in result.edges
                 if newidx[u] != newidx[v]}

    # -- 4. rebuild rounds: members replaced in place, dedup, no
    # dropped joins ---------------------------------------------------
    new_rounds: list[Round] = []
    for rd in result.rounds:
        nrd = Round()
        seen: set[int] = set()
        for k in rd.kernels:
            i = idx_of[id(k)]
            if i in dropped_joins:
                continue
            ni = newidx[i]
            if ni in seen:
                continue
            seen.add(ni)
            nrd.kernels.append(new_ks[ni])
        if nrd.kernels:
            new_rounds.append(nrd)

    new_sliced = {}
    for p, n in result.sliced.items():
        if p in collapsed:
            continue
        new_sliced[p] = survivors.get(p, n)
    return SlicedSchedule(schedule=Schedule(new_rounds), kernels=new_ks,
                          edges=new_edges, sliced=new_sliced,
                          parent_of=new_parent_of,
                          passes=result.passes)
