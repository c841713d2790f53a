"""Slice-aware precedence: expand sliced nodes inside a kernel DAG.

Expanding node ``t`` into slices ``s_1..s_k`` plus a join ``j`` rewires
the graph so precedence semantics are preserved while the slices gain
schedulable freedom:

* every in-edge ``(u, t)`` becomes ``(u, s_i)`` for all i — slices
  inherit the parent's predecessors (none may start early),
* every out-edge ``(t, v)`` becomes ``(j, v)`` — the parent's
  successors hang off the synthetic join, waiting for the whole stage,
* edges ``(s_i, j)`` close the diamond,
* slices of one kernel carry **no** edges among themselves: they are
  mutually independent, so the ready-set greedy may pack them into
  different rounds with different peers and
  :func:`repro_torch.graph.streams.assign_streams` may fan them out across
  launch queues.

Expansion preserves acyclicity (each node is replaced by a local
diamond) and composes: the output of one :func:`expand_nodes` call can
be expanded again, which is how the lazy scheduler
(:func:`repro_torch.slice.constrained.greedy_order_slices`) slices in
passes.  ``parent_of`` threads the original node identity through
arbitrarily many passes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Mapping, Sequence

from ..core.resources import KernelProfile

__all__ = ["SliceExpansion", "expand_nodes"]


@dataclass
class SliceExpansion:
    """One expansion pass: the rewired node list and edge set, plus
    the bookkeeping that maps new indices back to the input's.

    ``new_of[i]`` lists the new indices replacing input node ``i``
    (``[i']`` for untouched nodes, the slice indices for expanded
    ones); ``join_of[i]`` is the join's new index for expanded nodes;
    ``parent_of[j]`` is the input index every new node ``j`` descends
    from (slices and joins map to their parent).
    """

    kernels: list[KernelProfile]
    edges: set
    new_of: list[list[int]]
    join_of: dict[int, int] = field(default_factory=dict)
    parent_of: list[int] = field(default_factory=list)

    @property
    def n(self) -> int:
        return len(self.kernels)


def expand_nodes(kernels: Sequence[KernelProfile],
                 edges: Iterable[tuple[int, int]],
                 expansions: Mapping[int, tuple[Sequence[KernelProfile],
                                                KernelProfile]]
                 ) -> SliceExpansion:
    """Replace each node in ``expansions`` with its slices + join.

    ``expansions`` maps a node index to ``(slice_profiles, join)``.
    Slices are placed at the parent's position in the node list and
    the join directly after them, so a topological input ordering
    (every edge ``u < v``) stays topological after expansion — the
    invariant serving and the fifo baselines rely on.
    """
    out: list[KernelProfile] = []
    parent_of: list[int] = []
    new_of: list[list[int]] = []
    join_of: dict[int, int] = {}
    for i, k in enumerate(kernels):
        if i in expansions:
            slices, join = expansions[i]
            if len(slices) < 1:
                raise ValueError(f"node {i}: need >= 1 slice")
            idxs = []
            for s in slices:
                idxs.append(len(out))
                out.append(s)
                parent_of.append(i)
            join_of[i] = len(out)
            out.append(join)
            parent_of.append(i)
            new_of.append(idxs)
        else:
            new_of.append([len(out)])
            out.append(k)
            parent_of.append(i)
    new_edges: set = set()
    for u, v in set(edges):
        srcs = [join_of[u]] if u in expansions else new_of[u]
        for a in srcs:
            for b in new_of[v]:
                new_edges.add((a, b))
    for i in expansions:
        for s in new_of[i]:
            new_edges.add((s, join_of[i]))
    return SliceExpansion(kernels=out, edges=new_edges, new_of=new_of,
                          join_of=join_of, parent_of=parent_of)
