"""Kernelet-style kernel slicing (the port of the reference's
``repro.slice``, host NumPy, bit-equal to it).

The reordering scheduler (:mod:`repro_torch.core.fastscore`) and its DAG
generalisation (:mod:`repro_torch.graph`) pack kernels whose resource
profiles are complementary; a stage that saturates the device on its
own can never share a round, so reordering alone leaves it serialized.
This package cuts such stages into co-schedulable pieces:

* :mod:`repro_torch.slice.slicer` — :class:`SlicePolicy` (occupancy /
  round-fill / fixed-k, granularity chosen per stage from its
  profile) + :class:`KernelSlicer` (exact accounting: slice profiles
  sum back to the parent, the stage's weight stream is shared by its
  slices and charged once per round),
* :mod:`repro_torch.slice.graph` — :func:`expand_nodes` (slices inherit the
  parent's in-edges, successors hang off a synthetic join node,
  sibling slices stay mutually independent),
* :mod:`repro_torch.slice.constrained` — :func:`greedy_order_slices` (lazy
  expansion: a stage is cut only when the ready-set greedy lands it in
  a solo round) + :func:`refine_order_slices` (legal local search over
  the expanded order).

Gated makespans of sliced schedules come from the unchanged
:class:`repro_torch.graph.streams.DagEventSimulator`, which admits slices
under the ready-set gate and retires the zero-work join markers
instantly; at slice factor 1 every path here degenerates bit-for-bit
to the unsliced :mod:`repro_torch.graph` pipeline.  Serving opts in through
``SchedulerPolicy.slice_policy`` (default off).
"""

from .coalesce import coalesce_rounds
from .constrained import (SlicedSchedule, greedy_order_slices,
                          refine_order_slices)
from .graph import SliceExpansion, expand_nodes
from .slicer import (KernelSlicer, SlicePolicy, is_join, is_slice,
                     join_item, join_profile, merge_slice_profiles,
                     parent_name, slice_indices)

__all__ = [
    "SlicePolicy", "KernelSlicer", "join_profile", "join_item",
    "parent_name", "is_slice", "is_join", "merge_slice_profiles",
    "slice_indices", "coalesce_rounds",
    "SliceExpansion", "expand_nodes",
    "SlicedSchedule", "greedy_order_slices", "refine_order_slices",
]
