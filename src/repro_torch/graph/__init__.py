"""Dependency-aware kernel-DAG scheduling (the port of the reference's
``repro.graph``, host NumPy, bit-equal to it).

Generalizes the paper's Algorithm 1 — built for mutually independent
kernels — to precedence-constrained workloads: real model graphs where
attention feeds MLP feeds the next layer, traced per request from the
serving configs.  Flat-order callers keep using
``repro_torch.core.fastscore``; when dependencies exist, come here:

* :mod:`repro_torch.graph.kernel_graph` — :class:`KernelGraph` +
  :func:`trace_arch` (config -> per-layer work-item chains),
* :mod:`repro_torch.graph.constrained` — :func:`greedy_order_dag` (ready-set
  incremental greedy) + :func:`refine_order_dag` (legal local search;
  ``model="gated"`` optimizes the gated DAG makespan directly),
* :mod:`repro_torch.graph.streams` — :func:`assign_streams` (k launch
  queues) + :class:`DagEventSimulator` (gated makespan model,
  checkpointable),
* :mod:`repro_torch.graph.delta` — :class:`GatedDeltaEvaluator` +
  ``_FastGatedSim`` (suffix re-simulation under the gated model; the
  delta path that makes ``model="gated"`` refinement affordable).

When a workload carries *oversized* stages — profiles that saturate a
device capacity on their own (long prefill chunks against the slot
budget), which the ready-set greedy can only serialize into solo
rounds — go one layer up to :mod:`repro_torch.slice`, whose
:func:`~repro_torch.slice.greedy_order_slices` lazily cuts exactly those
stages into co-schedulable slices (Kernelet-style).
"""

from .constrained import greedy_order_dag, refine_order_dag
from .delta import GatedDeltaEvaluator
from .kernel_graph import (KernelGraph, TracedWorkload,
                           arch_kv_bytes_per_token, estimate_n_params,
                           trace_arch)
from .streams import (DagEventSimulator, StreamAssignment, assign_streams,
                      fifo_rounds_dag)

__all__ = [
    "KernelGraph", "TracedWorkload", "trace_arch",
    "arch_kv_bytes_per_token", "estimate_n_params",
    "greedy_order_dag", "refine_order_dag", "GatedDeltaEvaluator",
    "DagEventSimulator", "StreamAssignment", "assign_streams",
    "fifo_rounds_dag",
]
