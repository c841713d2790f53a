"""Host scheduler core: Algorithm 1 (launch reordering) and the serving
round cost model, copied from the reference package's ``repro.core``.

This is NumPy host code; the port keeps it bit-identical to the
reference (same orders, rounds, simulated times and refined orders).
The batched evaluators' float32 pair scoring runs in PyTorch on a
chosen device.
"""

from .resources import (GTX580, TPU_V5E_UNIT, DeviceModel, KernelProfile,
                        bs_kernel, ep_kernel, es_kernel, sw_kernel)
from .scorer import (combined_ratio, fits_alone, fits_together, pair_score,
                     profile_combine, score_matrix, score_vector)
from .scheduler import (Round, Schedule, exhaustive_search, greedy_order,
                        percentile_rank, random_orders)
from .simulator import (EventCheckpoint, EventSimulator, RoundCheckpoint,
                        RoundSimulator, simulate)
from .experiments import EXPERIMENTS, experiment
from .fastscore import (ProfileTable, greedy_order_fast, pair_score_matrix,
                        score_matrix_fast, warm_start_insert)
from .refine import (DeltaEvaluator, DeltaRoundEvaluator, refine_order,
                     refined_schedule)
from .batched import (BatchedEventSim, BatchedRoundSim, PackedKernels,
                      audit_pair_scores, pair_score_matrix_batched,
                      refine_order_batched)
from .tpu import (TpuWorkItem, compose_rounds, decode_profile, fifo_rounds,
                  make_serving_device, prefill_profile, round_time)

__all__ = [
    "GTX580", "TPU_V5E_UNIT", "DeviceModel", "KernelProfile",
    "bs_kernel", "ep_kernel", "es_kernel", "sw_kernel",
    "combined_ratio", "fits_alone", "fits_together", "pair_score",
    "profile_combine", "score_matrix", "score_vector",
    "Round", "Schedule", "exhaustive_search", "greedy_order",
    "percentile_rank", "random_orders",
    "EventCheckpoint", "EventSimulator", "RoundCheckpoint",
    "RoundSimulator", "simulate",
    "EXPERIMENTS", "experiment",
    "ProfileTable", "greedy_order_fast", "pair_score_matrix",
    "score_matrix_fast", "warm_start_insert",
    "DeltaEvaluator", "DeltaRoundEvaluator", "refine_order",
    "refined_schedule",
    "BatchedEventSim", "BatchedRoundSim", "PackedKernels",
    "audit_pair_scores", "pair_score_matrix_batched",
    "refine_order_batched",
    "TpuWorkItem", "compose_rounds", "decode_profile", "fifo_rounds",
    "make_serving_device", "prefill_profile", "round_time",
]
