"""Host scheduler core: Algorithm 1 (launch reordering) and the serving
round cost model, copied from the reference package's ``repro.core``.

This is NumPy host code; the port keeps it bit-identical to the
reference (same orders, rounds and modelled times).  The simulators,
the refiners and the batched evaluators come with later slices.
"""

from .resources import (GTX580, TPU_V5E_UNIT, DeviceModel, KernelProfile,
                        bs_kernel, ep_kernel, es_kernel, sw_kernel)
from .scorer import (combined_ratio, fits_alone, fits_together, pair_score,
                     profile_combine, score_matrix, score_vector)
from .scheduler import (Round, Schedule, exhaustive_search, greedy_order,
                        percentile_rank, random_orders)
from .fastscore import (ProfileTable, greedy_order_fast, pair_score_matrix,
                        score_matrix_fast, warm_start_insert)
from .tpu import (TpuWorkItem, compose_rounds, decode_profile, fifo_rounds,
                  make_serving_device, prefill_profile, round_time)

__all__ = [
    "GTX580", "TPU_V5E_UNIT", "DeviceModel", "KernelProfile",
    "bs_kernel", "ep_kernel", "es_kernel", "sw_kernel",
    "combined_ratio", "fits_alone", "fits_together", "pair_score",
    "profile_combine", "score_matrix", "score_vector",
    "Round", "Schedule", "exhaustive_search", "greedy_order",
    "percentile_rank", "random_orders",
    "ProfileTable", "greedy_order_fast", "pair_score_matrix",
    "score_matrix_fast", "warm_start_insert",
    "TpuWorkItem", "compose_rounds", "decode_profile", "fifo_rounds",
    "make_serving_device", "prefill_profile", "round_time",
]
