"""TPU adaptation of the paper's reordering idea.

A TPU core has no notion of concurrent kernel co-residency: one XLA
program owns the chip.  The transferable insight of the paper is
*symbiotic round packing* — group independent work items into
sequential "rounds" so that every round (a) saturates the bounding
resource dimensions evenly, and (b) mixes compute-bound with
memory-bound work so the round's arithmetic intensity lands near the
hardware balance point ``R_B = peak_FLOPs / HBM_bw``.

On TPU the natural unit of independent work is a *serving micro-batch
entry* (a prefill chunk is compute-bound, a decode step is
memory-bound) or a *pipeline task* (a gradient all-reduce bucket is
interconnect-bound, a backward matmul is compute-bound).  This module
maps such tasks onto :class:`KernelProfile` so the unmodified
Algorithm 1 composes the rounds; the serving engine
(:mod:`repro.serve.scheduler`) and the overlap scheduler
(:mod:`repro.train.overlap`) build on it.

The PyTorch port keeps this cost model unchanged: the rounds it composes
and the ``modelled_time_s`` it reports are the v5e model's, from the
model's inputs in :data:`TPU_V5E_UNIT`, not times measured on the card
that executes the requests.

Resource dimensions for a serving round on a v5e core:

* ``hbm``   — bytes the round's working set streams from HBM (weights are
  counted once per round, KV reads per request),
* ``vmem``  — peak on-chip residency claimed by the round's kernels,
* ``slots`` — token budget per round (compiled batch geometry).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from .fastscore import greedy_order_fast
from .resources import TPU_V5E_UNIT, DeviceModel, KernelProfile
from .scheduler import Schedule, greedy_order

__all__ = [
    "TpuWorkItem",
    "prefill_profile",
    "decode_profile",
    "make_serving_device",
    "compose_rounds",
]


@dataclass(frozen=True)
class TpuWorkItem:
    """An independent unit of TPU work with a roofline cost model.

    ``hbm_bytes`` is the item's *marginal* HBM traffic; the shared
    weight stream is a per-round fixed cost (see :func:`round_time`).
    ``intensity_hint`` is the standalone arithmetic intensity used as
    the paper's ``R_i`` (it includes the weight stream the item would
    pay alone, which is what makes decode memory-bound)."""

    name: str
    flops: float
    hbm_bytes: float
    vmem_bytes: float
    tokens: int
    intensity_hint: float | None = None
    #: Weight bytes THIS item's computation streams (a layer stage's
    #: parameter share, bf16).  0.0 for whole-request items, whose
    #: shared weight stream the engine charges per round via
    #: ``round_time(..., weights_bytes)``; per-stage items from
    #: ``repro.graph.trace_arch`` carry their own share so a round's
    #: weight traffic can be summed over the *distinct* stages present
    #: (co-scheduled copies of one stage share its stream).
    weight_bytes: float = 0.0

    @property
    def intensity(self) -> float:
        if self.intensity_hint is not None:
            return self.intensity_hint
        return self.flops / max(self.hbm_bytes, 1.0)

    def profile(self) -> KernelProfile:
        return KernelProfile(
            name=self.name,
            n_blocks=1,
            demands={"vmem": self.vmem_bytes, "hbm": self.hbm_bytes,
                     "slots": float(self.tokens)},
            inst_per_block=self.flops,
            r=self.intensity,
        )


def prefill_profile(name: str, *, n_params: float, seq_len: int,
                    kv_bytes_per_token: float,
                    vmem_tile_bytes: float = 8 << 20) -> TpuWorkItem:
    """A prefill chunk: ~2*N*s FLOPs; *marginal* HBM traffic is the KV
    it writes plus its activation working set.  The weight stream is a
    per-round fixed cost (shared by every co-scheduled item) and is
    accounted by :func:`round_time`, not per item.

    Strongly compute-bound: intensity ~ 2*N / (weights/round) >> R_B.
    """
    flops = 2.0 * n_params * seq_len
    hbm = seq_len * kv_bytes_per_token * 2.0  # KV write + activation traffic
    r = 2.0 * n_params * seq_len / (2.0 * n_params + hbm)
    return TpuWorkItem(name, flops=flops, hbm_bytes=hbm,
                       vmem_bytes=vmem_tile_bytes, tokens=seq_len,
                       intensity_hint=r)


def decode_profile(name: str, *, n_params: float, kv_len: int,
                   kv_bytes_per_token: float,
                   vmem_tile_bytes: float = 4 << 20) -> TpuWorkItem:
    """One decode token: 2*N FLOPs; marginal HBM traffic is its KV-cache
    read.  Intensity (counting the shared weight stream it would incur
    alone) ~ 1: strongly memory-bound."""
    flops = 2.0 * n_params + 2.0 * kv_len * kv_bytes_per_token / 2.0
    hbm = kv_len * kv_bytes_per_token
    r = flops / (2.0 * n_params + hbm)
    return TpuWorkItem(name, flops=flops, hbm_bytes=hbm,
                       vmem_bytes=vmem_tile_bytes, tokens=1,
                       intensity_hint=r)


def round_time(items: Sequence["TpuWorkItem"], device: DeviceModel,
               weights_bytes: float) -> float:
    """Occupancy-adjusted roofline time of ONE execution round.

    The weight stream is charged once per round — the sharing that
    makes symbiotic prefill+decode rounds pay off.  Memory streams
    (weights, KV) are long contiguous DMA reads and saturate HBM at any
    batch size; occupancy (token rows) only gates the MXU."""
    if not items:
        return 0.0
    sum_c = sum(it.flops for it in items)
    sum_m = weights_bytes + sum(it.hbm_bytes for it in items)
    used = {device.sat_dim: float(sum(it.tokens for it in items))}
    eff_c = max(device.compute_efficiency(used), 1e-9)
    return max(sum_c / (device.compute_rate * eff_c),
               sum_m / device.mem_bw)


def schedule_time(rounds: Sequence[Sequence["TpuWorkItem"]],
                  device: DeviceModel, weights_bytes: float) -> float:
    return sum(round_time(r, device, weights_bytes) for r in rounds)


def fifo_rounds(items: Sequence["TpuWorkItem"],
                device: DeviceModel) -> list[list["TpuWorkItem"]]:
    """Arrival-order round packing (the baseline scheduler)."""
    rounds: list[list[TpuWorkItem]] = []
    cur: list[TpuWorkItem] = []
    used = {d: 0.0 for d in device.caps}
    for it in items:
        dem = it.profile().demands
        fits = all(used[k] + dem[k] <= device.cap(k) for k in used)
        if not fits and cur:
            rounds.append(cur)
            cur, used = [], {d: 0.0 for d in device.caps}
        cur.append(it)
        for k in used:
            used[k] += dem[k]
    if cur:
        rounds.append(cur)
    return rounds


def make_serving_device(*, hbm_round_budget: float = 8 << 30,
                        token_budget: int = 4096,
                        vmem_budget: float = 96 << 20,
                        n_units: int = 1) -> DeviceModel:
    """A v5e core viewed as one execution unit for round composition.

    ``n_units > 1`` models a multi-core serving slice (a v5e-N pod
    slice): every core carries its own budgets (``caps`` are per unit)
    and its own roofline rates; the event dispatcher round-robins work
    items across cores while dependent chains serialize through the
    ready-set gate (:class:`repro.graph.streams.DagEventSimulator`).
    This is the regime where the paper's placement effects exist at
    all — per-core load imbalance and under-occupancy make the gated
    makespan genuinely order-sensitive, which single-core round
    composition (aligned rounds, one unit) is blind to.
    """
    base = TPU_V5E_UNIT
    return DeviceModel(
        name=("tpu_v5e_round" if n_units == 1
              else f"tpu_v5e_round_x{n_units}"),
        n_units=n_units,
        caps={"vmem": vmem_budget, "hbm": hbm_round_budget,
              "slots": float(token_budget)},
        max_resident=token_budget,
        compute_rate=base.compute_rate,
        mem_bw=base.mem_bw,
        r_balanced=base.r_balanced,
        sat_dim=base.sat_dim,
        sat_compute=base.sat_compute,
        sat_memory=base.sat_memory,
        # TPU-tuned ScoreGen weights (see DeviceModel docstring).
        r_weight=4.0,
        residual_weight=0.5,
        combined_r="harmonic",
    )


def compose_rounds(items: Sequence[TpuWorkItem],
                   device: DeviceModel | None = None,
                   method: str = "fast") -> Schedule:
    """Run the paper's Algorithm 1 over TPU work items.

    Returns the round-structured schedule; the serving engine executes
    one round per ``serve_step`` dispatch.  ``method="fast"`` (default)
    uses the incremental vectorized scheduler
    (:mod:`repro_torch.core.fastscore`), which produces identical rounds to
    ``method="reference"`` in ``O(n^2)`` instead of ``O(R * n^2)``
    Python-level ScoreGen reruns — the difference between microseconds
    and seconds per serving step at production queue depths.
    ``method="reference"`` runs the pure-Python test-only oracle and
    exists solely for equivalence checks; no production caller should
    select it.
    """
    device = device or make_serving_device()
    profiles = [it.profile() for it in items]
    if method == "reference":
        return greedy_order(profiles, device)
    return greedy_order_fast(profiles, device)
