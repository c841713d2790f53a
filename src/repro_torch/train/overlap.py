"""Compute/communication overlap scheduling for training (the port of
the reference's ``repro.train.overlap``: host code, the same orders and
times).

The training-side use of the paper's reordering insight: gradient
all-reduce buckets (interconnect-bound, intensity ~0) and backward
compute tasks (compute-bound) are independent work items within a step
window.  Ordering bucket launches so each "round" pairs a comm-bound
bucket with compute-bound work keeps both the ICI links and the MXU
busy — the same ScoreGen machinery composes the schedule.

On the XLA side the actual overlap is performed by the latency-hiding
scheduler once collectives are *emitted in the chosen order*; this
module decides bucket membership and launch order, and provides a
roofline estimate of exposed (non-overlapped) communication time for
the chosen schedule, which the tests assert improves on naive ordering.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from ..core import DeviceModel, KernelProfile, greedy_order_fast

__all__ = ["CommTask", "ComputeTask", "make_overlap_device",
           "overlap_schedule", "exposed_comm_time"]


@dataclass(frozen=True)
class ComputeTask:
    name: str
    flops: float


@dataclass(frozen=True)
class CommTask:
    name: str
    bytes: float


def make_overlap_device(*, peak_flops: float = 197e12,
                        link_bw: float = 50e9) -> DeviceModel:
    """One 'execution unit' whose two resources are MXU time and link
    time; R is flops/byte so compute tasks sit far above R_B and comm
    tasks far below — the paper's mixing rule pairs them."""
    return DeviceModel(
        name="overlap", n_units=1,
        caps={"slots": 64.0},
        max_resident=64,
        compute_rate=peak_flops,
        mem_bw=link_bw,
        r_balanced=peak_flops / link_bw,
        r_weight=4.0, residual_weight=0.5,
        combined_r="harmonic",
    )


def _profile(task, device) -> KernelProfile:
    if isinstance(task, ComputeTask):
        return KernelProfile(task.name, 1, {"slots": 1.0},
                             inst_per_block=task.flops,
                             r=1e9)          # pure compute
    return KernelProfile(task.name, 1, {"slots": 1.0},
                         inst_per_block=task.bytes * 1e-9,
                         r=1e-9)             # pure comm ("memory" = link)


def overlap_schedule(tasks: Sequence, device: DeviceModel | None = None
                     ) -> list[str]:
    """Launch order (task names) from Algorithm 1."""
    device = device or make_overlap_device()
    profs = [_profile(t, device) for t in tasks]
    sched = greedy_order_fast(profs, device)
    return [k.name for k in sched.order]


def exposed_comm_time(order: Sequence[str], tasks: Sequence,
                      device: DeviceModel | None = None,
                      window: int = 2) -> float:
    """Roofline estimate of non-overlapped communication: tasks are
    issued in ``order``; within each consecutive window the comm time
    hides under compute time, max(c, m); across windows it serialises."""
    device = device or make_overlap_device()
    by = {t.name: t for t in tasks}
    total = 0.0
    for i in range(0, len(order), window):
        grp = [by[n] for n in order[i:i + window]]
        c = sum(t.flops for t in grp if isinstance(t, ComputeTask))
        m = sum(t.bytes for t in grp if isinstance(t, CommTask))
        total += max(c / device.compute_rate, m / device.mem_bw)
    return total
