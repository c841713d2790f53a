"""Resource models for concurrent-kernel scheduling.

Faithful port of the resource abstraction in

    Li, Narayana, El-Ghazawi, "Reordering GPU Kernel Launches to Enable
    Efficient Concurrent Execution", 2015.

The paper characterises a GPU as a set of identical execution units
("streaming multiprocessors", SMs) with per-unit capacities
(registers, shared memory, warps, resident blocks) and a *balanced*
instructions/bytes ratio ``R_B``.  Each kernel is characterised by a
resource-demand vector and an instructions/bytes ratio ``R_i``.

We generalise the resource vector to a named mapping so the identical
algorithm drives both

* the faithful GPU reproduction (dims: ``shm``, ``reg``, ``warp``), and
* the TPU adaptation (dims: ``vmem``, ``hbm``, ``slots``) used by the
  serving-round composer (see :mod:`repro_torch.core.tpu`).

All capacities are *per execution unit*; kernels report *per block*
demands plus a block count, and the per-unit aggregate demand assumes
the round-robin block distribution described in the paper (``ceil(n_blocks
/ n_units)`` blocks per unit).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Mapping

__all__ = [
    "DeviceModel",
    "KernelProfile",
    "GTX580",
    "TPU_V5E_UNIT",
    "ep_kernel",
    "bs_kernel",
    "es_kernel",
    "sw_kernel",
]


@dataclass(frozen=True)
class DeviceModel:
    """A device made of ``n_units`` identical execution units.

    ``caps`` holds the per-unit capacity of every schedulable resource
    dimension.  ``max_resident`` caps the number of co-resident blocks
    per unit (``N_blk_SM``).  ``compute_rate`` is work-units/sec/unit
    (instructions for the GPU model, FLOPs for the TPU model) and
    ``mem_bw`` is bytes/sec/unit.  ``r_balanced`` is the ratio deemed
    "balanced" by the vendor (``R_B``); for a roofline-consistent model
    it equals ``compute_rate / mem_bw`` in the profile's ratio units.
    """

    name: str
    n_units: int
    caps: Mapping[str, float]
    max_resident: int
    compute_rate: float
    mem_bw: float
    r_balanced: float
    #: Occupancy model: execution units are latency-hiding machines and
    #: only reach peak throughput when enough independent work is
    #: resident.  ``sat_dim`` names the resource dimension that measures
    #: parallel slack (warps on a GPU, token slots on a TPU).  ALU/MXU
    #: pipelines saturate with much less parallelism (``sat_compute``)
    #: than the memory system, whose long latency needs far more
    #: in-flight work to hide (``sat_memory``) — the asymmetry that
    #: makes lone memory-bound kernels the worst co-tenants and is the
    #: physical reason the paper's compute/memory mixing pays off.
    sat_dim: str = ""
    sat_compute: float = 1.0
    sat_memory: float = 1.0
    #: ScoreGen term weights.  The paper weights every residual-capacity
    #: term and the R-mixing term equally (1.0) — keep that for the GPU
    #: reproduction.  The TPU serving device up-weights the R term: with
    #: a single binding capacity (token slots) the residual terms
    #: otherwise dominate and the greedy degenerates to
    #: smallest-items-first, starving compute/memory mixing.
    r_weight: float = 1.0
    residual_weight: float = 1.0
    #: How the combined ratio of co-scheduled kernels is estimated:
    #: "block_mean" is the paper's block-weighted average of R_i;
    #: "harmonic" is the physically-correct total-work/total-bytes
    #: (needed when intensities span orders of magnitude, e.g. the
    #: TPU comm-vs-compute overlap scheduler).
    combined_r: str = "block_mean"

    def cap(self, dim: str) -> float:
        return self.caps[dim]

    def _occupancy(self, used: Mapping[str, float]) -> float:
        return used.get(self.sat_dim, 0.0) if self.sat_dim else float("inf")

    def _has_occupancy_model(self) -> bool:
        # A sat_dim that is not a tracked capacity can never accumulate
        # occupancy, so treating it as an occupancy model would pin
        # every efficiency at 0 (~1e12x slowdowns).  Such a device has
        # no usable occupancy signal: run at peak.  Mirrored exactly by
        # the vectorized simulators (repro.core.refine) and pinned by
        # tests/test_fastscore.py::test_sat_dim_configs_match_reference.
        return bool(self.sat_dim) and self.sat_dim in self.caps

    def compute_efficiency(self, used: Mapping[str, float]) -> float:
        if not self._has_occupancy_model():
            return 1.0
        return min(1.0, self._occupancy(used) / self.sat_compute)

    def memory_efficiency(self, used: Mapping[str, float]) -> float:
        if not self._has_occupancy_model():
            return 1.0
        return min(1.0, self._occupancy(used) / self.sat_memory)


@dataclass(frozen=True)
class KernelProfile:
    """Per-kernel profiling record (one row of the paper's Table 1).

    ``demands`` are per *block*; ``n_blocks`` is the grid size.
    ``inst_per_block`` is total work units per block and ``r`` the
    instructions/bytes ratio, so a block's memory traffic is
    ``inst_per_block / r`` byte-units (the paper measures R in
    instructions per 4-byte transaction; the simulator is agnostic to
    the unit as long as ``mem_bw`` uses the same one).
    """

    name: str
    n_blocks: int
    demands: Mapping[str, float]
    inst_per_block: float
    r: float
    #: When set, ``demands`` is already a per-unit aggregate (virtual
    #: combined kernels produced by ProfileCombine) and holds the number
    #: of resident blocks per unit it represents.
    agg_blocks_per_unit: int | None = None

    def blocks_per_unit(self, device: DeviceModel) -> int:
        if self.agg_blocks_per_unit is not None:
            return self.agg_blocks_per_unit
        return math.ceil(self.n_blocks / device.n_units)

    def per_unit_demand(self, device: DeviceModel) -> dict[str, float]:
        """Aggregate per-unit demand under round-robin distribution."""
        if self.agg_blocks_per_unit is not None:
            return dict(self.demands)
        b = self.blocks_per_unit(device)
        return {k: v * b for k, v in self.demands.items()}

    def mem_per_block(self) -> float:
        return self.inst_per_block / self.r

    def with_name(self, name: str) -> "KernelProfile":
        return replace(self, name=name)


# ---------------------------------------------------------------------------
# Concrete device models
# ---------------------------------------------------------------------------

#: NVIDIA GTX 580 (Fermi GF110) exactly as characterised in the paper:
#: 16 SMs, 32K registers / 48KB shared memory / 48 warps / 8 blocks per SM,
#: R_B = 4.11.  ``compute_rate`` is chosen so the roofline balance point
#: matches R_B with the memory system's per-SM bandwidth (192 GB/s / 16 SMs
#: = 12 GB/s => 3e9 4-byte transactions/s => 4.11 * 3e9 inst/s).
GTX580 = DeviceModel(
    name="gtx580",
    n_units=16,
    caps={"shm": 48 * 1024, "reg": 32 * 1024, "warp": 48},
    max_resident=8,
    compute_rate=4.11 * 3.0e9,
    mem_bw=3.0e9,  # 4-byte transactions/sec/SM (12 GB/s)
    r_balanced=4.11,
    sat_dim="warp",
    sat_compute=12.0,  # ALU pipelines saturate with ~12 resident warps
    sat_memory=30.0,   # DRAM latency needs ~30 warps in flight to hide
)

#: TPU v5e modelled as a single large execution unit for the serving-round
#: composer.  The rates below (197 TFLOP/s bf16, 819 GB/s HBM, ~128 MiB
#: VMEM; R_B = 197e12 / 819e9 = 240.5 FLOPs/byte) are the cost model's
#: inputs, kept equal to the reference package's so both compose the same
#: rounds; they are not measurements of any card the port runs on.
#: ``slots`` is a per-round token budget (set by the serving engine),
#: ``hbm`` a per-round working-set budget.
TPU_V5E_UNIT = DeviceModel(
    name="tpu_v5e",
    n_units=1,
    caps={"vmem": 128 * 1024 * 1024, "hbm": 16 * 1024**3, "slots": 4096},
    max_resident=4096,
    compute_rate=197e12,
    mem_bw=819e9,
    r_balanced=197e12 / 819e9,
    sat_dim="slots",
    sat_compute=512.0,  # MXU wants >=512 row-slots per round
    sat_memory=16.0,    # HBM DMA streams saturate with few requests
)


# ---------------------------------------------------------------------------
# Benchmark kernel profiles (Table 2 of the paper)
# ---------------------------------------------------------------------------
#
# The paper profiles four applications on the GTX 580 with the CUDA
# profiler.  Absolute instruction counts are not published; we pick
# counts that give standalone execution times of the right order of
# magnitude (tens of ms) while preserving the published inst/bytes
# ratios, grid/block geometry and resource footprints.  Everything the
# *algorithm* consumes (demand vectors + R_i) is as published.

def _mk(name: str, *, grid: int, block: int, regs_per_thread: int,
        shm: int, r: float, inst: float) -> KernelProfile:
    warps = block // 32
    return KernelProfile(
        name=name,
        n_blocks=grid,
        demands={"shm": float(shm), "reg": float(regs_per_thread * block),
                 "warp": float(warps)},
        inst_per_block=inst,
        r=r,
    )


def ep_kernel(name: str = "EP", *, grid: int = 16, block: int = 128,
              shm: int = 0, inst: float = 60e6) -> KernelProfile:
    """NPB EP (M=24): memory-bound, R = 3.11 < R_B."""
    return _mk(name, grid=grid, block=block, regs_per_thread=21, shm=shm,
               r=3.11, inst=inst)


def bs_kernel(name: str = "BS", *, grid: int = 32, block: int = 128,
              shm: int = 0, inst: float = 220e6) -> KernelProfile:
    """BlackScholes (4M options): compute-bound, R = 11.1 > R_B."""
    return _mk(name, grid=grid, block=block, regs_per_thread=24, shm=shm,
               r=11.1, inst=inst)


def es_kernel(name: str = "ES", *, grid: int = 48, block: int = 256,
              shm: int = 8 * 1024, inst: float = 150e6) -> KernelProfile:
    """VMD Electrostatics (40K atoms): strongly compute-bound."""
    return _mk(name, grid=grid, block=block, regs_per_thread=28, shm=shm,
               r=20.0, inst=inst)


def sw_kernel(name: str = "SW", *, grid: int = 32, block: int = 128,
              shm: int = 16 * 1024, inst: float = 45e6) -> KernelProfile:
    """Smith-Waterman: strongly memory-bound."""
    return _mk(name, grid=grid, block=block, regs_per_thread=18, shm=shm,
               r=1.6, inst=inst)
