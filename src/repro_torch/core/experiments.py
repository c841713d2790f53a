"""The six concurrent-kernel experiments of the paper (Table 2).

Each experiment is a list of :class:`KernelProfile` for the GTX 580
device model.  Geometry, shared-memory footprints, warp counts and
inst/bytes ratios follow Table 2; absolute instruction counts are
scaled so the standalone times have the same order of magnitude as the
published tables (the algorithm never sees them).
"""

from __future__ import annotations

from typing import Callable

from .resources import (GTX580, KernelProfile, bs_kernel, ep_kernel,
                        es_kernel, sw_kernel)

__all__ = ["EXPERIMENTS", "experiment"]


def _ep_6_shm() -> list[KernelProfile]:
    # Six EP kernels, grid 16 x block 128, shm 8K..48K (per SM == per block).
    return [ep_kernel(f"EP-shm{s // 1024}K", shm=s)
            for s in (8192, 16384, 24576, 32768, 40960, 49152)]


def _ep_6_grid() -> list[KernelProfile]:
    # Warps/SM 4..24 via grid 16..96; work scales with grid size.
    return [ep_kernel(f"EP-g{g}", grid=g, inst=60e6)
            for g in (16, 32, 48, 64, 80, 96)]


def _bs_6_blk() -> list[KernelProfile]:
    # Grid 32 (2 blocks/SM); block size 64..1024 => warps/SM 4..64.
    # Per-block work scales with block size (same per-thread work).
    out = []
    for bs in (64, 128, 256, 512, 768, 1024):
        out.append(bs_kernel(f"BS-b{bs}", grid=32, block=bs,
                             inst=220e6 * bs / 128))
    return out


def _epbs_6() -> list[KernelProfile]:
    eps = [ep_kernel(f"EP{i}", grid=16) for i in range(3)]     # 4 warps/SM
    bss = [bs_kernel(f"BS{i}", grid=32, block=192) for i in range(3)]  # 12 w/SM
    return eps + bss


def _epbs_6_shm() -> list[KernelProfile]:
    shms = (16384, 24576, 49152)
    eps = [ep_kernel(f"EP-shm{s // 1024}K", grid=16, shm=s) for s in shms]
    bss = [bs_kernel(f"BS-shm{s // 1024}K", grid=32, block=192, shm=s)
           for s in shms]
    return eps + bss


def _epbsessw_8() -> list[KernelProfile]:
    # Eight kernels, two per application, varying every resource metric.
    # All footprints are individually feasible on an SM (as the CUDA
    # occupancy calculator reports them to the profiler).
    return [
        ep_kernel("EP0", grid=16), ep_kernel("EP1", grid=32, shm=8192),
        bs_kernel("BS0", grid=32, block=192),
        bs_kernel("BS1", grid=48, block=128, shm=4096),
        es_kernel("ES0"),
        es_kernel("ES1", grid=32, shm=12288, inst=190e6),
        sw_kernel("SW0"),
        sw_kernel("SW1", grid=32, shm=12288, inst=90e6),
    ]


EXPERIMENTS: dict[str, Callable[[], list[KernelProfile]]] = {
    "EP-6-shm": _ep_6_shm,
    "EP-6-grid": _ep_6_grid,
    "BS-6-blk": _bs_6_blk,
    "EpBs-6": _epbs_6,
    "EpBs-6-shm": _epbs_6_shm,
    "EpBsEsSw-8": _epbsessw_8,
}


def experiment(name: str) -> list[KernelProfile]:
    return EXPERIMENTS[name]()
