"""Mesh construction (the port of the reference's ``repro.launch.mesh``).

Functions, not module-level constants, so importing this module starts
no process group.  Single pod: 16 x 16 = 256 ranks, axes ("data",
"model").  Multi-pod: 2 x 16 x 16 = 512 ranks, axes ("pod", "data",
"model"); "pod" is pure data parallelism.  The production meshes need
that many ranks (``torchrun``); in any other world size they raise and
never fall back to one device.  :func:`production_mesh_spec` describes
the same shapes with no process behind them (the dry run).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..dist.context import MeshSpec

__all__ = ["make_production_mesh", "make_host_mesh", "production_mesh_spec"]

_PRODUCTION = {False: ((16, 16), ("data", "model")),
               True: ((2, 16, 16), ("pod", "data", "model"))}


def production_mesh_spec(*, multi_pod: bool = False) -> MeshSpec:
    shape, axes = _PRODUCTION[multi_pod]
    return MeshSpec(axes, shape)


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _device_id(device: torch.device):
    if device.type != "cuda":
        return None
    return torch.device("cuda", torch.cuda.current_device()
                        if device.index is None else device.index)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The 16 x 16 (or 2 x 16 x 16) DeviceMesh over every rank of the
    job.  Joins the ``env://`` process group that ``torchrun`` describes
    if none is up; raises ``ValueError`` unless the world has exactly
    256 (512) ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = _PRODUCTION[multi_pod]
    need = 1
    for s in shape:
        need *= s
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if world != need:
        raise ValueError(
            f"the {'x'.join(map(str, shape))} production mesh needs a world "
            f"of {need} ranks (torchrun --nproc-per-node ... over the job's "
            f"hosts); this one has {world}")
    dev = torch.device(device)
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(_backend(dev), init_method="env://",
                                device_id=_device_id(dev))
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_host_mesh(device="cuda"):
    """A 1 x 1 ("data", "model") DeviceMesh over the current device
    (tests, examples, one card).  Starts a world-1 process group first
    if there is none: NCCL on ``cuda``, gloo on the CPU, over an
    in-process store, so no environment variable is needed."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = torch.device(device)
    if not dist.is_initialized():
        dist.init_process_group(_backend(dev), store=dist.HashStore(),
                                rank=0, world_size=1,
                                device_id=_device_id(dev))
    if dist.get_world_size() != 1:
        raise ValueError(f"the host mesh is one rank; this world has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(dev.type, (1, 1), mesh_dim_names=("data", "model"))
