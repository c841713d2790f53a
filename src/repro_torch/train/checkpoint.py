"""Atomic, async checkpointing (the port of the reference's
``repro.train.checkpoint``), in the reference's on-disk layout::

    <dir>/step_000123/
        MANIFEST.json           # step, extra (data-pipeline state),
                                # n_hosts, every leaf's key, shape, dtype
        shard_<host>.npz        # the host's flattened leaves
    <dir>/LATEST                # atomic pointer file

* **atomic publish** — shards are written to ``step_*.tmp`` and the
  directory is renamed before ``LATEST`` is swapped, so a killed host
  never leaves a half-checkpoint visible,
* **async save** — :class:`AsyncCheckpointer` copies the tensors to the
  host on the caller's thread and writes them on its own thread,
* bf16 leaves are stored as f32 (npz has no bf16), with the dtype in
  the manifest.

Leaf keys are the tree paths joined by "/" (dict keys in sorted order,
as the reference's).  :func:`restore_checkpoint` casts each leaf to its
target's dtype and device; it finds a leaf by its key, so a target may
leave out subtrees (``{"params": p, "opt": None}``).  With
``shardings`` (a tree of :class:`repro_torch.dist.sharding.NamedSharding`
matching the target) each leaf comes back as a DTensor on that mesh,
built from this rank's block of the saved array: a checkpoint saved on
one mesh restores onto another (elastic restart).  DTensor leaves are
saved whole (every rank gathers them; rank 0 writes).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from ..pytree import flatten, path_str, tree_map, unflatten

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "AsyncCheckpointer"]

PyTree = Any


def _dtype_name(v) -> str:
    if isinstance(v, torch.Tensor):
        return str(v.dtype).removeprefix("torch.")
    return str(np.asarray(v).dtype)


def _is_dtensor(v) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(v, DTensor)


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _host_copy(x):
    """A consistent host snapshot of one leaf; a DTensor is gathered whole
    (a collective: every rank calls it)."""
    if isinstance(x, torch.Tensor):
        if _is_dtensor(x):
            x = x.full_tensor()
        return x.detach().to("cpu", copy=True)
    return np.asarray(x)


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        if _is_dtensor(v):
            v = v.full_tensor()
        t = v.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()              # npz-portable; dtype in manifest
        return t.numpy()
    a = np.asarray(v)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return a


def latest_step(ckpt_dir: str) -> int | None:
    ptr = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        txt = f.read().strip()
    return int(txt) if txt else None


def save_checkpoint(ckpt_dir: str, step: int, tree: PyTree,
                    extra: dict | None = None, host_id: int = 0,
                    n_hosts: int = 1) -> str:
    """Synchronous save with atomic publish."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)

    leaves = [(path_str(p), v) for p, v in flatten(tree)]
    manifest = {
        "step": step,
        "extra": extra or {},
        "n_hosts": n_hosts,
        "leaves": [{"key": k, "shape": list(v.shape),
                    "dtype": _dtype_name(v)} for k, v in leaves],
    }
    arrays = {f"leaf_{i}": _to_numpy(v) for i, (_, v) in enumerate(leaves)}
    np.savez(os.path.join(tmp, f"shard_{host_id}.npz"), **arrays)
    if host_id == 0:
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
    # Atomic publish.
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    with open(os.path.join(ckpt_dir, "LATEST.tmp"), "w") as f:
        f.write(str(step))
    os.replace(os.path.join(ckpt_dir, "LATEST.tmp"),
               os.path.join(ckpt_dir, "LATEST"))
    return final


def _restore_leaf(arr: np.ndarray, tgt, dtype_name: str):
    t = torch.from_numpy(arr)
    if isinstance(tgt, torch.Tensor):
        return t.to(device=tgt.device, dtype=tgt.dtype)
    return t.to(getattr(torch, dtype_name))


def _restore_sharded(arr: np.ndarray, tgt, dtype_name: str, sharding):
    """A DTensor placed by ``sharding`` from this rank's block of the
    saved array, cut on the host before it moves to the device."""
    from torch.distributed.tensor import DTensor
    from ..dist.sharding import local_block
    dtype = (tgt.dtype if isinstance(tgt, torch.Tensor)
             else getattr(torch, dtype_name))
    mesh, pls = sharding.mesh, sharding.placements
    device = (torch.device("cuda", torch.cuda.current_device())
              if mesh.device_type == "cuda" else torch.device("cpu"))
    whole = torch.from_numpy(arr)
    block = local_block(whole, mesh, pls).to(device=device, dtype=dtype)
    return DTensor.from_local(block.contiguous(), mesh, pls,
                              shape=whole.shape, stride=whole.stride())


def restore_checkpoint(ckpt_dir: str, target: PyTree, step: int | None = None,
                       shardings: PyTree | None = None, host_id: int = 0
                       ) -> tuple[PyTree, dict]:
    """Restore into the structure of ``target`` (leaves cast to the
    target's dtype and device) -> (tree, the manifest's ``extra``).
    ``shardings``: a tree of ``NamedSharding`` matching ``target``; each
    leaf is then a DTensor holding this rank's block."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "MANIFEST.json")) as f:
        manifest = json.load(f)
    index = {leaf["key"]: (i, leaf["dtype"])
             for i, leaf in enumerate(manifest["leaves"])}
    flat = [(path_str(p), v) for p, v in flatten(target)]
    missing = [k for k, _ in flat if k not in index]
    if missing:
        raise KeyError(f"checkpoint {d} has no leaves {missing[:4]} "
                       f"({len(missing)} of the target's {len(flat)})")
    shards = ([s for _, s in flatten(shardings)] if shardings is not None
              else [None] * len(flat))
    if len(shards) != len(flat):
        raise ValueError(f"shardings has {len(shards)} leaves, the target "
                         f"{len(flat)}")
    with np.load(os.path.join(d, f"shard_{host_id}.npz")) as data:
        leaves = [_restore_leaf(data[f"leaf_{index[k][0]}"], tgt, index[k][1])
                  if shd is None else
                  _restore_sharded(data[f"leaf_{index[k][0]}"], tgt,
                                   index[k][1], shd)
                  for (k, tgt), shd in zip(flat, shards)]
    return unflatten(target, leaves), manifest["extra"]


class AsyncCheckpointer:
    """Fire-and-forget saves on a background thread (one in flight)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.last_saved: int | None = None

    def save(self, step: int, tree: PyTree, extra: dict | None = None
             ) -> None:
        self.wait()
        # The device -> host copy on the caller's thread (a consistent
        # snapshot), the write on the background thread, by rank 0 only.
        host_tree = tree_map(_host_copy, tree)
        if _rank() != 0:
            return

        def run():
            save_checkpoint(self.ckpt_dir, step, host_tree, extra)
            self.last_saved = step
            self._gc()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        if not os.path.isdir(self.ckpt_dir):
            return
        steps = sorted(int(d.split("_")[1])
                       for d in os.listdir(self.ckpt_dir)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)
