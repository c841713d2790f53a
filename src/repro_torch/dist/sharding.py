"""Placement policies: parameter, batch and cache sharding specs (the port
of the reference's ``repro.dist.sharding``).

One convention everywhere: the mesh axis named ``"model"`` is tensor
parallelism; every other axis is data parallelism (``"data"``, plus
``"pod"`` on multi-pod meshes).  Dimensions are only sharded when they
divide the axis size evenly, so no spec here ever introduces padding.

* ``param_specs(mode="train")`` — TP over ``model`` on the largest
  divisible dimension, then FSDP over the data axes on the largest
  remaining divisible dimension.
* ``param_specs(mode="serve")`` — TP-only *resident* weights.
* ``cache_specs`` — batch dimension over the data axes, the largest
  divisible non-batch dimension over ``model`` (the slots in every 32k
  cell's attention cache).

:func:`tp_spec` is a leaf's ``model`` placement alone (the same in both
modes); :func:`layer_spec_leaves` and :func:`gather_hook` view a spec
tree one layer at a time, for the rank programs that gather one layer's
data-sharded blocks at a time (:mod:`repro_torch.train.sharded`, the dry
run).

The policies are pure functions of leaf shapes and the mesh's axis
names and sizes (:func:`repro_torch.dist.context.mesh_axes`), so they
take a ``DeviceMesh``, a ``MeshSpec`` or any mesh description, and
tensors on any device (``meta`` included).  The port keeps one dict per
layer where the reference stacks repeating layers on a leading
``(reps,)`` axis, so each layer's leaf gets the rule applied to its own
shape: where the reference's rule picks the layer axis, the two layouts
differ by design.

:class:`PartitionSpec` is the port's own tuple of per-dimension entries
(None, an axis name, or a tuple of names); :func:`named` pairs a spec
with a mesh, and :func:`placements` gives the DTensor placements: a
tuple entry such as ``("pod", "data")`` is ``Shard(i)`` on each of those
mesh dims, which DTensor applies in mesh order (pod-major, as in JAX).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from ..pytree import flatten, tree_map, unflatten
from .context import all_gather, mesh_axes

__all__ = [
    "PartitionSpec",
    "NamedSharding",
    "batch_spec",
    "named",
    "placements",
    "local_shape",
    "local_block",
    "gather_block",
    "param_specs",
    "cache_specs",
    "spec_leaves",
    "tp_spec",
    "spec_at",
    "param_groups",
    "layer_spec_leaves",
    "gather_hook",
    "under",
    "serve_weights_resident",
]

#: HBM of one H100 SXM (NVIDIA's data sheet: 80 GB)
H100_HBM_BYTES = 80e9


class PartitionSpec(tuple):
    """Per-dimension mesh axes of one array: ``P(None, "model")``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


def _entry_axes(e) -> tuple[str, ...]:
    if e is None:
        return ()
    return tuple(e) if isinstance(e, (tuple, list)) else (e,)


def placements(mesh, spec: PartitionSpec) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(i)`` on each
    mesh dim that tensor dim ``i`` names, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for a in mesh_axes(mesh):
        dims = [i for i, e in enumerate(spec) if a in _entry_axes(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def local_shape(shape, spec: PartitionSpec, mesh) -> tuple[int, ...]:
    """The shape of one rank's block of an array of ``shape``."""
    sizes = mesh_axes(mesh)
    out = list(shape)
    for i, e in enumerate(spec):
        out[i] //= math.prod(sizes[a] for a in _entry_axes(e))
    return tuple(out)


def local_block(t: torch.Tensor, mesh, pls) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` under the placements
    ``pls`` on the DeviceMesh ``mesh``, split in mesh-dim order as DTensor
    splits it."""
    from torch.distributed.tensor import Shard
    for j, pl in enumerate(pls):
        if isinstance(pl, Shard):
            t = t.chunk(mesh.size(j), pl.dim)[mesh.get_local_rank(j)]
    return t


def gather_block(t: torch.Tensor, spec: PartitionSpec,
                 keep=None) -> torch.Tensor:
    """This rank's block of a leaf placed by ``spec`` all-gathered over
    every axis the spec names but the entry ``keep`` (on the bound mesh):
    the whole leaf, or its rows of ``keep``'s split."""
    for i, e in enumerate(spec):
        if e is not None and e != keep:
            t = all_gather(t, e, dim=i)
    return t


def _dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh_axes(mesh) if a != "model")


def _dp_entry(mesh):
    axes = _dp_axes(mesh)
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def _model_size(mesh) -> int:
    return int(mesh_axes(mesh).get("model", 1))


def _data_size(mesh) -> int:
    sizes = mesh_axes(mesh)
    return math.prod(sizes[a] for a in _dp_axes(mesh))


def batch_spec(mesh) -> PartitionSpec:
    """PartitionSpec whose leading entry is the batch (data) sharding."""
    return P(_dp_entry(mesh))


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def _map_specs(fn, spec_tree):
    if _is_spec(spec_tree):
        return fn(spec_tree)
    if isinstance(spec_tree, dict):
        return {k: _map_specs(fn, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(_map_specs(fn, v) for v in spec_tree)
    if spec_tree is None:
        return None
    raise TypeError(f"not a spec tree leaf: {spec_tree!r}")


def named(mesh, spec_tree):
    """Map a tree of PartitionSpecs to NamedShardings on ``mesh``."""
    return _map_specs(lambda s: NamedSharding(mesh, s), spec_tree)


def _leaf_spec(shape, *, msize: int, dsize: int, dp_entry,
               fsdp: bool) -> PartitionSpec:
    if not shape:
        return P()
    entries: list[Any] = [None] * len(shape)
    order = sorted(range(len(shape)), key=lambda i: shape[i], reverse=True)
    ti = None
    if msize > 1:
        ti = next((i for i in order if shape[i] % msize == 0), None)
        if ti is not None:
            entries[ti] = "model"
    if fsdp and dsize > 1:
        di = next((i for i in order
                   if i != ti and shape[i] % dsize == 0), None)
        if di is not None:
            entries[di] = dp_entry
    return P(*entries)


def _shape(leaf) -> tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()) or ())


def param_specs(params, mesh, mode: str = "train"):
    """Tree of PartitionSpecs matching ``params`` (tensors of any device,
    or anything with a ``shape``)."""
    msize, dsize = _model_size(mesh), _data_size(mesh)
    dp = _dp_entry(mesh)
    fsdp = mode == "train"
    return tree_map(lambda leaf: _leaf_spec(_shape(leaf), msize=msize,
                                            dsize=dsize, dp_entry=dp,
                                            fsdp=fsdp), params)


def spec_leaves(tree, spec_tree) -> list:
    """The specs of ``spec_tree`` (whose leaves are PartitionSpecs, tuples
    that a tree walk would enter) in ``flatten(tree)``'s leaf order."""
    out = []
    for path, _ in flatten(tree):
        node = spec_tree
        for k in path:
            node = node[k]
        out.append(node)
    return out


def tp_spec(shape, msize: int) -> PartitionSpec:
    """The ``model`` placement alone of a leaf of ``shape`` on a ``model``
    axis of ``msize`` ranks: the entry :func:`param_specs` gives it in
    either mode, with no data axis."""
    return _leaf_spec(tuple(shape), msize=msize, dsize=1, dp_entry=None,
                      fsdp=False)


def spec_at(tree, path: tuple):
    """The subtree of ``tree`` (params or specs) at the key path ``path``."""
    for k in path:
        tree = tree[k]
    return tree


def param_groups(params) -> list[tuple]:
    """The key paths of the parameter tree's groups that a rank program
    gathers one at a time: the embedding, each layer in order, the final
    norm and the LM head where there is one."""
    head = [("lm_head",)] if "lm_head" in params else []
    return ([("embed",)] + [("layers", i) for i in
                            range(len(params["layers"]))]
            + [("final_norm",)] + head)


def layer_spec_leaves(params, spec_tree) -> dict[tuple, list]:
    """:func:`spec_leaves` one group at a time: group path (see
    :func:`param_groups`) -> the group's specs in ``flatten`` order of
    its leaves."""
    return {path: spec_leaves(spec_at(params, path),
                              spec_at(spec_tree, path))
            for path in param_groups(params)}


def under(kp: tuple, whole) -> bool:
    """Whether the leaf at key path ``kp`` lies under one of ``whole``'s
    keys (a top-level key) or key paths (tuples)."""
    return any(tuple(kp[:len(w)]) == w if isinstance(w, tuple)
               else kp[0] == w for w in whole)


def gather_hook(spec_tree, keep="model"):
    """The per-layer gather of a rank program whose parameters are its
    blocks placed by ``spec_tree``: ``hook(blocks, path, whole=())``
    returns the group at ``path`` (:func:`param_groups`; any subtree's
    key path) all-gathered over every spec entry but ``keep`` (the data
    axes, by default: its ``model`` blocks are kept), and the subtrees
    under the keys or key paths in ``whole`` (:func:`under`) over every
    entry (``model`` too).  Which leaves of a group it gathers, and over
    which dims, is worked out at the group's first call and kept in
    ``hook.plans`` (``(path, whole)`` -> ``[(leaf index in flatten order,
    [(dim, mesh axes), ...]), ...]``); a group with nothing to gather
    (every group on one rank, or ``mode="serve"`` blocks) is returned as
    it is."""
    plans: dict = {}

    def plan(blocks, path, whole):
        out = []
        for i, ((kp, _), s) in enumerate(zip(flatten(blocks), spec_leaves(
                blocks, spec_at(spec_tree, path)))):
            k = None if under(kp, whole) else keep
            dims = [(d, e) for d, e in enumerate(s)
                    if e is not None and e != k]
            if dims:
                out.append((i, dims))
        return out

    def hook(blocks, path: tuple, whole=()):
        key = (path, tuple(whole))
        todo = plans.get(key)
        if todo is None:
            todo = plans[key] = plan(blocks, path, whole)
        if not todo:
            return blocks
        leaves = [t for _, t in flatten(blocks)]
        for i, dims in todo:
            for d, e in dims:
                leaves[i] = all_gather(leaves[i], e, dim=d)
        return unflatten(blocks, leaves)

    hook.plans = plans
    return hook


def cache_specs(cache, mesh):
    """KV/state cache specs: the batch dimension over the data axes where
    it divides, and the largest other dimension that divides over
    ``model`` (the slot dimension of every 32k cell's attention cache;
    the first of equal sizes wins)."""
    msize, dsize = _model_size(mesh), _data_size(mesh)
    dp = _dp_entry(mesh)

    def spec(leaf):
        shape = _shape(leaf)
        if not shape:
            return P()
        entries: list[Any] = [None] * len(shape)
        if dsize > 1 and shape[0] % dsize == 0:
            entries[0] = dp
        if msize > 1:
            order = sorted(range(1, len(shape)), key=lambda i: shape[i],
                           reverse=True)
            ti = next((i for i in order if shape[i] % msize == 0), None)
            if ti is not None:
                entries[ti] = "model"
        return P(*entries)

    return tree_map(spec, cache)


def _itemsize(dtype) -> int:
    if dtype is None:
        return 4
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    import numpy as np
    return np.dtype(dtype).itemsize


def serve_weights_resident(params, mesh, *,
                           hbm_bytes_per_chip: float = H100_HBM_BYTES,
                           resident_frac: float = 0.5) -> bool:
    """True when TP-only (``mode="serve"``) weights fit resident per
    device, i.e. the decode step may be unrolled without materialising
    per-layer FSDP all-gathers (see :mod:`repro_torch.launch.dryrun`).
    ``hbm_bytes_per_chip`` defaults to the H100's 80 GB."""
    msize = _model_size(mesh)

    def leaf_bytes(leaf) -> float:
        shape = _shape(leaf)
        item = _itemsize(getattr(leaf, "dtype", None))
        n = math.prod(shape) if shape else 1
        if msize > 1 and any(s % msize == 0 for s in shape):
            n //= msize
        return float(n * item)

    total = sum(leaf_bytes(leaf) for _, leaf in flatten(params))
    return total <= resident_frac * hbm_bytes_per_chip
