"""Logical activation axes bound to a mesh, and the collectives over its
axes (the port of the reference's ``repro.dist.context``).

Model code never names mesh axes: it asks for the *logical* axes ``"dp"``
(data parallel: one mesh axis or a tuple of them, pod-major) and
``"tp"`` (the ``model`` axis), which a launcher binds once with
:func:`set_activation_axes` or, scoped, with :func:`act_ctx`.  With
nothing bound, :func:`dp_size` and :func:`tp_size` are 1 and
:func:`constrain` is the identity, so the same code runs unsharded.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (processes,
one per rank) or a :class:`MeshSpec`, a description of axis names and
sizes with no process behind it; :func:`mesh_axes` reads either one (or
any object with ``axis_names`` and a ``shape`` mapping, as a JAX mesh
has).

The port's model code computes on plain local tensors, one program per
rank, as the reference's ``shard_map`` bodies do: a DTensor is only the
storage of a sharded leaf.  The collectives below are that program's
communication.  Each takes the mesh axes it runs over (a name, a tuple
of names, or None for none) and uses the autograd-aware forms of
``torch.distributed.nn.functional``, whose backward is the exact adjoint
(an all-gather's is a reduce-scatter), so gradients flow across ranks.
Over an axis of one rank each returns ``x`` itself, with no call to the
process group (a compiler drops such a collective too).  On ``meta``
tensors (the dry run) nothing is sent: each returns a tensor of the
right shape, still on the autograd graph (its backward tallies the
adjoint collective: a dry run's step counts both directions, as the
reference's compiled step does).  Inside :func:`count_collectives` every call
adds the bytes of its output, per device, under its kind, the names the
reference reads from the compiled program (and, given a list, records
its kind, mesh axis and output shape there).
"""

from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Sequence

import torch

__all__ = [
    "MeshSpec",
    "mesh_axes",
    "axis_index",
    "axis_size",
    "as_axes",
    "set_activation_axes",
    "activation_axes",
    "mesh",
    "dp_size",
    "tp_size",
    "constrain",
    "act_ctx",
    "with_axes",
    "all_reduce",
    "all_gather",
    "reduce_scatter",
    "all_to_all",
    "count_collectives",
]

@dataclass(frozen=True)
class MeshSpec:
    """A mesh by its axis names and sizes, with no process behind it:
    the production shapes for the dry run and the sharding policies.
    ``coords`` is the rank whose program runs on it (rank 0 by
    default), one index an axis."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    coords: tuple[int, ...] = field(default=())

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"MeshSpec: names {self.axis_names} and sizes "
                             f"{self.sizes} differ in length")
        if not self.coords:
            object.__setattr__(self, "coords", (0,) * len(self.sizes))

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    def size(self) -> int:
        return math.prod(self.sizes)

    def __str__(self) -> str:
        return "x".join(map(str, self.sizes)) + " " + str(self.axis_names)


def _is_device_mesh(m) -> bool:
    return hasattr(m, "mesh_dim_names") and hasattr(m, "get_group")


def mesh_axes(m) -> dict[str, int]:
    """Axis name -> size, in the mesh's axis order."""
    if _is_device_mesh(m):
        return dict(zip(m.mesh_dim_names, (int(s) for s in m.shape)))
    return {a: int(m.shape[a]) for a in m.axis_names}


class _Bound(threading.local):
    """The activation axes bound on this thread, and ``tpx``: the bound
    ``tp`` axis's ``(size, this rank's index, name)``, filled on first
    use after each binding (the layers ask for it at every call)."""

    def __init__(self):
        self.v = {"dp": None, "tp": None, "mesh": None, "tpx": (1, 0, None)}


_state = _Bound()


def _get() -> dict[str, Any]:
    return _state.v


def set_activation_axes(*, dp=None, tp=None, mesh=None) -> None:
    """Bind (or clear, with all-None) the logical activation axes.

    ``dp`` may be a single mesh-axis name or a tuple of names (multi-pod
    data parallelism); ``tp`` is a single mesh-axis name."""
    s = _get()
    s["dp"], s["tp"], s["mesh"] = dp, tp, mesh
    s["tpx"] = (1, 0, None) if tp is None or mesh is None else None


def activation_axes() -> tuple[Any, Any]:
    s = _get()
    return s["dp"], s["tp"]


def mesh():
    return _get()["mesh"]


def as_axes(ax) -> tuple[str, ...]:
    """A mesh-axis entry (None, a name or a tuple of names) as a tuple."""
    if ax is None:
        return ()
    return tuple(ax) if isinstance(ax, (tuple, list)) else (ax,)


def axis_size(ax, m=None) -> int:
    """The number of ranks along ``ax`` on ``m`` (by default the bound
    mesh); 1 with no mesh."""
    m = mesh() if m is None else m
    if m is None:
        return 1
    sizes = mesh_axes(m)
    return math.prod(sizes[a] for a in as_axes(ax))


def dp_size() -> int:
    s = _get()
    return axis_size(s["dp"], s["mesh"])


def tp_size() -> int:
    s = _get()
    return axis_size(s["tp"], s["mesh"])


def axis_index(ax, m=None) -> int:
    """This rank's index along ``ax`` (a name or a tuple of names, the
    first outermost) on ``m`` (by default the bound mesh)."""
    m = mesh() if m is None else m
    idx = 0
    sizes = mesh_axes(m)
    for a in as_axes(ax):
        if _is_device_mesh(m):
            i = m.get_local_rank(a)
        else:
            i = m.coords[m.axis_names.index(a)]
        idx = idx * sizes[a] + i
    return idx


def _resolve(entry):
    s = _get()
    if entry == "dp":
        return s["dp"]
    if entry == "tp":
        return s["tp"]
    return entry


def constrain(x, axes: Sequence[Any]):
    """The layout hint of the reference's ``with_sharding_constraint``
    against logical axes.  The identity when no mesh is bound, when every
    resolved entry is None, and on plain tensors (each rank's program
    holds its own); a DTensor is redistributed to the resolved
    placements.  Values never change."""
    m = _get()["mesh"]
    if m is None:
        return x
    resolved = tuple(_resolve(e) for e in axes)
    if all(e is None for e in resolved):
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from .sharding import PartitionSpec, placements
    return x.redistribute(x.device_mesh,
                          placements(x.device_mesh, PartitionSpec(*resolved)))


def with_axes(fn):
    """``fn`` run under the activation axes bound now.  The binding is
    per thread, and autograd runs a CUDA tensor's backward on a device
    thread of its own, where a checkpoint's recompute would see none:
    the function a checkpoint reruns is wrapped in this.  ``fn`` itself
    where nothing is bound."""
    s = _get()
    bound = {k: s[k] for k in ("dp", "tp", "mesh")}
    if all(v is None for v in bound.values()):
        return fn

    def run(*args, **kw):
        with act_ctx(**bound):
            return fn(*args, **kw)
    return run


@contextmanager
def act_ctx(*, dp=None, tp=None, mesh=None):
    """Scoped :func:`set_activation_axes` (restores the previous binding)."""
    s = _get()
    prev = dict(s)
    set_activation_axes(dp=dp, tp=tp, mesh=mesh)
    try:
        yield
    finally:
        s.update(prev)


# ---------------------------------------------------------------------------
# Collectives over mesh axes
# ---------------------------------------------------------------------------

_tally: list[tuple[dict[str, float], list | None]] = []


@contextmanager
def count_collectives(calls: list | None = None):
    """Yields a dict that collects, by kind ("all-gather", "all-reduce",
    "reduce-scatter", "all-to-all"), the bytes of every collective's
    output on this rank while the block runs.  With ``calls``, each call
    also appends ``(kind, mesh axis, output shape, output bytes)`` to
    that list."""
    out: dict[str, float] = {}
    entry = (out, calls)
    _tally.append(entry)
    try:
        yield out
    finally:
        _tally.remove(entry)


def _count(kind: str, t: torch.Tensor, axis: str) -> None:
    """Tally one collective's output on this rank."""
    n = float(t.numel() * t.element_size())
    for d, calls in _tally:
        d[kind] = d.get(kind, 0.0) + n
        if calls is not None:
            calls.append((kind, axis, tuple(t.shape), n))


class _OnMeta(torch.autograd.Function):
    """A collective on ``meta`` tensors: an output of ``shape`` on the
    autograd graph; its backward tallies the ``adjoint`` collective."""

    @staticmethod
    def forward(ctx, x, shape, adjoint, axis):
        ctx.in_shape, ctx.adjoint, ctx.axis = x.shape, adjoint, axis
        return x.new_empty(shape)

    @staticmethod
    def backward(ctx, g):
        out = g.new_empty(ctx.in_shape)
        _count(ctx.adjoint, out, ctx.axis)
        return out, None, None, None


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward hands on a contiguous gradient: the
    all-gather's backward sends its pieces' gradients as they come, and
    gloo sends a permuted one's storage in the wrong order (sLSTM's
    ``r``, whose gradient arrives through a permute)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _group(a: str):
    m = mesh()
    if not _is_device_mesh(m):
        raise RuntimeError(
            f"collective over {a!r}: the bound mesh {m} has no processes "
            "(a MeshSpec runs meta tensors only)")
    return m.get_group(a)


def _nnf():
    import torch.distributed.nn.functional as nnf
    return nnf


def all_reduce(x: torch.Tensor, axes, op: str = "sum") -> torch.Tensor:
    """The sum (``op="sum"``) or the maximum (``op="max"``, no backward:
    it raises where autograd would record) of ``x`` over the ranks of
    ``axes``."""
    if op not in ("sum", "max"):
        raise ValueError(f"all_reduce: op must be 'sum' or 'max', not {op!r}")
    for a in as_axes(axes):
        if axis_size(a) == 1:
            continue
        if x.device.type == "meta":
            x = _OnMeta.apply(x, x.shape, "all-reduce", a)
        elif op == "sum":
            x = _nnf().all_reduce(x, group=_group(a))
        else:
            if torch.is_grad_enabled() and x.requires_grad:
                raise RuntimeError("all_reduce(op='max') has no backward")
            import torch.distributed as dist
            x = x.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(x, op=dist.ReduceOp.MAX, group=_group(a))
        _count("all-reduce", x, a)
    return x


def all_gather(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim``, over ``axes`` in
    rank order (pod-major for a tuple)."""
    for a in reversed(as_axes(axes)):
        n = mesh_axes(mesh())[a]
        if n == 1:
            continue
        if x.device.type == "meta":
            shape = list(x.shape)
            shape[dim] *= n
            x = _OnMeta.apply(x, shape, "reduce-scatter", a)
        else:
            x = torch.cat([_ContiguousGrad.apply(t) for t in _nnf().all_gather(
                x.contiguous(), group=_group(a))], dim)
        _count("all-gather", x, a)
    return x


def reduce_scatter(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """The sum of ``x`` over ``axes``, split along ``dim``: this rank's
    block (pod-major for a tuple)."""
    for a in as_axes(axes):
        n = mesh_axes(mesh())[a]
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                             f"does not split {n} ways")
        if x.device.type == "meta":
            shape = list(x.shape)
            shape[dim] //= n
            x = _OnMeta.apply(x, shape, "all-gather", a)
        else:
            parts = [c.contiguous() for c in x.chunk(n, dim)]
            x = _nnf().reduce_scatter(torch.empty_like(parts[0]), parts,
                                      group=_group(a))
        _count("reduce-scatter", x, a)
    return x


def all_to_all(x: torch.Tensor, axis: str, in_splits=None,
               out_splits=None) -> torch.Tensor:
    """Block ``j`` of ``x``'s leading dim (one block a rank of ``axis``)
    goes to rank ``j``; block ``j`` of the result came from rank ``j``.
    ``in_splits`` / ``out_splits``: the blocks' lengths (rows of dim 0)
    sent to and received from each rank, where they are not equal."""
    if axis_size(axis) == 1:
        return x
    shape = list(x.shape)
    if out_splits is not None:
        shape[0] = sum(out_splits)
    if x.device.type == "meta":
        x = _OnMeta.apply(x, shape, "all-to-all", axis)
    else:
        x = _nnf().all_to_all_single(x.new_empty(shape), x.contiguous(),
                                     out_splits, in_splits,
                                     group=_group(axis))
    _count("all-to-all", x, axis)
    return x
