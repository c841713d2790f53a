"""Tensor parallelism on this rank's ``model`` blocks: the dense layers,
norms, embedding and head of a rank program whose weights are placed by
:func:`repro_torch.dist.sharding.param_specs` (the placement the
reference's SPMD partitioner gives its ``constrain``-ed program), and
the re-cuts and cache views the Mamba and xLSTM mixers run on.

A weight's ``model`` entry (:func:`weight_spec`: the largest dimension
that divides the bound ``tp`` axis) decides the program:

* split on the input dim (dim 0): this rank's block of x's features, the
  local GEMM, then one ``all_reduce`` over ``model`` (or a
  ``reduce_scatter`` where the caller keeps a block of the output);
* split on the output dim (dim 1): the local GEMM gives this rank's block
  of the output features, kept for a consumer that works on its block
  (attention's heads, the MLP's hidden features) or ``all_gather``-ed;
* not split: the whole GEMM on every rank.

An activation that is a block of its features travels with a flag (the
functions return ``(y, is_block)``), so each consumer takes what it
needs: its own block is a slice, the whole an ``all_gather`` of the
activation.  A weight is never gathered over ``model``.  A bias split
with its weight's output is added to the block it belongs to: after the
local GEMM, or before the all-reduce on the rank that holds it (the sum
then counts it once).  Norms: a split scale gives this rank's block of
the normalised features, the statistics taken over the whole
(replicated) row.

A dense layer whose output is groups of features one after another
(Mamba's and mLSTM's [x | z], a GLU's [u | g]) gives this rank's block of
each group through :func:`tp_dense_groups`: the placement's contiguous
output blocks do not line up with the groups, so one all-to-all
(:func:`regroup`) re-cuts the weight's block or the output's.  A decode
step views a cache's blocks along the dim its program needs
(:func:`cache_as`, :func:`cache_put`: the blocks themselves, a re-cut or
a gather), and :func:`off` runs a layer's one-device program on whole
weights.

The collectives are :mod:`repro_torch.dist.context`'s, whose backwards
are exact adjoints, so gradients flow to each rank's blocks.  With no
``tp`` axis bound, or a ``model`` axis of one rank, every function here
is its plain counterpart (``dense``, ``norm``, the embedding lookup)
itself, bit for bit.
"""

from __future__ import annotations

import functools
from contextlib import contextmanager

import torch
import torch.nn.functional as F

from . import context as dctx
from .sharding import PartitionSpec, tp_spec

__all__ = ["tp_axis", "off", "weight_spec", "model_dim", "tp_dense",
           "tp_dense_groups", "tp_norm", "full", "rank_block", "as_block",
           "dense_blocks", "reblock", "regroup", "to_dim",
           "cache_dims", "cache_as", "cache_put", "tp_embed"]


def tp_axis() -> tuple[int, int, str | None]:
    """``(m, r, axis)``: the bound ``tp`` axis's size, this rank's index
    along it and its name; ``(1, 0, None)`` with none bound.  Worked out
    once a binding, then a lookup: the layers ask at every call, and a
    host-bound decode step pays for each call."""
    t = dctx._state.v["tpx"]
    return t if t is not None else _bind_tp()


def _bind_tp() -> tuple[int, int, str | None]:
    bound = dctx._get()
    ax = bound["tp"]
    m = dctx.axis_size(ax)
    t = bound["tpx"] = (1, 0, ax) if m == 1 else (m, dctx.axis_index(ax), ax)
    return t


@contextmanager
def off():
    """The layers called inside run their one-device program, as with no
    ``tp`` axis bound: a mixer whose width ``model`` does not divide,
    gathered whole on every rank."""
    s = dctx._state.v
    prev, s["tpx"] = s["tpx"], (1, 0, None)
    try:
        yield
    finally:
        s["tpx"] = prev


def weight_spec(shape) -> PartitionSpec:
    """The ``model`` placement of a weight of global ``shape`` on the
    bound mesh (no entry where no ``tp`` axis is bound)."""
    m = tp_axis()[0]
    return _WHOLE if m == 1 else _spec(tuple(shape), m)


_WHOLE = PartitionSpec()
# the decode step asks for each weight's placement every call: a cache
# keeps that to a lookup on the host
_spec = functools.lru_cache(maxsize=None)(tp_spec)


def model_dim(spec) -> int | None:
    """The dim a spec splits over ``model``, or None."""
    if spec is None:
        return None
    for i, e in enumerate(spec):
        if "model" in dctx.as_axes(e):
            return i
    return None


def _narrow(t: torch.Tensor, dim: int, m: int, r: int) -> torch.Tensor:
    n = t.shape[dim] // m
    return t.narrow(dim, r * n, n)


def full(x: torch.Tensor, is_block: bool) -> torch.Tensor:
    """The whole of an activation: ``x`` itself, or its feature blocks
    all-gathered over ``model``."""
    if not is_block:
        return x
    _, _, ax = tp_axis()
    return dctx.all_gather(x, ax, dim=x.dim() - 1)


def rank_block(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (by default a replicated
    activation's features; a view)."""
    m, r, _ = tp_axis()
    return x if m == 1 else _narrow(x, dim % x.dim(), m, r)


def tp_dense(p: dict, x: torch.Tensor, spec=None, *, shape=None,
             x_block: bool = False, keep_block: bool = False
             ) -> tuple[torch.Tensor, bool]:
    """``x @ W + b`` from this rank's block of ``W`` (``p["w"]``, placed by
    ``spec``'s ``model`` entry, or by :func:`weight_spec` of its global
    ``shape``, looked up only on a split ``model`` axis) and of ``b``.
    ``x_block``: x holds this rank's block of its features (m equal
    blocks).  ``keep_block``: return this rank's block of the output
    features where the program has it (an output-split W, or an
    input-split one whose output divides: one reduce-scatter); else the
    whole output.  Returns ``(y, is_block)``."""
    m, r, ax = tp_axis()
    w, b = p["w"], p.get("b")
    if m == 1:
        y = x @ w.to(x.dtype)
        return (y + b.to(y.dtype) if b is not None else y), False
    d = model_dim(weight_spec(shape) if spec is None else spec)
    if d is None:
        y = full(x, x_block)
        y = y @ w.to(y.dtype)
        return (y + b.to(y.dtype) if b is not None else y), False
    if d == 1:
        y = full(x, x_block)
        y = y @ w.to(y.dtype)
        if b is not None:
            y = y + b.to(y.dtype)
        return (y, True) if keep_block else (full(y, True), False)
    if not x_block:
        x = rank_block(x)
    y = x @ w.to(x.dtype)
    d_out = y.shape[-1]
    b_split = b is not None and d_out % m == 0
    if b_split:
        n = d_out // m
        y = y + F.pad(b.to(y.dtype), (r * n, d_out - (r + 1) * n))
    if keep_block and d_out % m == 0:
        y, out_block = dctx.reduce_scatter(y, ax, dim=y.dim() - 1), True
    else:
        y, out_block = dctx.all_reduce(y, ax), False
    if b is not None and not b_split:
        y = y + b.to(y.dtype)
    return y, out_block


def tp_dense_groups(p: dict, x: torch.Tensor, shape, groups: int, *,
                    x_block: bool = False) -> tuple[torch.Tensor, bool]:
    """``x @ W + b`` for ``W`` of global ``shape`` (k, groups * n) whose
    output features are ``groups`` equal groups, one after another
    (Mamba's and mLSTM's [x | z], a GLU's [u | g]): where ``model``
    divides n, this rank's block of n / m features of each group, the
    groups in order, so that the groups' blocks line up.  The placement
    cuts the output dim into m contiguous blocks, which do not (on 2
    ranks rank 0 holds all of x, rank 1 all of z), so one all-to-all
    (:func:`regroup`) re-cuts the weight's block or the output's,
    whichever is smaller: the weight's (k rows) for a long input, the
    output's (x's rows) for a decode step.  Where ``model`` does not
    divide n, the whole output.  Returns ``(y, is_block)``."""
    m = tp_axis()[0]
    k, N = shape
    if m == 1 or (N // groups) % m:
        return tp_dense(p, x, shape=shape, x_block=x_block)
    rows = x.numel() // x.shape[-1]
    if rows * x.element_size() <= k * p["w"].element_size():
        # W is split (m divides N): its output's contiguous block
        y, _ = tp_dense(p, x, shape=shape, x_block=x_block, keep_block=True)
        return regroup(y, -1, groups), True
    x = full(x, x_block)
    y = x @ regroup(as_block(p["w"], shape, 1), 1, groups).to(x.dtype)
    if "b" in p:
        b = regroup(as_block(p["b"], (N,), 0), 0, groups)
        y = y + b.to(y.dtype)
    return y, True


def tp_norm(p: dict, x: torch.Tensor, kind: str
            ) -> tuple[torch.Tensor, bool]:
    """The norm of the replicated rows ``x``: the whole where its scale is
    whole, else this rank's block of the normalised features (statistics
    over the whole row; the scale and bias blocks padded with zeros, so
    the RMSNorm kernel runs on the row as it does on one device).
    Returns ``(y, is_block)``."""
    m, r, _ = tp_axis()
    if m == 1:
        return _norm()(p, x, kind), False
    D, n = x.shape[-1], p["scale"].shape[0]
    if n == D:
        return _norm()(p, x, kind), False
    padded = {k: F.pad(v, (r * n, D - (r + 1) * n)) for k, v in p.items()}
    return rank_block(_norm()(padded, x, kind)), True


@functools.cache
def _norm():
    # imported at first use: the models import this module
    from ..models.common import norm
    return norm


def as_block(w: torch.Tensor, shape, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of the weight of global ``shape``
    that ``w`` holds: a slice of the whole weight, ``w`` itself where its
    ``model`` block is already along ``dim``, else its block re-cut by
    :func:`reblock` (one all-to-all, never a gather)."""
    m, r, _ = tp_axis()
    if m == 1:
        return w
    if tuple(w.shape) == tuple(shape):
        return _narrow(w, dim, m, r)
    have = model_dim(weight_spec(shape))
    return w if have == dim else reblock(w, have, dim)


def dense_blocks(p: dict, shape) -> dict:
    """A dense layer's ``{"w", "b"}`` of global weight ``shape``, whole or
    this rank's blocks, as this rank's blocks (a whole leaf sliced)."""
    m, r, _ = tp_axis()
    d = model_dim(weight_spec(shape))
    if m == 1 or d is None:
        return p
    out = {"w": as_block(p["w"], shape, d)}
    if "b" in p:
        b = p["b"]
        out["b"] = _narrow(b, 0, m, r) if b.shape[0] == shape[1] and \
            shape[1] % m == 0 else b
    return out


def reblock(w: torch.Tensor, have: int, want: int) -> torch.Tensor:
    """A ``model`` block split along ``have`` -> the block along ``want``:
    piece j (``want``'s block j) goes to rank j, and the pieces received
    join along ``have`` in rank order."""
    m, _, ax = tp_axis()
    send = torch.stack(w.chunk(m, want))
    recv = dctx.all_to_all(send, ax)
    return torch.cat(list(recv.unbind(0)), dim=have)


def regroup(t: torch.Tensor, dim: int, groups: int) -> torch.Tensor:
    """``t``, this rank's contiguous block along ``dim`` of a dim that
    holds ``groups`` equal groups one after another -> this rank's block
    of each group, the groups in order (:func:`tp_dense_groups`).  Each
    of the block's ``groups`` pieces goes to the rank whose block of its
    group it is: one all-to-all, of the block's own size."""
    m, r, ax = tp_axis()
    if m == 1 or groups == 1:
        return t
    dim %= t.dim()
    c = t.shape[dim] // groups
    # piece k of this block is piece P = r * groups + k of the whole:
    # group P // m, rank P % m's block of it
    dest = [(r * groups + k) % m for k in range(groups)]
    order = sorted(range(groups), key=dest.__getitem__)
    x = t.movedim(dim, 0)
    send = torch.cat([x[k * c:(k + 1) * c] for k in order])
    sent = [c * dest.count(j) for j in range(m)]
    got = [c * sum((s * m + r) // groups == q for s in range(groups))
           for q in range(m)]
    return dctx.all_to_all(send, ax, sent, got).movedim(0, dim)


def to_dim(t: torch.Tensor, have: int | None,
           want: int | None) -> torch.Tensor:
    """``t``, this rank's ``model`` block along ``have`` (None: whole), as
    its block along ``want`` (None: whole): ``t`` itself, a slice, an
    all-gather, or an all-to-all (:func:`reblock`)."""
    if have == want or tp_axis()[0] == 1:
        return t
    if want is None:
        return dctx.all_gather(t, tp_axis()[2], dim=have)
    if have is None:
        return rank_block(t, want)
    return reblock(t, have, want)


def cache_dims(cache: dict, cspec) -> dict:
    """Each cache leaf's ``model`` dim by ``cspec`` (``cache_specs``'s
    entries for one layer; None: every leaf whole)."""
    return {k: model_dim(cspec[k]) if cspec else None for k in cache}


def cache_as(cache: dict, have: dict, want: dict) -> dict:
    """A layer's cache leaves (blocks along ``have``) as blocks along
    ``want`` (None: whole), for a decode step to update in place."""
    return {k: to_dim(v, have[k], want[k]) for k, v in cache.items()}


def cache_put(cache: dict, view: dict, have: dict, want: dict) -> None:
    """Write a step's state ``view`` (:func:`cache_as`) back into the
    cache's blocks where it is not the blocks themselves."""
    for k, v in cache.items():
        if have[k] != want[k]:
            v.copy_(to_dim(view[k], want[k], have[k]))


def tp_embed(w: torch.Tensor, tokens: torch.Tensor, shape,
             dtype: torch.dtype) -> torch.Tensor:
    """The embedding rows of ``tokens`` from this rank's block of the table
    of global ``shape`` (vocab, d): a vocab-split block looks up the
    tokens it holds (zeros elsewhere) and the ranks' rows are summed (one
    rank adds each); a d-split block's columns are all-gathered."""
    m, r, ax = tp_axis()
    d = model_dim(weight_spec(shape)) if m > 1 else None
    if d is None:
        return w.to(dtype)[tokens]
    w = as_block(w, shape, d)
    if d == 1:
        return full(w.to(dtype)[tokens], True)
    n = w.shape[0]
    local = tokens - r * n
    mine = (local >= 0) & (local < n)
    rows = w.to(dtype)[torch.where(mine, local, 0)]
    return dctx.all_reduce(torch.where(mine[..., None], rows, 0.0), ax)
