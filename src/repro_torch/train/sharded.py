"""The train step on a mesh: each rank's program over its blocks of the
state (the port's counterpart of the reference's train step jitted with
``param_specs(mode="train")`` shardings, ``repro.launch.train``).

The f32 master parameters and the AdamW moments are placed by
:func:`repro_torch.dist.sharding.param_specs` (TP over ``model``, FSDP
over the data axes); between steps each rank holds its blocks of them as
plain tensors (:func:`shard_train_state`), and they become DTensors only
to be saved or restored (:func:`as_dtensors`, :func:`local_blocks`).
The batch is split over the data axes (``batch_spec``) and replicated
over ``model``.  One step, on every rank:

1. the loss and its gradients on this rank's rows (the single-device
   step body, :func:`repro_torch.train.step.accumulate_grads`) on this
   rank's blocks, with the activation axes bound: the bf16 copies are
   made of the blocks, and the per-layer gather hook
   (:func:`repro_torch.dist.sharding.gather_hook`) all-gathers one
   group's data-sharded blocks (the embedding, a layer, the final norm,
   the head) where it is used, inside the layer's checkpoint, so no
   rank holds more than one layer gathered (two in the backward: the
   recompute's and the gradients').  The ``model`` blocks stay blocks:
   attention runs on this rank's heads, the MLP on its block of ``d_ff``,
   MoE on its experts or its ``d_ff`` slices, Mamba on its ``d_inner``
   channels, the xLSTM projections on their blocks, the residual whole
   (:mod:`repro_torch.dist.tp`); sLSTM's recurrent ``r``, and a Mamba or
   xLSTM mixer whose width ``model`` does not divide, are gathered whole
   (:func:`repro_torch.models.transformer.whole_keys`);
2. each gradient is already this rank's block: the all-gathers'
   adjoints reduce-scatter it over the data axes, and a ``model`` block
   is only this rank's.  What is left is an all-reduce over the axes the
   leaf's spec replicates (one flat buffer for all the leaves that
   share them), then the division by the world size.  Every rank
   differentiates its own copy of the loss and every cross-rank path in
   the forward is a collective whose backward is its exact adjoint, so
   the sum of the ranks' gradients is the gradient of the sum of their
   losses: ``world`` times the global loss (each model rank holds a copy
   of its data shard's loss).  With ``accum`` above 1 the microbatches'
   gradients are accumulated in f32 blocks;
3. the global norm from the distinct blocks only (a block's squares
   divided by the ranks that hold a copy of it, then one all-reduce), and
   the AdamW update on this rank's blocks;
4. the metrics averaged over the data axes.

Gradients, the clipped update and the loss equal the single-device step
on the global batch up to the order of the sums (bit for bit on one
rank, where every collective is the identity and nothing is copied).
On a :class:`repro_torch.dist.context.MeshSpec` the same program runs on
``meta`` blocks (the dry run).
"""

from __future__ import annotations

import math
from typing import Any

import torch

from ..dist import context as dctx
from ..dist.sharding import (PartitionSpec, batch_spec, gather_hook,
                             local_block, named, param_specs, spec_leaves)
from ..models import transformer as T
from ..models.common import ModelConfig
from ..optim.adamw import AdamWConfig, adamw_update
from ..pytree import flatten, unflatten
from .step import _to_device, accumulate_grads

__all__ = ["make_sharded_train_step", "shard_train_state",
           "train_state_shardings", "sharded_grads", "sharded_update",
           "as_dtensors", "local_blocks"]

PyTree = Any


def train_state_shardings(params: PyTree, mesh) -> dict:
    """NamedShardings of ``{"params", "opt"}``: the parameters and both
    AdamW moments by ``param_specs(mode="train")``, the step count
    replicated."""
    ps = named(mesh, param_specs(params, mesh))
    return {"params": ps, "opt": {"m": ps, "v": ps,
                                  "step": named(mesh, PartitionSpec())}}


def shard_train_state(params: PyTree, opt_state: PyTree, mesh
                      ) -> tuple[PyTree, PyTree]:
    """Whole parameters and AdamW state (the same on every rank) -> this
    rank's blocks of them under :func:`train_state_shardings`, plain
    tensors (views of the whole ones where a block is contiguous; the
    whole tensors themselves on one rank).  Nothing is sent."""
    shd = train_state_shardings(params, mesh)
    cut = lambda tree, s: unflatten(tree, [  # noqa: E731
        local_block(t, sh.mesh, sh.placements).contiguous()
        for (_, t), (_, sh) in zip(flatten(tree), flatten(s))])
    return cut(params, shd["params"]), cut(opt_state, shd["opt"])


def as_dtensors(blocks: PyTree, shardings: PyTree) -> PyTree:
    """This rank's blocks as the DTensors that ``shardings`` place (for a
    checkpoint save); nothing is sent."""
    from torch.distributed.tensor import DTensor
    return unflatten(blocks, [
        DTensor.from_local(t, sh.mesh, sh.placements)
        for (_, t), (_, sh) in zip(flatten(blocks), flatten(shardings))])


def local_blocks(tree: PyTree) -> PyTree:
    """A tree of DTensors (a sharded restore) -> this rank's blocks."""
    return unflatten(tree, [t.to_local() for _, t in flatten(tree)])


def _replicas(spec, sizes: dict[str, int]) -> int:
    """The ranks that hold a copy of one block of a leaf with ``spec``."""
    held = {a for e in spec for a in dctx.as_axes(e)}
    return math.prod(n for a, n in sizes.items() if a not in held)


def _reduce(grads: list, specs: list, sizes: dict[str, int]) -> list:
    """Each gradient block (already summed over the ranks that hold its
    block's pieces: the gathers' adjoints reduce-scattered it) summed over
    the axes its spec replicates and divided by the world size: one
    all-reduce for all the leaves that share those axes (and a dtype), on
    one flat buffer."""
    out, groups = [], {}
    for g, spec in zip(grads, specs):
        held = {a for e in spec for a in dctx.as_axes(e)}
        rest = tuple(a for a in sizes if a not in held and sizes[a] > 1)
        groups.setdefault((rest, g.dtype), []).append(len(out))
        out.append(g)
    for (rest, _), idx in groups.items():
        if rest:
            flat = dctx.all_reduce(torch.cat([out[i].reshape(-1)
                                              for i in idx]), rest)
            parts = flat.split([out[i].numel() for i in idx])
            for i, part in zip(idx, parts):
                out[i] = part.view_as(out[i])
    world = math.prod(sizes.values())
    return [g / world for g in out] if world > 1 else out


def sharded_grads(cfg: ModelConfig, mesh, specs: list, params: PyTree,
                  batch: dict, *, accum: int = 1, remat: bool = True,
                  unroll: bool = False) -> tuple[list, dict]:
    """Steps 1 and 2 of this rank's program (module docstring): its
    blocks' gradients of the global mean loss, in ``flatten`` order, and
    the loss's metrics on its rows.  The activation axes must be bound
    (:func:`sharded_update` binds them)."""
    grads, metrics = accumulate_grads(
        params, cfg, batch, accum=accum, remat=remat, unroll=unroll,
        gather=gather_hook(unflatten(params, specs)))
    return (_reduce([g for _, g in flatten(grads)], specs,
                    dctx.mesh_axes(mesh)), metrics)


def sharded_update(cfg: ModelConfig, opt: AdamWConfig, mesh, specs: list,
                   params: PyTree, opt_state: PyTree, batch: dict, *,
                   accum: int = 1, remat: bool = True, unroll: bool = False
                   ) -> tuple[PyTree, PyTree, dict]:
    """One step of this rank's program on plain blocks: ``params`` and
    ``opt_state``'s moments hold this rank's blocks of leaves placed by
    ``specs`` (one a leaf, in ``flatten`` order), ``batch`` this rank's
    rows.  Returns the updated blocks and the metrics."""
    sizes = dctx.mesh_axes(mesh)
    dp = batch_spec(mesh)[0]
    with dctx.act_ctx(dp=dp, tp="model", mesh=mesh):
        gl, metrics = sharded_grads(cfg, mesh, specs, params, batch,
                                    accum=accum, remat=remat, unroll=unroll)
        sq = 0
        for g, s in zip(gl, specs):
            part, r = torch.sum(torch.square(g.float())), _replicas(s, sizes)
            sq = sq + (part / r if r > 1 else part)
        gnorm = torch.sqrt(dctx.all_reduce(sq, tuple(sizes)))
        new_p, new_o, opt_metrics = adamw_update(
            opt, params, unflatten(params, gl), opt_state, grad_norm=gnorm)
        # the metrics' mean over the data shards, in one all-reduce
        mean = dctx.all_reduce(torch.stack(list(metrics.values())),
                               dp) / dctx.axis_size(dp, mesh)
        metrics = dict(zip(metrics, mean.unbind()))
    return new_p, new_o, {**metrics, **opt_metrics}


def make_sharded_train_step(cfg: ModelConfig, opt: AdamWConfig, mesh, *,
                            accum: int = 1, remat: bool = True,
                            unroll: bool = False):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` on the DeviceMesh ``mesh``: ``params`` and ``opt_state``
    hold this rank's blocks (:func:`shard_train_state`), ``batch`` the
    global batch (NumPy or tensors; every rank passes the same), of which
    each rank takes its data shard's rows."""
    dp = batch_spec(mesh)[0]
    shapes = T.init(cfg, device="meta", param_dtype=torch.float32)
    specs = spec_leaves(shapes, param_specs(shapes, mesh))
    n, i = dctx.axis_size(dp, mesh), dctx.axis_index(dp, mesh)

    def step(params, opt_state, batch):
        batch = _to_device(batch, flatten(params)[0][1].device)
        rows = {k: v.chunk(n, 0)[i] for k, v in batch.items()}
        return sharded_update(cfg, opt, mesh, specs, params, opt_state, rows,
                              accum=accum, remat=remat, unroll=unroll)

    return step
