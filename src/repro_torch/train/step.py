"""Loss and train-step builders (the port of the reference's
``repro.train.step``).

Training runs the plain path (``impl="xla"``, as the reference's
``forward_features`` defaults to): flash attention, decode attention and
the selective scan have no backward, and raise under grad.  The RMSNorm
kernel has one (:mod:`repro_torch.kernels.rmsnorm`), so on the card the
norms go through it.  Parameters are f32 master weights; each step
differentiates through one bf16 copy of every >=2-D f32 leaf
(:func:`cast_matmul_params`), and autograd carries the gradient back to
the f32 master.  On a mesh the leaves are this rank's blocks and
``gather`` (:func:`repro_torch.dist.sharding.gather_hook`) gathers one
layer's bf16 blocks where the layer runs
(:mod:`repro_torch.train.sharded`).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..dist import context as dctx
from ..dist import tp
from ..models import transformer as T
from ..models.common import ModelConfig
from ..optim.adamw import AdamWConfig, adamw_init, adamw_update
from ..pytree import flatten, tree_map, unflatten

__all__ = ["cross_entropy", "chunked_cross_entropy", "cast_matmul_params",
           "loss_fn", "make_train_step", "make_eval_step",
           "init_train_state", "accumulate_grads"]

PyTree = Any

# the most f32 logits one chunk of chunked_cross_entropy's default holds
_CHUNK_BYTES = 1 << 30


def _label_index(labels: torch.Tensor, vocab: int) -> torch.Tensor:
    """Gather indices: a negative label (``ignore_id``) wraps as a
    negative NumPy index does; its term is masked out anyway."""
    return torch.remainder(labels.long(), vocab)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_id: int = -1) -> torch.Tensor:
    lp = torch.log_softmax(logits.float(), dim=-1)
    ll = lp.gather(-1, _label_index(labels, lp.shape[-1])[..., None])[..., 0]
    mask = (labels != ignore_id).float()
    return -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _ce_chunk(xc: torch.Tensor, lc: torch.Tensor, head_w: torch.Tensor,
              ignore_id: int, head_spec) -> tuple[torch.Tensor, torch.Tensor]:
    m, r, ax = tp.tp_axis()
    mask = (lc != ignore_id).float()
    if m > 1 and tp.model_dim(head_spec) == 1:
        return _ce_chunk_vocab_split(xc, lc, head_w, mask, r, ax)
    logits = tp.tp_dense({"w": head_w}, xc, head_spec)[0].float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, _label_index(lc, logits.shape[-1])[:, None])[:, 0]
    return torch.sum((lse - ll) * mask), torch.sum(mask)


def _ce_chunk_vocab_split(xc, lc, head_w, mask, r: int, ax):
    """:func:`_ce_chunk` on this rank's block of the vocabulary (the
    head's ``model`` block): the log-sum-exp from the ranks' max
    (all-reduced, held constant: the lse does not depend on the shift)
    and sums of exponentials (all-reduced), the label's logit from the
    rank that holds it (all-reduced); no rank holds a chunk's whole
    logits."""
    logits = (xc @ head_w.to(xc.dtype)).float()             # (t, V / m)
    n = logits.shape[-1]
    mx = dctx.all_reduce(logits.detach().amax(-1), ax, op="max")
    lse = torch.log(dctx.all_reduce(
        torch.exp(logits - mx[:, None]).sum(-1), ax)) + mx
    local = _label_index(lc, n * tp.tp_axis()[0]) - r * n
    mine = (local >= 0) & (local < n)
    ll = logits.gather(-1, torch.where(mine, local, 0)[:, None])[:, 0]
    ll = dctx.all_reduce(torch.where(mine, ll, 0.0), ax)
    return torch.sum((lse - ll) * mask), torch.sum(mask)


def chunked_cross_entropy(x: torch.Tensor, head_w: torch.Tensor,
                          labels: torch.Tensor, *, n_chunks: int = 0,
                          ignore_id: int = -1,
                          head_spec=None) -> torch.Tensor:
    """CE over (B, S, d) features without the (B*S, V) logits at once.

    Tokens go in ``n_chunks`` chunks, each under
    ``torch.utils.checkpoint`` where autograd records (the reference
    remats each): peak memory is one chunk of logits, and the backward
    recomputes each chunk.  ``n_chunks=0`` sizes chunks to ~64k tokens,
    as the reference does, and to at most ``_CHUNK_BYTES`` of f32 logits:
    the reference's 64k tokens are global, spread over a mesh, while one
    device here holds a chunk's logits whole.  ``head_spec``: the
    ``model`` placement of ``head_w`` where it is this rank's block
    (:func:`repro_torch.models.transformer.head_spec`); where it splits
    the vocabulary each rank computes its block of a chunk's logits and
    the ranks combine their log-sum-exps.
    """
    B, S, d = x.shape
    T_ = B * S
    if n_chunks <= 0:
        n_chunks = max(1, T_ // 65536)
        by_bytes = -(-T_ * head_w.shape[-1] * 4 // _CHUNK_BYTES)
        while by_bytes < T_ and T_ % by_bytes:
            by_bytes += 1
        n_chunks = max(n_chunks, by_bytes)
    n_chunks = min(n_chunks, T_)
    while T_ % n_chunks:
        n_chunks -= 1
    xf = x.reshape(n_chunks, T_ // n_chunks, d)
    lf = labels.reshape(n_chunks, T_ // n_chunks)
    remat = torch.is_grad_enabled()
    num = torch.zeros((), dtype=torch.float32, device=x.device)
    den = torch.zeros((), dtype=torch.float32, device=x.device)
    for xc, lc in zip(xf, lf):
        if remat:
            n, m = checkpoint(dctx.with_axes(_ce_chunk), xc, lc, head_w,
                              ignore_id, head_spec, use_reentrant=False)
        else:
            n, m = _ce_chunk(xc, lc, head_w, ignore_id, head_spec)
        num, den = num + n, den + m
    return num / torch.clamp(den, min=1.0)


def cast_matmul_params(params: PyTree,
                       dtype: torch.dtype = torch.bfloat16) -> PyTree:
    """Mixed precision: one ``dtype`` copy of every >=2-D f32 weight,
    made once per step before the layer loop; autograd carries its
    gradient back to the f32 master.  1-D leaves (norms, biases, gates)
    stay f32."""
    def cast(p):
        if p.dtype == torch.float32 and p.dim() >= 2:
            return p.to(dtype)
        return p

    return tree_map(cast, params)


def loss_fn(params: PyTree, cfg: ModelConfig, batch: dict,
            *, lb_weight: float = 0.01, z_weight: float = 1e-3,
            remat: bool = True, loss_chunks: int = 0,
            unroll: bool = False, mixed_precision: bool = True,
            gather=None) -> tuple[torch.Tensor, dict]:
    """The loss and its metrics.  ``gather``: the per-layer gather hook
    of a rank program whose ``params`` are its blocks (the bf16 copies
    are made of the blocks, and gathered where each group is used)."""
    if mixed_precision:
        params = cast_matmul_params(params)
    feats, aux = T.forward_features(params, cfg, batch["inputs"],
                                    remat=remat, impl="xla", unroll=unroll,
                                    gather=gather)
    head = T.head_params(params, cfg, gather)
    ce = chunked_cross_entropy(feats, T.head_matrix(head, cfg),
                               batch["labels"], n_chunks=loss_chunks,
                               head_spec=T.head_spec(cfg))
    loss = ce + lb_weight * aux["moe_lb_loss"] + z_weight * aux["moe_z_loss"]
    metrics = {"loss": loss, "ce": ce, **aux}
    return loss, metrics


def init_train_state(cfg: ModelConfig, *, seed: int = 0,
                     device="cuda") -> tuple[PyTree, PyTree]:
    """Seeded f32 master weights (:func:`T.init` with
    ``param_dtype=torch.float32``) and a fresh AdamW state."""
    params = T.init(cfg, seed=seed, device=device,
                    param_dtype=torch.float32)
    return params, adamw_init(params)


def _to_device(batch: dict, device) -> dict:
    """Host (NumPy) or device batches -> tensors on ``device``; integer
    tokens as int64 indices."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor)
                            else v)
        if not t.is_floating_point():
            t = t.long()
        out[k] = t.to(device)
    return out


def _grads_of(params: PyTree, cfg: ModelConfig, batch: dict, *,
              remat: bool, unroll: bool, gather=None) -> tuple[PyTree, dict]:
    leaves = [t.detach().requires_grad_() for _, t in flatten(params)]
    loss, metrics = loss_fn(unflatten(params, leaves), cfg, batch,
                            remat=remat, unroll=unroll, gather=gather)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return (unflatten(params, grads),
            {k: v.detach() for k, v in metrics.items()})


def make_train_step(cfg: ModelConfig, opt: AdamWConfig, *,
                    accum: int = 1, remat: bool = True,
                    unroll: bool = False):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``batch`` holds "inputs" and "labels" (NumPy or tensors),
    moved to the parameters' device.  With ``accum > 1`` the batch's
    leading dim is split into microbatches and gradients are accumulated
    in f32, one microbatch at a time; the metrics are their means."""

    def step(params, opt_state, batch):
        device = flatten(params)[0][1].device
        batch = _to_device(batch, device)
        grads, metrics = accumulate_grads(params, cfg, batch, accum=accum,
                                          remat=remat, unroll=unroll)
        params, opt_state, opt_metrics = adamw_update(
            opt, params, grads, opt_state)
        return params, opt_state, {**metrics, **opt_metrics}

    return step


def accumulate_grads(params: PyTree, cfg: ModelConfig, batch: dict, *,
                     accum: int = 1, remat: bool = True,
                     unroll: bool = False, gather=None
                     ) -> tuple[PyTree, dict]:
    """The gradients of the loss on ``batch`` (tensors on the parameters'
    device) and its metrics; with ``accum > 1`` the batch's leading dim
    is split into microbatches whose gradients are accumulated in f32,
    one microbatch at a time, and whose metrics are averaged.  With
    ``gather`` (:func:`loss_fn`) ``params`` are this rank's blocks and so
    are the gradients and the f32 accumulator."""
    if accum == 1:
        return _grads_of(params, cfg, batch, remat=remat, unroll=unroll,
                         gather=gather)
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params)
    ms = []
    for i in range(accum):
        mb = {k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])[i]
              for k, v in batch.items()}
        g, m = _grads_of(params, cfg, mb, remat=remat, unroll=unroll,
                         gather=gather)
        acc = tree_map(lambda a, b: a + b.float(), acc, g)
        ms.append(m)
    grads = tree_map(lambda g: g / accum, acc)
    return grads, {k: torch.stack([m[k] for m in ms]).mean(0)
                   for k in ms[0]}


def make_eval_step(cfg: ModelConfig):
    def step(params, batch):
        device = flatten(params)[0][1].device
        with torch.no_grad():
            _, metrics = loss_fn(params, cfg, _to_device(batch, device),
                                 remat=False)
        return metrics

    return step
