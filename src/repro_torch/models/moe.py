"""Mixture-of-Experts with capacity-based, sort-free static dispatch (the
port of the reference's ``repro.models.moe``).

Static shapes: per-expert buffers of ``capacity`` slots, overflow tokens
dropped (Switch/GShard semantics, earlier tokens win); slot indices come
from a stable sort of the token-expert assignments and a
segment-relative rank, and tokens are gathered into an ``(E, C, d)``
buffer for a grouped matrix product per expert.  The router runs in
float32 on a float32 weight (kept float32 whatever the compute dtype),
with load-balance and z losses returned as aux terms.

With a tensor-parallel mesh axis bound (:mod:`repro_torch.dist.context`)
the layer takes the reference's distributed paths, each written as the
per-rank program of the reference's ``shard_map`` body over plain local
tensors and the collectives of ``dist.context``: expert parallelism
(``E % tp == 0``: fixed-capacity all-to-all to the experts' ranks and
back) or tensor parallelism inside the experts (each rank a ``d_ff``
slice of every expert, then an all-reduce).  The port's activations are
replicated over the ``model`` axis, so expert parallelism takes this
rank's slice of the sequence and all-gathers its output back.

The weights may be whole or this rank's ``model`` blocks as
``param_specs`` places them (:mod:`repro_torch.dist.tp`): a path takes
the slice of a whole weight it needs, uses a block that is already cut
along the dim it needs and re-cuts one that is not by an all-to-all; the
router and the shared experts are tensor-parallel dense layers on the
replicated tokens.  No weight is gathered over ``model``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..dist import context as dctx
from ..dist import tp
from .common import ModelConfig, act_fn, make_dense, normal

__all__ = ["MoE"]


def _expert_ffn(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """Grouped SwiGLU/GELU ffn over (E, C, d) buffers."""
    wg, wu, wd = (p["w_gate"].to(x.dtype), p["w_up"].to(x.dtype),
                  p["w_down"].to(x.dtype))
    if act == "swiglu":
        h = F.silu(torch.bmm(x, wg)) * torch.bmm(x, wu)
    else:
        h = act_fn("gelu")(torch.bmm(x, wg))
    return torch.bmm(h, wd)


class MoE:
    @staticmethod
    def init(gen: torch.Generator, cfg: ModelConfig, *, dtype,
             device) -> dict:
        d, E, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
        s_in = 1.0 / math.sqrt(d)
        s_out = 1.0 / math.sqrt(ff * 2 * cfg.n_layers)
        kw = {"dtype": dtype, "device": device}
        p = {
            "router": make_dense(gen, d, E, scale=s_in, dtype=torch.float32,
                                 device=device),
            "experts": {
                "w_gate": normal(gen, (E, d, ff), s_in, **kw),
                "w_up": normal(gen, (E, d, ff), s_in, **kw),
                "w_down": normal(gen, (E, ff, d), s_out, **kw),
            },
        }
        if cfg.n_shared_experts:
            ff_sh = ff * cfg.n_shared_experts
            p["shared"] = {
                "w_gate": make_dense(gen, d, ff_sh, scale=s_in, **kw),
                "w_up": make_dense(gen, d, ff_sh, scale=s_in, **kw),
                "w_down": make_dense(gen, ff_sh, d, scale=s_out, **kw),
            }
        return p

    @staticmethod
    def capacity(cfg: ModelConfig, n_tokens: int) -> int:
        c = int(math.ceil(n_tokens * cfg.top_k * cfg.capacity_factor
                          / cfg.n_experts))
        return max(8, -(-c // 8) * 8)  # pad to multiple of 8

    @staticmethod
    def fwd(p: dict, cfg: ModelConfig, x: torch.Tensor
            ) -> tuple[torch.Tensor, dict]:
        """x: (B, S, d) -> (y, aux terms).

        Dispatches as the reference does: with a tensor-parallel axis of
        size ``tp > 1`` bound on a mesh, expert parallelism where
        ``E % tp == 0`` (:meth:`_fwd_ep`), else tensor parallelism
        inside the experts (:meth:`_fwd_tp`); the local path otherwise.
        """
        tp = dctx.tp_size()
        if tp > 1 and dctx.mesh() is not None:
            if cfg.n_experts % tp == 0:
                return MoE._fwd_ep(p, cfg, x)
            return MoE._fwd_tp(p, cfg, x)
        if dctx.dp_size() > 1:
            return MoE._fwd_local(p, cfg, x,
                                  aux_axes=MoE._token_axes()[0])
        return MoE._fwd_local(p, cfg, x)

    @staticmethod
    def _fwd_local(p: dict, cfg: ModelConfig, x: torch.Tensor,
                   aux_axes: tuple = ()) -> tuple[torch.Tensor, dict]:
        """The whole layer on this rank's tokens.  With ``aux_axes`` (the
        data axes the rows are split over) the aux terms' means run over
        them too, as the reference's SPMD program takes them over the
        global batch; the capacity stays this rank's."""
        B, S, d = x.shape
        E, K = cfg.n_experts, cfg.top_k
        T = B * S
        xt = x.reshape(T, d)
        C = MoE.capacity(cfg, T)
        logits, probs, gates, flat_e, ranks, keep = MoE._route_local(
            cfg, MoE._router(p, cfg, xt), C)
        slot = flat_e * C + torch.where(keep, ranks, 0)        # (T*K,)
        token_idx = torch.arange(T, device=x.device).repeat_interleave(K)
        # Scatter tokens into the (E*C, d) buffer; a dropped assignment
        # adds zeros to its expert's slot 0.
        contrib = torch.where(keep[:, None], xt[token_idx], 0.0)
        buf = torch.zeros((E * C, d), dtype=x.dtype,
                          device=x.device).index_add(0, slot, contrib)
        y_buf = _expert_ffn(p["experts"], buf.reshape(E, C, d), cfg.act)
        y = MoE._combine(y_buf.reshape(E * C, d)[slot], keep, gates, T, K,
                         x.dtype)
        y = y + MoE._shared(p, cfg, xt)
        aux = MoE._aux_of(cfg, logits, probs, flat_e, keep, aux_axes)
        return y.reshape(B, S, d), aux

    # ------------------------------------------------------------------
    # The pieces every path shares, then the distributed paths: the
    # per-rank programs of the reference's shard_map bodies, over the
    # bound mesh's "model" axis.
    # ------------------------------------------------------------------

    @staticmethod
    def _router(p, cfg, xt):
        """The f32 router's logits (t, E) on the tokens ``xt`` (t, d),
        replicated over ``model`` where a ``tp`` axis is bound (an
        input-split router sums its ranks' partial products)."""
        shape = (cfg.d_model, cfg.n_experts)
        w = tp.dense_blocks(p["router"], shape)
        y, _ = tp.tp_dense({"w": w["w"].float()}, xt.float(), shape=shape)
        return y

    @staticmethod
    def _route_local(cfg, logits, capacity):
        """Routing from the router's ``logits`` (t, E): top-k gates
        renormalised, each assignment's rank in its expert's queue."""
        E, K = cfg.n_experts, cfg.top_k
        t = logits.shape[0]
        dev = logits.device
        probs = torch.softmax(logits, dim=-1)
        gate_vals, expert_ids = torch.topk(probs, K, dim=-1)
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
        # ---- slot assignment without (t, E) one-hots ------------------
        flat_e = expert_ids.reshape(-1)                        # (t*K,)
        # Priority: earlier tokens win capacity (GShard semantics).
        order = torch.argsort(flat_e, stable=True)             # group by expert
        sorted_e = flat_e[order]
        # Counts by scatter, not bincount: no host sync on the card.
        counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
            0, flat_e, torch.ones_like(flat_e))
        starts = torch.cumsum(counts, 0) - counts
        ranks_sorted = torch.arange(t * K, device=dev) - starts[sorted_e]
        ranks = torch.empty_like(ranks_sorted).scatter_(0, order,
                                                        ranks_sorted)
        keep = ranks < capacity
        return logits, probs, gate_vals, flat_e, ranks, keep

    @staticmethod
    def _aux_of(cfg, logits, probs, flat_e, keep, axes):
        """The aux terms, each mean taken over the token axes ``axes``
        too (the reference's ``pmean``s: one all-reduce of the four means
        side by side, over the ranks' count)."""
        E, K = cfg.n_experts, cfg.top_k
        t = probs.shape[0]
        counts = torch.zeros(E, dtype=torch.long,
                             device=flat_e.device).scatter_add_(
            0, flat_e, torch.ones_like(flat_e))
        means = torch.cat([probs.mean(0), counts.float() / (t * K),
                           torch.logsumexp(logits, -1).square().mean()[None],
                           (1.0 - keep.float().mean())[None]])
        if axes:
            means = dctx.all_reduce(means, axes) / dctx.axis_size(axes)
        me, frac, z, drop = means.split([E, E, 1, 1])
        return {"moe_lb_loss": E * torch.sum(frac * me),
                "moe_z_loss": z[0], "moe_drop_frac": drop[0]}

    @staticmethod
    def _shared(p, cfg, xt):
        """Shared experts (0 where there are none) on the tokens ``xt``
        (t, d), replicated over ``model`` where a ``tp`` axis is bound:
        tensor-parallel dense layers on this rank's blocks."""
        if "shared" not in p:
            return 0.0
        sh = p["shared"]
        d, ff = cfg.d_model, cfg.moe_d_ff * cfg.n_shared_experts
        g, blk = tp.tp_dense(tp.dense_blocks(sh["w_gate"], (d, ff)), xt,
                             shape=(d, ff), keep_block=True)
        if cfg.act == "swiglu":
            u, _ = tp.tp_dense(tp.dense_blocks(sh["w_up"], (d, ff)), xt,
                               shape=(d, ff), keep_block=True)
            h = F.silu(g) * u
        else:
            h = act_fn("gelu")(g)
        y, _ = tp.tp_dense(tp.dense_blocks(sh["w_down"], (ff, d)), h,
                           shape=(ff, d), x_block=blk)
        return y

    @staticmethod
    def _experts(p, cfg, dims):
        """This rank's blocks of the expert weights along ``dims`` (one a
        weight: the experts for EP, ``d_ff`` for TP) by
        :func:`repro_torch.dist.tp.as_block`."""
        E, d, ff = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
        shapes = {"w_gate": (E, d, ff), "w_up": (E, d, ff),
                  "w_down": (E, ff, d)}
        return {k: tp.as_block(w, shapes[k], dims[k])
                for k, w in p["experts"].items()}

    @staticmethod
    def _combine(y_flat, keep, gates, t: int, K: int, dtype):
        """Each kept assignment's output weighted by its gate, the K of a
        token added in k order onto zeros, as :meth:`_fwd_local` does."""
        w = torch.where(keep, gates.reshape(-1), 0.0).to(dtype)
        yk = (y_flat * w[:, None]).reshape(t, K, -1)
        y = torch.zeros((t, yk.shape[-1]), dtype=dtype, device=y_flat.device)
        for k in range(K):
            y = y + yk[:, k]
        return y

    @staticmethod
    def _token_axes():
        """The data axes this rank's rows are split over (the bound "dp"
        axes: the port's programs hold their own rows only)."""
        dp_ax, tp_ax = dctx.activation_axes()
        return dctx.as_axes(dp_ax), tp_ax

    @staticmethod
    def _fwd_ep(p: dict, cfg: ModelConfig, x: torch.Tensor
                ) -> tuple[torch.Tensor, dict]:
        """Expert parallelism: this rank's tokens (its rows, and its
        slice of the sequence where ``S % tp == 0``) go by a
        fixed-capacity all-to-all to the ranks that hold their experts,
        through the grouped FFN on this rank's ``E // tp`` experts, and
        back; the output is all-gathered over the sequence again.  The
        router and the shared experts run on the whole (replicated)
        sequence."""
        b_axes, tp_ax = MoE._token_axes()
        B, S, d = x.shape
        E, K = cfg.n_experts, cfg.top_k
        m = dctx.tp_size()
        E_loc = E // m
        r = dctx.axis_index(tp_ax)
        s_split = S % m == 0
        logits = MoE._router(p, cfg, x.reshape(-1, d))
        shared = MoE._shared(p, cfg, x.reshape(-1, d))
        if s_split:
            S_loc = S // m
            x = x[:, r * S_loc:(r + 1) * S_loc]
            logits = logits.reshape(B, S, E)[:, r * S_loc:(r + 1) * S_loc]
        xt = x.reshape(-1, d)
        logits = logits.reshape(-1, E)
        t = xt.shape[0]
        c_se = max(4, -(-int(t * K * cfg.capacity_factor / E) // 4) * 4)
        dev = xt.device

        logits, probs, gates, flat_e, ranks, keep = MoE._route_local(
            cfg, logits, c_se)
        dest = flat_e // E_loc
        eslot = flat_e % E_loc
        slot = dest * (E_loc * c_se) + eslot * c_se + \
            torch.where(keep, ranks, 0)
        token_idx = torch.arange(t, device=dev).repeat_interleave(K)
        contrib = torch.where(keep[:, None], xt[token_idx], 0.0)
        send = torch.zeros((m * E_loc * c_se, d), dtype=xt.dtype,
                           device=dev).index_add(0, slot, contrib)
        recv = dctx.all_to_all(send, tp_ax)
        buf = recv.reshape(m, E_loc, c_se, d).transpose(0, 1)
        buf = buf.reshape(E_loc, m * c_se, d)
        mine = MoE._experts(p, cfg, {"w_gate": 0, "w_up": 0, "w_down": 0})
        y_buf = _expert_ffn(mine, buf, cfg.act)
        back = y_buf.reshape(E_loc, m, c_se, d).transpose(0, 1)
        ret = dctx.all_to_all(back.reshape(m * E_loc * c_se, d), tp_ax)
        y = MoE._combine(ret[slot], keep, gates, t, K, xt.dtype)
        aux = MoE._aux_of(cfg, logits, probs, flat_e, keep,
                          b_axes + ((tp_ax,) if s_split else ()))
        y = y.reshape(x.shape)
        if s_split:
            y = dctx.all_gather(y, tp_ax, dim=1)
        return (y.reshape(-1, d) + shared).reshape(B, S, d), aux

    @staticmethod
    def _fwd_tp(p: dict, cfg: ModelConfig, x: torch.Tensor
                ) -> tuple[torch.Tensor, dict]:
        """Experts too few to shard: every rank routes its tokens, runs
        its ``d_ff`` slice of every expert (and of the shared experts),
        and the outputs are summed over the ``model`` axis."""
        b_axes, tp_ax = MoE._token_axes()
        B, S, d = x.shape
        E, K = cfg.n_experts, cfg.top_k
        xt = x.reshape(-1, d)
        t = xt.shape[0]
        C = max(8, -(-int(t * K * cfg.capacity_factor / E) // 8) * 8)
        dev = xt.device
        mine = MoE._experts(p, cfg, {"w_gate": 2, "w_up": 2, "w_down": 1})
        logits, probs, gates, flat_e, ranks, keep = MoE._route_local(
            cfg, MoE._router(p, cfg, xt), C)
        slot = flat_e * C + torch.where(keep, ranks, 0)
        token_idx = torch.arange(t, device=dev).repeat_interleave(K)
        contrib = torch.where(keep[:, None], xt[token_idx], 0.0)
        buf = torch.zeros((E * C, d), dtype=xt.dtype,
                          device=dev).index_add(0, slot, contrib)
        y_buf = _expert_ffn(mine, buf.reshape(E, C, d), cfg.act)
        y = MoE._combine(y_buf.reshape(E * C, d)[slot], keep, gates, t, K,
                         xt.dtype)
        y = dctx.all_reduce(y, tp_ax)
        y = y + MoE._shared(p, cfg, xt)
        aux = MoE._aux_of(cfg, logits, probs, flat_e, keep, b_axes)
        return y.reshape(B, S, d), aux
