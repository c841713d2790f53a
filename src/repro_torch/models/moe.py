"""Mixture-of-Experts with capacity-based, sort-free static dispatch (the
port of the reference's ``repro.models.moe``, local path).

Static shapes: per-expert buffers of ``capacity`` slots, overflow tokens
dropped (Switch/GShard semantics, earlier tokens win); slot indices come
from a stable sort of the token-expert assignments and a
segment-relative rank, and tokens are gathered into an ``(E, C, d)``
buffer for a grouped matrix product per expert.  The router runs in
float32 on a float32 weight (kept float32 whatever the compute dtype),
with load-balance and z losses returned as aux terms.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import ModelConfig, act_fn, dense, make_dense, normal

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
        """x: (B, S, d) -> (y, aux terms).  The local path only: the
        reference's expert- and tensor-parallel paths need a mesh and come
        with the distribution slice (ROADMAP item 13)."""
        return MoE._fwd_local(p, cfg, x)

    @staticmethod
    def _fwd_local(p: dict, cfg: ModelConfig, x: torch.Tensor
                   ) -> tuple[torch.Tensor, dict]:
        B, S, d = x.shape
        E, K = cfg.n_experts, cfg.top_k
        T = B * S
        dev = x.device
        xt = x.reshape(T, d)
        C = MoE.capacity(cfg, T)

        logits = xt.float() @ p["router"]["w"].float()         # (T, E)
        probs = torch.softmax(logits, dim=-1)
        gate_vals, expert_ids = torch.topk(probs, K, dim=-1)   # (T, K)
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

        # ---- slot assignment without (T, E) one-hots ------------------
        flat_e = expert_ids.reshape(-1)                        # (T*K,)
        # Priority: earlier tokens win capacity (GShard semantics).
        order = torch.argsort(flat_e, stable=True)             # group by expert
        sorted_e = flat_e[order]
        # Counts by scatter, not bincount: no host sync on the card.
        counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
            0, flat_e, torch.ones_like(flat_e))
        starts = torch.cumsum(counts, 0) - counts
        ranks_sorted = torch.arange(T * K, device=dev) - starts[sorted_e]
        ranks = torch.empty_like(ranks_sorted).scatter_(0, order,
                                                        ranks_sorted)
        keep = ranks < C                                       # (T*K,)

        slot = flat_e * C + torch.where(keep, ranks, 0)        # (T*K,)
        token_idx = torch.arange(T, device=dev).repeat_interleave(K)
        # Scatter tokens into the (E*C, d) buffer; a dropped assignment
        # adds zeros to its expert's slot 0.
        contrib = torch.where(keep[:, None], xt[token_idx], 0.0)
        buf = torch.zeros((E * C, d), dtype=x.dtype, device=dev)
        buf.index_add_(0, slot, contrib)
        y_buf = _expert_ffn(p["experts"], buf.reshape(E, C, d), cfg.act)

        # Combine: each kept assignment's output weighted by its gate,
        # the K of a token added in k order onto zeros, as the
        # reference's scatter-add does.
        y_flat = y_buf.reshape(E * C, d)[slot]                 # (T*K, d)
        w = torch.where(keep, gate_vals.reshape(-1), 0.0).to(x.dtype)
        yk = (y_flat * w[:, None]).reshape(T, K, d)
        y = torch.zeros((T, d), dtype=x.dtype, device=dev)
        for k in range(K):
            y = y + yk[:, k]

        if "shared" in p:
            sh = p["shared"]
            if cfg.act == "swiglu":
                h = F.silu(dense(sh["w_gate"], xt)) * dense(sh["w_up"], xt)
            else:
                h = act_fn("gelu")(dense(sh["w_gate"], xt))
            y = y + dense(sh["w_down"], h)

        # ---- aux losses ----------------------------------------------
        me = probs.mean(0)                                     # (E,)
        frac = counts.float() / (T * K)
        aux = {"moe_lb_loss": E * torch.sum(frac * me),
               "moe_z_loss": torch.logsumexp(logits, -1).square().mean(),
               "moe_drop_frac": 1.0 - keep.float().mean()}
        return y.reshape(B, S, d), aux
