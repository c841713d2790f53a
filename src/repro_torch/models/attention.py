"""Grouped-query attention, decode half (the port of the reference's
``repro.models.attention`` GQA decode path).

``GQA.decode`` writes the new token's K/V into its cache slot in place
and attends through the decode-attention op
(:func:`repro_torch.kernels.ops.decode_attention`: the Hopper kernel on
CUDA tensors).  :func:`decode_sdpa` is the plain twin of the
reference's model-path core, kept for parity checks.  The full-sequence
``fwd`` (flash attention) and MLA come with later slices.
"""

from __future__ import annotations

import math

import torch

from ..kernels import ops
from .common import ModelConfig, apply_rope, dense, make_dense, rope_tables

__all__ = ["GQA", "decode_sdpa"]

_NEG_INF = -1e30


def decode_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                length_mask: torch.Tensor, *, scale: float) -> torch.Tensor:
    """Single-position attention against a (possibly oversized) cache,
    as the reference's ``decode_sdpa`` computes it: the normalised
    softmax weights are rounded to the cache dtype before the P.V
    product.

    q: (B, H, Dk)  k/v: (B, T, Hkv, D*)  length_mask: (B, T) bool valid.
    """
    B, H, Dk = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    qg = q.reshape(B, Hkv, g, Dk)
    logits = torch.einsum("bhgd,bthd->bhgt", qg.float(), k.float()) * scale
    logits = torch.where(length_mask[:, None, None, :], logits, _NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgt,bthd->bhgd", w.to(v.dtype), v)
    return out.reshape(B, H, v.shape[-1])


class GQA:
    """Grouped-query attention with RoPE, bias and sliding-window options."""

    @staticmethod
    def init(gen: torch.Generator, cfg: ModelConfig, *, dtype, device) -> dict:
        d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        b = cfg.qkv_bias
        kw = {"dtype": dtype, "device": device}
        return {
            "wq": make_dense(gen, d, H * hd, bias=b, **kw),
            "wk": make_dense(gen, d, Hkv * hd, bias=b, **kw),
            "wv": make_dense(gen, d, Hkv * hd, bias=b, **kw),
            "wo": make_dense(gen, H * hd, d,
                             scale=1.0 / math.sqrt(H * hd * 2 * cfg.n_layers),
                             **kw),
        }

    @staticmethod
    def _qkv(p: dict, cfg: ModelConfig, x: torch.Tensor):
        B, S, _ = x.shape
        q = dense(p["wq"], x).reshape(B, S, cfg.n_heads, cfg.head_dim)
        k = dense(p["wk"], x).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
        v = dense(p["wv"], x).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
        return q, k, v

    @staticmethod
    def init_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16, *,
                   device="cuda") -> dict:
        # Sliding-window models only ever need `window` cache slots
        # (ring buffer); full attention needs max_len.
        slots = min(max_len, cfg.sliding_window or max_len)
        shape = (batch, slots, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    @staticmethod
    def decode(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict,
               pos: int) -> tuple[torch.Tensor, dict]:
        """x: (B, 1, d); pos: count of tokens already in the cache.

        Writes K/V into ``cache`` in place (slot ``pos % slots``) and
        returns the same dict.  The valid cache prefix is
        ``min(pos + 1, slots)`` positions: ``idx <= pos`` for a full
        cache, and the whole ring buffer once a sliding window is warm —
        the reference's mask (``attention.py:261-267``) in both cases."""
        B = x.shape[0]
        q, k, v = GQA._qkv(p, cfg, x)
        if cfg.use_rope:
            positions = torch.full((1,), pos, dtype=torch.int32,
                                   device=x.device)
            cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
            q = apply_rope(q, cos[None], sin[None])
            k = apply_rope(k, cos[None], sin[None])
        slots = cache["k"].shape[1]
        slot = pos % slots
        cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
        lengths = torch.full((B,), min(pos + 1, slots), dtype=torch.int32,
                             device=x.device)
        out = ops.decode_attention(q[:, 0], cache["k"], cache["v"], lengths)
        y = dense(p["wo"], out.reshape(B, 1, -1).to(x.dtype))
        return y, cache
