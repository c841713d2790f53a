"""Grouped-query attention (the port of the reference's
``repro.models.attention`` GQA half).

``GQA.fwd`` is the full-sequence layer: by default it attends through
the flash-attention op (:func:`repro_torch.kernels.ops.flash_attention`:
the Hopper kernel on CUDA tensors); ``impl="xla"`` runs the plain twins
of the reference's XLA path instead, :func:`sdpa` with
:func:`causal_mask_bias` up to S = 2048 and :func:`blockwise_sdpa`
above, exactly the reference's branch.  ``GQA.decode`` writes the new
token's K/V into its cache slot in place and attends through the
decode-attention op (:func:`repro_torch.kernels.ops.decode_attention`).
:func:`decode_sdpa` is the plain twin of the reference's decode core.
The twins serve parity checks; the kernels are the path on the card.

``MLA`` is DeepSeek-V2's multi-head latent attention.  As in the
reference, it has no kernel branch: ``MLA.fwd`` runs :func:`sdpa` /
:func:`blockwise_sdpa` on every device (its q/k head dim 192 differs
from v's 128, outside the flash kernel's contract), and ``MLA.decode``
is the reference's absorbed form, a few einsums against the compressed
cache.  Its RMSNorms (``q_norm``, ``kv_norm``) go through the RMSNorm
op like every other norm.

Under tensor parallelism (a ``tp`` axis bound, the weights this rank's
``model`` blocks: :mod:`repro_torch.dist.tp`) both attend this rank's
heads, as the reference's ``constrain(q|k|v, ("dp", None, "tp",
None))`` places them, and ``wo``'s output is all-reduced, so the
residual stream stays whole.  Their decodes read a cache placed by
``cache_specs``: over a slot block GQA merges the ranks' decode
attention by its log-sum-exp and MLA runs the reference's partitioned
softmax.
"""

from __future__ import annotations

import math

import torch

from ..dist import context as dctx
from ..dist import tp
from ..kernels import ops
from ..kernels.decode_attention import merge_partials
from .common import ModelConfig, apply_rope, make_dense, rope_tables

__all__ = ["GQA", "MLA", "sdpa", "blockwise_sdpa", "decode_sdpa",
           "causal_mask_bias"]

_NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Scaled-dot-product cores (plain twins of the reference's XLA path)
# ---------------------------------------------------------------------------

def causal_mask_bias(q_len: int, kv_len: int, *, causal: bool,
                     window: int | None, q_offset: int = 0,
                     device=None) -> torch.Tensor:
    """(q_len, kv_len) f32 additive bias implementing causal + sliding
    window."""
    qi = torch.arange(q_len, device=device)[:, None] + q_offset
    ki = torch.arange(kv_len, device=device)[None, :]
    ok = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        ok &= ki <= qi
    if window is not None:
        ok &= ki > qi - window
    return torch.where(ok, 0.0, _NEG_INF).float()


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         bias: torch.Tensor | None, *, scale: float) -> torch.Tensor:
    """Scaled-dot-product attention with GQA head grouping, as the
    reference's ``sdpa`` computes it: f32 scores and softmax, weights
    rounded to v's dtype for the P.V product.

    q: (B, S, H, Dk)   k: (B, T, Hkv, Dk)   v: (B, T, Hkv, Dv)
    bias: (S, T) additive or None.
    """
    B, S, H, Dk = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, H // Hkv, Dk)
    logits = torch.einsum("bshgd,bthd->bhgst", qg.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", w.to(v.dtype), v)
    return out.reshape(B, S, H, v.shape[-1])


def blockwise_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   scale: float, causal: bool, window: int | None,
                   q_chunk: int = 1024, kv_chunk: int = 1024
                   ) -> torch.Tensor:
    """Flash-style online-softmax attention over (q_chunk, kv_chunk)
    score tiles, as the reference's ``blockwise_sdpa`` computes it
    (without its sharding constraints: the port has no mesh yet).  For
    sliding-window attention each query chunk visits a fixed-width KV
    span (window + q_chunk, rounded up to whole chunks), so the cost is
    O(S * window)."""
    B, S, H, Dk = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    Dv = v.shape[-1]
    while S % q_chunk:
        q_chunk //= 2
    while T % kv_chunk:
        kv_chunk //= 2
    span = None
    if window is not None and causal:
        span = min(T, -(-(window + q_chunk) // kv_chunk) * kv_chunk)
    blocks = []
    for q_off in range(0, S, q_chunk):
        qb = q[:, q_off:q_off + q_chunk].reshape(B, q_chunk, Hkv, g, Dk)
        if span is not None:
            kv_start = min(max(q_off + q_chunk - span, 0), T - span)
            nkv = span // kv_chunk
        else:
            kv_start, nkv = 0, T // kv_chunk
        m = torch.full((B, Hkv, g, q_chunk), _NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, Hkv, g, q_chunk), dtype=torch.float32,
                        device=q.device)
        o = torch.zeros((B, Hkv, g, q_chunk, Dv), dtype=torch.float32,
                        device=q.device)
        for ki in range(nkv):
            kv_off = kv_start + ki * kv_chunk
            kb = k[:, kv_off:kv_off + kv_chunk]
            vb = v[:, kv_off:kv_off + kv_chunk]
            s = torch.einsum("bshgd,bthd->bhgst", qb.float(),
                             kb.float()) * scale
            bias = causal_mask_bias(q_chunk, kv_chunk, causal=causal,
                                    window=window, q_offset=q_off - kv_off,
                                    device=q.device)
            s = s + bias
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = torch.einsum("bhgst,bthd->bhgsd", p.to(vb.dtype), vb)
            o = o * corr[..., None] + pv
            m = m_new
        o = o / torch.clamp(l, min=1e-30)[..., None]
        # (B, Hkv, g, qc, Dv) -> (B, qc, H, Dv)
        blocks.append(o.permute(0, 3, 1, 2, 4).reshape(B, q_chunk, H, Dv)
                      .to(v.dtype))
    return torch.cat(blocks, dim=1)


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
    def _qkv(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
             x_block: bool = False, local: bool = True):
        """q (B, S, Hq, hd), k and v (B, S, Hk, hd).  On one rank every
        head.  Under tensor parallelism with ``local`` and ``H % tp ==
        0``: this rank's q heads (a reduce-scatter of an input-split
        projection, the columns of an output-split one) and the kv heads
        they read (this rank's where ``Hkv % tp == 0``, else taken from
        the whole k and v); otherwise every head on every rank."""
        B, S, _ = x.shape
        m, r, _ = tp.tp_axis()
        H, Hkv, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
        local = local and m > 1 and H % m == 0

        def proj(name, heads, block):
            y, is_block = tp.tp_dense(p[name], x, shape=(d, heads * hd),
                                      x_block=x_block, keep_block=block)
            if block and not is_block:
                y = tp.rank_block(y)
            return y.reshape(B, S, -1, hd)

        q = proj("wq", H, local)
        kv_local = local and Hkv % m == 0
        k, v = proj("wk", Hkv, kv_local), proj("wv", Hkv, kv_local)
        if local and not kv_local:
            k, v = GQA._kv_for(k, cfg, m, r), GQA._kv_for(v, cfg, m, r)
        return q, k, v

    @staticmethod
    def _kv_for(k: torch.Tensor, cfg: ModelConfig, m: int, r: int):
        """The kv heads that rank ``r``'s ``H / m`` query heads read, from
        every kv head (dim 2), grouped as the local GQA needs them."""
        Hl, g = cfg.n_heads // m, cfg.q_per_kv
        if Hl % g == 0:
            return k[:, :, r * Hl // g:(r + 1) * Hl // g]
        if g % Hl == 0:
            return k[:, :, r * Hl // g:r * Hl // g + 1]
        idx = (r * Hl + torch.arange(Hl, device=k.device)) // g
        return k[:, :, idx]

    @staticmethod
    def _out(p: dict, cfg: ModelConfig, out: torch.Tensor,
             heads_local: bool) -> torch.Tensor:
        """``wo`` on the attention output (this rank's heads where
        ``heads_local``): the residual stream's whole features."""
        H, hd = cfg.n_heads, cfg.head_dim
        y, _ = tp.tp_dense(p["wo"], out, shape=(H * hd, cfg.d_model),
                           x_block=heads_local)
        return y

    @staticmethod
    def fwd(p: dict, cfg: ModelConfig, x: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor, *, impl: str = "kernel",
            x_block: bool = False) -> torch.Tensor:
        """Full-sequence attention layer.  x: (B, S, d) (this rank's block
        of its features where ``x_block``); cos/sin: (S, head_dim/2).
        ``impl="kernel"`` (the default) attends through
        ``ops.flash_attention``; ``impl="xla"`` through the plain twins
        of the reference's XLA path.  Under tensor parallelism each rank
        attends its own heads (:meth:`_qkv`) and ``wo``'s output is
        all-reduced: the residual stays whole on every rank."""
        B, S, _ = x.shape
        m = tp.tp_axis()[0]
        q, k, v = GQA._qkv(p, cfg, x, x_block=x_block)
        if cfg.use_rope:
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
        scale = 1.0 / math.sqrt(cfg.head_dim)
        if impl == "kernel":
            out = ops.flash_attention(q, k, v, causal=cfg.causal,
                                      window=cfg.sliding_window)
        elif impl != "xla":
            raise ValueError(f"impl must be 'kernel' or 'xla', not {impl!r}")
        elif S > 2048:
            out = blockwise_sdpa(q, k, v, scale=scale, causal=cfg.causal,
                                 window=cfg.sliding_window)
        else:
            bias = causal_mask_bias(S, S, causal=cfg.causal,
                                    window=cfg.sliding_window,
                                    device=x.device)
            out = sdpa(q, k, v, bias, scale=scale)
        return GQA._out(p, cfg, out.reshape(B, S, -1),
                        m > 1 and q.shape[2] < cfg.n_heads)

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
               pos: int, *, x_block: bool = False,
               cspec: dict | None = None) -> tuple[torch.Tensor, dict]:
        """x: (B, 1, d) (this rank's feature block where ``x_block``); pos:
        count of tokens already in the cache.

        Writes K/V into ``cache`` in place (slot ``pos % slots``) and
        returns the same dict.  The valid cache prefix is
        ``min(pos + 1, slots)`` positions: ``idx <= pos`` for a full
        cache, and the whole ring buffer once a sliding window is warm —
        the reference's mask (``attention.py:261-267``) in both cases.

        Under tensor parallelism ``cache`` holds this rank's blocks,
        placed by ``cspec`` (``cache_specs``' entries for "k" and "v";
        None: whole).  Slots split over ``model``: every rank attends
        every head over its slot block (the rank holding slot ``pos %
        slots`` writes the new K/V), the kernel also returning each row's
        log-sum-exp, and the ranks' ``(out, lse)`` pairs are all-gathered
        and merged in rank order.  KV heads split: each rank decodes its
        own heads.  Any other split dim: the cache is gathered for the
        step and cut back after it."""
        B = x.shape[0]
        m, r, ax = tp.tp_axis()
        split = tp.model_dim(cspec["k"]) if (m > 1 and cspec) else None
        if split not in (None, 1, 2):
            whole = {k: dctx.all_gather(c, ax, dim=split)
                     for k, c in cache.items()}
            y, whole = GQA.decode(p, cfg, x, whole, pos, x_block=x_block)
            for k, c in cache.items():
                c.copy_(tp.rank_block(whole[k], split))
            return y, cache
        q, k, v = GQA._qkv(p, cfg, x, x_block=x_block, local=split == 2)
        if cfg.use_rope:
            positions = torch.full((1,), pos, dtype=torch.int32,
                                   device=x.device)
            cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
            q = apply_rope(q, cos[None], sin[None])
            k = apply_rope(k, cos[None], sin[None])
        T_r = cache["k"].shape[1]
        slots = T_r * m if split == 1 else T_r
        slot = pos % slots
        first = r * T_r if split == 1 else 0
        if first <= slot < first + T_r:
            cache["k"][:, slot - first] = k[:, 0].to(cache["k"].dtype)
            cache["v"][:, slot - first] = v[:, 0].to(cache["v"].dtype)
        n = min(max(min(pos + 1, slots) - first, 0), T_r)
        lengths = torch.full((B,), n, dtype=torch.int32, device=x.device)
        if split == 1:
            out, lse = ops.decode_attention(q[:, 0], cache["k"], cache["v"],
                                            lengths, return_lse=True)
            parts = dctx.all_gather(
                torch.cat([out.float(), lse[..., None]], -1)[None], ax, 0)
            out = merge_partials(parts[..., :-1], parts[..., -1]).to(q.dtype)
        else:
            out = ops.decode_attention(q[:, 0], cache["k"], cache["v"],
                                       lengths)
        y = GQA._out(p, cfg, out.reshape(B, 1, -1).to(x.dtype),
                     m > 1 and q.shape[2] < cfg.n_heads)
        return y, cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------

class MLA:
    """Multi-head latent attention with a low-rank compressed KV cache.

    The cache holds only ``c_kv`` (kv_lora_rank) and the rope key shared
    by the heads (qk_rope_head_dim) per token.  Decode uses the
    *absorbed* form, so it attends to the compressed cache directly.
    """

    @staticmethod
    def init(gen: torch.Generator, cfg: ModelConfig, *, dtype, device) -> dict:
        d, H = cfg.d_model, cfg.n_heads
        r_kv, r_q = cfg.kv_lora_rank, cfg.q_lora_rank
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        kw = {"dtype": dtype, "device": device}
        p = {
            "w_dkv": make_dense(gen, d, r_kv, **kw),
            "w_krope": make_dense(gen, d, dr, **kw),
            "w_uk": make_dense(gen, r_kv, H * dn, **kw),
            "w_uv": make_dense(gen, r_kv, H * dv, **kw),
            "wo": make_dense(gen, H * dv, d,
                             scale=1.0 / math.sqrt(H * dv * 2 * cfg.n_layers),
                             **kw),
            "kv_norm": {"scale": torch.ones((r_kv,), dtype=torch.float32,
                                            device=device)},
        }
        if r_q:
            p["w_dq"] = make_dense(gen, d, r_q, **kw)
            p["w_uq"] = make_dense(gen, r_q, H * (dn + dr), **kw)
            p["q_norm"] = {"scale": torch.ones((r_q,), dtype=torch.float32,
                                               device=device)}
        else:
            p["wq"] = make_dense(gen, d, H * (dn + dr), **kw)
        return p

    @staticmethod
    def _heads(cfg: ModelConfig) -> int:
        """The heads this rank computes: its ``H / tp`` where they split,
        else all of them (the forward only: see :meth:`decode`)."""
        m = tp.tp_axis()[0]
        return cfg.n_heads // m if cfg.n_heads % m == 0 else cfg.n_heads

    @staticmethod
    def _head_proj(p: dict, x: torch.Tensor, shape, x_block: bool = False,
                   local: bool = True) -> torch.Tensor:
        """A per-head projection's output for this rank's heads (its
        columns of an output-split weight, the reduce-scatter of an
        input-split one), or with ``local`` False every head's."""
        y, is_block = tp.tp_dense(p, x, shape=shape, x_block=x_block,
                                  keep_block=local)
        if not local:
            return y
        return y if is_block else tp.rank_block(y)

    @staticmethod
    def _head_cols(w: torch.Tensor, shape, heads: int) -> torch.Tensor:
        """This rank's head columns of the whole-shape ``(r_kv, H * dh)``
        weight ``w`` holds a block of, as ``(r_kv, heads, dh)``."""
        return tp.as_block(w, shape, 1).reshape(shape[0], heads, -1)

    @staticmethod
    def _q(p: dict, cfg: ModelConfig, x: torch.Tensor, x_block: bool = False):
        B, S, _ = x.shape
        d, H = cfg.d_model, cfg.n_heads
        dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        local = MLA._heads(cfg) < H
        if "w_dq" in p:
            r_q = cfg.q_lora_rank
            cq, _ = tp.tp_dense(p["w_dq"], x, shape=(d, r_q),
                                x_block=x_block)
            cq, blk = tp.tp_norm(p["q_norm"], cq, "rmsnorm")
            q = MLA._head_proj(p["w_uq"], cq, (r_q, H * (dn + dr)), blk,
                               local)
        else:
            q = MLA._head_proj(p["wq"], x, (d, H * (dn + dr)), x_block,
                               local)
        q = q.reshape(B, S, -1, dn + dr)
        return q[..., :dn], q[..., dn:]

    @staticmethod
    def _ckv(p: dict, cfg: ModelConfig, x: torch.Tensor,
             x_block: bool = False):
        # Two GEMMs, not one sliced: the RMSNorm kernel takes contiguous
        # rows only.  Both outputs are whole on every rank.
        d, r_kv = cfg.d_model, cfg.kv_lora_rank
        c_kv, _ = tp.tp_dense(p["w_dkv"], x, shape=(d, r_kv),
                              x_block=x_block)
        c_kv = tp.full(*tp.tp_norm(p["kv_norm"], c_kv, "rmsnorm"))
        # (B, S, dr) shared across heads
        k_rope, _ = tp.tp_dense(p["w_krope"], x,
                                shape=(d, cfg.qk_rope_head_dim),
                                x_block=x_block)
        return c_kv, k_rope

    @staticmethod
    def fwd(p: dict, cfg: ModelConfig, x: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor, *, impl: str = "kernel",
            x_block: bool = False) -> torch.Tensor:
        """Full-sequence causal layer.  x: (B, S, d) (this rank's feature
        block where ``x_block``); cos/sin: (S, qk_rope_head_dim/2).
        ``impl`` is accepted for the layer signature: both values run
        :func:`sdpa` up to S = 2048 and :func:`blockwise_sdpa` above, the
        reference's branch.  Under tensor parallelism each rank attends
        its own heads, as :meth:`GQA.fwd` does (every head, from whole
        projections, where the heads do not split over ``model``)."""
        if impl not in ("kernel", "xla"):
            raise ValueError(f"impl must be 'kernel' or 'xla', not {impl!r}")
        B, S, _ = x.shape
        H, Hl = cfg.n_heads, MLA._heads(cfg)
        r_kv = cfg.kv_lora_rank
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        q_nope, q_rope = MLA._q(p, cfg, x, x_block)
        c_kv, k_rope = MLA._ckv(p, cfg, x, x_block)
        q_rope = apply_rope(q_rope, cos, sin)
        k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)  # (B,S,1,dr)
        local = Hl < H
        k_nope = MLA._head_proj(p["w_uk"], c_kv, (r_kv, H * dn),
                                local=local).reshape(B, S, Hl, dn)
        v = MLA._head_proj(p["w_uv"], c_kv, (r_kv, H * dv),
                           local=local).reshape(B, S, Hl, dv)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope.expand(B, S, Hl, dr)], dim=-1)
        scale = 1.0 / math.sqrt(dn + dr)
        if S > 2048:
            out = blockwise_sdpa(q, k, v, scale=scale, causal=True,
                                 window=None)
        else:
            bias = causal_mask_bias(S, S, causal=True, window=None,
                                    device=x.device)
            out = sdpa(q, k, v, bias, scale=scale)
        y, _ = tp.tp_dense(p["wo"], out.reshape(B, S, -1),
                           shape=(H * dv, cfg.d_model), x_block=Hl < H)
        return y

    # -- decode (absorbed form) ---------------------------------------
    @staticmethod
    def init_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16, *,
                   device="cuda") -> dict:
        kw = {"dtype": dtype, "device": device}
        return {
            "c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank), **kw),
            "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_head_dim),
                                  **kw),
        }

    @staticmethod
    def decode(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict,
               pos: int, *, x_block: bool = False,
               cspec: dict | None = None) -> tuple[torch.Tensor, dict]:
        """x: (B, 1, d) (this rank's feature block where ``x_block``);
        pos: count of tokens already in the cache.

        Writes ``c_kv`` and the rotated rope key into slot ``pos`` of
        ``cache`` in place and returns the same dict.  The numerics are
        the reference's: W_uk and W_uv absorbed in the compute dtype,
        f32 logits and softmax, the weights rounded to the cache dtype
        before the context product.

        Under tensor parallelism each rank absorbs its own heads; over a
        cache whose slots are split over ``model`` (``cspec``:
        ``cache_specs``' entries) every rank scores every head against its
        slot block and the softmax runs as the reference's partitioned
        program does: the f32 max all-reduced (max), the exponentials
        local, their sum all-reduced, the weights normalised and rounded
        to the cache dtype, the local context product all-reduced.  Any
        other split dim: the cache is gathered for the step and cut back
        after it."""
        B = x.shape[0]
        m, r, ax = tp.tp_axis()
        dims = ({k: tp.model_dim(cspec[k]) for k in cache}
                if (m > 1 and cspec) else {})
        split = 1 if dims and set(dims.values()) == {1} else None
        if split is None and any(d is not None for d in dims.values()):
            whole = {k: c if dims[k] is None else
                     dctx.all_gather(c, ax, dim=dims[k])
                     for k, c in cache.items()}
            y, whole = MLA.decode(p, cfg, x, whole, pos, x_block=x_block)
            for k, c in cache.items():
                if dims[k] is not None:
                    c.copy_(tp.rank_block(whole[k], dims[k]))
            return y, cache
        H, Hl = cfg.n_heads, MLA._heads(cfg)
        if m > 1 and Hl == H:
            raise ValueError(f"MLA.decode: {H} heads do not split over {m} "
                             "model ranks (the absorbed weights are split "
                             "by head)")
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        r_kv = cfg.kv_lora_rank
        q_nope, q_rope = MLA._q(p, cfg, x, x_block)  # (B,1,Hl,dn),(B,1,Hl,dr)
        c_kv, k_rope = MLA._ckv(p, cfg, x, x_block)  # (B,1,r_kv),(B,1,dr)
        positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
        cos, sin = rope_tables(positions, dr, cfg.rope_theta)
        q_rope = apply_rope(q_rope, cos[None], sin[None])
        k_rope = apply_rope(k_rope[:, :, None, :], cos[None],
                            sin[None])[:, :, 0]
        ck, cr = cache["c_kv"], cache["k_rope"]
        T = ck.shape[1]
        first = r * T if split == 1 else 0
        if first <= pos < first + T:
            ck[:, pos - first] = c_kv[:, 0].to(ck.dtype)
            cr[:, pos - first] = k_rope[:, 0].to(cr.dtype)
        valid = torch.arange(first, first + T, device=x.device) <= pos
        # Absorb W_uk into the query: q_c = q_nope @ W_uk^T (per head).
        w_uk = MLA._head_cols(p["w_uk"]["w"], (r_kv, H * dn), Hl)
        q_c = torch.einsum("bhd,rhd->bhr", q_nope[:, 0],
                           w_uk.to(q_nope.dtype))          # (B,Hl,r_kv)
        q_r = q_rope[:, 0]
        if split == 1:    # every head against this rank's slots
            q_c = dctx.all_gather(q_c, ax, dim=1)
            q_r = dctx.all_gather(q_r, ax, dim=1)
        logits = torch.einsum("bhr,btr->bht", q_c.float(), ck.float())
        logits = logits + torch.einsum("bhd,btd->bht", q_r.float(),
                                       cr.float())
        logits = logits / math.sqrt(dn + dr)
        logits = torch.where(valid[None, None, :], logits, _NEG_INF)
        if split == 1:
            mx = dctx.all_reduce(logits.amax(-1, keepdim=True), ax, op="max")
            e = torch.exp(logits - mx)
            w = e / dctx.all_reduce(e.sum(-1, keepdim=True), ax)
            ctx = dctx.all_reduce(torch.einsum("bht,btr->bhr",
                                               w.to(ck.dtype), ck), ax)
            ctx = tp.rank_block(ctx, 1)                       # (B,Hl,r_kv)
        else:
            w = torch.softmax(logits, dim=-1)
            ctx = torch.einsum("bht,btr->bhr", w.to(ck.dtype), ck)
        # Absorb W_uv on the way out.
        w_uv = MLA._head_cols(p["w_uv"]["w"], (r_kv, H * dv), Hl)
        out = torch.einsum("bhr,rhd->bhd", ctx, w_uv.to(ctx.dtype))
        y, _ = tp.tp_dense(p["wo"], out.reshape(B, 1, -1).to(x.dtype),
                           shape=(H * dv, cfg.d_model), x_block=Hl < H)
        return y, cache
