"""xLSTM blocks (arXiv:2405.04517): mLSTM and sLSTM (the port of the
reference's ``repro.models.xlstm``).

* ``MLSTM`` — matrix-memory LSTM with exponential gating.  The
  full-sequence ``fwd`` is the chunkwise-parallel form: within a chunk
  the stabilised log-gate decay matrix, across chunks a (C, n, m) state
  that is the decode recurrence's, so the two agree token for token.
  ``decode`` is the recurrent form with a (B, H, dv, dk) f32 state.
* ``SLSTM`` — scalar-memory LSTM with exponential gating and a
  head-wise block-diagonal recurrence, sequential in time; the whole
  recurrence runs in f32.

Both follow the paper's pre-up-projection block layout (no separate FF:
``d_ff = 0`` in the config).  No TPU kernel computes either block: both
are plain PyTorch, differentiable by autograd.  ``ln_scale`` (both
blocks) and sLSTM's recurrent ``r`` stay float32, as the reference
keeps them; the projections take the given dtype.  ``decode`` updates
the cache in place and returns it, as the port's other mixers do.

Under tensor parallelism (a ``tp`` axis bound, the weights this rank's
``model`` blocks as ``param_specs`` places them: :mod:`repro_torch.dist.
tp`) every projection runs on its blocks and no weight is gathered but
sLSTM's ``r``: mLSTM's ``w_up`` gives this rank's block of both x and z
(one all-to-all re-cuts the [x | z] columns), ``wq``/``wk``/``wv``/
``w_if`` are row-parallel (q, k, v and the gates all-reduced whole),
``ln_scale``, the z gate and ``w_down`` (row-parallel) work on this
rank's block of the inner features; sLSTM's ``w_x`` output is gathered
whole, its ``ln_scale`` and GeGLU FF run on blocks.  The recurrences
(mLSTM's chunkwise form and its decode, sLSTM's step loop) run whole on
every rank: xlstm-125m's 4 heads do not split over a 16-wide ``model``
axis, so what they need whole is an activation or a state (gathered for
a decode step where ``cache_specs`` splits it) and sLSTM's ``r``, which
the gather hook gathers whole once a layer call
(:func:`repro_torch.models.transformer.whole_keys`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..dist import tp
from .common import ModelConfig, act_fn, make_dense, normal

__all__ = ["MLSTM", "SLSTM"]

#: the stabiliser's start (the reference's -1e30 in f32)
_M0 = -1e30


def _proj_dims(cfg: ModelConfig) -> tuple[int, int]:
    di = int(cfg.d_model * cfg.xlstm_proj_factor)
    di = -(-di // cfg.n_heads) * cfg.n_heads
    return di, di // cfg.n_heads


def _ff_dim(cfg: ModelConfig) -> int:
    """sLSTM's post-up-projection FF width (proj factor 4/3)."""
    return int(cfg.d_model * 4 / 3)


def _head_norm(h: torch.Tensor) -> torch.Tensor:
    """Per-head layer norm over the head dim (population variance, as
    ``jnp.var``), no scale."""
    mu = h.mean(-1, keepdim=True)
    var = h.var(-1, keepdim=True, correction=0)
    return (h - mu) * torch.rsqrt(var + 1e-6)


class MLSTM:
    @staticmethod
    def init(gen: torch.Generator, cfg: ModelConfig, *, dtype,
             device) -> dict:
        d = cfg.d_model
        di, _ = _proj_dims(cfg)
        kw = {"dtype": dtype, "device": device}
        return {
            "w_up": make_dense(gen, d, 2 * di, **kw),
            "wq": make_dense(gen, di, di, **kw),
            "wk": make_dense(gen, di, di, **kw),
            "wv": make_dense(gen, di, di, **kw),
            "w_if": make_dense(gen, di, 2 * cfg.n_heads, bias=True, **kw),
            "ln_scale": torch.ones((di,), dtype=torch.float32, device=device),
            "w_down": make_dense(gen, di, d,
                                 scale=1.0 / math.sqrt(di * 2 * cfg.n_layers),
                                 **kw),
        }

    @staticmethod
    def tp_width(cfg: ModelConfig) -> int:
        """The width whose blocks a rank computes on: the inner di."""
        return _proj_dims(cfg)[0]

    @staticmethod
    def _up(p: dict, cfg: ModelConfig, x: torch.Tensor, x_block: bool):
        """x (B, S, d) -> xu, z (B, S, di), or this rank's blocks of both
        under tensor parallelism."""
        di, _ = _proj_dims(cfg)
        xz, _ = tp.tp_dense_groups(p["w_up"], x, (cfg.d_model, 2 * di), 2,
                                   x_block=x_block)
        return xz.chunk(2, dim=-1)

    @staticmethod
    def _qkv_gates(p: dict, cfg: ModelConfig, xu: torch.Tensor):
        """xu (B, S, di), or this rank's block of it -> q, k, v (B, S, H,
        hd) and the gates' pre-activations (B, S, H) f32, whole."""
        B, S = xu.shape[:2]
        H = cfg.n_heads
        di, hd = _proj_dims(cfg)
        split = tp.tp_axis()[0] > 1

        def proj(name, width):
            return tp.tp_dense(p[name], xu, shape=(di, width),
                               x_block=split)[0]
        q = proj("wq", di).reshape(B, S, H, hd)
        k = proj("wk", di).reshape(B, S, H, hd) / math.sqrt(hd)
        v = proj("wv", di).reshape(B, S, H, hd)
        gates = proj("w_if", 2 * H).float()                    # (B,S,2H)
        return q, k, v, gates[..., :H], gates[..., H:]

    @staticmethod
    def _out(p: dict, cfg: ModelConfig, x: torch.Tensor, h: torch.Tensor,
             z: torch.Tensor) -> torch.Tensor:
        """Head norm, ``ln_scale``, the SiLU gate and the down
        projection: h (B, S, H, hd) f32, z (B, S, di) or this rank's
        block -> (B, S, d) in x's dtype."""
        B, S = h.shape[:2]
        di, _ = _proj_dims(cfg)
        h = tp.rank_block(_head_norm(h).reshape(B, S, -1))
        h = (h * tp.as_block(p["ln_scale"], (di,), 0)).to(x.dtype)
        return tp.tp_dense(p["w_down"], h * F.silu(z),
                           shape=(di, cfg.d_model),
                           x_block=tp.tp_axis()[0] > 1)[0]

    @staticmethod
    def _chunk(carry, qb, kb, vb, ib, fb):
        """One chunk of the parallel form (the reference's
        ``chunk_body``): carry (C, n, m) in f32, (B, H, hd, hd), (B, H,
        hd), (B, H); q/k/v (B, ck, H, hd), gate pre-activations (B, ck,
        H) f32 -> (new carry, h (B, ck, H, hd) f32)."""
        C_a, n_a, m_a = carry
        ck = qb.shape[1]
        logf = F.logsigmoid(fb)
        Fc = torch.cumsum(logf, dim=1)                         # (B,ck,H)
        # Row stabiliser: m_t = F_t + max(m_a, cummax_s(i_s - F_s)).
        g = torch.cummax(ib - Fc, dim=1).values
        m_t = Fc + torch.maximum(m_a[:, None, :], g)
        # Inter-chunk contribution (the state carries scale exp(m_a)).
        w_inter = torch.exp(m_a[:, None, :] + Fc - m_t)
        qf, kf, vf = qb.float(), kb.float(), vb.float()
        num_inter = (torch.einsum("bshd,bhvd->bshv", qf, C_a)
                     * w_inter[..., None])
        den_inter = torch.einsum("bshd,bhd->bsh", qf, n_a) * w_inter
        # Intra-chunk attention with the stabilised decay matrix.
        Dlog = Fc[:, :, None, :] - Fc[:, None, :, :] + ib[:, None, :, :]
        tri = torch.ones((ck, ck), dtype=torch.bool,
                         device=qb.device).tril()
        Dlog = torch.where(tri[None, :, :, None], Dlog, -math.inf)
        Dw = torch.exp(Dlog - m_t[:, :, None, :])
        w = torch.einsum("bshd,bthd->bsth", qf, kf) * Dw
        num = num_inter + torch.einsum("bsth,bthd->bshd", w, vf)
        den = den_inter + w.sum(2)
        h = num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]
        # End-of-chunk state (decode's convention).
        F_L = Fc[:, -1:, :]                                    # (B,1,H)
        m_b = (F_L + torch.maximum(m_a[:, None, :], g[:, -1:, :]))[:, 0]
        sc_old = torch.exp(m_a + F_L[:, 0] - m_b)              # (B,H)
        w_new = torch.exp(F_L - Fc + ib - m_b[:, None, :])     # (B,ck,H)
        C_b = C_a * sc_old[..., None, None] + torch.einsum(
            "bsh,bshv,bshk->bhvk", w_new, vf, kf)
        n_b = n_a * sc_old[..., None] + torch.einsum(
            "bsh,bshk->bhk", w_new, kf)
        return (C_b, n_b, m_b), h

    @staticmethod
    def fwd(p: dict, cfg: ModelConfig, x: torch.Tensor,
            chunk: int = 256, *, x_block: bool = False) -> torch.Tensor:
        """Chunkwise-parallel form over x (B, S, d) (this rank's feature
        block where ``x_block``).  The chunk halves until it divides S,
        as the reference's does (to 1 for a prime S above ``chunk``)."""
        B, S, _ = x.shape
        H = cfg.n_heads
        _, hd = _proj_dims(cfg)
        xu, z = MLSTM._up(p, cfg, x, x_block)
        q, k, v, i_pre, f_pre = MLSTM._qkv_gates(p, cfg, xu)
        ck = min(chunk, S)
        while S % ck:
            ck //= 2
        f32 = {"dtype": torch.float32, "device": x.device}
        carry = (torch.zeros((B, H, hd, hd), **f32),
                 torch.zeros((B, H, hd), **f32),
                 torch.full((B, H), _M0, **f32))
        hs = []
        for s in range(0, S, ck):
            sl = slice(s, s + ck)
            carry, h = MLSTM._chunk(carry, q[:, sl], k[:, sl], v[:, sl],
                                    i_pre[:, sl], f_pre[:, sl])
            hs.append(h)
        return MLSTM._out(p, cfg, x, torch.cat(hs, dim=1), z)

    # -- decode --------------------------------------------------------
    @staticmethod
    def init_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16, *,
                   device="cuda") -> dict:
        """The (C, n, m) state in f32 whatever ``dtype``; constant
        memory per sequence."""
        del max_len, dtype
        _, hd = _proj_dims(cfg)
        H = cfg.n_heads
        f32 = {"dtype": torch.float32, "device": device}
        return {"C": torch.zeros((batch, H, hd, hd), **f32),
                "n": torch.zeros((batch, H, hd), **f32),
                "m": torch.full((batch, H), _M0, **f32)}

    @staticmethod
    def decode(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict,
               pos: int, *, x_block: bool = False,
               cspec: dict | None = None) -> tuple[torch.Tensor, dict]:
        """x: (B, 1, d), one token (this rank's feature block where
        ``x_block``): one step of the recurrence.  Under tensor
        parallelism ``cache`` holds this rank's blocks placed by
        ``cspec`` (``cache_specs``' entries; None: whole): the state is
        gathered whole for the step and its new value cut back into the
        blocks."""
        del pos
        split = tp.tp_axis()[0] > 1
        if split:
            have = tp.cache_dims(cache, cspec)
            want = dict.fromkeys(cache)
            cache, blocks = tp.cache_as(cache, have, want), cache
        xu, z = MLSTM._up(p, cfg, x, x_block)
        q, k, v, i_pre, f_pre = MLSTM._qkv_gates(p, cfg, xu)
        q, k, v = q[:, 0], k[:, 0], v[:, 0]                    # (B,H,hd)
        i_pre, f_pre = i_pre[:, 0], f_pre[:, 0]                # (B,H)
        logf = F.logsigmoid(f_pre)
        m_new = torch.maximum(logf + cache["m"], i_pre)
        f_sc = torch.exp(logf + cache["m"] - m_new)[..., None]
        i_sc = torch.exp(i_pre - m_new)[..., None]
        kf, vf, qf = k.float(), v.float(), q.float()
        C = (cache["C"] * f_sc[..., None]
             + i_sc[..., None] * vf[..., :, None] * kf[..., None, :])
        n = cache["n"] * f_sc + i_sc * kf
        num = torch.einsum("bhvk,bhk->bhv", C, qf)
        den = torch.maximum(torch.einsum("bhk,bhk->bh", n, qf).abs(),
                            torch.exp(-m_new))[..., None]
        y = MLSTM._out(p, cfg, x, (num / den)[:, None], z)
        cache["C"].copy_(C)
        cache["n"].copy_(n)
        cache["m"].copy_(m_new)
        if split:
            tp.cache_put(blocks, cache, have, want)
            cache = blocks
        return y, cache


class SLSTM:
    @staticmethod
    def init(gen: torch.Generator, cfg: ModelConfig, *, dtype,
             device) -> dict:
        d = cfg.d_model
        H = cfg.n_heads
        hd = d // H
        ff = _ff_dim(cfg)
        kw = {"dtype": dtype, "device": device}
        # 4 gates (i, f, z, o), input and block-diagonal recurrent weights.
        return {
            "w_x": make_dense(gen, d, 4 * d, bias=True, **kw),
            "r": normal(gen, (4, H, hd, hd), 1.0 / math.sqrt(hd),
                        torch.float32, device),
            "ln_scale": torch.ones((d,), dtype=torch.float32, device=device),
            "w_up": make_dense(gen, d, ff * 2, **kw),
            "w_down": make_dense(gen, ff, d,
                                 scale=1.0 / math.sqrt(d * 2 * cfg.n_layers),
                                 **kw),
        }

    @staticmethod
    def tp_width(cfg: ModelConfig) -> int:
        """The width whose blocks a rank computes on: d_model."""
        return cfg.d_model

    @staticmethod
    def _r_cat(p: dict) -> torch.Tensor:
        """The recurrent weights (4, H, hd, hd) as (H, hd, 4 hd): one
        product a step gives the four gates' recurrent terms, laid out as
        the input projection's (i, f, z, o) blocks of a head."""
        r = p["r"].float()
        G, H, hd, _ = r.shape
        return r.permute(1, 2, 0, 3).reshape(H, hd, G * hd)

    @staticmethod
    def _cell(pre: torch.Tensor, c, n, m):
        """The exponential gates and the state update from the
        pre-activations ``pre`` (..., 4 hd), blocks i, f, z, o; the
        states (..., hd), f32 -> (c, n, h, m)."""
        i_pre, f_pre, z_pre, o_pre = pre.chunk(4, dim=-1)
        lm = F.logsigmoid(f_pre) + m
        m_new = torch.maximum(lm, i_pre)
        i_g = torch.exp(i_pre - m_new)
        f_g = torch.exp(lm - m_new)
        c_new = torch.addcmul(f_g * c, i_g, torch.tanh(z_pre))
        n_new = torch.addcmul(i_g, f_g, n)
        h_new = torch.sigmoid(o_pre) * c_new / torch.clamp(n_new, min=1e-6)
        return c_new, n_new, h_new, m_new

    @staticmethod
    def _step(p: dict, cfg: ModelConfig, carry, wx_t: torch.Tensor):
        """carry: (c, n, h, m), each (B, H, hd) f32; wx_t: (B, 4d) f32."""
        h = carry[2]
        B, H, hd = h.shape
        wx = wx_t.reshape(B, 4, H, hd).transpose(1, 2).reshape(B, H, 4 * hd)
        pre = wx + torch.einsum("bhk,hkx->bhx", h, SLSTM._r_cat(p))
        c, n, h, m = SLSTM._cell(pre, carry[0], carry[1], carry[3])
        return (c, n, h, m), h

    @staticmethod
    def _wx(p: dict, cfg: ModelConfig, x: torch.Tensor,
            x_block: bool) -> torch.Tensor:
        """The gates' input terms (B, S, 4d) in f32, whole."""
        d = cfg.d_model
        return tp.tp_dense(p["w_x"], x, shape=(d, 4 * d),
                           x_block=x_block)[0].float()

    @staticmethod
    def _out(p: dict, cfg: ModelConfig, x: torch.Tensor,
             h: torch.Tensor) -> torch.Tensor:
        """``ln_scale``, then the post-up-projection FF (proj factor 4/3,
        GeGLU): h (B, S, d) f32 -> (B, S, d) in x's dtype.  Under tensor
        parallelism on this rank's block of h's features, and of the FF's
        where ``model`` divides it."""
        d, ff = cfg.d_model, _ff_dim(cfg)
        split = tp.tp_axis()[0] > 1
        h = tp.rank_block(h) * tp.as_block(p["ln_scale"], (d,), 0)
        ug, blk = tp.tp_dense_groups(p["w_up"], h.to(x.dtype), (d, 2 * ff),
                                     2, x_block=split)
        u, g = ug.chunk(2, dim=-1)
        return tp.tp_dense(p["w_down"], u * act_fn("gelu")(g),
                           shape=(ff, d), x_block=blk)[0]

    @staticmethod
    def fwd(p: dict, cfg: ModelConfig, x: torch.Tensor,
            chunk: int = 64, *, x_block: bool = False) -> torch.Tensor:
        """The recurrence over x (B, S, d) (this rank's feature block
        where ``x_block``), one step a position.  ``chunk`` is accepted
        for the reference's signature: its chunks bound only what the
        reference's backward keeps, and the padded steps of its last
        chunk come after every kept output.  On ``meta`` (the dry run,
        shapes only) the steps' recurrent products are one batched
        product over every step's input-only state, so that autograd
        and the FLOP counter see the loop's work (2·S·B·d·4hd) without
        its S host steps."""
        del chunk
        B, S = x.shape[:2]
        d, H = cfg.d_model, cfg.n_heads
        hd = d // H
        # Heads lead, so that a step's recurrent product and its input
        # term are one batched GEMM: wx (S, H, B, 4 hd), states (H, B, hd).
        wx = SLSTM._wx(p, cfg, x, x_block).reshape(B, S, 4, H, hd)
        wx = wx.permute(1, 3, 0, 2, 4).reshape(S, H, B, 4 * hd)
        r = SLSTM._r_cat(p)
        c, n, h, m = (t.transpose(0, 1)
                      for t in SLSTM._zero_state(cfg, B, x.device))
        if x.device.type == "meta":
            h0 = SLSTM._cell(wx, c, n, m)[2]
            h = SLSTM._cell(wx + h0 @ r, c, n, m)[2]
        else:
            hs = []
            for t in range(S):
                c, n, h, m = SLSTM._cell(torch.baddbmm(wx[t], h, r), c, n,
                                         m)
                hs.append(h)
            h = torch.stack(hs, dim=0)
        h = h.permute(2, 0, 1, 3).reshape(B, S, d)
        return SLSTM._out(p, cfg, x, h)

    @staticmethod
    def _zero_state(cfg: ModelConfig, batch: int, device):
        H = cfg.n_heads
        shape = (batch, H, cfg.d_model // H)
        f32 = {"dtype": torch.float32, "device": device}
        return (torch.zeros(shape, **f32), torch.zeros(shape, **f32),
                torch.zeros(shape, **f32), torch.full(shape, _M0, **f32))

    # -- decode --------------------------------------------------------
    @staticmethod
    def init_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16, *,
                   device="cuda") -> dict:
        """(c, n, h, m) in f32 whatever ``dtype``, each its own tensor
        (decode writes them in place)."""
        del max_len, dtype
        return dict(zip("cnhm", SLSTM._zero_state(cfg, batch, device)))

    @staticmethod
    def decode(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict,
               pos: int, *, x_block: bool = False,
               cspec: dict | None = None) -> tuple[torch.Tensor, dict]:
        """x: (B, 1, d), one token (this rank's feature block where
        ``x_block``): one step of the recurrence.  Under tensor
        parallelism the state is gathered whole for the step, as
        :meth:`MLSTM.decode`'s is."""
        del pos
        split = tp.tp_axis()[0] > 1
        if split:
            have = tp.cache_dims(cache, cspec)
            want = dict.fromkeys(cache)
            cache, blocks = tp.cache_as(cache, have, want), cache
        B = x.shape[0]
        wx = SLSTM._wx(p, cfg, x, x_block)[:, 0]               # (B,4d)
        carry = tuple(cache[k] for k in "cnhm")
        new, h = SLSTM._step(p, cfg, carry, wx)
        y = SLSTM._out(p, cfg, x, h.reshape(B, 1, -1))
        for k, t in zip("cnhm", new):
            cache[k].copy_(t)
        if split:
            tp.cache_put(blocks, cache, have, want)
            cache = blocks
        return y, cache
