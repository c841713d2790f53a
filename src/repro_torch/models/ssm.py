"""Mamba-1 selective-state-space block, for jamba-v0.1 (the port of the
reference's ``repro.models.ssm``).

In-projection to (x, z), depthwise causal conv, selective
(input-dependent) Δ/B/C, diagonal A, gated out-projection.  ``Mamba.fwd``
runs the selective scan through :func:`repro_torch.kernels.ops.mamba_scan`
by default (the Hopper kernel on CUDA tensors; the reference's own
``fwd`` runs a ``lax.scan`` that computes the same function, and reaches
the Pallas kernel only from its tests); ``impl="xla"`` runs the plain
twin of the reference's scan instead.  Decode keeps (conv window, ssm
state) as the cache and is one step of the recurrence in plain PyTorch,
as in the reference.

``a_log``, ``conv_w``, ``conv_b``, ``dt_bias`` and ``d_skip`` stay
float32 whatever the compute dtype, as the reference keeps them; the
projections take the compute dtype.

Under tensor parallelism (a ``tp`` axis bound, the weights this rank's
``model`` blocks as ``param_specs`` places them: :mod:`repro_torch.dist.
tp`) both run on this rank's block of the ``d_inner`` channels, where
``model`` divides ``d_inner``: ``w_in``'s [x | z] columns re-cut to the
same channels of x and z (one all-to-all of the weight's block, or of the
output's at a decode step), the conv, ``dt_bias``, ``A`` and ``D`` on the
channels' blocks, ``w_x_dbc`` row-parallel (dt's low rank, B and C
all-reduced whole), ``w_dt`` column-parallel, the selective scan on the
(B, S, d_inner / m) block (it is independent per channel), ``w_out``
row-parallel.  The decode updates the conv window's and the ssm state's
channel blocks (``cache_specs`` splits both on ``d_inner``) in place.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..dist import tp
from ..kernels import ops
from .common import ModelConfig, make_dense, normal

__all__ = ["Mamba"]


def _scan_xla(xc, dt, Bm, Cm, A) -> torch.Tensor:
    """The plain twin of the reference's scan (``ssm.py:91-113``): f32
    state from zero, ``y[t] = h[t]·C[t]`` in f32.  The reference walks T
    in chunks of 128 only to bound what its backward keeps; the values
    are those of this step loop."""
    B, S, di = xc.shape
    xf, dtf, bf, cf = (t.float() for t in (xc, dt, Bm, Cm))
    if xc.device.type == "meta":
        # shapes only (the dry run): the steps' work as one op each, so
        # that autograd keeps every input on the graph and the FLOP
        # counter sees the loop's products h·C (2·B·S·di·ds)
        h = torch.exp(dtf[..., None] * A) * (dtf * xf)[..., None] \
            * bf[:, :, None, :]
        return torch.einsum("btds,bts->btd", h, cf)
    h = torch.zeros((B, di, A.shape[1]), dtype=torch.float32,
                    device=xc.device)
    ys = torch.empty((B, S, di), dtype=torch.float32, device=xc.device)
    for t in range(S):
        dA = torch.exp(dtf[:, t, :, None] * A)
        dBx = dtf[:, t, :, None] * bf[:, t, None, :] * xf[:, t, :, None]
        h = h * dA + dBx
        ys[:, t] = torch.einsum("bds,bs->bd", h, cf[:, t])
    return ys


class Mamba:
    @staticmethod
    def init(gen: torch.Generator, cfg: ModelConfig, *, dtype,
             device) -> dict:
        d, di, ds = cfg.d_model, cfg.mamba_d_inner, cfg.mamba_d_state
        dtr, dc = cfg.dt_rank, cfg.mamba_d_conv
        kw = {"dtype": dtype, "device": device}
        f32 = {"dtype": torch.float32, "device": device}
        # S4D-real initialisation for A.
        a = torch.arange(1, ds + 1, dtype=torch.float32).repeat(di, 1)
        u = torch.rand((di,), generator=gen, dtype=torch.float32,
                       device=gen.device).cpu()
        dt_init = torch.exp(u * (math.log(0.1) - math.log(0.001))
                            + math.log(0.001))
        return {
            "w_in": make_dense(gen, d, 2 * di, **kw),
            "conv_w": normal(gen, (dc, di), 1.0 / math.sqrt(dc), **f32),
            "conv_b": torch.zeros((di,), **f32),
            "w_x_dbc": make_dense(gen, di, dtr + 2 * ds, **kw),
            "w_dt": make_dense(gen, dtr, di, scale=dtr ** -0.5, **kw),
            "dt_bias": torch.log(torch.expm1(dt_init)).to(device),
            "a_log": torch.log(a).to(device),
            "d_skip": torch.ones((di,), **f32),
            "w_out": make_dense(gen, di, d,
                                scale=1.0 / math.sqrt(di * 2 * cfg.n_layers),
                                **kw),
        }

    @staticmethod
    def tp_width(cfg: ModelConfig) -> int:
        """The width whose blocks a rank computes on: ``d_inner``."""
        return cfg.mamba_d_inner

    # ------------------------------------------------------------------
    @staticmethod
    def _channels(p: dict, cfg: ModelConfig) -> dict:
        """The per-channel leaves (conv, ``dt_bias``, ``a_log``,
        ``d_skip``) as this rank's channel blocks."""
        if tp.tp_axis()[0] == 1:
            return p
        di, ds, dc = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
        shapes = {"conv_w": ((dc, di), 1), "conv_b": ((di,), 0),
                  "dt_bias": ((di,), 0), "a_log": ((di, ds), 0),
                  "d_skip": ((di,), 0)}
        return {k: tp.as_block(p[k], shape, dim)
                for k, (shape, dim) in shapes.items()}

    @staticmethod
    def _in(p: dict, cfg: ModelConfig, x: torch.Tensor, x_block: bool):
        """x: (..., d) -> xi, z (..., di), or this rank's channels of
        both under tensor parallelism."""
        d, di = cfg.d_model, cfg.mamba_d_inner
        xz, _ = tp.tp_dense_groups(p["w_in"], x, (d, 2 * di), 2,
                                   x_block=x_block)
        return xz.chunk(2, dim=-1)

    @staticmethod
    def _dbc(p: dict, q: dict, cfg: ModelConfig, xc: torch.Tensor):
        """xc: (..., di) (this rank's channels under tensor parallelism)
        -> dt (..., di) on the same channels, Bm (..., ds), Cm (..., ds)
        whole; Bm and Cm are views of one projection.  ``q``: the
        channel leaves (:meth:`_channels`)."""
        di, dtr, ds = cfg.mamba_d_inner, cfg.dt_rank, cfg.mamba_d_state
        split = tp.tp_axis()[0] > 1
        dbc, _ = tp.tp_dense(p["w_x_dbc"], xc, shape=(di, dtr + 2 * ds),
                             x_block=split)
        dt, blk = tp.tp_dense(p["w_dt"], dbc[..., :dtr], shape=(dtr, di),
                              keep_block=split)
        if split and not blk:
            dt = tp.rank_block(dt)
        dt = F.softplus(dt + q["dt_bias"].to(xc.dtype))
        return dt, dbc[..., dtr:dtr + ds], dbc[..., dtr + ds:]

    @staticmethod
    def _out(p: dict, cfg: ModelConfig, y: torch.Tensor) -> torch.Tensor:
        """``w_out`` on the gated channels (row-parallel on a block)."""
        di, d = cfg.mamba_d_inner, cfg.d_model
        return tp.tp_dense(p["w_out"], y, shape=(di, d),
                           x_block=tp.tp_axis()[0] > 1)[0]

    @staticmethod
    def _conv(p: dict, cfg: ModelConfig, xi: torch.Tensor) -> torch.Tensor:
        """Depthwise causal conv along S, then SiLU: (B, S, di)."""
        S, dc = xi.shape[1], cfg.mamba_d_conv
        pad = F.pad(xi, (0, 0, dc - 1, 0))
        w = p["conv_w"].to(xi.dtype)
        conv = pad[:, 0:S] * w[0]
        for i in range(1, dc):
            conv = conv + pad[:, i:i + S] * w[i]
        return F.silu(conv + p["conv_b"].to(xi.dtype))

    @staticmethod
    def fwd(p: dict, cfg: ModelConfig, x: torch.Tensor, chunk: int = 128,
            *, impl: str = "kernel", x_block: bool = False) -> torch.Tensor:
        """x: (B, S, d) -> (B, S, d).  ``impl="kernel"`` (the default)
        scans through ``ops.mamba_scan``, whose output includes the
        ``D·x`` skip; ``impl="xla"`` through the plain twin of the
        reference's scan, then adds the skip in x's dtype as the
        reference does.  ``chunk`` is accepted for the reference's
        signature and ignored: there it shapes only the backward pass's
        memory, and the port's scan keeps no activations.  ``x_block``:
        x is this rank's block of its features (a split norm's)."""
        del chunk
        xi, z = Mamba._in(p, cfg, x, x_block)
        q = Mamba._channels(p, cfg)
        xc = Mamba._conv(q, cfg, xi)
        dt, Bm, Cm = Mamba._dbc(p, q, cfg, xc)
        A = -torch.exp(q["a_log"])                              # (di, ds)
        if impl == "kernel":
            y = ops.mamba_scan(xc, dt, Bm, Cm, A, q["d_skip"])
        elif impl == "xla":
            y = _scan_xla(xc, dt, Bm, Cm, A).to(x.dtype)
            y = y + xc * q["d_skip"].to(x.dtype)
        else:
            raise ValueError(f"impl must be 'kernel' or 'xla', not {impl!r}")
        return Mamba._out(p, cfg, y * F.silu(z))

    # ------------------------------------------------------------------
    @staticmethod
    def init_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16, *,
                   device="cuda") -> dict:
        """The conv window in the cache dtype, the ssm state in f32."""
        del max_len  # constant memory per sequence
        di, ds, dc = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
        return {"conv": torch.zeros((batch, dc - 1, di), dtype=dtype,
                                    device=device),
                "ssm": torch.zeros((batch, di, ds), dtype=torch.float32,
                                   device=device)}

    @staticmethod
    def decode(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict,
               pos: int, *, x_block: bool = False,
               cspec: dict | None = None) -> tuple[torch.Tensor, dict]:
        """x: (B, 1, d), one token (this rank's feature block where
        ``x_block``).  Updates ``cache`` in place and returns it.  Under
        tensor parallelism ``cache`` holds this rank's blocks placed by
        ``cspec`` (``cache_specs``' entries; None: whole): the step runs
        on this rank's channels of the conv window and the ssm state,
        in place where the blocks are those channels (a block along any
        other dim is re-cut for the step, a whole leaf sliced and its new
        state all-gathered)."""
        del pos
        split = tp.tp_axis()[0] > 1
        if split:
            have = tp.cache_dims(cache, cspec)
            want = {"conv": 2, "ssm": 1}
            c = tp.cache_as(cache, have, want)
        else:
            c = cache
        xi, z = Mamba._in(p, cfg, x, x_block)
        xi, z = xi[:, 0], z[:, 0]                              # (B, di)
        q = Mamba._channels(p, cfg)
        window = torch.cat([c["conv"].to(x.dtype), xi[:, None, :]],
                           dim=1)                              # (B, dc, di)
        conv = torch.einsum("bcd,cd->bd", window, q["conv_w"].to(x.dtype))
        xc = F.silu(conv + q["conv_b"].to(x.dtype))
        dt, Bm, Cm = Mamba._dbc(p, q, cfg, xc)
        A = -torch.exp(q["a_log"])
        dtf = dt.float()
        dA = torch.exp(dtf[..., None] * A)
        dBx = dtf[..., None] * Bm.float()[:, None, :] * xc.float()[..., None]
        h = c["ssm"] * dA + dBx
        y = torch.einsum("bds,bs->bd", h, Cm.float()).to(x.dtype)
        y = y + xc * q["d_skip"].to(x.dtype)
        out = Mamba._out(p, cfg, y * F.silu(z))[:, None, :]
        c["conv"].copy_(window[:, 1:])
        c["ssm"].copy_(h)
        if split:
            tp.cache_put(cache, c, have, want)
        return out, cache
