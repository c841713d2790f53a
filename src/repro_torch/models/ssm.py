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
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import ops
from .common import ModelConfig, dense, make_dense, normal

__all__ = ["Mamba"]


def _scan_xla(xc, dt, Bm, Cm, A) -> torch.Tensor:
    """The plain twin of the reference's scan (``ssm.py:91-113``): f32
    state from zero, ``y[t] = h[t]·C[t]`` in f32.  The reference walks T
    in chunks of 128 only to bound what its backward keeps; the values
    are those of this step loop."""
    B, S, di = xc.shape
    xf, dtf, bf, cf = (t.float() for t in (xc, dt, Bm, Cm))
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

    # ------------------------------------------------------------------
    @staticmethod
    def _dbc(p: dict, cfg: ModelConfig, xc: torch.Tensor):
        """xc: (..., di) -> dt (..., di), Bm (..., ds), Cm (..., ds);
        Bm and Cm are views of one projection."""
        dtr, ds = cfg.dt_rank, cfg.mamba_d_state
        dbc = dense(p["w_x_dbc"], xc)
        dt = F.softplus(dense(p["w_dt"], dbc[..., :dtr])
                        + p["dt_bias"].to(xc.dtype))
        return dt, dbc[..., dtr:dtr + ds], dbc[..., dtr + ds:]

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
            *, impl: str = "kernel") -> torch.Tensor:
        """x: (B, S, d) -> (B, S, d).  ``impl="kernel"`` (the default)
        scans through ``ops.mamba_scan``, whose output includes the
        ``D·x`` skip; ``impl="xla"`` through the plain twin of the
        reference's scan, then adds the skip in x's dtype as the
        reference does.  ``chunk`` is accepted for the reference's
        signature and ignored: there it shapes only the backward pass's
        memory, and the port's scan keeps no activations."""
        del chunk
        xi, z = dense(p["w_in"], x).chunk(2, dim=-1)
        xc = Mamba._conv(p, cfg, xi)
        dt, Bm, Cm = Mamba._dbc(p, cfg, xc)
        A = -torch.exp(p["a_log"])                              # (di, ds)
        if impl == "kernel":
            y = ops.mamba_scan(xc, dt, Bm, Cm, A, p["d_skip"])
        elif impl == "xla":
            y = _scan_xla(xc, dt, Bm, Cm, A).to(x.dtype)
            y = y + xc * p["d_skip"].to(x.dtype)
        else:
            raise ValueError(f"impl must be 'kernel' or 'xla', not {impl!r}")
        return dense(p["w_out"], y * F.silu(z))

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
               pos: int) -> tuple[torch.Tensor, dict]:
        """x: (B, 1, d), one token.  Updates ``cache`` in place and
        returns it."""
        del pos
        xi, z = dense(p["w_in"], x)[:, 0].chunk(2, dim=-1)     # (B, di)
        window = torch.cat([cache["conv"].to(x.dtype), xi[:, None, :]],
                           dim=1)                              # (B, dc, di)
        conv = torch.einsum("bcd,cd->bd", window, p["conv_w"].to(x.dtype))
        xc = F.silu(conv + p["conv_b"].to(x.dtype))
        dt, Bm, Cm = Mamba._dbc(p, cfg, xc)
        A = -torch.exp(p["a_log"])
        dtf = dt.float()
        dA = torch.exp(dtf[..., None] * A)
        dBx = dtf[..., None] * Bm.float()[:, None, :] * xc.float()[..., None]
        h = cache["ssm"] * dA + dBx
        y = torch.einsum("bds,bs->bd", h, Cm.float()).to(x.dtype)
        y = y + xc * p["d_skip"].to(x.dtype)
        out = dense(p["w_out"], y * F.silu(z))[:, None, :]
        cache["conv"].copy_(window[:, 1:])
        cache["ssm"].copy_(h)
        return out, cache
