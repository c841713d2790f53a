"""Mamba-1 selective scan: the CUDA kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``mamba_scan_bd``
(``src/repro/kernels/mamba_scan.py:63``) behind the reference's
``ops.mamba_scan``.  For x, dt (B, T, Dc), Bm, Cm (B, T, S), A (Dc, S)
and D (Dc,), from a zero f32 state and walking t in order::

    h = exp(dt[t, c] * A[c, s]) * h + (dt[t, c] * x[t, c]) * Bm[t, s]
    y[t, c] = sum_s h * Cm[t, s] + D[c] * x[t, c]

in f32 (inputs upcast), y in x's dtype.  The kernel
(``csrc/mamba_scan.cu``) runs lanes over (channel, state), each thread
carrying one h value, and walks T in staged chunks; it is bound by the
special-function units' exps.  The source note in the ``.cu`` file has
the details.

:func:`mamba_scan` launches the kernel for CUDA tensors and uses
:func:`mamba_scan_plain` only for tensors on the CPU; on a CUDA tensor
it launches or raises.  ``mamba_scan.launches`` counts the kernel's
launches.
"""

from __future__ import annotations

import torch

from .build import library

__all__ = ["mamba_scan", "mamba_scan_plain"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_S = 32


def mamba_scan_plain(x: torch.Tensor, dt: torch.Tensor, bm: torch.Tensor,
                     cm: torch.Tensor, a: torch.Tensor,
                     d_skip: torch.Tensor) -> torch.Tensor:
    """The step loop of the reference's ``ref.mamba_scan_ref``: x/dt
    (B, T, Dc), bm/cm (B, T, S), a (Dc, S), d_skip (Dc,) -> y (B, T, Dc)
    in x's dtype, computed in f32."""
    B, T, Dc = x.shape
    S = bm.shape[-1]
    xf, dtf, bf, cf = (t.float() for t in (x, dt, bm, cm))
    af, df = a.float(), d_skip.float()
    h = torch.zeros((B, Dc, S), dtype=torch.float32, device=x.device)
    ys = torch.empty((B, T, Dc), dtype=torch.float32, device=x.device)
    for t in range(T):
        dA = torch.exp(dtf[:, t, :, None] * af)
        dBx = (dtf[:, t] * xf[:, t])[:, :, None] * bf[:, t, None, :]
        h = h * dA + dBx
        ys[:, t] = (h * cf[:, t, None, :]).sum(-1) + df * xf[:, t]
    return ys.to(x.dtype)


def _check(x, dt, bm, cm, a, d_skip) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"mamba_scan: no kernel for device {x.device}")
    if not all(t.device == x.device for t in (dt, bm, cm, a, d_skip)):
        raise ValueError("mamba_scan: tensors on different devices")
    if x.device.index != torch.cuda.current_device():
        raise ValueError("mamba_scan: x is not on the current CUDA device")
    if x.dtype not in _DTYPE_CODES or not (dt.dtype == bm.dtype == cm.dtype
                                           == x.dtype):
        raise TypeError("mamba_scan: x, dt, bm and cm must all be float32 or "
                        "all bfloat16")
    if a.dtype != torch.float32 or d_skip.dtype != torch.float32:
        raise TypeError("mamba_scan: a and d_skip must be float32")
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"mamba_scan: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}; want one (B, T, Dc)")
    B, T, Dc = x.shape
    S = bm.shape[-1] if bm.dim() == 3 else -1
    if bm.shape != (B, T, S) or cm.shape != (B, T, S):
        raise ValueError(f"mamba_scan: shapes bm {tuple(bm.shape)}, cm "
                         f"{tuple(cm.shape)}; want (B, T, S) = ({B}, {T}, S)")
    if not 1 <= S <= _MAX_S:
        raise ValueError(f"mamba_scan: S={S} must be 1..{_MAX_S}")
    if a.shape != (Dc, S) or d_skip.shape != (Dc,):
        raise ValueError(f"mamba_scan: shapes a {tuple(a.shape)}, d_skip "
                         f"{tuple(d_skip.shape)}; want ({Dc}, {S}), ({Dc},)")
    if not (x.is_contiguous() and dt.is_contiguous() and a.is_contiguous()
            and d_skip.is_contiguous()):
        raise ValueError("mamba_scan: x, dt, a and d_skip must be contiguous")
    if bm.stride(-1) != 1 or cm.stride(-1) != 1:
        raise ValueError("mamba_scan: bm and cm need a contiguous last axis")
    if B > 65535:
        raise ValueError(f"mamba_scan: B={B} above 65535")


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, bm: torch.Tensor,
               cm: torch.Tensor, a: torch.Tensor,
               d_skip: torch.Tensor) -> torch.Tensor:
    """x/dt (B, T, Dc), bm/cm (B, T, S) of x's dtype (f32 or bf16; bm and
    cm may be strided views, as slices of one projection are), a (Dc, S)
    and d_skip (Dc,) f32 -> y (B, T, Dc) in x's dtype."""
    if x.device.type == "cpu":
        return mamba_scan_plain(x, dt, bm, cm, a, d_skip)
    _check(x, dt, bm, cm, a, d_skip)
    y = torch.empty_like(x)
    B, T, Dc = x.shape
    if y.numel() == 0:
        return y
    rc = library().repro_mamba_scan(
        x.data_ptr(), dt.data_ptr(), bm.data_ptr(), cm.data_ptr(),
        a.data_ptr(), d_skip.data_ptr(), y.data_ptr(), B, T, Dc,
        bm.shape[-1], bm.stride(0), bm.stride(1), cm.stride(0), cm.stride(1),
        _DTYPE_CODES[x.dtype], torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"mamba_scan kernel launch failed: CUDA error {rc}")
    mamba_scan.launches += 1
    return y


mamba_scan.launches = 0
