"""RMSNorm over rows: the CUDA kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``rmsnorm_rows``
(``src/repro/kernels/rmsnorm.py:26``).  The kernel
(``csrc/rmsnorm.cu``) is bound by bytes: on the serving path it
normalises one row of 1024 bf16 values, about 8 KB of traffic, so its
time there is launch latency.  Its design (one block per row, 16-byte
vector loads, an f32 sum of squares reduced by warp shuffles and shared
memory) is for the row counts where bytes matter; the source note in
the ``.cu`` file has the details.

:func:`rmsnorm_rows` launches the kernel for CUDA tensors and uses
:func:`rmsnorm_rows_plain` only for tensors on the CPU
or on ``meta`` (shapes only); on a CUDA
tensor it launches or raises.  ``rmsnorm_rows.launches`` counts the
kernel's launches.

Where autograd records (grad enabled and ``x`` or ``scale`` requiring
grad), the CUDA path is a ``torch.autograd.Function``: its forward is
the kernel, its backward :func:`rmsnorm_rows_backward`, plain PyTorch
in f32 from the saved ``x`` and ``scale`` with the row scale
recomputed.  The reference has no backward kernel (its training
differentiates the XLA norm), so none is written here.  On the CPU the
plain version is differentiated by autograd.
"""

from __future__ import annotations

import torch

from .build import PLAIN_DEVICES as _PLAIN_DEVICES
from .build import library

__all__ = ["rmsnorm_rows", "rmsnorm_rows_plain", "rmsnorm_rows_backward"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def rmsnorm_rows_plain(x: torch.Tensor, scale: torch.Tensor, *,
                       eps: float = 1e-6) -> torch.Tensor:
    """x: (R, D), scale: (D,) -> (R, D) in x's dtype, computed in f32."""
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


def rmsnorm_rows_backward(x: torch.Tensor, scale: torch.Tensor,
                          gy: torch.Tensor, *, eps: float = 1e-6
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradients of ``y = x·r·scale``, ``r = rsqrt(mean(x²)+eps)``,
    for the output gradient ``gy`` (R, D), computed in f32: ``dx = r·u -
    x·r³·mean(u·x)`` with ``u = gy·scale``, returned in x's dtype, and
    ``dscale = Σ_rows gy·(x·r)`` in f32, its terms rounded as the plain
    version's autograd rounds them (``x·r`` first): a column's sum runs
    over every row and may cancel to near zero, where the order of the
    roundings would show."""
    xf, gf, sf = x.float(), gy.float(), scale.float()
    r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    u = gf * sf
    dx = r * u - xf * r.pow(3) * (u * xf).mean(-1, keepdim=True)
    return dx.to(x.dtype), (gf * (xf * r)).sum(0)


class _RMSNormRows(torch.autograd.Function):
    """The kernel forward with the plain f32 backward."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _launch(x, scale, eps)

    @staticmethod
    def backward(ctx, gy):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_rows_backward(x, scale, gy, eps=ctx.eps)
        return (dx if ctx.needs_input_grad[0] else None,
                dscale if ctx.needs_input_grad[1] else None, None)


def _check(x: torch.Tensor, scale: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm_rows: no kernel for device {x.device}")
    if scale.device != x.device:
        raise ValueError("rmsnorm_rows: x and scale on different devices")
    if x.device.index != torch.cuda.current_device():
        raise ValueError("rmsnorm_rows: x is not on the current CUDA device")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"rmsnorm_rows: x dtype {x.dtype} not in "
                        "(float32, bfloat16)")
    if scale.dtype != torch.float32:
        raise TypeError("rmsnorm_rows: scale must be float32")
    if x.dim() != 2 or scale.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm_rows: shapes x {tuple(x.shape)}, "
                         f"scale {tuple(scale.shape)}; want (R, D), (D,)")
    d = x.shape[1]
    if d % 8 or not 0 < d <= 8192:
        raise ValueError(f"rmsnorm_rows: D={d} must be a multiple of 8 "
                         "up to 8192")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm_rows: x and scale must be contiguous")
    if x.data_ptr() % 16 or scale.data_ptr() % 16:
        raise ValueError("rmsnorm_rows: x and scale must be 16-byte aligned")


def rmsnorm_rows(x: torch.Tensor, scale: torch.Tensor, *,
                 eps: float = 1e-6) -> torch.Tensor:
    """x: (R, D), scale: (D,) f32 -> (R, D) in x's dtype."""
    if x.device.type in _PLAIN_DEVICES:
        return rmsnorm_rows_plain(x, scale, eps=eps)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNormRows.apply(x, scale, eps)
    return _launch(x, scale, eps)


def _launch(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    _check(x, scale)
    y = torch.empty_like(x)
    if x.shape[0] == 0:
        return y
    rc = library().repro_rmsnorm(
        x.data_ptr(), scale.data_ptr(), y.data_ptr(), x.shape[0], x.shape[1],
        eps, _DTYPE_CODES[x.dtype], torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {rc}")
    rmsnorm_rows.launches += 1
    return y


rmsnorm_rows.launches = 0
