"""RMSNorm over rows: the CUDA kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``rmsnorm_rows``
(``src/repro/kernels/rmsnorm.py:26``).  The kernel
(``csrc/rmsnorm.cu``) is bound by bytes.  Each row is read once into
registers with its scale, one warp a narrow row (several rows a block,
reduced by shuffles alone) or several warps a wide one, every load of a
lane in flight at once.  :func:`rmsnorm_plan` sets the launch from the
shapes alone; the source note in the ``.cu`` file has the details and
the designs measured against it.

On the serving path the kernel normalises one row of 1024 bf16 values,
and the step is host-bound: there the call's host work is what costs.
The call path does the least it can: a launch is looked up by the
input's shape, dtype and device (its plan and the ctypes structure
passed to the C entry point, made once), the per-call checks are
tensor queries that raise through :func:`_check` on any refusal, and
the stream is PyTorch's current raw stream (no ``Stream`` object).

:func:`rmsnorm_rows` launches the kernel for CUDA tensors and uses
:func:`rmsnorm_rows_plain` only for tensors on the CPU
or on ``meta`` (shapes only); on a CUDA
tensor it launches or raises.  :func:`rmsnorm` (``ops.rmsnorm``) takes
x (..., D) and launches on a contiguous x's rows without reshaping it.
``rmsnorm_rows.launches`` counts the kernel's launches (of both).

Where autograd records (grad enabled and ``x`` or ``scale`` requiring
grad), the CUDA path is a ``torch.autograd.Function``: its forward is
the kernel, its backward :func:`rmsnorm_rows_backward`, plain PyTorch
in f32 from the saved ``x`` and ``scale`` with the row scale
recomputed.  The reference has no backward kernel (its training
differentiates the XLA norm), so none is written here.  On the CPU the
plain version is differentiated by autograd.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .build import PLAIN_DEVICES as _PLAIN_DEVICES
from .build import library

__all__ = ["RMSNormPlan", "rmsnorm", "rmsnorm_plan", "rmsnorm_rows",
           "rmsnorm_rows_plain", "rmsnorm_rows_backward"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_D = 8192
_MAX_THREADS = 256       # a block (csrc/rmsnorm.cu kMaxThreads)
#: vectors of a narrow row: one warp holds it at 3 a lane at most
_NARROW = 96
#: 16-byte vectors a lane of a wider row holds where the block's 8 warps
#: allow (measured best on the H100: PERF.md, PR 26)
_LANE_VECS = 4
#: narrow rows a block at most
_MAX_ROWS_PER_BLOCK = 4


class RMSNormPlan(NamedTuple):
    """The kernel's launch: ``grid`` blocks of ``rows_per_block`` rows,
    ``lanes`` lanes a row (a power of two up to 32, inside one warp, or
    32 x its warps), each holding ``vecs`` 16-byte vectors of the row
    (vector j on lane j % lanes); block b normalises rows b x
    rows_per_block + g, g < rows_per_block."""
    lanes: int
    vecs: int
    rows_per_block: int
    grid: int

    @property
    def threads(self) -> int:
        return self.rows_per_block * self.lanes


def _vector(dtype: torch.dtype) -> int:
    """Elements a 16-byte vector of ``dtype`` holds."""
    return 16 // (4 if dtype == torch.float32 else 2)


def _check_d(d: int, dtype: torch.dtype) -> None:
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"rmsnorm_rows: x dtype {dtype} not in "
                        "(float32, bfloat16)")
    if d % 8 or not 0 < d <= _MAX_D:
        raise ValueError(f"rmsnorm_rows: D={d} must be a multiple of 8 "
                         f"up to {_MAX_D}")


@functools.lru_cache(maxsize=None)
def rmsnorm_plan(rows: int, d: int, dtype: torch.dtype,
                 sms: int) -> RMSNormPlan:
    """The launch for x (rows, d) in ``dtype`` on a card of ``sms`` SMs.

    A row of nv = d / V vectors (V = 8 bf16, 4 f32) of at most
    ``_NARROW`` vectors is narrow: one warp, 3 vectors a lane at most (a power of two
    of a warp's lanes, one vector each, below 32 vectors), and a block
    holds rows enough for every SM to have a block (ceil(rows / sms), at
    most ``_MAX_ROWS_PER_BLOCK``, whole warps).  A wider row is a block
    of its own, of at least 2 warps, as many as give each lane at most
    ``_LANE_VECS`` vectors (up to twice as many where they cover the row
    exactly), at most the block's 8 warps, whose lanes then take more.
    The grid is a block for each block's rows."""
    _check_d(d, dtype)
    if rows < 1 or sms < 1:
        raise ValueError(f"rmsnorm_plan: rows={rows}, sms={sms}")
    nv = d // _vector(dtype)
    if nv <= _NARROW:
        lanes = 32 if nv > 32 else 1 << (nv - 1).bit_length()
        per_warp = 32 // lanes
        g = min(-(-rows // sms), _MAX_ROWS_PER_BLOCK * per_warp)
        rows_per_block = -(-g // per_warp) * per_warp
    else:
        top = _MAX_THREADS // 32
        fewest = min(max(2, -(-nv // (32 * _LANE_VECS))), top)
        lanes = 32 * next((w for w in range(fewest, min(2 * fewest, top) + 1)
                           if nv % (32 * w) == 0
                           and nv // (32 * w) <= _LANE_VECS), fewest)
        rows_per_block = 1
    return RMSNormPlan(lanes, -(-nv // lanes), rows_per_block,
                       -(-rows // rows_per_block))


class _Launch(ctypes.Structure):
    """``RmsnormLaunch`` of ``csrc/rmsnorm.cu``, field for field."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "rows", "d", "dtype", "lanes", "vecs", "rows_per_block", "grid")] + [
        ("eps", ctypes.c_float)]


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


def _check(x: torch.Tensor, scale: torch.Tensor, rows_only: bool = True
           ) -> None:
    """Raises on what the kernel does not take; ``rows_only``: x must be
    (R, D), else (..., D)."""
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
    if (x.dim() != 2 if rows_only else x.dim() < 1) \
            or scale.shape != (x.shape[-1],):
        want = "(R, D)" if rows_only else "(..., D)"
        raise ValueError(f"rmsnorm_rows: shapes x {tuple(x.shape)}, "
                         f"scale {tuple(scale.shape)}; want {want}, (D,)")
    _check_d(x.shape[-1], x.dtype)
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm_rows: x and scale must be contiguous")
    if x.data_ptr() % 16 or scale.data_ptr() % 16:
        raise ValueError("rmsnorm_rows: x and scale must be 16-byte aligned")


def rmsnorm_rows(x: torch.Tensor, scale: torch.Tensor, *,
                 eps: float = 1e-6) -> torch.Tensor:
    """x: (R, D), scale: (D,) f32 -> (R, D) in x's dtype."""
    if not x.is_cuda:
        return _plain(x, scale, eps)
    if x.dim() != 2:
        _check(x, scale)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNormRows.apply(x, scale, eps)
    return _launch(x, scale, eps)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D), scale: (D,) f32 -> x's shape in x's dtype: RMSNorm of
    each of x's rows.  On the card a contiguous x outside autograd is
    launched on as it is (its rows are contiguous), with no reshape in or
    out; anything else goes through :func:`rmsnorm_rows` as (R, D)."""
    if x.is_cuda and x.is_contiguous() and not (
            torch.is_grad_enabled()
            and (x.requires_grad or scale.requires_grad)):
        return _launch(x, scale, eps)
    shape = x.shape
    return rmsnorm_rows(x.reshape(-1, shape[-1]), scale,
                        eps=eps).reshape(shape)


def _plain(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    if x.device.type not in _PLAIN_DEVICES:
        _check(x, scale)
    return rmsnorm_rows_plain(x, scale, eps=eps)


#: (x's shape, dtype, device index, eps) -> (the C entry point, the
#: address of its ``_Launch``, the ``_Launch``, scale's shape)
_LAUNCHES: dict = {}
#: torch._C's current-device and current-raw-stream lookups, found at the
#: first launch (a CPU build of torch has neither)
_CUDA: list = []


def _launch(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """The kernel on x (..., D)'s rows; everything refused raises in
    :func:`_check` (a launch for a new shape is made there too)."""
    dev = x.get_device()
    launch = _LAUNCHES.get((x.shape, x.dtype, dev, eps))
    xp, sp = x.data_ptr(), scale.data_ptr()
    if (launch is None or not x.is_contiguous()
            or not scale.is_contiguous() or scale.dtype != torch.float32
            or scale.shape != launch[3] or scale.get_device() != dev
            or dev != _CUDA[0]() or (xp | sp) & 15):
        _check(x, scale, rows_only=False)
        launch = _prepare(x, eps)
    y = torch.empty_like(x)
    if launch is None:      # no rows
        return y
    rc = launch[0](xp, sp, y.data_ptr(), launch[1], _CUDA[1](dev))
    if rc:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {rc}")
    rmsnorm_rows.launches += 1
    return y


@functools.cache
def _sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _prepare(x: torch.Tensor, eps: float) -> tuple | None:
    """The launch of a checked x (..., D) (its first call: the plan, the
    ``_Launch``), kept in ``_LAUNCHES``; None for no rows."""
    if not _CUDA:
        _CUDA.extend((torch._C._cuda_getDevice,
                      torch._C._cuda_getCurrentRawStream))
    dev, d = x.get_device(), x.shape[-1]
    rows = x.numel() // d
    if rows == 0:
        return None
    plan = rmsnorm_plan(rows, d, x.dtype, _sms(dev))
    desc = _Launch(rows, d, _DTYPE_CODES[x.dtype], plan.lanes, plan.vecs,
                   plan.rows_per_block, plan.grid, eps)
    launch = (library().repro_rmsnorm, ctypes.addressof(desc), desc,
              torch.Size((d,)))
    _LAUNCHES[(x.shape, x.dtype, dev, eps)] = launch
    return launch


rmsnorm_rows.launches = 0
