"""Mamba-1 selective scan: the CUDA kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``mamba_scan_bd``
(``src/repro/kernels/mamba_scan.py:63``) behind the reference's
``ops.mamba_scan``.  For x, dt (B, T, Dc), Bm, Cm (B, T, S), A (Dc, S)
and D (Dc,), from a zero f32 state and walking t in order::

    h = exp(dt[t, c] * A[c, s]) * h + (dt[t, c] * x[t, c]) * Bm[t, s]
    y[t, c] = sum_s h * Cm[t, s] + D[c] * x[t, c]

in f32 (inputs upcast), y in x's dtype.  The kernel
(``csrc/mamba_scan.cu``) is bound by the special-function units' exps.
Each scan thread carries K states of one channel in registers, so a
channel takes L = SP / K lanes (S padded to SP = K * L); the lanes keep
their partial y of several steps and sum them over the channel in one
transpose-reduce.  Staging warps of their own land the next chunk of
steps by cp.async, convert x and dt into step-major tiles per channel
and write y out while the scan warps run the current chunk.
:func:`scan_plan` sets K, L, the chunk, the grid and the shared memory
from the shapes and the card's SM count; the source note in the ``.cu``
file has the details.

:func:`mamba_scan` launches the kernel for CUDA tensors and uses
:func:`mamba_scan_plain` only for tensors on the CPU
or on ``meta`` (shapes only); on a CUDA tensor
it launches or raises.  ``mamba_scan.launches`` counts the kernel's
launches.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .build import PLAIN_DEVICES as _PLAIN_DEVICES
from .build import library
from .nograd import refuse_grad

__all__ = ["ScanPlan", "mamba_scan", "mamba_scan_plain", "scan_plan"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_S = 32
_SCAN_THREADS = 256   # scan threads a block (csrc/mamba_scan.cu kScan)
_STAGE_THREADS = 128  # staging threads a block (kStage)
_TILE = 4096          # channels x steps of a block's x tile (kTile)
_SMEM_MAX = 232448    # shared memory a Hopper block can have


class ScanPlan(NamedTuple):
    """The kernel's launch: blocks of ``threads`` (256 scan threads, then
    128 staging threads) over ``grid`` = (channel blocks, batch rows); scan
    thread ``tid`` of block x carries states ``(tid % lanes) * states``
    onward of channel ``x * CH + tid // lanes``, CH = 256 / lanes; T is
    walked ``chunk`` steps at a time, and a channel's lanes sum their
    partial y every ``group`` steps; ``smem`` dynamic shared-memory bytes
    a block."""
    states: int
    lanes: int
    chunk: int
    group: int
    threads: int
    grid: tuple[int, int]
    smem: int

    @property
    def block_channels(self) -> int:
        return _SCAN_THREADS // self.lanes


def _check_shape(B: int, S: int) -> None:
    if not 1 <= S <= _MAX_S:
        raise ValueError(f"mamba_scan: S={S} must be 1..{_MAX_S}")
    if B > 65535:
        raise ValueError(f"mamba_scan: B={B} above 65535")


@functools.lru_cache(maxsize=None)
def scan_plan(B: int, T: int, Dc: int, S: int, dtype: torch.dtype,
              sms: int) -> ScanPlan:
    """The plan for x (B, T, Dc) and S states in ``dtype`` on a card of
    ``sms`` SMs: S padded to the power of two SP, K states a thread (at
    most SP), SP / K lanes a channel; a block's x tile holds 4096
    (channel, step) values, so the chunk is 16 * lanes steps.  K is 8
    where that grid still gives every SM two blocks (jamba's B 8 on an
    H100's 132), else 4: fewer lanes a channel cost fewer shuffles and
    loads a state, but at B 1 the 8-state grid leaves SMs idle."""
    _check_plan(B, T, Dc, S, dtype)
    if sms < 1:
        raise ValueError(f"mamba_scan: no plan for {sms} SMs")
    sp = 1 << (S - 1).bit_length()
    wide = B * -(-Dc * max(sp // 8, 1) // _SCAN_THREADS)
    return _plan(8 if sp >= 8 and wide >= 2 * sms else 4, B, T, Dc, S, dtype)


def _check_plan(B: int, T: int, Dc: int, S: int, dtype: torch.dtype) -> None:
    if dtype not in _DTYPE_CODES:
        raise TypeError("mamba_scan: x, dt, bm and cm must all be float32 "
                        "or all bfloat16")
    _check_shape(B, S)
    if min(B, T, Dc) < 1:
        raise ValueError(f"mamba_scan: no plan for an empty scan (B={B}, "
                         f"T={T}, Dc={Dc})")


def _plan(states: int, B: int, T: int, Dc: int, S: int,
          dtype: torch.dtype) -> ScanPlan:
    """The layout of ``states`` states a thread (at most SP) at these
    shapes; the library builds only the plans :func:`scan_plan` picks."""
    _check_plan(B, T, Dc, S, dtype)
    if states not in (1, 2, 4, 8):
        raise ValueError(f"mamba_scan: no plan of {states} states a thread")
    sp = 1 << (S - 1).bit_length()
    K = min(states, sp)
    L = sp // K
    ch = _SCAN_THREADS // L
    chunk = _TILE // ch
    # the layout of csrc/mamba_scan.cu's Plan: two stages of f32 tiles (x,
    # dt, then B and C (chunk, SP)), then the landing tiles in the input
    # dtype (B and C rows padded to 16 bytes)
    esize = dtype.itemsize
    row = -(-sp * esize // 16) * 16 // esize
    smem = 8 * (2 * _TILE + 2 * chunk * sp) + esize * (2 * _TILE + 2 * chunk * row)
    if smem > _SMEM_MAX:
        raise ValueError(f"mamba_scan: {states} states a thread at S={S} need "
                         f"{smem} bytes of shared memory a block")
    return ScanPlan(K, L, chunk, 2 * max(4, L), _SCAN_THREADS + _STAGE_THREADS,
                    (-(-Dc // ch), B), smem)


def mamba_scan_plain(x: torch.Tensor, dt: torch.Tensor, bm: torch.Tensor,
                     cm: torch.Tensor, a: torch.Tensor,
                     d_skip: torch.Tensor) -> torch.Tensor:
    """The step loop of the reference's ``ref.mamba_scan_ref``: x/dt
    (B, T, Dc), bm/cm (B, T, S), a (Dc, S), d_skip (Dc,) -> y (B, T, Dc)
    in x's dtype, computed in f32.  On ``meta`` the step loop would only
    repeat shapes: the output's is x's."""
    if x.device.type == "meta":
        return torch.empty_like(x)
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
    _check_shape(B, S)
    if a.shape != (Dc, S) or d_skip.shape != (Dc,):
        raise ValueError(f"mamba_scan: shapes a {tuple(a.shape)}, d_skip "
                         f"{tuple(d_skip.shape)}; want ({Dc}, {S}), ({Dc},)")
    if not (x.is_contiguous() and dt.is_contiguous() and a.is_contiguous()
            and d_skip.is_contiguous()):
        raise ValueError("mamba_scan: x, dt, a and d_skip must be contiguous")
    if bm.stride(-1) != 1 or cm.stride(-1) != 1:
        raise ValueError("mamba_scan: bm and cm need a contiguous last axis")


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, bm: torch.Tensor,
               cm: torch.Tensor, a: torch.Tensor,
               d_skip: torch.Tensor) -> torch.Tensor:
    """x/dt (B, T, Dc), bm/cm (B, T, S) of x's dtype (f32 or bf16; bm and
    cm may be strided views, as slices of one projection are), a (Dc, S)
    and d_skip (Dc,) f32 -> y (B, T, Dc) in x's dtype."""
    if x.device.type in _PLAIN_DEVICES:
        return mamba_scan_plain(x, dt, bm, cm, a, d_skip)
    refuse_grad("mamba_scan", x, dt, bm, cm, a, d_skip)
    _check(x, dt, bm, cm, a, d_skip)
    y = torch.empty_like(x)
    B, T, Dc = x.shape
    if y.numel() == 0:
        return y
    S = bm.shape[-1]
    plan = scan_plan(B, T, Dc, S, x.dtype, _sm_count(x.device.index))
    rc = library().repro_mamba_scan(
        x.data_ptr(), dt.data_ptr(), bm.data_ptr(), cm.data_ptr(),
        a.data_ptr(), d_skip.data_ptr(), y.data_ptr(), B, T, Dc, S,
        bm.stride(0), bm.stride(1), cm.stride(0), cm.stride(1),
        _DTYPE_CODES[x.dtype], plan.states, plan.lanes, plan.chunk,
        plan.grid[0], plan.smem,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"mamba_scan kernel launch failed: CUDA error {rc}")
    mamba_scan.launches += 1
    return y


mamba_scan.launches = 0
