"""Flash attention (full-sequence forward): the CUDA kernel's wrapper and
its plain version.

Replaces the Pallas TPU kernel ``flash_attention_bh``
(``src/repro/kernels/flash_attention.py:79``) behind the reference's
``ops.flash_attention``.  The kernel (``csrc/flash_attention.cu``) is
bound by operations: it reads q in its ``(B, S, H, D)`` layout and k/v
in ``(B, T, Hkv, D)`` in place through their strides, serves the g query
heads of one KV head from each K/V tile it stages, bounds the KV walk of
every query tile by the causal diagonal and the sliding window, and
masks the tails, so any S and T are taken.  bf16 inputs run on Hopper's
machinery: TMA loads into a ring of K/V stages guarded by mbarriers, a
producer warp and two consumer warpgroups on ``wgmma``, over 128-row
query tiles planned by :func:`flash_plan`; f32 inputs run both products
on the f32 FMA units.  The source note in the ``.cu`` file has the
details.

Both versions keep the softmax weights in f32 for the P.V product, as
the TPU kernel and ``ref.flash_attention_ref`` do.  The output is in
q's dtype.

:func:`flash_attention` launches the kernel for CUDA tensors and uses
:func:`flash_attention_plain` only for tensors on the CPU
or on ``meta`` (shapes only); on a CUDA
tensor it launches or raises.  ``flash_attention.launches`` counts the
kernel's launches.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .build import PLAIN_DEVICES as _PLAIN_DEVICES
from .build import library
from .nograd import refuse_grad

__all__ = ["FlashPlan", "flash_attention", "flash_attention_plain",
           "flash_plan"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_NEG_INF = -1e30
_MAX_D = 128
_TILE_ROWS = 128    # (position, head) rows of a bf16 block
_MAX_GROUP = 16     # query heads of one KV head per block


class FlashPlan(NamedTuple):
    """The bf16 kernel's block map: block ``(x, y)`` serves batch
    ``x // (Hkv * ngroups)``, KV head ``x // ngroups % Hkv``, query heads
    ``kv_head * g + (x % ngroups) * G`` onward (G of them) and positions
    ``(ntiles - 1 - y) * P`` onward (P of them, fewer at the end of S);
    row ``r < P * G`` of the block is position ``r // G``, head ``r % G``
    of those."""
    G: int
    P: int
    ngroups: int
    ntiles: int


def flash_plan(S: int, H: int, Hkv: int) -> FlashPlan:
    """Heads per group G: the largest power of two, at most 16, that
    divides g = H / Hkv, so that no group is partial (a TMA box of G
    heads never reaches another KV head's rows) and the tile of
    P = 128 // G positions fills all 128 rows."""
    g = H // Hkv
    G = min(g & -g, _MAX_GROUP)
    P = _TILE_ROWS // G
    return FlashPlan(G, P, g // G, -(-S // P))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: int | None = None) -> torch.Tensor:
    """q: (B, S, H, D), k/v: (B, T, Hkv, D) -> (B, S, H, D).

    Key t is seen by query s where ``t <= s`` (causal) and
    ``t > s - window`` (window); the math is f32."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, S, Hkv, H // Hkv, D)
    s = torch.einsum("bshgd,bthd->bhgst", qg, k.float()) * (1.0 / math.sqrt(D))
    qi = torch.arange(S, device=q.device)[:, None]
    ki = torch.arange(T, device=q.device)[None, :]
    ok = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        ok &= ki <= qi
    if window is not None:
        ok &= ki > qi - window
    p = torch.softmax(torch.where(ok, s, _NEG_INF), dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", p, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)


def _check(q, k, v, window) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if not (k.device == v.device == q.device):
        raise ValueError("flash_attention: tensors on different devices")
    if q.device.index != torch.cuda.current_device():
        raise ValueError("flash_attention: q is not on the current CUDA "
                         "device")
    if q.dtype not in _DTYPE_CODES or not (k.dtype == v.dtype == q.dtype):
        raise TypeError("flash_attention: q, k and v must all be float32 or "
                        "all bfloat16")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, S, H, D = q.shape
    _, T, Hkv, Dk = k.shape
    if k.shape[0] != B or Dk != D or Hkv == 0 or H % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not "
                         f"match k/v {tuple(k.shape)}")
    if not 0 < S <= T:
        # Every query must see at least one key (S <= T with the rows
        # aligned at position 0, as in the model).
        raise ValueError(f"flash_attention: needs 0 < S <= T, got S={S}, "
                         f"T={T}")
    if not 0 < D <= _MAX_D:
        raise ValueError(f"flash_attention: head dim {D} not in "
                         f"[1, {_MAX_D}]")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} must be >= 1")


def _check_layout(*ts) -> None:
    for name, t in zip("qkv", ts):
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError(f"flash_attention: {name} needs a contiguous "
                             "last axis and strides in multiples of 8")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be 16-byte "
                             "aligned")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """q: (B, S, H, D), k/v: (B, T, Hkv, D) -> (B, S, H, D) in q's dtype.

    On the card q, k and v share one dtype (float32 or bfloat16), D is
    at most 128, and S <= T.  A head dim that is not a multiple of 8 is
    zero-padded here (the padded columns add nothing to a dot product
    and are cut from the output)."""
    if q.device.type in _PLAIN_DEVICES:
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    refuse_grad("flash_attention", q, k, v)
    _check(q, k, v, window)
    B, S, H, D = q.shape
    _, T, Hkv, _ = k.shape
    scale = 1.0 / math.sqrt(D)
    if D % 8:
        q, k, v = (F.pad(t, (0, 8 - D % 8)) for t in (q, k, v))
    _check_layout(q, k, v)
    out = torch.empty((B, S, H, q.shape[3]), dtype=q.dtype, device=q.device)
    plan = flash_plan(S, H, Hkv)     # the f32 kernel plans its own tiles
    rc = library().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, T, H,
        Hkv, q.shape[3], *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        scale, int(causal), window or 0, plan.G, plan.P,
        _DTYPE_CODES[q.dtype], torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA "
                           f"error {rc}")
    flash_attention.launches += 1
    return out[..., :D] if out.shape[3] != D else out


flash_attention.launches = 0
