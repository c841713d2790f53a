"""Decode attention: the CUDA kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``decode_attention_bh``
(``src/repro/kernels/decode_attention.py:68``) and, on the model path,
the reference's XLA ``decode_sdpa``.  The kernel
(``csrc/decode_attention.cu``) is bound by bytes: it reads the valid
prefix of the KV cache once, in place in its ``(B, T, Hkv, D)`` layout,
split over a cluster of blocks per (batch, KV head, group of up to 8
query heads).  Each block streams its share of the prefix through a ring
of TMA-fed stages, and the blocks merge their online-softmax partials in
a fixed order through distributed shared memory, all in one launch.
:func:`decode_plan` sets tile, ring depth, cluster size, grid and shared
memory from the shapes alone; the source note in the ``.cu`` file has
the details.

Both versions keep the softmax weights in f32 for the P.V product, as
the TPU kernel does (``decode_sdpa`` rounds them to the cache dtype
first).  The output is in q's dtype.  With ``return_lse`` both also
return each row's log-sum-exp of its scaled scores, (B, H) f32, natural
log, -inf for a row of length 0: the kernel writes it from the merge it
already does (no extra pass), so a cache cut into slot blocks can be
attended block by block and the blocks' outputs merged
(:func:`merge_partials`).

:func:`decode_attention` launches the kernel for CUDA tensors and uses
:func:`decode_attention_plain` only for tensors on the CPU
or on ``meta`` (shapes only); on a CUDA
tensor it launches or raises.  ``decode_attention.launches`` counts the
kernel's launches.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from .build import PLAIN_DEVICES as _PLAIN_DEVICES
from .build import library
from .nograd import refuse_grad

__all__ = ["DecodePlan", "decode_attention", "decode_attention_plain",
           "decode_plan", "merge_partials"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_NEG_INF = -1e30
_WARPS = 8             # warps per block (csrc/decode_attention.cu kWarps)
_MAX_GROUP = 8         # query heads per cluster
_CLUSTER = 8           # blocks per cluster, the portable maximum
_STAGES = 2            # K/V stages in each block's ring
_STAGE_BYTES = 32768   # K + V bytes a stage aims at


class DecodePlan(NamedTuple):
    """The kernel's launch: ``grid`` blocks in clusters of ``cluster``,
    cluster ``x // cluster`` serving batch ``x // (Hkv * ngroups)``, KV
    head ``x // ngroups % Hkv`` and query heads ``(x % ngroups) * heads``
    onward of that KV head's g (``ngroups = ceil(g / heads)``); block
    rank r of a cluster reads tiles r, r + cluster, ... of ``tile``
    positions of the valid prefix through a ring of ``stages`` K/V
    stages; ``smem`` dynamic shared-memory bytes a block."""
    tile: int
    stages: int
    cluster: int
    heads: int
    grid: int
    smem: int


def _pow2_ceil(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


@functools.lru_cache(maxsize=None)
def decode_plan(B: int, H: int, Hkv: int, T: int, D: int,
                q_dtype: torch.dtype, kv_dtype: torch.dtype) -> DecodePlan:
    """The plan for q (B, H, D) in ``q_dtype`` on a (B, T, Hkv, D) cache in
    ``kv_dtype``, from the shapes alone (the lengths are read on the
    card).  The tile is the power of two, 8 to 256 positions and no
    larger than T needs, that brings a stage's K and V nearest
    ``_STAGE_BYTES`` from below; the query heads per cluster are g
    rounded up to a power of two, at most 8.  q's dtype does not change
    the plan."""
    if q_dtype not in _DTYPE_CODES or kv_dtype not in _DTYPE_CODES:
        raise TypeError("decode_plan: q and the cache must be float32 or "
                        "bfloat16")
    esize = 4 if kv_dtype == torch.float32 else 2
    g = H // Hkv
    heads = min(_MAX_GROUP, _pow2_ceil(g))
    tile = 1 << ((_STAGE_BYTES // (2 * D * esize)).bit_length() - 1)
    tile = max(8, min(256, tile, _pow2_ceil(T)))
    # the layout of csrc/decode_attention.cu's `layout`: the ring (later
    # the warps' partials), the block's partial, the mbarriers, slack to
    # align the ring to 128 bytes
    ring = _STAGES * 2 * tile * D * esize
    warps = 4 * _WARPS * heads * (D + 2)
    part = -(-max(ring, warps) // 16) * 16
    bars = -(-(part + 4 * heads * (D + 2)) // 8) * 8
    smem = bars + 16 * _STAGES + 128
    ngroups = -(-g // heads)
    return DecodePlan(tile, _STAGES, _CLUSTER, heads,
                      B * Hkv * ngroups * _CLUSTER, smem)


@functools.lru_cache(maxsize=None)
def _schedulable(plan: DecodePlan, H: int, Hkv: int, D: int, q_code: int,
                 kv_code: int, device: int) -> int:
    """Clusters of ``plan`` the card holds at once; raises where it holds
    none (the cluster cannot be scheduled) or the query fails."""
    n = library().repro_decode_attention_clusters(
        H, Hkv, D, q_code, kv_code, plan.tile, plan.stages, plan.cluster,
        plan.smem)
    if n < 0:
        raise RuntimeError(f"decode attention: the cluster occupancy query "
                           f"failed: CUDA error {-n} for {plan}")
    if n == 0:
        raise RuntimeError(f"decode attention: the card cannot schedule a "
                           f"cluster of {plan}")
    return n


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, lengths: torch.Tensor, *,
                           return_lse: bool = False):
    """q: (B, H, D), k/v: (B, T, Hkv, D), lengths: (B,) -> (B, H, D), and
    with ``return_lse`` the (B, H) f32 log-sum-exp of each row's scaled
    scores (-inf for a row of length 0).

    Positions ``t < lengths[b]`` are attended; the math is f32."""
    B, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    qg = q.float().reshape(B, Hkv, g, D)
    s = torch.einsum("bhgd,bthd->bhgt", qg, k.float()) / math.sqrt(D)
    ok = torch.arange(T, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(ok[:, None, None, :], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgt,bthd->bhgd", p, v.float())
    out = out.reshape(B, H, D).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(s, dim=-1).reshape(B, H)
    return out, torch.where(lengths[:, None] > 0, lse, -math.inf)


def merge_partials(outs: torch.Tensor, lses: torch.Tensor) -> torch.Tensor:
    """The attention over a cache cut into blocks, from each block's
    output ``outs`` (n, B, H, D) and log-sum-exp ``lses`` (n, B, H):
    ``sum_i exp(lse_i - M) out_i / sum_i exp(lse_i - M)`` in f32, summed
    in block order (the same bits wherever it runs).  A block of length 0
    (lse -inf) adds nothing; a row whose blocks are all empty gets zeros."""
    M = lses.amax(0)
    M = torch.where(torch.isinf(M), 0.0, M)
    num = torch.zeros(outs.shape[1:], dtype=torch.float32,
                      device=outs.device)
    den = torch.zeros(lses.shape[1:], dtype=torch.float32,
                      device=lses.device)
    for out, lse in zip(outs.float().unbind(0), lses.float().unbind(0)):
        w = torch.exp(lse - M)
        num = num + w[..., None] * out
        den = den + w
    return torch.where(den[..., None] > 0,
                       num / torch.where(den > 0, den, 1.0)[..., None], 0.0)


def _check(q, k, v, lengths, lse=None) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    if not (k.device == v.device == lengths.device == q.device):
        raise ValueError("decode_attention: tensors on different devices")
    if q.device.index != torch.cuda.current_device():
        raise ValueError("decode_attention: q is not on the current CUDA "
                         "device")
    if q.dtype not in _DTYPE_CODES or k.dtype not in _DTYPE_CODES:
        raise TypeError("decode_attention: q and the cache must be float32 "
                        "or bfloat16")
    if v.dtype != k.dtype:
        raise TypeError("decode_attention: k and v dtypes differ")
    if lengths.dtype != torch.int32:
        raise TypeError("decode_attention: lengths must be int32")
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, H, D = q.shape
    _, T, Hkv, Dk = k.shape
    if k.shape[0] != B or Dk != D or T == 0 or H % Hkv:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not "
                         f"match cache {tuple(k.shape)}")
    if lengths.shape != (B,) or not lengths.is_contiguous():
        raise ValueError("decode_attention: lengths must be contiguous (B,)")
    if D % 8 or not 0 < D <= 256:
        raise ValueError(f"decode_attention: D={D} must be a multiple of 8 "
                         "up to 256")
    if not q.is_contiguous():
        raise ValueError("decode_attention: q must be contiguous")
    for name, c in (("k", k), ("v", v)):
        if c.stride(3) != 1 or any(s % 8 for s in c.stride()[:3]):
            raise ValueError(f"decode_attention: {name} needs a contiguous "
                             "last axis and strides in multiples of 8")
        if c.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be 16-byte "
                             "aligned")
    if lse is not None and (lse.dtype != torch.float32
                            or lse.shape != (B, H) or not lse.is_contiguous()
                            or lse.device != q.device):
        raise ValueError("decode_attention: lse must be a contiguous f32 "
                         f"(B, H) = {(B, H)} tensor on q's device")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *, return_lse: bool = False):
    """q: (B, H, D), k/v: (B, T, Hkv, D), lengths: (B,) int32 ->
    (B, H, D) in q's dtype, and with ``return_lse`` the (B, H) f32
    log-sum-exp of each row's scaled scores.  Rows of length 0 give zeros
    on the card, and an lse of -inf."""
    if q.device.type in _PLAIN_DEVICES:
        return decode_attention_plain(q, k, v, lengths,
                                      return_lse=return_lse)
    refuse_grad("decode_attention", q, k, v)
    lse = (torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
           if return_lse else None)
    _check(q, k, v, lengths, lse)
    out = torch.empty_like(q)
    B, H, D = q.shape
    _, T, Hkv, _ = k.shape
    plan = decode_plan(B, H, Hkv, T, D, q.dtype, k.dtype)
    q_code, kv_code = _DTYPE_CODES[q.dtype], _DTYPE_CODES[k.dtype]
    _schedulable(plan, H, Hkv, D, q_code, kv_code, q.device.index)
    rc = library().repro_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(), B, H, Hkv,
        T, D, *k.stride()[:3], *v.stride()[:3],
        1.0 / math.sqrt(D), q_code, kv_code, plan.tile, plan.stages,
        plan.cluster, plan.grid, plan.smem,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"decode attention kernel launch failed: CUDA "
                           f"error {rc}")
    decode_attention.launches += 1
    return (out, lse) if return_lse else out


decode_attention.launches = 0
