"""Decode attention: the CUDA kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``decode_attention_bh``
(``src/repro/kernels/decode_attention.py:68``) and, on the model path,
the reference's XLA ``decode_sdpa``.  The kernel
(``csrc/decode_attention.cu``) is bound by bytes: it reads the valid
prefix of the KV cache once, in place in its ``(B, T, Hkv, D)`` layout,
with one block per (batch, KV head) serving that head's whole query
group, and keeps the online softmax on chip; the source note in the
``.cu`` file has the details.

Both versions keep the softmax weights in f32 for the P.V product, as
the TPU kernel does (``decode_sdpa`` rounds them to the cache dtype
first).  The output is in q's dtype.

:func:`decode_attention` launches the kernel for CUDA tensors and uses
:func:`decode_attention_plain` only for tensors on the CPU; on a CUDA
tensor it launches or raises.  ``decode_attention.launches`` counts the
kernel's launches.
"""

from __future__ import annotations

import math

import torch

from .build import library

__all__ = ["decode_attention", "decode_attention_plain"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_NEG_INF = -1e30


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H, D), k/v: (B, T, Hkv, D), lengths: (B,) -> (B, H, D).

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
    return out.reshape(B, H, D).to(q.dtype)


def _check(q, k, v, lengths) -> None:
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


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H, D), k/v: (B, T, Hkv, D), lengths: (B,) int32 ->
    (B, H, D) in q's dtype.  Rows of length 0 give zeros on the card."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, lengths)
    _check(q, k, v, lengths)
    out = torch.empty_like(q)
    B, H, D = q.shape
    _, T, Hkv, _ = k.shape
    rc = library().repro_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), B, H, Hkv, T, D, *k.stride()[:3], *v.stride()[:3],
        1.0 / math.sqrt(D), _DTYPE_CODES[q.dtype], _DTYPE_CODES[k.dtype],
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"decode attention kernel launch failed: CUDA "
                           f"error {rc}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
