"""Public kernel entry points with the reference's signatures
(``repro.kernels.ops``), minus its ``interpret`` flag: a CPU (or
``meta``) tensor takes the plain version, a CUDA tensor the Hopper kernel.
``mamba_scan(x, dt, bm, cm, a, d_skip)`` is the selective scan.
"""

from __future__ import annotations

import torch

from .decode_attention import decode_attention
from .flash_attention import flash_attention
from .mamba_scan import mamba_scan
from .rmsnorm import rmsnorm_rows

__all__ = ["flash_attention", "decode_attention", "rmsnorm", "mamba_scan"]


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D), scale: (D,)."""
    shape = x.shape
    return rmsnorm_rows(x.reshape(-1, shape[-1]), scale,
                        eps=eps).reshape(shape)
