"""Public kernel entry points with the reference's signatures
(``repro.kernels.ops``), minus its ``interpret`` flag: a CPU tensor
takes the plain version, a CUDA tensor the Hopper kernel.

Flash attention and the Mamba scan are not ported yet (see ROADMAP).
"""

from __future__ import annotations

import torch

from .decode_attention import decode_attention
from .rmsnorm import rmsnorm_rows

__all__ = ["decode_attention", "rmsnorm"]


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D), scale: (D,)."""
    shape = x.shape
    return rmsnorm_rows(x.reshape(-1, shape[-1]), scale,
                        eps=eps).reshape(shape)
