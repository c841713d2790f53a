"""Public kernel entry points with the reference's signatures
(``repro.kernels.ops``), minus its ``interpret`` flag: a CPU (or
``meta``) tensor takes the plain version, a CUDA tensor the Hopper kernel.
``mamba_scan(x, dt, bm, cm, a, d_skip)`` is the selective scan;
``rmsnorm(x, scale, eps=)`` takes x (..., D).
"""

from __future__ import annotations

from .decode_attention import decode_attention
from .flash_attention import flash_attention
from .mamba_scan import mamba_scan
from .rmsnorm import rmsnorm

__all__ = ["flash_attention", "decode_attention", "rmsnorm", "mamba_scan"]
