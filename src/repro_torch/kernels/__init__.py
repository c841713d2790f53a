"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``, built by
:mod:`.build`, bound with ctypes), each beside its plain PyTorch
version and a launch counter on its wrapper."""

from .decode_attention import decode_attention, decode_attention_plain
from .rmsnorm import rmsnorm_rows, rmsnorm_rows_plain

__all__ = ["decode_attention", "decode_attention_plain", "rmsnorm_rows",
           "rmsnorm_rows_plain", "launch_counts", "reset_launch_counts"]

_WRAPPERS = {"rmsnorm": rmsnorm_rows, "decode_attention": decode_attention}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
