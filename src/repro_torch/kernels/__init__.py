"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``, built by
:mod:`.build`, bound with ctypes), each beside its plain PyTorch
version and a launch counter on its wrapper."""

from .decode_attention import (decode_attention, decode_attention_plain,
                               decode_plan)
from .event_scan import event_times, event_times_plain, event_times_reference
from .flash_attention import (flash_attention, flash_attention_plain,
                              flash_plan)
from .mamba_scan import mamba_scan, mamba_scan_plain, scan_plan
from .rmsnorm import rmsnorm_plan, rmsnorm_rows, rmsnorm_rows_plain

__all__ = ["decode_attention", "decode_attention_plain", "decode_plan",
           "event_times",
           "event_times_plain", "event_times_reference", "flash_attention",
           "flash_attention_plain", "flash_plan", "mamba_scan",
           "mamba_scan_plain", "scan_plan",
           "rmsnorm_plan", "rmsnorm_rows", "rmsnorm_rows_plain",
           "launch_counts",
           "reset_launch_counts"]

_WRAPPERS = {"rmsnorm": rmsnorm_rows, "decode_attention": decode_attention,
             "flash_attention": flash_attention, "event_scan": event_times,
             "mamba_scan": mamba_scan}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
