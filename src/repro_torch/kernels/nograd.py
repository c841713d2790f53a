"""The guard of the kernels that have no backward.

Flash attention, decode attention, the selective scan and the event
scan fill a ``torch.empty`` output through ``ctypes``: their output has
no ``grad_fn``.  The reference has no backward kernel for any of them
(its training differentiates the XLA path, ``impl="xla"``), so rather
than return a tensor that has silently lost its graph, their CUDA paths
raise where autograd would record.
"""

from __future__ import annotations

import torch

__all__ = ["refuse_grad"]


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd would record through kernel ``name``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward; an input requires grad. "
            "Differentiate the plain path (impl=\"xla\", as the train "
            "step does) or call it under torch.no_grad()")
