"""Conversion of the reference package's parameters into the port's.

The reference keeps parameters as a pytree whose repeating layers are
stacked along a leading ``(reps,)`` axis (``T.init`` builds them with
``vmap``).  :func:`params_from_numpy` takes that tree with NumPy
leaves — the caller runs ``jax.tree.map(np.asarray, params)`` — and
returns the port's layout: one dict per layer, in layer order, weights
in the config's compute dtype and the leaves the reference keeps in
float32 (norm parameters, the MoE router, Mamba's non-projection
leaves) in float32.  Nothing here imports JAX.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .models import transformer as T
from .models.common import ModelConfig

__all__ = ["params_from_numpy"]

#: path suffixes of the leaves that stay float32: norm scales and norm
#: biases, the MoE router's weight (routing runs in f32), Mamba's conv,
#: dt bias, A and skip leaves, and xLSTM's ``ln_scale`` and sLSTM's
#: recurrent ``r`` (the mixer's own key: no other leaf ends so); other
#: leaves (dense ``w`` and ``b``, the experts) take the compute dtype
_F32_PATHS = (("scale",), ("bias",), ("router", "w"), ("conv_w",),
              ("conv_b",), ("dt_bias",), ("a_log",), ("d_skip",),
              ("ln_scale",), ("mixer", "r"))


def _is_f32(path: tuple[str, ...]) -> bool:
    return any(path[-len(s):] == s for s in _F32_PATHS)


def _index(tree, r: int):
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


def _convert(tree, dtype: torch.dtype, device, path: tuple[str, ...] = ()):
    if isinstance(tree, dict):
        return {k: _convert(v, dtype, device, path + (k,))
                for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":      # ml_dtypes bf16: no torch view
        a = a.astype(np.float32)
    with warnings.catch_warnings():
        # Read-only arrays (as from a JAX array) are copied just below.
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(a)
    dt = torch.float32 if _is_f32(path) else dtype
    return t.to(device=device, dtype=dt, copy=True)


def params_from_numpy(tree: dict, cfg: ModelConfig, *,
                      device="cuda") -> dict:
    """The reference's parameter tree (NumPy leaves) -> the port's."""
    dt = cfg.compute_dtype
    out = {k: _convert(v, dt, device, (k,)) for k, v in tree.items()
           if k not in ("prefix", "stack")}
    layers = [_convert(lp, dt, device) for lp in tree["prefix"]]
    prefix, period = T.unit_period(cfg)
    reps = (cfg.n_layers - prefix) // period
    for r in range(reps):
        for u in range(period):
            layers.append(_convert(_index(tree["stack"][u], r), dt, device))
    out["layers"] = layers
    return out
