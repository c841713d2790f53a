"""``meta`` stand-ins for every (arch x shape) dry-run cell (the port of
the reference's ``repro.launch.specs``, whose ``ShapeDtypeStruct``\\ s
these tensors mirror in shape and dtype).

Nothing here allocates: parameters and optimizer state come from the
real initialisers on ``meta`` (the port's per-layer layout), inputs are
synthesized per the assigned shape table.  ``[audio]``/``[vlm]`` archs
receive precomputed frame/patch embeddings (the modality frontend is a
stub).
"""

from __future__ import annotations

from typing import Any

import torch

from ..configs import ShapeSpec
from ..models import transformer as T
from ..models.common import ModelConfig
from ..optim.adamw import adamw_init
from ..pytree import tree_map

__all__ = ["input_specs", "state_specs", "cache_shape"]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, spec: ShapeSpec) -> dict[str, Any]:
    """Model inputs for one cell, as ``meta`` tensors."""
    B, S = spec.global_batch, spec.seq_len
    if spec.kind in ("train", "prefill"):
        if cfg.input_mode == "tokens":
            inputs = _meta((B, S), torch.int32)
        else:
            inputs = _meta((B, S, cfg.d_model), torch.bfloat16)
        out = {"inputs": inputs}
        if spec.kind == "train":
            out["labels"] = _meta((B, S), torch.int32)
        return out
    # decode: one new token against a cache of S tokens.
    if cfg.input_mode == "tokens":
        tok = _meta((B,), torch.int32)
    else:
        tok = _meta((B, 1, cfg.d_model), torch.bfloat16)
    return {"tok": tok, "pos": _meta((), torch.int32)}


def state_specs(cfg: ModelConfig, *, with_opt: bool = True,
                opt_dtype=torch.float32,
                param_dtype=None) -> dict[str, Any]:
    """``meta`` parameters (f32, as the reference initialises them) and,
    with ``with_opt``, the AdamW state in ``opt_dtype``.
    ``param_dtype=torch.bfloat16`` models inference deployments (resident
    bf16 weights): every f32 leaf takes it."""
    params = T.init(cfg, device="meta", param_dtype=torch.float32)
    if param_dtype is not None:
        params = tree_map(
            lambda t: _meta(t.shape, param_dtype if t.dtype == torch.float32
                            else t.dtype), params)
    out = {"params": params}
    if with_opt:
        out["opt_state"] = adamw_init(params, opt_dtype)
    return out


def cache_shape(cfg: ModelConfig, spec: ShapeSpec) -> Any:
    """The KV/state cache sized for the cell's context length, on
    ``meta``."""
    return T.init_cache(cfg, spec.global_batch, spec.seq_len, device="meta")
