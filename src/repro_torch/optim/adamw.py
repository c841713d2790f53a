"""AdamW, the cosine schedule and gradient utilities (the port of the
reference's ``repro.optim.adamw``), on the port's parameter trees.

State is ``{"m", "v", "step"}``: two trees mirroring the parameters in
``state_dtype`` and a 0-d int32 step count on the parameters' device,
so the update runs on the device with no host sync.  The update is
functional (new tensors, as the reference's): the training loop's NaN
guard discards an update by keeping the old trees.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from ..pytree import flatten, path_str, tree_map, tree_map_with_path

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm", "clip_by_global_norm", "compress_int8",
           "decompress_int8"]

PyTree = Any


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    #: dtype for m/v moments ("bfloat16" halves optimizer memory at 100B+
    #: scale, the standard production trade).
    state_dtype: str = "float32"


def _dtype(d) -> torch.dtype:
    return getattr(torch, d) if isinstance(d, str) else d


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr_frac``; ``step`` an f32
    tensor."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def adamw_init(params: PyTree, state_dtype="float32") -> PyTree:
    dt = _dtype(state_dtype)
    leaves = [t for _, t in flatten(params)]
    device = leaves[0].device if leaves else "cpu"
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: PyTree) -> torch.Tensor:
    leaves = [t for _, t in flatten(tree)]
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves))


def clip_by_global_norm(tree: PyTree, max_norm: float,
                        norm: torch.Tensor | None = None
                        ) -> tuple[PyTree, torch.Tensor]:
    """``tree`` scaled to at most ``max_norm``; ``norm`` is its global norm
    where the caller has it (a sharded tree's, summed over the ranks that
    hold distinct blocks), else :func:`global_norm` of ``tree``."""
    g = global_norm(tree) if norm is None else norm
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-9), max=1.0)
    return tree_map(lambda x: x * scale.to(x.dtype), tree), g


def _decay_mask(path: tuple) -> bool:
    """No weight decay for norms, biases, gates and 1-D params: the
    reference's substring tests on the path string (``"/b"`` matches any
    key that starts with "b").  The port's per-layer paths
    ("layers/3/...") and the reference's stacked ones ("stack/0/...")
    differ only in parts that no test matches."""
    s = path_str(path)
    return not any(t in s for t in ("norm", "scale", "/b", "bias", "a_log",
                                    "d_skip"))


def adamw_update(cfg: AdamWConfig, params: PyTree, grads: PyTree,
                 state: PyTree, *, grad_norm: torch.Tensor | None = None
                 ) -> tuple[PyTree, PyTree, dict]:
    """One AdamW step; ``grad_norm`` is the gradients' global norm where
    the caller computed it over blocks held on several ranks."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, grad_norm)
    step = state["step"] + 1
    stepf = step.float()
    lr = cosine_schedule(cfg, stepf)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)

    sdt = _dtype(cfg.state_dtype)
    new_m = tree_map(lambda m, g: (b1 * m.float() + (1 - b1) * g.float()
                                   ).to(sdt), state["m"], grads)
    new_v = tree_map(lambda v, g: (b2 * v.float() + (1 - b2)
                                   * torch.square(g.float())).to(sdt),
                     state["v"], grads)

    def upd(path, p, m, v):
        m, v = m.float(), v.float()
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if _decay_mask(path):
            u = u + cfg.weight_decay * p.float()
        return (p.float() - lr * u).to(p.dtype)

    new_params = tree_map_with_path(upd, params, new_m, new_v)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_params, {"m": new_m, "v": new_v, "step": step}, metrics


# ---------------------------------------------------------------------------
# Gradient compression (int8 with per-tensor scale + error feedback)
# ---------------------------------------------------------------------------

def compress_int8(tree: PyTree) -> PyTree:
    """-> {leaf: {"q": int8 values, "scale": f32 scale}}; for cross-host
    gradient exchange and accumulation-buffer compression (error
    feedback is the caller's, from the returned residual)."""

    def enc(x):
        xf = x.float()
        scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
        q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
        return {"q": q, "scale": scale}

    return tree_map(enc, tree)


def decompress_int8(tree: PyTree) -> PyTree:
    def dec(t):
        if isinstance(t, dict) and "q" in t:
            return t["q"].float() * t["scale"]
        if isinstance(t, dict):
            return {k: dec(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(dec(v) for v in t)
        return t
    return dec(tree)
