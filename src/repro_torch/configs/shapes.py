"""Assigned input shapes and per-architecture applicability.

Every LM-family architecture is paired with four shapes:

* ``train_4k``     seq 4,096   global batch 256   (training step)
* ``prefill_32k``  seq 32,768  global batch 32    (inference prefill)
* ``decode_32k``   seq 32,768  global batch 128   (one decode token, KV=32k)
* ``long_500k``    seq 524,288 global batch 1     (long-context decode)

Skip rules (recorded, not silently dropped):
* encoder-only archs have no decode step -> decode shapes skipped,
* ``long_500k`` requires a sub-quadratic/bounded-KV path -> runs for
  SSM/hybrid archs and SWA archs, skipped for pure full-attention archs.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..models.common import ModelConfig

__all__ = ["ShapeSpec", "SHAPES", "shape_plan"]


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def _is_recurrent_or_hybrid(cfg: ModelConfig) -> bool:
    return any(k != "attn" for k in cfg.block_pattern)


def shape_plan(cfg: ModelConfig) -> dict[str, str | None]:
    """shape name -> None (run) or a skip reason string."""
    plan: dict[str, str | None] = {}
    for name, spec in SHAPES.items():
        reason = None
        if spec.kind == "decode" and not cfg.causal:
            reason = "encoder-only: no autoregressive decode step"
        elif name == "long_500k":
            if not cfg.causal:
                reason = "encoder-only: no autoregressive decode step"
            elif _is_recurrent_or_hybrid(cfg):
                reason = None  # SSM/hybrid: constant/bounded state
            elif cfg.sliding_window is not None:
                reason = None  # SWA bounds the KV cache
            else:
                reason = ("pure full-attention architecture: no "
                          "sub-quadratic path at 524k context")
        elif spec.kind == "prefill" and not cfg.causal:
            # Encoder archs still run prefill-shaped forward (a 32k
            # utterance batch) — it is just a forward pass.
            reason = None
        plan[name] = reason
    return plan
