"""Shared model config and elementary layers (PyTorch).

The port of the reference's ``repro.models.common``.  Parameters are
plain nested dicts of tensors; every layer is a function of
``(params, x)``.  Weights and dense biases are stored once in the
config's compute dtype (the reference casts them on every call, which
gives the same numbers); norm scales and biases stay float32.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..kernels import ops

__all__ = ["ModelConfig", "normal", "make_dense", "init_norm", "dense",
           "rmsnorm", "layernorm", "norm", "act_fn", "rope_tables",
           "apply_rope"]


@dataclass(frozen=True)
class ModelConfig:
    """One config object covers all ten assigned architectures
    (field-identical to the reference's ``ModelConfig``)."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    # --- attention ---
    attn_type: str = "gqa"          # "gqa" | "mla"
    qkv_bias: bool = False
    causal: bool = True
    sliding_window: int | None = None
    rope_theta: float = 10_000.0
    use_rope: bool = True

    # --- MLA (deepseek-v2) ---
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    moe_layer_period: int = 1        # MoE every k-th layer
    first_dense_layers: int = 0      # leading dense layers (deepseek)
    capacity_factor: float = 1.25

    # --- block pattern, cycled over layers ---
    block_pattern: tuple[str, ...] = ("attn",)   # attn|mamba|mlstm|slstm

    # --- mamba ---
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 0           # 0 => ceil(d_model/16)

    # --- xlstm ---
    xlstm_proj_factor: float = 2.0

    # --- misc ---
    act: str = "swiglu"              # "swiglu" | "gelu"
    norm: str = "rmsnorm"            # "rmsnorm" | "layernorm"
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    input_mode: str = "tokens"       # "tokens" | "embeddings" (stub frontend)
    logit_softcap: float = 0.0

    # ------------------------------------------------------------------
    @property
    def compute_dtype(self) -> torch.dtype:
        dt = getattr(torch, self.dtype, None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"unknown dtype {self.dtype!r}")
        return dt

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.mamba_dt_rank or -(-self.d_model // 16)

    def layer_kind(self, i: int) -> str:
        return self.block_pattern[i % len(self.block_pattern)]

    def is_moe_layer(self, i: int) -> bool:
        if self.n_experts == 0 or i < self.first_dense_layers:
            return False
        return (i - self.first_dense_layers + 1) % self.moe_layer_period == 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Elementary layers
# ---------------------------------------------------------------------------

def normal(gen: torch.Generator, shape: tuple[int, ...], scale: float,
           dtype: torch.dtype, device) -> torch.Tensor:
    """``scale`` times a standard normal draw from ``gen``, made on the
    generator's device (a CPU generator gives the same weights on every
    device), stored in ``dtype`` on ``device``.  On ``meta`` nothing is
    drawn: the tensor holds its shape and dtype only."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return w.mul_(scale).to(device=device, dtype=dtype)


def make_dense(gen: torch.Generator, d_in: int, d_out: int, *,
               dtype: torch.dtype, device, bias: bool = False,
               scale: float | None = None) -> dict:
    scale = 1.0 / math.sqrt(d_in) if scale is None else scale
    p = {"w": normal(gen, (d_in, d_out), scale, dtype, device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def init_norm(d: int, kind: str, device) -> dict:
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x·rsqrt(mean(x²)+eps)·scale`` in f32, written in x's dtype; on
    CUDA tensors this is the port's RMSNorm kernel."""
    return ops.rmsnorm(x, p["scale"], eps=eps)


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"]
    if "bias" in p:
        y = y + p["bias"]
    return y.to(dt)


def norm(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    return rmsnorm(p, x) if kind == "rmsnorm" else layernorm(p, x)


def act_fn(kind: str):
    if kind == "gelu":
        # jax.nn.gelu defaults to the tanh approximation.
        return lambda x: F.gelu(x, approximate="tanh")
    if kind == "silu":
        return F.silu
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for the given positions; shape (..., head_dim//2)."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate the two halves of the head dim: (x1, x2) = (x[..., :D/2],
    x[..., D/2:]).  x: (..., S, H, D); cos/sin: (..., S, D/2)."""
    dt = x.dtype
    x1, x2 = x.float().chunk(2, dim=-1)
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.to(dt)
