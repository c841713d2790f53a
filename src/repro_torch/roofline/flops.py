"""Analytic per-cell FLOPs / HBM-bytes model (the port of the
reference's ``repro.roofline.flops``, its arithmetic copied as it is).

The model is exact for the matmul-dominated terms because the einsum
dimensions are known, and :mod:`repro_torch.roofline.correction`
validates it against two-point depth extrapolation of the dry run's
counted FLOPs (``flops(2 units) - flops(1 unit)`` = one unit's cost).

Conventions:
* forward FLOPs = 2 * (weights touched) per token + attention core;
* training multiplies forward by 4 (backward ~2x + full-remat
  recompute ~1x), inference by 1;
* bytes: parameter/optimizer streams per device + activation traffic
  + attention KV streams (restreamed once per query block by both the
  flash kernel and its plain twin).
"""

from __future__ import annotations

from ..configs import SHAPES, get_config
from ..models import transformer as T
from ..models.common import ModelConfig

__all__ = ["cell_flops", "cell_bytes", "layer_fwd_flops_per_token"]

_TRAIN_MULT = 4.0   # fwd + bwd(2x) + remat recompute(1x)


def _attn_core_ctx(cfg: ModelConfig, spec) -> float:
    """Average attended context length per query token."""
    S = spec.seq_len
    if spec.kind == "decode":
        ctx = S
    else:
        ctx = (S + 1) / 2 if cfg.causal else S
    if cfg.sliding_window is not None:
        ctx = min(ctx, cfg.sliding_window)
    return float(ctx)


def layer_fwd_flops_per_token(cfg: ModelConfig, i: int, ctx: float) -> float:
    d = cfg.d_model
    kind = cfg.layer_kind(i)
    f = 0.0
    if kind == "attn":
        if cfg.attn_type == "mla":
            H = cfg.n_heads
            dn, dr, dv = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                          cfg.v_head_dim)
            r_kv, r_q = cfg.kv_lora_rank, cfg.q_lora_rank
            w = d * r_kv + d * dr + r_kv * H * (dn + dv) + H * dv * d
            w += (d * r_q + r_q * H * (dn + dr)) if r_q else d * H * (dn + dr)
            f += 2 * w
            f += 2 * H * ((dn + dr) + dv) * ctx  # scores + PV
        else:
            H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
            w = d * hd * (H + 2 * Hkv) + H * hd * d
            f += 2 * w
            f += 2 * H * hd * 2 * ctx
    elif kind == "mamba":
        di, ds, dtr, dc = (cfg.mamba_d_inner, cfg.mamba_d_state,
                           cfg.dt_rank, cfg.mamba_d_conv)
        w = d * 2 * di + di * (dtr + 2 * ds) + dtr * di + di * d
        f += 2 * w + 2 * dc * di + 10 * di * ds
    elif kind == "mlstm":
        di = int(cfg.d_model * cfg.xlstm_proj_factor)
        di = -(-di // cfg.n_heads) * cfg.n_heads
        H = cfg.n_heads
        hd = di // H
        ck = 256.0
        w = d * 2 * di + 3 * di * di + di * d + di * 2 * H
        f += 2 * w + 4 * H * hd * ck + 6 * H * hd * hd
    elif kind == "slstm":
        H = cfg.n_heads
        hd = d // H
        ffd = int(d * 4 / 3)
        w = d * 4 * d + 4 * H * hd * hd + d * 2 * ffd + ffd * d
        f += 2 * w
    # ffn / moe
    if cfg.is_moe_layer(i):
        ff = cfg.moe_d_ff
        k_act = cfg.top_k * cfg.capacity_factor + cfg.n_shared_experts
        mult = 3 if cfg.act == "swiglu" else 2
        f += 2 * mult * d * ff * k_act + 2 * d * cfg.n_experts
    elif kind in ("attn", "mamba") and cfg.d_ff:
        mult = 3 if cfg.act == "swiglu" else 2
        f += 2 * mult * d * cfg.d_ff
    return f


def cell_flops(arch: str, shape_name: str) -> float:
    """Total true FLOPs of one step of the cell (all devices)."""
    cfg = get_config(arch)
    spec = SHAPES[shape_name]
    ctx = _attn_core_ctx(cfg, spec)
    per_tok = sum(layer_fwd_flops_per_token(cfg, i, ctx)
                  for i in range(cfg.n_layers))
    head = 2 * cfg.d_model * cfg.vocab
    if spec.kind == "decode":
        tokens = float(spec.global_batch)
        head_tokens = tokens
    elif spec.kind == "prefill":
        tokens = float(spec.global_batch * spec.seq_len)
        head_tokens = float(spec.global_batch)  # last position only
    else:
        tokens = float(spec.global_batch * spec.seq_len)
        head_tokens = tokens
    mult = _TRAIN_MULT if spec.kind == "train" else 1.0
    return (per_tok * tokens + head * head_tokens) * mult


def _param_count(cfg: ModelConfig) -> float:
    """The parameters of the port's ``meta`` init (nothing allocated)."""
    return float(T.count_params(T.init(cfg, device="meta")))


def cell_bytes(arch: str, shape_name: str, n_devices: int,
               accum: int = 1) -> float:
    """Per-device HBM traffic of one step (analytic)."""
    cfg = get_config(arch)
    spec = SHAPES[shape_name]
    P = _param_count(cfg)
    d = cfg.d_model
    if spec.kind == "decode":
        tokens_dev = spec.global_batch / min(spec.global_batch, n_devices)
        tokens_dev = max(spec.global_batch / n_devices, 1.0)
    else:
        tokens_dev = spec.global_batch * spec.seq_len / n_devices
    if spec.kind == "train":
        # params f32 read (fwd+bwd+remat ~3x), grad write+read, m/v rw
        # (bf16), param write — per microbatch the params are re-read.
        p_dev = P / n_devices
        param_traffic = p_dev * (3 * 4 * accum + 4 + 4 + 4 * 2 + 4)
        act = tokens_dev * d * cfg.n_layers * 2 * 2 * 3   # save+read, bf16
        kv_stream = _attn_stream_bytes(cfg, spec, tokens_dev) * 3
        return param_traffic + act + kv_stream
    # inference
    p_dev = P / n_devices
    param_traffic = p_dev * 2            # bf16-equivalent stream
    act = tokens_dev * d * cfg.n_layers * 2 * 2
    kv = _attn_stream_bytes(cfg, spec, tokens_dev)
    return param_traffic + act + kv


def _attn_stream_bytes(cfg: ModelConfig, spec, tokens_dev: float) -> float:
    """KV bytes streamed by attention per step per device."""
    n_attn = sum(1 for i in range(cfg.n_layers)
                 if cfg.layer_kind(i) == "attn")
    if n_attn == 0:
        return 0.0
    ctx = _attn_core_ctx(cfg, spec)
    if cfg.attn_type == "mla":
        if spec.kind == "decode":
            # absorbed decode attends the compressed cache directly
            per_ctx_tok = (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * 2
        else:
            # prefill/train decompress K/V per head
            per_ctx_tok = cfg.n_heads * (cfg.qk_nope_head_dim +
                                         cfg.qk_rope_head_dim +
                                         cfg.v_head_dim) * 2
    else:
        per_ctx_tok = 2 * cfg.n_kv_heads * cfg.head_dim * 2
    if spec.kind == "decode":
        return tokens_dev * n_attn * ctx * per_ctx_tok
    # prefill/train: blockwise attention restreams KV once per q block
    q_blocks = max(spec.seq_len // 1024, 1)
    share = ctx / spec.seq_len
    return (tokens_dev * n_attn * per_ctx_tok * q_blocks * share)
