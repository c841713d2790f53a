"""Three-term roofline analysis from dry-run records (the port of the
reference's ``repro.roofline.analysis``).

Per (arch x shape x mesh) cell::

    compute term    = FLOPs / (devices * peak_FLOP/s)
    memory term     = HBM bytes / (devices * HBM_bw)
    collective term = collective bytes per device / link_bw

FLOPs and bytes come from the analytic model
(:mod:`repro_torch.roofline.flops`); the dry run's counted FLOPs and
collective bytes are reported beside them.  :class:`HW` holds one H100
SXM's figures.  ``roofline_row`` reads depth-extrapolation corrections
from ``roofline_correction.json`` in the working directory where one
exists, as the reference does.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

from ..configs import SHAPES, get_config
from ..models.common import ModelConfig

__all__ = ["HW", "roofline_row", "model_flops", "active_params",
           "load_records", "analyse"]


@dataclass(frozen=True)
class HW:
    """One device's peaks: NVIDIA's H100 SXM data sheet (dense bf16
    tensor-core FLOP/s, HBM3 bytes/s, and NVLink 4's 900 GB/s total
    bandwidth, 450 GB/s each direction)."""

    peak_flops: float = 989e12        # bf16 / device
    hbm_bw: float = 3.35e12           # bytes/s / device
    link_bw: float = 450e9            # bytes/s / device, one direction


def active_params(cfg: ModelConfig) -> float:
    """Parameters touched per token (dense N, or N_active for MoE)."""
    d, L = cfg.d_model, cfg.n_layers
    n = cfg.vocab * d  # embedding (+ head if untied ~ counted once)
    if not cfg.tie_embeddings:
        n += cfg.vocab * d
    for i in range(L):
        kind = cfg.layer_kind(i)
        if kind == "attn":
            if cfg.attn_type == "mla":
                dn, dr, dv = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                              cfg.v_head_dim)
                H = cfg.n_heads
                n += d * cfg.kv_lora_rank + d * dr
                if cfg.q_lora_rank:
                    n += d * cfg.q_lora_rank + cfg.q_lora_rank * H * (dn + dr)
                else:
                    n += d * H * (dn + dr)
                n += cfg.kv_lora_rank * H * (dn + dv) + H * dv * d
            else:
                hd, H, Hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
                n += d * hd * (H + 2 * Hkv) + H * hd * d
        elif kind == "mamba":
            di, ds, dtr = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.dt_rank
            n += d * 2 * di + di * (dtr + 2 * ds) + dtr * di + di * d
        elif kind in ("mlstm", "slstm"):
            if kind == "mlstm":
                di = int(d * cfg.xlstm_proj_factor)
                n += d * 2 * di + 3 * di * di + di * d
            else:
                n += d * 4 * d + 4 * (d // cfg.n_heads) * d + \
                    d * int(d * 4 / 3) * 3
        if cfg.is_moe_layer(i):
            # active experts only
            ff = cfg.moe_d_ff
            k_active = cfg.top_k + cfg.n_shared_experts
            n += 3 * d * ff * k_active + d * cfg.n_experts  # router
        elif kind in ("attn", "mamba") and cfg.d_ff:
            mult = 3 if cfg.act == "swiglu" else 2
            n += mult * d * cfg.d_ff
    return float(n)


def model_flops(arch: str, shape_name: str) -> float:
    """MODEL_FLOPS = 6·N_active·D (train) or 2·N_active·D (inference)."""
    cfg = get_config(arch)
    spec = SHAPES[shape_name]
    n_act = active_params(cfg)
    if spec.kind == "train":
        tokens = spec.global_batch * spec.seq_len
        return 6.0 * n_act * tokens
    if spec.kind == "prefill":
        tokens = spec.global_batch * spec.seq_len
        return 2.0 * n_act * tokens
    # decode: one token per sequence
    return 2.0 * n_act * spec.global_batch


def roofline_row(rec: dict, hw: HW = HW()) -> dict:
    """One roofline row from a dry-run record.

    FLOPs/bytes use the analytic model (``repro_torch.roofline.flops``);
    the record's counted FLOPs per device are reported alongside.
    Collective bytes come from the record's tally, plus the per-unit
    slope of a correction record where one is attached for the arch
    (``unit_coll_bytes``)."""
    if "skipped" in rec or "error" in rec:
        return dict(rec)
    from ..launch.dryrun import TRAIN_ACCUM
    from .flops import cell_bytes, cell_flops
    chips = rec["n_devices"]
    arch, shape = rec["arch"], rec["shape"]
    accum = rec.get("accum", TRAIN_ACCUM.get(arch, 1))
    flops_total = cell_flops(arch, shape)
    flops_dev = flops_total / chips
    bytes_dev = cell_bytes(arch, shape, chips, accum=accum)
    coll = rec.get("coll_corrected",
                   sum(rec.get("collectives", {}).values()))
    # Depth-extrapolation correction (roofline_correction.json): the
    # per-unit collective slope for train cells.
    corr = _load_corrections().get(arch, {})
    if ("coll_corrected" not in rec and shape == "train_4k" and
            "unit_coll_bytes" in corr):
        coll = coll + corr["unit_coll_bytes"] * (corr["reps_full"] - 1)
    t_compute = flops_dev / hw.peak_flops
    t_memory = bytes_dev / hw.hbm_bw
    t_coll = coll / hw.link_bw
    dominant = max(("compute", t_compute), ("memory", t_memory),
                   ("collective", t_coll), key=lambda kv: kv[1])[0]
    mf = model_flops(arch, shape)
    bound = max(t_compute, t_memory, t_coll)
    # Roofline fraction: ideal useful-work time (MODEL_FLOPS at peak)
    # over the step-time bound.  1.0 = every cycle is useful matmul.
    t_ideal = mf / chips / hw.peak_flops
    return {
        **{k: rec[k] for k in ("arch", "shape", "mesh", "n_devices")},
        "peak_gib": rec["memory"]["peak_bytes"] / 2**30,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "step_time_bound_s": bound,
        "roofline_fraction": min(t_ideal / bound, 1.0) if bound else 0.0,
        "model_flops": mf,
        "hlo_flops_total": flops_total,
        "useful_flops_ratio": mf / max(flops_total, 1.0),
        "raw_cost_flops_dev": rec["cost"]["flops"],
        "raw_coll_bytes_dev": sum(rec.get("collectives", {}).values()),
    }


_CORR: dict | None = None


def _load_corrections() -> dict:
    global _CORR
    if _CORR is None:
        import os
        _CORR = {}
        if os.path.exists("roofline_correction.json"):
            with open("roofline_correction.json") as f:
                _CORR = json.load(f)
    return _CORR


def load_records(path: str) -> list[dict]:
    with open(path) as f:
        return json.load(f)


def analyse(path: str, hw: HW = HW()) -> list[dict]:
    return [roofline_row(r, hw) for r in load_records(path)]
