"""Model assembly for dense GQA architectures: embedding -> block stack
-> head, decode path (the port of the reference's
``repro.models.transformer``).

Parameters are a plain dict: ``final_norm``, ``embed``, optionally
``lm_head``, and ``layers``, one dict per layer in layer order (the
reference's ``prefix`` plus its ``(reps, ...)``-stacked unit leaves,
unstacked; :mod:`repro_torch.interop` converts one into the other).
PyTorch runs eagerly, so the layer loop is a Python loop.

Entry points:

* ``init(cfg, *, seed, device)``                 -> params
* ``init_cache(cfg, batch, max_len, *, device)`` -> cache
* ``decode_step(params, cfg, tok, cache, pos)``  -> logits, cache

Mamba, xLSTM, MoE and MLA layers, the full-sequence ``forward`` and
``prefill`` come with later slices; those configs raise
``NotImplementedError``.
"""

from __future__ import annotations

import math

import torch

from .attention import GQA
from .common import (ModelConfig, act_fn, dense, init_norm, make_dense,
                     norm, normal)

__all__ = ["init", "decode_step", "init_cache", "unit_period",
           "count_params", "check_supported"]


# ---------------------------------------------------------------------------
# Layer plumbing
# ---------------------------------------------------------------------------

def _has_ff(cfg: ModelConfig, i: int) -> bool:
    kind = cfg.layer_kind(i)
    return kind in ("attn", "mamba") and (cfg.d_ff > 0 or cfg.is_moe_layer(i))


def _layer_sig(cfg: ModelConfig, i: int) -> tuple:
    return (cfg.layer_kind(i), cfg.is_moe_layer(i), _has_ff(cfg, i))


def unit_period(cfg: ModelConfig) -> tuple[int, int]:
    """(prefix_len, period): layers [prefix:] repeat with ``period``."""
    n = cfg.n_layers
    prefix = cfg.first_dense_layers
    sigs = [_layer_sig(cfg, i) for i in range(prefix, n)]
    m = len(sigs)
    for p in range(1, m + 1):
        if m % p == 0 and all(sigs[i] == sigs[i % p] for i in range(m)):
            return prefix, p
    return prefix, m


def check_supported(cfg: ModelConfig) -> None:
    """Raise for configs outside this slice: dense GQA only."""
    if cfg.attn_type != "gqa":
        raise NotImplementedError(
            f"{cfg.name}: MLA attention is not ported yet (ROADMAP: "
            "'MoE and MLA: mixtral and deepseek')")
    for i in range(cfg.n_layers):
        if cfg.layer_kind(i) != "attn":
            raise NotImplementedError(
                f"{cfg.name}: {cfg.layer_kind(i)} layers are not ported "
                "yet (ROADMAP: 'The other seven archs')")
        if cfg.is_moe_layer(i):
            raise NotImplementedError(
                f"{cfg.name}: MoE layers are not ported yet (ROADMAP: "
                "'MoE and MLA: mixtral and deepseek')")


def _init_mlp(gen, cfg: ModelConfig, dtype, device) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    s_in = 1.0 / math.sqrt(d)
    s_out = 1.0 / math.sqrt(ff * 2 * cfg.n_layers)
    kw = {"dtype": dtype, "device": device}
    p = {"w_up": make_dense(gen, d, ff, scale=s_in, **kw),
         "w_down": make_dense(gen, ff, d, scale=s_out, **kw)}
    if cfg.act == "swiglu":
        p["w_gate"] = make_dense(gen, d, ff, scale=s_in, **kw)
    return p


def _mlp(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "swiglu":
        h = act_fn("silu")(dense(p["w_gate"], x)) * dense(p["w_up"], x)
    else:
        h = act_fn("gelu")(dense(p["w_up"], x))
    return dense(p["w_down"], h)


def _init_layer(gen, cfg: ModelConfig, i: int, dtype, device) -> dict:
    p = {"norm1": init_norm(cfg.d_model, cfg.norm, device),
         "mixer": GQA.init(gen, cfg, dtype=dtype, device=device)}
    if _has_ff(cfg, i):
        p["norm2"] = init_norm(cfg.d_model, cfg.norm, device)
        p["mlp"] = _init_mlp(gen, cfg, dtype, device)
    return p


# ---------------------------------------------------------------------------
# Model init
# ---------------------------------------------------------------------------

def init(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> dict:
    """Seeded random weights with the reference's shapes and scales.

    The draws come from a CPU ``torch.Generator``, so one seed gives the
    same weights on every device (they are not the reference's
    ``jax.random`` numbers: tests convert the reference's own weights
    with :func:`repro_torch.interop.params_from_numpy`).  Weights are
    stored in the compute dtype, norm parameters in float32."""
    check_supported(cfg)
    gen = torch.Generator().manual_seed(seed)
    dt = cfg.compute_dtype
    kw = {"dtype": dt, "device": device}
    params: dict = {"final_norm": init_norm(cfg.d_model, cfg.norm, device)}
    if cfg.input_mode == "tokens":
        params["embed"] = {"w": normal(gen, (cfg.vocab, cfg.d_model), 0.02,
                                       dt, device)}
    else:  # stub modality frontend: inputs arrive as embeddings
        params["embed"] = {"proj": make_dense(gen, cfg.d_model, cfg.d_model,
                                              **kw)}
    if not cfg.tie_embeddings:
        params["lm_head"] = make_dense(gen, cfg.d_model, cfg.vocab,
                                       scale=1.0 / math.sqrt(cfg.d_model),
                                       **kw)
    params["layers"] = [_init_layer(gen, cfg, i, dt, device)
                        for i in range(cfg.n_layers)]
    return params


def _embed(params: dict, cfg: ModelConfig, batch) -> torch.Tensor:
    dt = cfg.compute_dtype
    if cfg.input_mode == "tokens":
        return params["embed"]["w"].to(dt)[batch]
    return dense(params["embed"]["proj"], batch.to(dt))


def _head(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = norm(params["final_norm"], x, cfg.norm)
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["w"].to(x.dtype).T
    else:
        logits = dense(params["lm_head"], x)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


# ---------------------------------------------------------------------------
# KV-cache init / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, *, device="cuda") -> dict:
    """One ``{"k", "v"}`` cache per layer.  bf16 by default whatever
    ``cfg.dtype`` is, as in the reference."""
    check_supported(cfg)
    return {"layers": [GQA.init_cache(cfg, batch, max_len, dtype,
                                      device=device)
                       for _ in range(cfg.n_layers)]}


def _decode_layer(p: dict, cfg: ModelConfig, i: int, x: torch.Tensor,
                  c: dict, pos: int) -> tuple[torch.Tensor, dict]:
    h = norm(p["norm1"], x, cfg.norm)
    y, c = GQA.decode(p["mixer"], cfg, h, c, pos)
    x = x + y
    if "norm2" in p:
        h = norm(p["norm2"], x, cfg.norm)
        x = x + _mlp(p["mlp"], cfg, h)
    return x, c


def decode_step(params: dict, cfg: ModelConfig, tok: torch.Tensor,
                cache: dict, pos: int) -> tuple[torch.Tensor, dict]:
    """One autoregressive step.  tok: (B,) int tokens or (B, 1, d)
    embeddings; pos: count of tokens already in the cache.  The cache
    is updated in place and returned; logits are (B, vocab)."""
    if cfg.input_mode == "tokens":
        x = _embed(params, cfg, tok[:, None])
    else:
        x = _embed(params, cfg, tok)
    for i, lp in enumerate(params["layers"]):
        x, _ = _decode_layer(lp, cfg, i, x, cache["layers"][i], pos)
    logits = _head(params, cfg, x)
    return logits[:, 0], cache


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def count_params(params: dict) -> int:
    return sum(int(t.numel()) for t in _leaves(params))
