"""Model assembly: embedding -> patterned block stack -> head (the port
of the reference's ``repro.models.transformer``).

Parameters are a plain dict: ``final_norm``, ``embed``, optionally
``lm_head``, and ``layers``, one dict per layer in layer order (the
reference's ``prefix`` plus its ``(reps, ...)``-stacked unit leaves,
unstacked; :mod:`repro_torch.interop` converts one into the other).
PyTorch runs eagerly, so the layer loop is a Python loop.

Entry points:

* ``init(cfg, *, seed, device)``                   -> params
* ``forward(params, cfg, batch)``                  -> logits, aux
* ``forward_features(params, cfg, batch)``         -> features, aux
* ``prefill_logits(params, cfg, batch)``           -> last logits
* ``prefill(params, cfg, batch, max_len)``         -> last logits, cache
* ``init_cache(cfg, batch, max_len, *, device)``   -> cache
* ``decode_step(params, cfg, tok, cache, pos)``    -> logits, cache

A layer's mixer is attention (GQA, or MLA where ``cfg.attn_type ==
"mla"``: deepseek-v2) or a Mamba block (jamba), and its feed-forward a
dense MLP or an MoE layer (``cfg.is_moe_layer``), after a prefix of
``cfg.first_dense_layers`` dense layers.  ``forward``,
``forward_features`` and ``prefill_logits`` take ``impl``: ``"kernel"``
(the default) attends through the flash-attention op and scans through
the selective-scan op, ``"xla"`` runs the plain twins of the
reference's XLA path instead; MLA has no kernel branch, as in the
reference, and runs its plain twins either way.  xLSTM layers come with
a later slice; those configs raise ``NotImplementedError``.
"""

from __future__ import annotations

import math

import torch

from .attention import GQA, MLA
from .common import (ModelConfig, act_fn, dense, init_norm, make_dense,
                     norm, normal, rope_tables)
from .moe import MoE
from .ssm import Mamba

__all__ = ["init", "forward", "forward_features", "head_matrix",
           "prefill_logits", "prefill", "decode_step", "init_cache",
           "unit_period", "count_params", "model_flops", "check_supported"]


# ---------------------------------------------------------------------------
# Layer plumbing
# ---------------------------------------------------------------------------

def _attn_cls(cfg: ModelConfig):
    return MLA if cfg.attn_type == "mla" else GQA


def _mixer(cfg: ModelConfig, i: int):
    """Layer ``i``'s mixer class: the config's attention class or
    Mamba."""
    return _attn_cls(cfg) if cfg.layer_kind(i) == "attn" else Mamba


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
    """Raise for configs outside the ported slices: xLSTM layers."""
    for i in range(cfg.n_layers):
        if cfg.layer_kind(i) not in ("attn", "mamba"):
            raise NotImplementedError(
                f"{cfg.name}: {cfg.layer_kind(i)} layers are not ported "
                "yet (ROADMAP: 'xLSTM, and checks for the other archs')")


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
         "mixer": _mixer(cfg, i).init(gen, cfg, dtype=dtype, device=device)}
    if _has_ff(cfg, i):
        p["norm2"] = init_norm(cfg.d_model, cfg.norm, device)
        if cfg.is_moe_layer(i):
            p["moe"] = MoE.init(gen, cfg, dtype=dtype, device=device)
        else:
            p["mlp"] = _init_mlp(gen, cfg, dtype, device)
    return p


def _zero_aux(device) -> dict:
    return {name: torch.zeros((), dtype=torch.float32, device=device)
            for name in ("moe_lb_loss", "moe_z_loss", "moe_drop_frac")}


def _apply_layer(p: dict, cfg: ModelConfig, i: int, x: torch.Tensor, cos,
                 sin, impl: str) -> tuple[torch.Tensor, dict]:
    """Full-sequence layer -> (x, aux terms: zero but for MoE layers).
    The reference's also returns a state slot, which it leaves empty."""
    aux = _zero_aux(x.device)
    h = norm(p["norm1"], x, cfg.norm)
    if cfg.layer_kind(i) == "attn":
        y = _attn_cls(cfg).fwd(p["mixer"], cfg, h, cos, sin, impl=impl)
    else:
        y = Mamba.fwd(p["mixer"], cfg, h, impl=impl)
    x = x + y
    if "norm2" in p:
        h = norm(p["norm2"], x, cfg.norm)
        if "moe" in p:
            y, aux = MoE.fwd(p["moe"], cfg, h)
        else:
            y = _mlp(p["mlp"], cfg, h)
        x = x + y
    return x, aux


def _add_aux(a: dict, b: dict) -> dict:
    return {k: a[k] + b[k] for k in a}


# ---------------------------------------------------------------------------
# Model init / forward
# ---------------------------------------------------------------------------

def init(cfg: ModelConfig, *, seed: int = 0, device="cuda",
         draw_device="cpu") -> dict:
    """Seeded random weights with the reference's shapes and scales.

    The draws come from a ``torch.Generator`` on ``draw_device``: the
    CPU's by default, so one seed gives the same weights on every device
    (they are not the reference's ``jax.random`` numbers: tests convert
    the reference's own weights with
    :func:`repro_torch.interop.params_from_numpy`); ``"cuda"`` draws a
    full-width model on the card in seconds, with other numbers.
    Weights are stored in the compute dtype; norm parameters, the MoE
    router and Mamba's ``a_log``, ``conv_*``, ``dt_bias`` and ``d_skip``
    in float32, as the reference keeps them."""
    check_supported(cfg)
    gen = torch.Generator(device=draw_device).manual_seed(seed)
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


def _rope_for(cfg: ModelConfig, positions: torch.Tensor):
    dim = cfg.qk_rope_head_dim if cfg.attn_type == "mla" else cfg.head_dim
    return rope_tables(positions, dim, cfg.rope_theta)


def _stack(params: dict, cfg: ModelConfig, batch,
           impl: str) -> tuple[torch.Tensor, dict]:
    """Embedding and every layer: the hidden states before the final
    norm, and the aux terms summed over the layers in the reference's
    order (prefix layers one by one; then each unit's layers, and the
    units' sums over the repetitions)."""
    check_supported(cfg)
    x = _embed(params, cfg, batch)
    cos, sin = _rope_for(cfg, torch.arange(x.shape[1], device=x.device))
    prefix, period = unit_period(cfg)
    aux_tot = _zero_aux(x.device)
    units = []
    for i, lp in enumerate(params["layers"]):
        x, aux = _apply_layer(lp, cfg, i, x, cos, sin, impl)
        if i < prefix:
            aux_tot = _add_aux(aux_tot, aux)
            continue
        if (i - prefix) % period == 0:
            units.append(_zero_aux(x.device))
        units[-1] = _add_aux(units[-1], aux)
    if units:
        aux_tot = {k: aux_tot[k] + torch.stack([u[k] for u in units]).sum()
                   for k in aux_tot}
    return x, aux_tot


def forward(params: dict, cfg: ModelConfig, batch, *, remat: bool = True,
            impl: str = "kernel") -> tuple[torch.Tensor, dict]:
    """Training/eval forward.  batch: (B, S) int tokens or (B, S, d)
    embeddings -> logits (B, S, vocab) and the aux terms (MoE's
    load-balance, z and drop fraction, summed over the layers).

    ``remat`` is accepted for the reference's signature and has no
    effect: eager inference keeps no activations for a backward pass
    (training, ROADMAP item 12, gives it a meaning)."""
    del remat
    x, aux = _stack(params, cfg, batch, impl)
    return _head(params, cfg, x), aux


def forward_features(params: dict, cfg: ModelConfig, batch, *,
                     remat: bool = True, impl: str = "kernel",
                     unroll: bool = False) -> tuple[torch.Tensor, dict]:
    """Like :func:`forward` but stops before the LM head, returning the
    final-norm hidden states (B, S, d), so that a loss head can run
    chunked.  ``remat`` and ``unroll`` are accepted for the reference's
    signature and have no effect: the layer loop is always a Python
    loop, and eager inference keeps no activations for a backward pass
    (training, ROADMAP item 12, gives ``remat`` a meaning)."""
    del remat, unroll
    x, aux = _stack(params, cfg, batch, impl)
    return norm(params["final_norm"], x, cfg.norm), aux


def head_matrix(params: dict, cfg: ModelConfig) -> torch.Tensor:
    """(d, vocab) projection used by the chunked loss."""
    if cfg.tie_embeddings:
        return params["embed"]["w"].T
    return params["lm_head"]["w"]


def prefill_logits(params: dict, cfg: ModelConfig, batch, *,
                   impl: str = "kernel") -> torch.Tensor:
    """Serving prefill: run the prompt through the stack and return the
    LAST position's logits only, (B, vocab); the (B, S, vocab) logits
    never exist."""
    x, _ = forward_features(params, cfg, batch, remat=False, impl=impl)
    last = x[:, -1, :]                      # features are already normed
    logits = last @ head_matrix(params, cfg).to(last.dtype)
    if not cfg.tie_embeddings and "b" in params.get("lm_head", {}):
        logits = logits + params["lm_head"]["b"].to(logits.dtype)
    return logits


# ---------------------------------------------------------------------------
# KV-cache init / prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, *, device="cuda") -> dict:
    """One cache per layer, by kind: ``{"k", "v"}`` for GQA attention,
    ``{"c_kv", "k_rope"}`` for MLA, ``{"conv", "ssm"}`` for Mamba.
    bf16 by default whatever ``cfg.dtype`` is, as in the reference
    (Mamba's ssm state is f32)."""
    check_supported(cfg)
    return {"layers": [_mixer(cfg, i).init_cache(
        cfg, batch, max_len, dtype, device=device)
        for i in range(cfg.n_layers)]}


def _decode_layer(p: dict, cfg: ModelConfig, i: int, x: torch.Tensor,
                  c: dict, pos: int) -> tuple[torch.Tensor, dict]:
    h = norm(p["norm1"], x, cfg.norm)
    y, c = _mixer(cfg, i).decode(p["mixer"], cfg, h, c, pos)
    x = x + y
    if "norm2" in p:
        h = norm(p["norm2"], x, cfg.norm)
        if "moe" in p:
            y, _ = MoE.fwd(p["moe"], cfg, h)
        else:
            y = _mlp(p["mlp"], cfg, h)
        x = x + y
    return x, c


def decode_step(params: dict, cfg: ModelConfig, tok: torch.Tensor,
                cache: dict, pos: int, *,
                unroll: bool = False) -> tuple[torch.Tensor, dict]:
    """One autoregressive step.  tok: (B,) int tokens or (B, 1, d)
    embeddings; pos: count of tokens already in the cache.  The cache
    is updated in place and returned; logits are (B, vocab).
    ``unroll`` is accepted for the reference's signature and has no
    effect: the layer loop is always a Python loop."""
    del unroll
    if cfg.input_mode == "tokens":
        x = _embed(params, cfg, tok[:, None])
    else:
        x = _embed(params, cfg, tok)
    for i, lp in enumerate(params["layers"]):
        x, _ = _decode_layer(lp, cfg, i, x, cache["layers"][i], pos)
    logits = _head(params, cfg, x)
    return logits[:, 0], cache


def prefill(params: dict, cfg: ModelConfig, batch, max_len: int, *,
            impl: str = "xla") -> tuple[torch.Tensor, dict]:
    """Run the prompt through the model, returning (last-token logits,
    cache filled for positions [0, S)).  As in the reference, the prompt
    is replayed through :func:`decode_step` one position at a time into
    a fresh bf16 cache, so it runs no full-sequence attention; ``impl``
    is accepted and ignored, as the reference ignores it."""
    del impl
    B, S = batch.shape[:2]
    cache = init_cache(cfg, B, max_len, device=batch.device)
    for s in range(S):
        tok = batch[:, s]
        if cfg.input_mode != "tokens":
            tok = tok[:, None]
        logits, cache = decode_step(params, cfg, tok, cache, s)
    return logits, cache


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def model_flops(cfg: ModelConfig, n_params_active: int,
                n_tokens: int) -> float:
    """MODEL_FLOPS = 6 * N_active * D (the roofline 'useful work' term)."""
    return 6.0 * n_params_active * n_tokens


def count_params(params: dict) -> int:
    return sum(int(t.numel()) for t in _leaves(params))
