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
"mla"``: deepseek-v2), a Mamba block (jamba) or an mLSTM or sLSTM
block (xlstm), and its feed-forward a dense MLP or an MoE layer
(``cfg.is_moe_layer``), after a prefix of ``cfg.first_dense_layers``
dense layers; xLSTM blocks have none.  ``forward``,
``forward_features`` and ``prefill_logits`` take ``impl``: ``"kernel"``
(the default) attends through the flash-attention op and scans through
the selective-scan op, ``"xla"`` runs the plain twins of the
reference's XLA path instead (the training path's: those kernels have
no backward); MLA and the xLSTM blocks have no kernel branch, as in the
reference, and run their plain code either way.

Tensor parallelism: with a ``tp`` axis bound (:mod:`repro_torch.dist.
context`) the parameters are this rank's ``model`` blocks as
``param_specs`` places them, and the layers run as the reference's
constrained SPMD program does (:mod:`repro_torch.dist.tp`): attention on
this rank's heads, the MLP's hidden features on this rank's block, the
residual stream whole on every rank.  The entry points take ``gather``,
a hook (:func:`repro_torch.dist.sharding.gather_hook`) that turns one
group of blocks (the embedding, a layer, the final norm, the head) into
its data-gathered blocks where it is used: inside a layer's
``torch.utils.checkpoint``, so autograd saves blocks only and the
backward's recompute gathers again.  Mamba and xLSTM mixers run on their
blocks too (:mod:`.ssm`, :mod:`.xlstm`): Mamba on this rank's
``d_inner`` channels, its decode on the state's channel blocks in
place; the xLSTM projections on their blocks, their recurrences whole,
sLSTM's recurrent ``r`` gathered whole a layer call (:func:`whole_keys`)
and the xLSTM states gathered for a decode step.  A Mamba or xLSTM mixer
whose width the ``model`` axis does not divide is gathered whole (its
weights, and its cache for a decode step) and runs its one-device
program on every rank.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from ..dist import context as dctx
from ..dist import tp
from ..dist.sharding import PartitionSpec
from ..pytree import flatten
from .attention import GQA, MLA
from .common import (ModelConfig, act_fn, init_norm, make_dense, normal,
                     rope_tables)
from .moe import MoE
from .ssm import Mamba
from .xlstm import MLSTM, SLSTM

__all__ = ["init", "forward", "forward_features", "head_matrix",
           "prefill_logits", "prefill", "decode_step", "init_cache",
           "unit_period", "count_params", "model_flops"]


# ---------------------------------------------------------------------------
# Layer plumbing
# ---------------------------------------------------------------------------

def _attn_cls(cfg: ModelConfig):
    return MLA if cfg.attn_type == "mla" else GQA


def _mixer(cfg: ModelConfig, i: int):
    """Layer ``i``'s mixer class: the config's attention class, Mamba,
    MLSTM or SLSTM."""
    kind = cfg.layer_kind(i)
    if kind == "attn":
        return _attn_cls(cfg)
    return {"mamba": Mamba, "mlstm": MLSTM, "slstm": SLSTM}[kind]


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


def _mlp(p: dict, cfg: ModelConfig, x: torch.Tensor,
         x_block: bool = False) -> torch.Tensor:
    """Gate and up column-parallel, down row-parallel under tensor
    parallelism: the hidden ``d_ff`` features stay this rank's block."""
    kw = {"shape": (cfg.d_model, cfg.d_ff), "x_block": x_block,
          "keep_block": True}
    if cfg.act == "swiglu":
        g, blk = tp.tp_dense(p["w_gate"], x, **kw)
        h = act_fn("silu")(g) * tp.tp_dense(p["w_up"], x, **kw)[0]
    else:
        u, blk = tp.tp_dense(p["w_up"], x, **kw)
        h = act_fn("gelu")(u)
    y, _ = tp.tp_dense(p["w_down"], h, shape=(cfg.d_ff, cfg.d_model),
                       x_block=blk)
    return y


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


def whole_mixer(cfg: ModelConfig, i: int) -> bool:
    """Whether layer ``i``'s mixer runs whole on every rank: a Mamba or
    xLSTM mixer whose width (``tp_width``) the bound ``model`` axis does
    not divide."""
    m = tp.tp_axis()[0]
    if m == 1 or cfg.layer_kind(i) == "attn":
        return False
    return _mixer(cfg, i).tp_width(cfg) % m != 0


def whole_keys(cfg: ModelConfig, i: int) -> tuple:
    """The keys (or key paths) of layer ``i`` that the gather hook gathers
    whole, over ``model`` too: a mixer that runs whole
    (:func:`whole_mixer`), and sLSTM's recurrent ``r``, which its step
    loop needs for every head."""
    if whole_mixer(cfg, i):
        return ("mixer",)
    return (("mixer", "r"),) if cfg.layer_kind(i) == "slstm" else ()


def _ff(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """The norm2 half of a layer: (its output, MoE's aux terms or None)."""
    h, blk = tp.tp_norm(p["norm2"], x, cfg.norm)
    if "moe" in p:
        return MoE.fwd(p["moe"], cfg, tp.full(h, blk))
    return _mlp(p["mlp"], cfg, h, blk), None


def _apply_layer(p: dict, cfg: ModelConfig, i: int, x: torch.Tensor, cos,
                 sin, impl: str) -> tuple[torch.Tensor, dict]:
    """Full-sequence layer -> (x, aux terms: zero but for MoE layers).
    The reference's also returns a state slot, which it leaves empty."""
    aux = _zero_aux(x.device)
    h, blk = tp.tp_norm(p["norm1"], x, cfg.norm)
    kind = cfg.layer_kind(i)
    # attention takes the rope tables and this rank's feature block; the
    # kernel choice goes to the mixers that have a kernel (xLSTM has none)
    if kind == "attn":
        y = _mixer(cfg, i).fwd(p["mixer"], cfg, h, cos, sin, impl=impl,
                               x_block=blk)
    else:
        kw = {"impl": impl} if kind == "mamba" else {}
        if whole_mixer(cfg, i):
            with tp.off():
                y = _mixer(cfg, i).fwd(p["mixer"], cfg, tp.full(h, blk),
                                       **kw)
        else:
            y = _mixer(cfg, i).fwd(p["mixer"], cfg, h, x_block=blk, **kw)
    x = x + y
    if "norm2" in p:
        y, moe_aux = _ff(p, cfg, x)
        aux = aux if moe_aux is None else moe_aux
        x = x + y
    return x, aux


def _gathered_layer(lp: dict, cfg: ModelConfig, i: int, x: torch.Tensor,
                    cos, sin, impl: str, gather) -> tuple[torch.Tensor, dict]:
    """Layer ``i`` on its blocks ``lp``, gathered by the hook first."""
    if gather is not None:
        lp = gather(lp, ("layers", i), whole=whole_keys(cfg, i))
    return _apply_layer(lp, cfg, i, x, cos, sin, impl)


def _group(params: dict, gather, key: str) -> dict:
    """The parameter group ``key``, through the gather hook if any."""
    return params[key] if gather is None else gather(params[key], (key,))


def _add_aux(a: dict, b: dict) -> dict:
    return {k: a[k] + b[k] for k in a}


# ---------------------------------------------------------------------------
# Model init / forward
# ---------------------------------------------------------------------------

def init(cfg: ModelConfig, *, seed: int = 0, device="cuda",
         draw_device="cpu", param_dtype: torch.dtype | None = None) -> dict:
    """Seeded random weights with the reference's shapes and scales.

    The draws come from a ``torch.Generator`` on ``draw_device``: the
    CPU's by default, so one seed gives the same weights on every device
    (they are not the reference's ``jax.random`` numbers: tests convert
    the reference's own weights with
    :func:`repro_torch.interop.params_from_numpy`); ``"cuda"`` draws a
    full-width model on the card in seconds, with other numbers.
    Weights are stored in ``param_dtype``, by default the compute dtype
    (serving's choice); norm parameters, the MoE router, Mamba's
    ``a_log``, ``conv_*``, ``dt_bias`` and ``d_skip`` and xLSTM's
    ``ln_scale`` and ``r`` in float32, as the reference keeps them.
    Training passes ``param_dtype=torch.float32``: the reference's
    parameters are all f32 (master weights), and its train step casts
    them to bf16 for the matrix products."""
    gen = torch.Generator(device=draw_device).manual_seed(seed)
    dt = param_dtype or cfg.compute_dtype
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


def _embed(embed: dict, cfg: ModelConfig, batch) -> torch.Tensor:
    """The embedding group's rows of ``batch`` (its token lookup, or the
    stub frontend's projection), whole on every rank."""
    dt = cfg.compute_dtype
    if cfg.input_mode == "tokens":
        return tp.tp_embed(embed["w"], batch, (cfg.vocab, cfg.d_model), dt)
    d = cfg.d_model
    return tp.tp_dense(embed["proj"], batch.to(dt), shape=(d, d))[0]


def head_spec(cfg: ModelConfig) -> PartitionSpec:
    """The ``model`` placement of :func:`head_matrix` (d, vocab) on the
    bound mesh: the embedding's, transposed, where the two are tied."""
    if cfg.tie_embeddings:
        return PartitionSpec(*reversed(tp.weight_spec((cfg.vocab,
                                                       cfg.d_model))))
    return tp.weight_spec((cfg.d_model, cfg.vocab))


def head_params(params: dict, cfg: ModelConfig, gather=None) -> dict:
    """The groups the head reads (the final norm, and the embedding or
    the LM head), through the gather hook if any."""
    return {k: _group(params, gather, k) for k in
            ("final_norm", "embed" if cfg.tie_embeddings else "lm_head")}


def _head(params: dict, cfg: ModelConfig, x: torch.Tensor,
          gather=None) -> torch.Tensor:
    hp = head_params(params, cfg, gather)
    x, blk = tp.tp_norm(hp["final_norm"], x, cfg.norm)
    w = {"w": head_matrix(hp, cfg)}
    if not cfg.tie_embeddings and "b" in hp["lm_head"]:
        w["b"] = hp["lm_head"]["b"]
    logits, _ = tp.tp_dense(w, x, head_spec(cfg), x_block=blk)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _rope_for(cfg: ModelConfig, positions: torch.Tensor):
    dim = cfg.qk_rope_head_dim if cfg.attn_type == "mla" else cfg.head_dim
    return rope_tables(positions, dim, cfg.rope_theta)


def _stack(params: dict, cfg: ModelConfig, batch, impl: str,
           remat: bool, gather=None) -> tuple[torch.Tensor, dict]:
    """Embedding and every layer: the hidden states before the final
    norm, and the aux terms summed over the layers in the reference's
    order (prefix layers one by one; then each unit's layers, and the
    units' sums over the repetitions).  With ``remat`` and autograd
    recording, each layer runs under ``torch.utils.checkpoint`` (its
    activations are recomputed in the backward pass, as the reference's
    ``jax.checkpoint`` over its layer units does), the gather hook
    inside it."""
    x = _embed(_group(params, gather, "embed"), cfg, batch)
    cos, sin = _rope_for(cfg, torch.arange(x.shape[1], device=x.device))
    prefix, period = unit_period(cfg)
    aux_tot = _zero_aux(x.device)
    units = []
    remat = remat and torch.is_grad_enabled()
    layer = dctx.with_axes(_gathered_layer)
    for i, lp in enumerate(params["layers"]):
        if remat:
            x, aux = checkpoint(layer, lp, cfg, i, x, cos, sin, impl,
                                gather, use_reentrant=False)
        else:
            x, aux = _gathered_layer(lp, cfg, i, x, cos, sin, impl, gather)
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
            impl: str = "kernel", gather=None) -> tuple[torch.Tensor, dict]:
    """Training/eval forward.  batch: (B, S) int tokens or (B, S, d)
    embeddings -> logits (B, S, vocab) and the aux terms (MoE's
    load-balance, z and drop fraction, summed over the layers).

    ``remat`` recomputes each layer's activations in the backward pass
    (``torch.utils.checkpoint``); it changes nothing where autograd does
    not record.  ``gather``: the per-layer gather hook (module
    docstring)."""
    x, aux = _stack(params, cfg, batch, impl, remat, gather)
    return _head(params, cfg, x, gather), aux


def forward_features(params: dict, cfg: ModelConfig, batch, *,
                     remat: bool = True, impl: str = "kernel",
                     unroll: bool = False, gather=None
                     ) -> tuple[torch.Tensor, dict]:
    """Like :func:`forward` but stops before the LM head, returning the
    final-norm hidden states (B, S, d), so that a loss head can run
    chunked.  ``remat`` and ``gather`` as in :func:`forward`; ``unroll``
    is accepted for the reference's signature and has no effect: the
    layer loop is always a Python loop."""
    del unroll
    x, aux = _stack(params, cfg, batch, impl, remat, gather)
    fn = _group(params, gather, "final_norm")
    return tp.full(*tp.tp_norm(fn, x, cfg.norm)), aux


def head_matrix(params: dict, cfg: ModelConfig) -> torch.Tensor:
    """(d, vocab) projection used by the chunked loss."""
    if cfg.tie_embeddings:
        return params["embed"]["w"].T
    return params["lm_head"]["w"]


def prefill_logits(params: dict, cfg: ModelConfig, batch, *,
                   impl: str = "kernel", gather=None) -> torch.Tensor:
    """Serving prefill: run the prompt through the stack and return the
    LAST position's logits only, (B, vocab); the (B, S, vocab) logits
    never exist.  ``gather`` as in :func:`forward`."""
    x, _ = forward_features(params, cfg, batch, remat=False, impl=impl,
                            gather=gather)
    last = x[:, -1, :]                      # features are already normed
    hp = head_params(params, cfg, gather)
    w = {"w": head_matrix(hp, cfg)}
    if not cfg.tie_embeddings and "b" in hp["lm_head"]:
        w["b"] = hp["lm_head"]["b"]
    return tp.tp_dense(w, last, head_spec(cfg))[0]


# ---------------------------------------------------------------------------
# KV-cache init / prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, *, device="cuda") -> dict:
    """One cache per layer, by kind: ``{"k", "v"}`` for GQA attention,
    ``{"c_kv", "k_rope"}`` for MLA, ``{"conv", "ssm"}`` for Mamba.
    ``{"C", "n", "m"}`` for mLSTM and ``{"c", "n", "h", "m"}`` for sLSTM.
    bf16 by default whatever ``cfg.dtype`` is, as in the reference
    (Mamba's ssm state and the xLSTM states are f32)."""
    return {"layers": [_mixer(cfg, i).init_cache(
        cfg, batch, max_len, dtype, device=device)
        for i in range(cfg.n_layers)]}


def _decode_whole_cache(mixer, p: dict, cfg: ModelConfig, h: torch.Tensor,
                        c: dict, pos: int, cspec) -> tuple[torch.Tensor, dict]:
    """A mixer that runs whole (:func:`whole_mixer`) on its cache's
    blocks: the ``model``-split dims gathered for the step, the updated
    state cut back into the blocks in place."""
    have = tp.cache_dims(c, cspec)
    want = dict.fromkeys(c)
    whole = tp.cache_as(c, have, want)
    with tp.off():
        y, whole = mixer.decode(p, cfg, h, whole, pos)
    tp.cache_put(c, whole, have, want)
    return y, c


def _decode_layer(p: dict, cfg: ModelConfig, i: int, x: torch.Tensor,
                  c: dict, pos: int, cspec=None) -> tuple[torch.Tensor, dict]:
    h, blk = tp.tp_norm(p["norm1"], x, cfg.norm)
    if whole_mixer(cfg, i):
        y, c = _decode_whole_cache(_mixer(cfg, i), p["mixer"], cfg,
                                   tp.full(h, blk), c, pos, cspec)
    else:
        y, c = _mixer(cfg, i).decode(p["mixer"], cfg, h, c, pos,
                                     x_block=blk, cspec=cspec)
    x = x + y
    if "norm2" in p:
        x = x + _ff(p, cfg, x)[0]
    return x, c


def decode_step(params: dict, cfg: ModelConfig, tok: torch.Tensor,
                cache: dict, pos: int, *, unroll: bool = False,
                gather=None, cache_specs=None) -> tuple[torch.Tensor, dict]:
    """One autoregressive step.  tok: (B,) int tokens or (B, 1, d)
    embeddings; pos: count of tokens already in the cache.  The cache
    is updated in place and returned; logits are (B, vocab).
    ``unroll`` is accepted for the reference's signature and has no
    effect: the layer loop is always a Python loop.  ``gather`` as in
    :func:`forward`; ``cache_specs`` (``cache_specs(cache, mesh)``'s tree)
    places the cache's blocks where ``cache`` holds this rank's."""
    del unroll
    embed = _group(params, gather, "embed")
    if cfg.input_mode == "tokens":
        x = _embed(embed, cfg, tok[:, None])
    else:
        x = _embed(embed, cfg, tok)
    for i, lp in enumerate(params["layers"]):
        if gather is not None:
            lp = gather(lp, ("layers", i), whole=whole_keys(cfg, i))
        cs = cache_specs["layers"][i] if cache_specs is not None else None
        x, _ = _decode_layer(lp, cfg, i, x, cache["layers"][i], pos, cs)
    logits = _head(params, cfg, x, gather)
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


def model_flops(cfg: ModelConfig, n_params_active: int,
                n_tokens: int) -> float:
    """MODEL_FLOPS = 6 * N_active * D (the roofline 'useful work' term)."""
    return 6.0 * n_params_active * n_tokens


def count_params(params: dict) -> int:
    return sum(int(t.numel()) for _, t in flatten(params))
