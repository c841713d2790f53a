"""``tests/test_archs_smoke.py``'s checks on the port for all ten archs
at their smoke configs (bf16): one forward, one train step and, for the
causal archs, two decode steps on the CPU, with shapes and finiteness
asserted; the train step is the reference test's (f32 parameters, bf16
compute, the plain path differentiated by autograd)."""

import numpy as np
import pytest
import torch

from repro_torch.configs import arch_names, get_config
from repro_torch.models import transformer as T
from repro_torch.pytree import flatten, unflatten
from torch_threads import one_torch_thread  # noqa: F401


def _batch_for(cfg, seed, B=2, S=16):
    g = torch.Generator().manual_seed(seed)
    if cfg.input_mode == "tokens":
        return torch.randint(0, cfg.vocab, (B, S), generator=g)
    return torch.randn((B, S, cfg.d_model), generator=g)


@pytest.mark.parametrize("arch", arch_names())
def test_smoke_forward(arch):
    cfg = get_config(arch, "smoke")
    params = T.init(cfg, seed=0, device="cpu")
    batch = _batch_for(cfg, 0)
    with torch.inference_mode():
        logits, aux = T.forward(params, cfg, batch)
    assert logits.shape == (2, 16, cfg.vocab)
    assert torch.isfinite(logits.float()).all(), f"{arch}: non-finite logits"
    for k, v in aux.items():
        assert torch.isfinite(v), f"{arch}: non-finite aux {k}"


@pytest.mark.parametrize("arch", arch_names())
def test_smoke_train_step(arch):
    cfg = get_config(arch, "smoke")
    params = T.init(cfg, seed=1, device="cpu", param_dtype=torch.float32)
    batch = _batch_for(cfg, 1)
    if cfg.input_mode == "tokens":
        labels = torch.roll(batch, -1, dims=1)
    else:
        labels = torch.randint(0, cfg.vocab, batch.shape[:2],
                               generator=torch.Generator().manual_seed(1))

    def loss_fn(p):
        logits, aux = T.forward(p, cfg, batch, impl="xla")
        lp = torch.log_softmax(logits.float(), dim=-1)
        loss = -lp.gather(-1, labels[..., None]).mean()
        return loss + 0.01 * aux["moe_lb_loss"] + 1e-3 * aux["moe_z_loss"]

    leaves = [t.requires_grad_() for _, t in flatten(params)]
    loss = loss_fn(unflatten(params, leaves))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert torch.isfinite(loss), f"{arch}: non-finite loss"
    assert all(g is None or torch.isfinite(g).all() for g in grads), \
        f"{arch}: NaN grads"
    assert sum(g is not None and bool(g.abs().sum() > 0) for g in grads) > \
        len(grads) // 2, f"{arch}: most gradients are zero"
    # One SGD step changes the loss (sanity that grads are non-trivial).
    with torch.no_grad():
        new = [p - 1e-2 * (g if g is not None else 0)
               for p, g in zip(leaves, grads)]
        loss2 = loss_fn(unflatten(params, new))
    assert torch.isfinite(loss2) and float(loss2) != float(loss.detach())


@pytest.mark.parametrize("arch", [a for a in arch_names()
                                  if get_config(a, "smoke").causal])
def test_smoke_decode(arch):
    cfg = get_config(arch, "smoke")
    params = T.init(cfg, seed=2, device="cpu")
    B = 2
    cache = T.init_cache(cfg, B, 8, device="cpu")
    if cfg.input_mode == "tokens":
        tok = torch.zeros((B,), dtype=torch.long)
    else:
        tok = torch.zeros((B, 1, cfg.d_model))
    with torch.inference_mode():
        logits, cache = T.decode_step(params, cfg, tok, cache, 0)
        assert logits.shape == (B, cfg.vocab)
        assert torch.isfinite(logits.float()).all()
        logits, cache = T.decode_step(params, cfg, tok, cache, 1)
    assert torch.isfinite(logits.float()).all()


_CONFIG_MODULES = ["deepseek_v2_236b", "hubert_xlarge", "internlm2_20b",
                   "jamba_v0_1_52b", "mistral_nemo_12b", "mixtral_8x7b",
                   "pixtral_12b", "qwen1_5_0_5b", "starcoder2_7b",
                   "xlstm_125m"]


@pytest.mark.parametrize("module", _CONFIG_MODULES)
def test_config_module(module):
    """``repro_torch.configs.<arch>``: ``full()``, ``smoke()`` and
    ``config = full`` over ``get_config``, for each of the reference's
    ten config modules."""
    import importlib
    import pathlib
    mod = importlib.import_module(f"repro_torch.configs.{module}")
    arch = mod.full().name
    assert arch in arch_names()
    assert mod.full() == get_config(arch, "full")
    assert mod.smoke() == get_config(arch, "smoke")
    assert mod.config is mod.full
    ref = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro" / \
        "configs"
    assert sorted(p.stem for p in ref.glob("*.py")
                  if p.stem not in ("__init__", "archs", "shapes")) == \
        _CONFIG_MODULES
