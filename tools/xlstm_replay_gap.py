#!/usr/bin/env python3
"""How far xlstm-125m's f32 forward sits from its decode replay, in the
JAX reference and in the port's plain path, relative to the largest
logit: the figures behind ``chip_smoke.py`` §20's bound.

    PYTHONPATH=src python tools/xlstm_replay_gap.py
        [--out build/xlstm_replay_gap.json]

For each weight seed w (0, 1) and prompt seed p (0-7): the reference's
weights at full width in f32 (``repro.models.transformer.init(
PRNGKey(w))``), a 64-token prompt drawn uniformly over the vocabulary
from ``numpy.random.default_rng(p)``, and the forward's logits (the
chunkwise mLSTM) against a decode replay of the prompt into an f32 cache
(its recurrence).  The gap is max |forward - replay| / max |forward|, as
the reference's own
``tests/test_model_properties.py::test_decode_matches_forward`` holds
them.  The port's plain path (``repro_torch``, on the CPU) runs the same
weights and prompts.  Prints each pair's gaps and largest logit, the
worst reference gap, the bound (``MULTIPLE`` times it) and, for each
pair, the positions whose top-two logit margin is at most twice the
bound (the argmax check skips them).  CPU only; ~1 min a weight seed
and ~20 s a prompt.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

ARCH = "xlstm-125m"
S = 64
WEIGHT_SEEDS = 2
PROMPT_SEEDS = 8
#: ``chip_smoke.py``'s ``XLSTM_REPLAY_MULTIPLE``
MULTIPLE = 1.5


def _gap(full: np.ndarray, dec: np.ndarray) -> tuple[float, float]:
    scale = float(np.abs(full).max())
    return float(np.abs(full - dec).max()) / scale, scale


def _margins(full: np.ndarray) -> np.ndarray:
    """Each position's top-two logit margin over the largest |logit|."""
    top2 = np.sort(full.reshape(-1, full.shape[-1]), axis=-1)[:, -2:]
    return (top2[:, 1] - top2[:, 0]) / float(np.abs(full).max())


class Reference:
    """The JAX reference's weights from ``PRNGKey(seed)``, its forward
    and its decode replay, jitted once."""

    def __init__(self, seed: int):
        import jax

        import repro.configs as ref_configs
        from repro.models import transformer as RT

        cfg = ref_configs.get_config(ARCH, "full").replace(dtype="float32")
        self.cfg, self.RT = cfg, RT
        self.params = jax.jit(lambda k: RT.init(k, cfg))(
            jax.random.PRNGKey(seed))
        self.fwd = jax.jit(lambda p, t: RT.forward(p, cfg, t)[0])
        self.step = jax.jit(lambda p, t, c, s: RT.decode_step(p, cfg, t, c,
                                                              s))

    def run(self, toks: np.ndarray):
        import jax.numpy as jnp

        full = self.fwd(self.params, jnp.asarray(toks))
        cache = self.RT.init_cache(self.cfg, 1, S, dtype=jnp.float32)
        rows = []
        for pos in range(S):
            lg, cache = self.step(self.params, jnp.asarray(toks[:, pos]),
                                  cache, pos)
            rows.append(np.asarray(lg))
        return np.asarray(full, np.float32), np.stack(rows, axis=1)


class Port:
    """The port's plain path on the CPU, on the reference's weights."""

    def __init__(self, ref: Reference):
        import jax

        import repro_torch.configs as pt_configs
        from repro_torch import interop
        from repro_torch.models import transformer as PT

        self.cfg = pt_configs.get_config(ARCH, "full").replace(
            dtype="float32")
        self.PT = PT
        self.params = interop.params_from_numpy(
            jax.tree.map(np.asarray, ref.params), self.cfg, device="cpu")

    def run(self, toks: np.ndarray):
        import torch

        prompt = torch.from_numpy(toks.astype(np.int64))
        with torch.inference_mode():
            full, _ = self.PT.forward(self.params, self.cfg, prompt)
            cache = self.PT.init_cache(self.cfg, 1, S, dtype=torch.float32,
                                       device="cpu")
            rows = []
            for pos in range(S):
                lg, cache = self.PT.decode_step(self.params, self.cfg,
                                                prompt[:, pos], cache, pos)
                rows.append(lg)
        return full.numpy(), torch.stack(rows, dim=1).numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    rows = []
    for w in range(WEIGHT_SEEDS):
        ref = Reference(w)
        port = Port(ref)
        for seed in range(PROMPT_SEEDS):
            toks = np.random.default_rng(seed).integers(0, ref.cfg.vocab,
                                                        (1, S))
            full, dec = ref.run(toks)
            ref_gap, scale = _gap(full, dec)
            p_full, p_dec = port.run(toks)
            port_gap, p_scale = _gap(p_full, p_dec)
            rows.append({"weights": w, "prompt": seed,
                         "reference_gap": ref_gap,
                         "reference_max_abs_logit": scale,
                         "reference_max_abs_diff": ref_gap * scale,
                         "port_gap": port_gap, "port_max_abs_logit": p_scale,
                         "margins": _margins(full),
                         "port_margins": _margins(p_full)})
            print(f"weights {w} prompt {seed}: reference {ref_gap:.4e} of "
                  f"max |logit| {scale:.4f} ({ref_gap * scale:.4e} "
                  f"absolute); port plain {port_gap:.4e} of {p_scale:.4f}",
                  flush=True)
        del ref, port
    worst = max(r["reference_gap"] for r in rows)
    bound = MULTIPLE * worst
    for r in rows:
        for side in ("", "port_"):
            m = np.sort(r.pop(side + "margins"))
            r[side + "skipped"] = int((m <= 2 * bound).sum())
            r[side + "smallest_margins"] = m[:8].tolist()
    print(f"worst reference gap {worst:.4e} over {len(rows)} prompts; bound "
          f"{MULTIPLE:g} x it = {bound:.4e}; port plain worst "
          f"{max(r['port_gap'] for r in rows):.4e}")
    print("positions of 64 whose top-two margin is within twice the bound "
          f"(reference / port plain): "
          f"{[(r['skipped'], r['port_skipped']) for r in rows]}")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(
            {"arch": ARCH, "S": S, "dtype": "float32",
             "worst_reference_gap": worst, "multiple": MULTIPLE,
             "bound": bound, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
