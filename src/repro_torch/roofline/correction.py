"""Two-point depth extrapolation: validate the analytic cost model
against the FLOPs the port's own program performs (the port of the
reference's ``repro.roofline.correction``).

For a cell, run the same full-width ``meta`` program as the dry run
(:func:`repro_torch.launch.dryrun.run_cell`: train cells the sharded
step with remat, prefill cells ``prefill_logits``) at depths
``prefix + 1*period`` and ``prefix + 2*period`` layers
(``T.unit_period``; accum 1) under ``torch.utils.flop_counter`` and the
collective tally.  The difference of any additive metric between the
two runs is one layer-unit's cost:

    unit_X  = X(2 units) - X(1 unit)

``validate_flops`` compares the unit's FLOPs with the analytic model of
:mod:`repro_torch.roofline.flops`.  The reference needs the extrapolation
because XLA's cost analysis counts a loop body once; the FLOP counter
sees every layer, so here it isolates one unit.  By default the program
runs on a 1 x 1 mesh description, one device holding the whole cell, so
the count is the cell's whole work: on the production mesh rank 0's
program replicates attention over ``model`` and holds a part of the
experts, and no single factor turns its count into the cell's.  The
ratio need not be 1: the plain attention computes every (query, key)
pair that the analytic causal term halves, and the counter sees only
matrix products (no softmax, norm or elementwise work).

  PYTHONPATH=src python -m repro_torch.roofline.correction --arch qwen1.5-0.5b
"""

from __future__ import annotations

import argparse
import sys

from ..configs import SHAPES, get_config
from ..dist.context import MeshSpec
from ..launch.dryrun import run_cell
from ..models.transformer import unit_period
from .flops import _attn_core_ctx, layer_fwd_flops_per_token

__all__ = ["measure_depths", "validate_flops", "main"]


def measure_depths(arch: str, shape_name: str, mesh=None) -> dict:
    """Run depth-1 and depth-2 variants on ``meta``; return per-unit
    metrics.  ``mesh``: a mesh description, by default 1 x 1."""
    mesh = MeshSpec(("data", "model"), (1, 1)) if mesh is None else mesh
    cfg_full = get_config(arch, "full")
    spec = SHAPES[shape_name]
    prefix, period = unit_period(cfg_full)
    out = {}
    for k in (1, 2):
        flops, coll, _ = run_cell(
            cfg_full.replace(n_layers=prefix + k * period), spec, mesh)
        out[k] = {"flops": flops, "coll": float(sum(coll.values()))}
    reps_full = (cfg_full.n_layers - prefix) // period
    unit = {m: out[2][m] - out[1][m] for m in ("flops", "coll")}
    return {"arch": arch, "shape": shape_name, "prefix": prefix,
            "period": period, "reps_full": reps_full,
            "n_devices": mesh.size(),
            "depth1": out[1], "depth2": out[2], "unit": unit}


def validate_flops(arch: str, shape_name: str, mesh=None) -> dict:
    """Measured per-unit FLOPs (times the devices) against the analytic
    model; ``ratio`` = measured / analytic."""
    m = measure_depths(arch, shape_name, mesh)
    cfg = get_config(arch, "full")
    spec = SHAPES[shape_name]
    ctx = _attn_core_ctx(cfg, spec)
    per_tok = sum(layer_fwd_flops_per_token(cfg, cfg.first_dense_layers + u,
                                            ctx)
                  for u in range(m["period"]))
    tokens = spec.global_batch * spec.seq_len
    mult = 4.0 if spec.kind == "train" else 1.0
    analytic_unit = per_tok * tokens * mult
    measured_unit = m["unit"]["flops"] * m["n_devices"]
    return {**m, "analytic_unit_flops": analytic_unit,
            "measured_unit_flops": measured_unit,
            "ratio": measured_unit / max(analytic_unit, 1.0)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--shape", default="train_4k")
    args = ap.parse_args(argv)
    r = validate_flops(args.arch, args.shape)
    print(f"{r['arch']} x {r['shape']}: unit(period={r['period']}) "
          f"measured {r['measured_unit_flops']:.3e} vs analytic "
          f"{r['analytic_unit_flops']:.3e} FLOPs -> ratio "
          f"{r['ratio']:.3f}")
    print(f"per-unit collective bytes: {r['unit']['coll'] / 2**20:.1f} MiB "
          f"(x{r['reps_full']} units)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
