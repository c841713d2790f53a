"""Dry run of every (arch x shape) cell on the production mesh (the port
of the reference's ``repro.launch.dryrun``).

The reference compiles each cell for 256 or 512 fake devices and reads
the compiler's memory and cost analyses.  The port runs rank 0's program
instead, on ``meta`` tensors (shapes only), on a description of the
production mesh (:func:`repro_torch.launch.mesh.production_mesh_spec`):
nothing is allocated and no process group is needed.

* train cells: the sharded train step
  (:func:`repro_torch.train.sharded.sharded_update`, bf16 AdamW moments,
  ``TRAIN_ACCUM`` microbatches, or one a row where rank 0 holds fewer
  rows, remat) on rank 0's blocks of the state placed by
  ``param_specs(mode="train")`` and its rows of the batch: one layer's
  data-sharded blocks gathered at a time (the gather hook), the
  ``model`` blocks kept (tensor parallelism inside attention, the MLP and
  MoE);
* prefill cells: ``prefill_logits`` on rank 0's TP-only
  (``mode="serve"``) bf16 blocks and its rows;
* decode cells: ``decode_step(..., unroll=serve_weights_resident(...))``
  on the same blocks and rank 0's blocks of the cache placed by
  ``cache_specs``: attention over its slot block (GQA merges the ranks'
  decode attention by its log-sum-exp, MLA runs the partitioned
  softmax), Mamba on its state's channel blocks in place, the xLSTM
  states gathered for their layer's step.

The record keeps the reference's keys:

* ``memory``: argument, output and alias (donated) bytes per device,
  exactly from the spec'd blocks.  ``gathered_bytes`` (the port's own
  key) are the buffers that rank 0's program gathers beside its blocks
  and may hold at once: the largest parameter group's gathered blocks
  (the embedding, a layer, the final norm or the head; over the data
  axes in a train cell, in bf16 where the step casts them, and the
  leaves under ``T.whole_keys`` whole: sLSTM's ``r``, or a Mamba or
  xLSTM mixer whose width ``model`` does not divide), twice in a train
  cell (the forward's and the backward's recompute); the largest layer's
  gathered cache blocks in a decode cell (xLSTM states, a whole mixer's,
  or an attention cache split on neither its slots nor its kv heads; no
  Mamba state); and the largest all-gather of an activation over
  ``model``.  On ``meta`` the Mamba scan's plain twin and sLSTM's step
  loop run no step loop (``models.ssm._scan_xla``, ``SLSTM.fwd``): the
  FLOP count keeps their products (the scan's h·C, sLSTM's recurrent
  GEMMs), as the loops' would; the kernel path's selective scan counts
  none (``mamba_scan_plain`` on ``meta`` returns the shape only).
  ``gradient_bytes`` (the port's own key)
  are a train cell's f32 gradients of rank 0's blocks (twice with
  ``accum`` above 1: the accumulator and one microbatch's), 0 in a
  serving cell.  ``peak_bytes`` is argument plus output less aliases
  plus gathered plus gradients.  ``temp_bytes`` is null: the
  temporaries' high-water mark (activations, the bf16 copies of the
  weights) is what a compiler's buffer assignment knows, and an eager
  program on ``meta`` has none, so ``peak_bytes`` leaves them out: it is
  a floor;
* ``cost.flops``: rank 0's FLOPs, from ``torch.utils.flop_counter``; the
  counter sees every layer and microbatch, so it is not a floor (XLA's
  count sees a loop body once);
* ``collectives``: rank 0's collective bytes by kind, from
  :func:`repro_torch.dist.context.count_collectives`;
* ``skipped``: exactly as ``shape_plan`` says; ``accum`` for train cells.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..configs import SHAPES, arch_names, get_config, shape_plan
from ..dist import context as dctx
from ..dist import tp
from ..dist.sharding import (PartitionSpec, batch_spec, cache_specs,
                             gather_hook, layer_spec_leaves, local_shape,
                             param_specs, serve_weights_resident, spec_at,
                             spec_leaves, under)
from ..models import transformer as T
from ..optim.adamw import AdamWConfig
from ..pytree import flatten, unflatten
from ..train.sharded import sharded_update
from ..train.step import _to_device
from .mesh import production_mesh_spec
from .specs import cache_shape, input_specs, state_specs

__all__ = ["dryrun_cell", "run_cell", "main", "TRAIN_ACCUM"]

#: Gradient-accumulation factor per arch for the train_4k cell.
#: Microbatches run one after another; the global batch spec is
#: unchanged.
TRAIN_ACCUM = {
    "deepseek-v2-236b": 16,
    "jamba-v0.1-52b": 4,
    "mixtral-8x7b": 4,
    "internlm2-20b": 4,
    "mistral-nemo-12b": 4,
    "pixtral-12b": 4,
    "starcoder2-7b": 4,
    "hubert-xlarge": 2,
    "xlstm-125m": 2,
    "qwen1.5-0.5b": 1,
}

_METRICS = ("loss", "ce", "moe_lb_loss", "moe_z_loss", "moe_drop_frac",
            "grad_norm", "lr")


def _block(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    return torch.empty(local_shape(t.shape, spec, mesh), dtype=t.dtype,
                       device="meta")


def _nbytes(t: torch.Tensor, spec, mesh) -> float:
    return float(math.prod(local_shape(t.shape, spec, mesh))
                 * t.element_size())


def _tree_bytes(tree, specs, mesh) -> float:
    return sum(_nbytes(t, s, mesh) for (_, t), s in zip(flatten(tree),
                                                        specs))


def _rows_spec(t: torch.Tensor, dp, split: bool) -> PartitionSpec:
    return PartitionSpec(dp if split else None, *([None] * (t.dim() - 1)))


def _kept(spec, keep) -> PartitionSpec:
    return PartitionSpec(*(e if e == keep else None for e in spec))


def _group_bytes(cfg, params, stree, mesh, cast: bool) -> float:
    """The largest parameter group's gathered bytes (module docstring):
    each leaf its spec splits over the data axes at its data-gathered
    shape, the leaves under ``T.whole_keys`` whole; ``cast``: >= 2-D f32
    leaves in bf16, as the train step gathers them."""
    best = 0.0
    for path, specs in layer_spec_leaves(params, stree).items():
        whole = T.whole_keys(cfg, path[1]) if path[0] == "layers" else ()
        total = 0.0
        for (lp, t), s in zip(flatten(spec_at(params, path)), specs):
            kept = _kept(s, None if under(lp, whole) else "model")
            shape = local_shape(t.shape, kept, mesh)
            if shape == local_shape(t.shape, s, mesh):
                continue
            size = 2 if (cast and t.dim() >= 2
                         and t.dtype == torch.float32) else t.element_size()
            total += math.prod(shape) * size
        best = max(best, total)
    return best


def _cache_bytes(cfg, cache, ctree, mesh, keep) -> float:
    """The largest layer's cache blocks that ``decode_step`` gathers over
    ``model`` for the step (module docstring); ``keep``: the batch's
    entry.  A Mamba layer's are its channel blocks, updated in place
    (a block along another dim is re-cut by an all-to-all, not
    gathered); an xLSTM layer's states, and those of a mixer that runs
    whole, are gathered."""
    best = 0.0
    for i, layer in enumerate(cache["layers"]):
        dims = {k: tp.model_dim(s) for k, s in ctree["layers"][i].items()}
        split = set(dims.values())
        local = {1, 2} if "k" in layer else {1}
        kind = cfg.layer_kind(i)
        if split == {None} or (kind == "attn" and len(split) == 1
                               and split <= local) or (
                kind == "mamba" and not T.whole_mixer(cfg, i)):
            continue
        best = max(best, sum(
            math.prod(local_shape(t.shape, _kept(ctree["layers"][i][k],
                                                 keep), mesh))
            * t.element_size() for k, t in layer.items()
            if dims[k] is not None))
    return best


def _activation_bytes(calls, known) -> float:
    """The largest all-gather over ``model`` of anything but a weight or
    a cache (``known``: their gathered shapes)."""
    return max((c[3] for c in calls if c[0] == "all-gather"
                and c[1] == "model" and c[2] not in known), default=0.0)


def _gathered_shapes(tree, specs, mesh, keep) -> set:
    return {local_shape(t.shape, _kept(s, keep), mesh)
            for (_, t), s in zip(flatten(tree), specs)} | {
        tuple(t.shape) for _, t in flatten(tree)}


def _train(cfg, spec, mesh, accum: int, record: dict, calls: list):
    dp = batch_spec(mesh)[0]
    state = state_specs(cfg, with_opt=True, opt_dtype=torch.bfloat16)
    params, opt = state["params"], state["opt_state"]
    stree = param_specs(params, mesh)
    specs = spec_leaves(params, stree)
    ospecs = spec_leaves(opt, param_specs(opt, mesh))
    inp = input_specs(cfg, spec)
    bspecs = {k: _rows_spec(v, dp, True) for k, v in inp.items()}
    local = lambda tree: unflatten(tree, [  # noqa: E731
        _block(t, s, mesh) for (_, t), s in zip(flatten(tree), specs)])
    record["accum"] = accum
    opt_local = {"m": local(opt["m"]), "v": local(opt["v"]),
                 "step": opt["step"]}
    batch = _to_device({k: _block(v, bspecs[k], mesh)
                        for k, v in inp.items()}, "meta")
    # a rank with fewer rows than microbatches (deepseek-v2 on 2 x 16 x 16:
    # 8 rows, accum 16) runs one microbatch a row
    accum = min(accum, batch["inputs"].shape[0])
    sharded_update(cfg, AdamWConfig(state_dtype="bfloat16"), mesh, specs,
                   local(params), opt_local, batch, accum=accum, remat=True)
    state_b = _tree_bytes(params, specs, mesh) + _tree_bytes(opt, ospecs,
                                                             mesh)
    batch_b = sum(_nbytes(v, bspecs[k], mesh) for k, v in inp.items())
    grads_b = _tree_bytes(params, specs, mesh) * (2 if accum > 1 else 1)
    known = _gathered_shapes(params, specs, mesh, "model")
    gathered = (2 * _group_bytes(cfg, params, stree, mesh, cast=True)
                + _activation_bytes(calls, known))
    return (state_b + batch_b, state_b + 4.0 * len(_METRICS), state_b,
            gathered, grads_b)


def _serve_params(cfg, mesh):
    params = state_specs(cfg, with_opt=False,
                         param_dtype=torch.bfloat16)["params"]
    stree = param_specs(params, mesh, mode="serve")
    specs = spec_leaves(params, stree)
    blocks = unflatten(params, [_block(t, s, mesh)
                                for (_, t), s in zip(flatten(params), specs)])
    return params, stree, specs, blocks


def _prefill(cfg, spec, mesh, record: dict, calls: list):
    dp = batch_spec(mesh)[0]
    params, stree, specs, blocks = _serve_params(cfg, mesh)
    x = input_specs(cfg, spec)["inputs"]
    xspec = _rows_spec(x, dp, True)
    with torch.no_grad():
        logits = T.prefill_logits(blocks, cfg, _block(x, xspec, mesh),
                                  gather=gather_hook(stree))
    # serving prefill: last-position logits only, vocab over "model"
    # where it divides
    out_spec = PartitionSpec(dp, "model" if cfg.vocab % 16 == 0 else None)
    logits_b = _nbytes(torch.empty((x.shape[0], cfg.vocab),
                                   dtype=logits.dtype, device="meta"),
                       out_spec, mesh)
    arg = _tree_bytes(params, specs, mesh) + _nbytes(x, xspec, mesh)
    known = _gathered_shapes(params, specs, mesh, None)
    gathered = (_group_bytes(cfg, params, stree, mesh, cast=False)
                + _activation_bytes(calls, known))
    return arg, logits_b, 0.0, gathered, 0.0


def _decode(cfg, spec, mesh, record: dict, calls: list):
    dp = batch_spec(mesh)[0]
    params, stree, specs, blocks = _serve_params(cfg, mesh)
    # Unrolling is only safe with resident (TP-only) weights.
    unroll = serve_weights_resident(params, mesh)
    record["unroll"] = unroll
    tok = input_specs(cfg, spec)["tok"]
    split = spec.global_batch % dctx.axis_size(dp, mesh) == 0
    tspec = _rows_spec(tok, dp, split)
    cache = cache_shape(cfg, spec)
    ctree = cache_specs(cache, mesh)
    cspecs = spec_leaves(cache, ctree)
    if not split:    # the batch stays whole on every rank
        ctree = unflatten(cache, [_kept(s, "model") for s in cspecs])
        cspecs = spec_leaves(cache, ctree)
    c_blocks = unflatten(cache, [_block(t, s, mesh) for (_, t), s in
                                 zip(flatten(cache), cspecs)])
    with dctx.act_ctx(dp=dp if split else None, tp="model", mesh=mesh), \
            torch.no_grad():
        logits, _ = T.decode_step(blocks, cfg,
                                  _block(tok, tspec, mesh).long(), c_blocks,
                                  spec.seq_len - 1, unroll=unroll,
                                  gather=gather_hook(stree),
                                  cache_specs=ctree)
    cache_b = _tree_bytes(cache, cspecs, mesh)
    arg = (_tree_bytes(params, specs, mesh) + _nbytes(tok, tspec, mesh)
           + cache_b + 4.0)
    out = float(logits.numel() * logits.element_size()) + cache_b
    known = (_gathered_shapes(params, specs, mesh, None)
             | _gathered_shapes(cache, cspecs, mesh, dp if split else None))
    gathered = (_group_bytes(cfg, params, stree, mesh, cast=False)
                + _cache_bytes(cfg, cache, ctree, mesh, dp if split else None)
                + _activation_bytes(calls, known))
    return arg, out, cache_b, gathered, 0.0


def run_cell(cfg, spec, mesh, *, accum: int = 1,
             record: dict | None = None) -> tuple[float, dict, tuple]:
    """Rank 0's program of one cell on ``meta`` on the mesh description
    ``mesh`` -> (its FLOPs, its collective bytes by kind, (argument,
    output, alias, gathered, gradient) bytes).  ``record`` gets ``accum``
    (train) or
    ``unroll`` (decode)."""
    record = {} if record is None else record
    calls: list = []
    program = {"train": _train, "prefill": _prefill, "decode": _decode}
    args = (accum,) if spec.kind == "train" else ()
    with dctx.count_collectives(calls) as coll, \
            FlopCounterMode(display=False) as counter, \
            dctx.act_ctx(dp=batch_spec(mesh)[0], tp="model", mesh=mesh):
        mem = program[spec.kind](cfg, spec, mesh, *args, record, calls)
    return float(counter.get_total_flops()), dict(coll), mem


def dryrun_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
                collect_hlo: bool = True) -> dict:
    """Run one cell's rank-0 program on ``meta``; returns the roofline
    record.  ``collect_hlo`` keeps the reference's name: it adds the
    collective tally."""
    cfg = get_config(arch, "full")
    spec = SHAPES[shape_name]
    plan = shape_plan(cfg)
    if plan[shape_name] is not None:
        return {"arch": arch, "shape": shape_name,
                "skipped": plan[shape_name]}
    mesh = production_mesh_spec(multi_pod=multi_pod)
    t0 = time.time()
    record = {"arch": arch, "shape": shape_name,
              "mesh": "x".join(map(str, mesh.sizes)),
              "n_devices": mesh.size()}
    flops, coll, (arg, out, alias, gathered, grads) = run_cell(
        cfg, spec, mesh, accum=TRAIN_ACCUM.get(arch, 1), record=record)
    record["run_s"] = round(time.time() - t0, 1)
    record["memory"] = {"argument_bytes": arg, "output_bytes": out,
                        "temp_bytes": None, "alias_bytes": alias,
                        "gathered_bytes": gathered,
                        "gradient_bytes": grads,
                        "peak_bytes": arg + out - alias + gathered + grads}
    record["cost"] = {"flops": flops, "bytes_accessed": None}
    if collect_hlo:
        record["collectives"] = coll
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["no", "yes", "both"],
                    default="no")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = arch_names() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    pods = {"no": [False], "yes": [True], "both": [False, True]}[
        args.multi_pod]
    results = []
    for arch in archs:
        for shape in shapes:
            for mp in pods:
                try:
                    r = dryrun_cell(arch, shape, multi_pod=mp)
                except Exception as e:
                    r = {"arch": arch, "shape": shape, "multi_pod": mp,
                         "error": f"{type(e).__name__}: {e}"}
                    results.append(r)
                    print(f"[FAIL] {arch} x {shape} mp={mp}: "
                          f"{r['error'][:200]}", flush=True)
                    continue
                results.append(r)
                if "skipped" in r:
                    print(f"[skip] {arch} x {shape}: {r['skipped']}",
                          flush=True)
                    continue
                mem = r["memory"]["peak_bytes"] / 2**30
                fl = r["cost"]["flops"]
                coll = sum(r.get("collectives", {}).values()) / 2**30
                print(f"[ok]  {arch} x {shape} mesh={r['mesh']} "
                      f"peak={mem:.2f}GiB (no temporaries) flops={fl:.3e} "
                      f"coll={coll:.2f}GiB (run {r['run_s']}s)", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    # Non-zero exit if any non-skipped cell failed.
    bad = [r for r in results if "skipped" not in r and "error" in r]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
