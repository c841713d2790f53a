"""The port's launchers (``repro_torch.launch.{mesh,specs,dryrun}`` and
the train launcher's meshes) against the JAX reference, on the CPU.

* ``input_specs``, ``state_specs`` and ``cache_shape`` are ``meta``
  tensors with the shapes and dtypes of the reference's
  ``ShapeDtypeStruct``\\ s (the reference's stacked layers mapped to the
  port's per-layer leaves).
* ``T.init(cfg, device="meta")`` draws nothing: deepseek-v2-236b's
  235.7e9 parameters are laid out in seconds, with the reference's count.
* The dry run: qwen's train cell, mixtral's decode and prefill cells
  (tensor parallelism inside the experts), jamba's prefill (expert
  parallelism) and a skipped cell.  Its argument bytes equal the
  per-device sum over the reference's own specs of the same cell (no
  leaf of these cells differs by layout), exactly; ``roofline_row``
  accepts its records.
"""

import math
import time
import types

import jax
import jax.numpy as jnp
import pytest
import torch

import repro.configs as ref_configs
import repro.dist.sharding as RSH
from repro.dist.context import set_activation_axes
from repro.launch import dryrun as RDR
from repro.launch import specs as RSP
from repro.models import transformer as RT

import repro_torch.dist.sharding as PSH
import repro_torch.launch.specs as PSP
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun as PDR
from repro_torch.launch import make_host_mesh, make_production_mesh
from repro_torch.launch.mesh import production_mesh_spec
from repro_torch.launch.specs import cache_shape, input_specs, state_specs
from repro_torch.launch.train import train
from repro_torch.models import transformer as T
from repro_torch.pytree import flatten
from repro_torch.roofline import roofline_row
from torch_threads import one_torch_thread  # noqa: F401

_MESH16 = types.SimpleNamespace(axis_names=("data", "model"),
                                shape={"data": 16, "model": 16})


@pytest.fixture(autouse=True)
def _no_mesh():
    set_activation_axes()
    yield


def _np_dtype(dt: torch.dtype):
    return jnp.dtype(str(dt).removeprefix("torch."))


def _ref_layers(tree, cfg):
    """The reference's {"prefix", "stack", ...} tree -> {path: (shape,
    dtype)} in the port's layout (one dict per layer under "layers")."""
    prefix, period = T.unit_period(cfg)
    reps = (cfg.n_layers - prefix) // period
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        else:
            yield_leaf(path, node)

    def yield_leaf(path, leaf):
        if path[0] == "prefix":
            out[("layers",) + path[1:]] = (tuple(leaf.shape), leaf.dtype)
        elif path[0] == "stack":
            for r in range(reps):
                out[("layers", prefix + r * period + path[1]) + path[2:]] = (
                    tuple(leaf.shape[1:]), leaf.dtype)
        else:
            out[path] = (tuple(leaf.shape), leaf.dtype)
    walk(tree, ())
    return out


def _port_leaves(tree):
    return {p: (tuple(t.shape), _np_dtype(t.dtype)) for p, t in flatten(tree)}


@pytest.mark.parametrize("arch", ref_configs.arch_names())
def test_specs_match_reference_shapes(arch):
    cfg_ref = ref_configs.get_config(arch, "full")
    cfg = get_config(arch, "full")
    for shape in SHAPES:
        ref_in = RSP.input_specs(cfg_ref, ref_configs.SHAPES[shape])
        got = input_specs(cfg, SHAPES[shape])
        assert set(got) == set(ref_in)
        for k, v in got.items():
            assert v.device.type == "meta"
            assert (tuple(v.shape), _np_dtype(v.dtype)) == (
                tuple(ref_in[k].shape), ref_in[k].dtype), (shape, k)
    for kw, pkw in (({}, {}),
                    ({"with_opt": False, "param_dtype": jnp.bfloat16},
                     {"with_opt": False, "param_dtype": torch.bfloat16}),
                    ({"opt_dtype": jnp.bfloat16},
                     {"opt_dtype": torch.bfloat16})):
        ref = RSP.state_specs(cfg_ref, **kw)
        got = state_specs(cfg, **pkw)
        assert _port_leaves(got["params"]) == _ref_layers(ref["params"],
                                                          cfg)
        if "opt_state" in ref:
            o = ref["opt_state"]
            assert _port_leaves(got["opt_state"]["m"]) == _ref_layers(
                o["m"], cfg)
            assert _port_leaves(got["opt_state"]["v"]) == _ref_layers(
                o["v"], cfg)
            st = got["opt_state"]["step"]
            assert (tuple(st.shape), _np_dtype(st.dtype)) == (
                tuple(o["step"].shape), o["step"].dtype)
    for shape in ("decode_32k", "long_500k"):
        ref = RSP.cache_shape(cfg_ref, ref_configs.SHAPES[shape])
        assert _port_leaves(cache_shape(cfg, SHAPES[shape])) == \
            _ref_layers(ref, cfg)


def test_meta_init_is_quick_and_counts_the_reference():
    cfg = get_config("deepseek-v2-236b", "full")
    t0 = time.perf_counter()
    p = T.init(cfg, device="meta")
    assert time.perf_counter() - t0 < 10
    assert all(t.device.type == "meta" for _, t in flatten(p))
    ab = jax.eval_shape(lambda: RT.init(
        jax.random.PRNGKey(0), ref_configs.get_config("deepseek-v2-236b",
                                                      "full")))
    assert T.count_params(p) == sum(int(x.size) for x in jax.tree.leaves(ab))


def test_kernel_wrappers_take_their_plain_versions_on_meta():
    from repro_torch.kernels import (decode_attention, flash_attention,
                                     mamba_scan, rmsnorm_rows)
    m = lambda *s, dt=torch.bfloat16: torch.empty(s, dtype=dt,  # noqa: E731
                                                  device="meta")
    assert rmsnorm_rows(m(4, 64), m(64, dt=torch.float32)).shape == (4, 64)
    assert flash_attention(m(1, 8, 4, 16), m(1, 8, 2, 16),
                           m(1, 8, 2, 16)).shape == (1, 8, 4, 16)
    assert decode_attention(m(2, 4, 16), m(2, 8, 2, 16), m(2, 8, 2, 16),
                            m(2, dt=torch.int32)).shape == (2, 4, 16)
    y = mamba_scan(m(1, 5, 8), m(1, 5, 8), m(1, 5, 4), m(1, 5, 4),
                   m(8, 4, dt=torch.float32), m(8, dt=torch.float32))
    assert y.shape == (1, 5, 8) and y.device.type == "meta"


# --------------------------------------------------------------------------
# Meshes
# --------------------------------------------------------------------------

def test_meshes():
    m = make_host_mesh("cpu")
    assert m.mesh_dim_names == ("data", "model") and tuple(m.shape) == (1, 1)
    for multi, world in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"world of {world} ranks"):
            make_production_mesh(multi_pod=multi, device="cpu")
        spec = production_mesh_spec(multi_pod=multi)
        assert spec.size() == world
    assert production_mesh_spec(multi_pod=True).axis_names == (
        "pod", "data", "model")
    import repro.launch as RL
    import repro_torch.launch as PL
    import repro_torch.launch.specs as PSP
    assert set(RL.__all__) <= set(PL.__all__)
    assert set(RSP.__all__) <= set(PSP.__all__)


def test_train_launcher_runs_the_sharded_step_on_the_host_mesh(tmp_path):
    """``mesh_kind="host"`` runs the sharded step at world 1: the losses
    of the bare single-device step, bit for bit; the production meshes
    refuse a world of one rank."""
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import init_train_state, make_train_step
    out = train("qwen1.5-0.5b", steps=3, global_batch=2, seq_len=16,
                ckpt_dir=str(tmp_path), ckpt_every=0, device="cpu",
                log_fn=lambda s, m: None)
    cfg = get_config("qwen1.5-0.5b", "smoke")
    p, o = init_train_state(cfg, device="cpu")
    step = make_train_step(cfg, AdamWConfig(warmup_steps=5, total_steps=3))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16,
                                  global_batch=2))
    want = []
    for _ in range(3):
        p, o, m = step(p, o, data.next_batch())
        want.append(float(m["loss"]))
    assert out["losses"] == want
    with pytest.raises(ValueError, match="256"):
        train("qwen1.5-0.5b", steps=1, mesh_kind="single", device="cpu")


# --------------------------------------------------------------------------
# The dry run
# --------------------------------------------------------------------------

def _ref_dev_bytes(tree, specs, mesh):
    """Per-device bytes of ``tree`` placed by the reference's ``specs``."""
    total = 0
    for leaf, spec in zip(jax.tree.leaves(tree), jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))):
        n = math.prod(leaf.shape)
        for e in spec:
            for a in ((e,) if isinstance(e, str) else (e or ())):
                n //= mesh.shape[a]
        total += n * jnp.dtype(leaf.dtype).itemsize
    return total


def _rows(leaf, split=True):
    return jax.sharding.PartitionSpec("data" if split else None,
                                      *([None] * (len(leaf.shape) - 1)))


@pytest.fixture(scope="module")
def qwen_train_record():
    return PDR.dryrun_cell("qwen1.5-0.5b", "train_4k")


def test_dryrun_train_cell(qwen_train_record):
    r = qwen_train_record
    cfg = ref_configs.get_config("qwen1.5-0.5b", "full")
    st = RSP.state_specs(cfg, with_opt=True, opt_dtype=jnp.bfloat16)
    ps = RSH.param_specs(st["params"], _MESH16)
    inp = RSP.input_specs(cfg, ref_configs.SHAPES["train_4k"])
    state_b = (_ref_dev_bytes(st["params"], ps, _MESH16)
               + _ref_dev_bytes(st["opt_state"], {"m": ps, "v": ps,
                                                  "step": jax.sharding.PartitionSpec()},
                                _MESH16))
    batch_b = sum(_ref_dev_bytes(v, _rows(v), _MESH16) for v in inp.values())
    mem = r["memory"]
    assert mem["argument_bytes"] == state_b + batch_b
    assert mem["alias_bytes"] == state_b
    assert mem["temp_bytes"] is None
    # rank 0 gathers one parameter group's data-sharded blocks (bf16
    # where the step casts them), twice (the forward's and the backward's
    # recompute), and its largest activation over "model": the MLP's
    # input, its 16 rows x 4096 x 1024 in bf16 (the gate is split on
    # d_ff, its output, and reads every feature); nothing whole.  It
    # holds its blocks' f32 gradients (accum 1: one set)
    pcfg = get_config("qwen1.5-0.5b", "full")
    pst = PSP.state_specs(pcfg, with_opt=False)["params"]
    pspec = PSH.param_specs(pst, production_mesh_spec())
    blocks = sum(4 * math.prod(PSH.local_shape(t.shape, s,
                                               production_mesh_spec()))
                 for (_, t), s in zip(flatten(pst),
                                      PSH.spec_leaves(pst, pspec)))
    group = max(
        sum(math.prod(PSH.local_shape(t.shape, PSH.PartitionSpec(*(
            e if e == "model" else None for e in s)),
            production_mesh_spec())) * (2 if t.dim() >= 2 else 4)
            for (_, t), s in zip(flatten(PSH.spec_at(pst, path)),
                                 specs) if "data" in s)
        for path, specs in PSH.layer_spec_leaves(pst, pspec).items())
    act = (256 // 16) * 4096 * 1024 * 2
    assert mem["gathered_bytes"] == 2 * group + act
    assert mem["gradient_bytes"] == blocks
    assert mem["peak_bytes"] == (mem["argument_bytes"] + mem["output_bytes"]
                                 - mem["alias_bytes"] + mem["gathered_bytes"]
                                 + mem["gradient_bytes"])
    assert r["accum"] == RDR.TRAIN_ACCUM["qwen1.5-0.5b"] == 1
    assert (r["mesh"], r["n_devices"]) == ("16x16", 256)
    # rank 0 gathers each layer's data blocks (bf16) in the forward and
    # again in the recompute, its activations over "model", and the
    # backward reduce-scatters and all-reduces the adjoints
    n = T.count_params(T.init(pcfg, device="meta"))
    assert r["collectives"]["all-gather"] >= 2 * 2 * n / 16
    assert set(r["collectives"]) == {"all-gather", "reduce-scatter",
                                     "all-reduce"}
    assert r["cost"]["flops"] > 0
    row = roofline_row(r)
    assert row["dominant"] in ("compute", "memory", "collective")
    assert row["raw_cost_flops_dev"] == r["cost"]["flops"]


def test_dryrun_train_with_fewer_rows_than_microbatches():
    """deepseek-v2's train cell on 2 x 16 x 16: rank 0 holds 256 / 32 = 8
    rows and ``TRAIN_ACCUM`` asks for 16 microbatches; the rank program
    runs one microbatch a row (at smoke width and a 64-token sequence:
    the cell's global batch, the same mesh), and the record keeps the
    reference's ``accum``."""
    from repro_torch.configs import ShapeSpec
    cfg = get_config("deepseek-v2-236b", "smoke")
    mesh = production_mesh_spec(multi_pod=True)
    spec = ShapeSpec("train_64", "train", 64,
                     SHAPES["train_4k"].global_batch)
    record = {}
    flops, coll, mem = PDR.run_cell(cfg, spec, mesh,
                                    accum=RDR.TRAIN_ACCUM["deepseek-v2-236b"],
                                    record=record)
    assert record["accum"] == 16
    assert flops > 0 and coll["all-gather"] > 0
    n = T.count_params(T.init(cfg, device="meta"))
    # the accumulator and one microbatch's f32 gradients of rank 0's
    # blocks (at least a 256th of the parameters each)
    assert mem[4] >= 2 * 4 * n / 256


def test_dryrun_decode_prefill_and_skipped_cells():
    mix = ref_configs.get_config("mixtral-8x7b", "full")
    dec = PDR.dryrun_cell("mixtral-8x7b", "decode_32k")
    st = RSP.state_specs(mix, with_opt=False, param_dtype=jnp.bfloat16)
    ps = RSH.param_specs(st["params"], _MESH16, mode="serve")
    cache = RSP.cache_shape(mix, ref_configs.SHAPES["decode_32k"])
    tok = RSP.input_specs(mix, ref_configs.SHAPES["decode_32k"])["tok"]
    want = (_ref_dev_bytes(st["params"], ps, _MESH16)
            + _ref_dev_bytes(tok, _rows(tok), _MESH16)
            + _ref_dev_bytes(cache, RSH.cache_specs(cache, _MESH16), _MESH16)
            + 4)
    assert dec["memory"]["argument_bytes"] == want
    assert dec["unroll"] == RSH.serve_weights_resident(
        st["params"], _MESH16, hbm_bytes_per_chip=80e9)
    # mixtral's 8 experts on 16 model ranks: tensor parallelism inside
    # the experts, one all-reduce a layer (and the shared-free MoE)
    assert dec["collectives"]["all-reduce"] > 0
    assert "all-to-all" not in dec["collectives"]
    pre = PDR.dryrun_cell("mixtral-8x7b", "prefill_32k")
    x = RSP.input_specs(mix, ref_configs.SHAPES["prefill_32k"])["inputs"]
    assert pre["memory"]["argument_bytes"] == (
        _ref_dev_bytes(st["params"], ps, _MESH16)
        + _ref_dev_bytes(x, _rows(x), _MESH16))
    assert pre["memory"]["alias_bytes"] == 0
    for r in (dec, pre):
        mem = r["memory"]
        # the activations gathered over "model" (weights and the
        # slot-split cache stay blocks); no gradients
        assert mem["gathered_bytes"] > 0 and mem["gradient_bytes"] == 0
        assert mem["peak_bytes"] == (mem["argument_bytes"]
                                     + mem["output_bytes"]
                                     - mem["alias_bytes"]
                                     + mem["gathered_bytes"])
        assert r["cost"]["flops"] > 0
        assert roofline_row(r)["step_time_bound_s"] > 0
    skip = PDR.dryrun_cell("qwen1.5-0.5b", "long_500k")
    plan = ref_configs.shape_plan(ref_configs.get_config("qwen1.5-0.5b"))
    assert skip == {"arch": "qwen1.5-0.5b", "shape": "long_500k",
                    "skipped": plan["long_500k"]}
    assert roofline_row(skip) == skip


def test_dryrun_expert_parallel_prefill():
    """jamba's 16 experts over 16 model ranks: the prefill takes the
    expert-parallel path, an all-to-all there and back in each of its 16
    MoE layers, the sequence split over ``model`` and all-gathered back;
    its 28 Mamba layers scan their d_inner channels through the plain
    version on ``meta``, each re-cutting its ``w_in`` block to the same
    channels of x and z by one all-to-all of the block (the input's
    65,536 rows outweigh the weight's 4,096)."""
    r = PDR.dryrun_cell("jamba-v0.1-52b", "prefill_32k")
    cfg = get_config("jamba-v0.1-52b", "full")
    assert sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers)) == 16
    B, S, d = 32 // 16, 32768, cfg.d_model
    t = B * S // 16
    c_se = max(4, -(-int(t * cfg.top_k * cfg.capacity_factor
                         / cfg.n_experts) // 4) * 4)
    # each layer: two all-to-alls of (16 * 1 expert * c_se, d) bf16, and
    # the three expert weights' blocks re-cut from their d_ff split (the
    # serve spec's "model" entry) to one expert a rank, one all-to-all of
    # a block each
    recut = 3 * cfg.n_experts * d * cfg.moe_d_ff * 2 // 16
    n_mamba = sum(cfg.layer_kind(i) == "mamba" for i in range(cfg.n_layers))
    w_in = d * 2 * cfg.mamba_d_inner * 2 // 16
    assert n_mamba == 28
    assert r["collectives"]["all-to-all"] == 16 * (
        2 * (16 * c_se * d * 2) + recut) + n_mamba * w_in
    assert r["cost"]["flops"] > 0


def test_dryrun_cli(tmp_path, capsys):
    out = tmp_path / "r.json"
    assert PDR.main(["--arch", "qwen1.5-0.5b", "--shape", "decode_32k",
                     "--out", str(out)]) == 0
    assert "[ok]  qwen1.5-0.5b x decode_32k mesh=16x16" in \
        capsys.readouterr().out
    import json
    (rec,) = json.loads(out.read_text())
    assert rec["memory"]["temp_bytes"] is None
    assert PDR.TRAIN_ACCUM == RDR.TRAIN_ACCUM
