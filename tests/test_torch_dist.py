"""The port's distribution substrate (``repro_torch.dist``), MoE's
distributed paths on one rank and the elastic restore, against the JAX
reference (``repro.dist``, ``repro.models.moe``), on the CPU.

* Specs: the port's ``param_specs`` (train and serve), ``batch_spec``,
  ``cache_specs`` and ``serve_weights_resident`` are given the
  reference's own abstract trees (``jax.eval_shape``) on duck-typed
  16 x 16 and 2 x 16 x 16 meshes, and must return the reference's specs,
  leaf by leaf, exactly.  On the port's own per-layer parameters the rule
  is applied to each layer's shape; where the reference's rule shards
  the stacked layer axis the layouts differ by design, and the test pins
  how many leaves and their bytes per device on both sides.
* MoE on a world-1 gloo group: ``_fwd_ep`` and ``_fwd_tp`` against
  ``_fwd_local`` at rtol/atol 2e-4, ``moe_lb_loss`` at 1e-3 (the
  reference's ``test_moe_distributed_matches_local``), and the port's
  ``_fwd_ep`` against the reference's on its (1, 1) mesh at the same
  tolerances.
* The elastic restore (``test_elastic_checkpoint_reshard``): bit-equal
  values, the requested placements.
"""

import functools
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import repro.configs as ref_configs
import repro.dist.context as RC
import repro.dist.sharding as RSH
from repro.launch import specs as RSP
from repro.models import transformer as RT
from repro.models.moe import MoE as RMoE

import repro_torch.dist.context as C
import repro_torch.dist.sharding as S
from repro_torch.configs import get_config
from repro_torch.launch import make_host_mesh
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig
from repro_torch.models.moe import MoE
from repro_torch.train import restore_checkpoint, save_checkpoint
from torch_threads import one_torch_thread  # noqa: F401

ARCHS = ref_configs.arch_names()

MESHES = {
    "16x16": types.SimpleNamespace(axis_names=("data", "model"),
                                   shape={"data": 16, "model": 16}),
    "2x16x16": types.SimpleNamespace(axis_names=("pod", "data", "model"),
                                     shape={"pod": 2, "data": 16,
                                            "model": 16}),
}

#: (arch, mesh) -> (stacked leaves whose train spec shards the layer
#: axis, their bytes per device in the reference's stacked layout, the
#: same leaves' bytes per device in the port's per-layer layout); every
#: other (arch, mesh) has none.  All are 1-D leaves (norm scales,
#: biases), f32.
_LAYER_AXIS_PINS = {
    ("mixtral-8x7b", "16x16"): (3, 20480, 327680),
    ("mixtral-8x7b", "2x16x16"): (3, 10240, 327680),
    ("starcoder2-7b", "16x16"): (7, 12032, 192512),
    ("starcoder2-7b", "2x16x16"): (7, 6016, 192512),
    ("internlm2-20b", "16x16"): (2, 9216, 147456),
    ("hubert-xlarge", "16x16"): (4, 3840, 61440),
}


@pytest.fixture(autouse=True)
def _no_mesh():
    RC.set_activation_axes()
    C.set_activation_axes()
    yield
    C.set_activation_axes()


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    cfg = ref_configs.get_config(arch, "full")
    return jax.eval_shape(lambda: RT.init(jax.random.PRNGKey(0), cfg))


@functools.lru_cache(maxsize=None)
def _ref_cache(arch, shape):
    return RSP.cache_shape(ref_configs.get_config(arch, "full"),
                           ref_configs.SHAPES[shape])


def _ref_specs(tree):
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, JP))]


def _port_specs(tree, spec_tree):
    return [tuple(s) for s in S.spec_leaves(tree, spec_tree)]


# --------------------------------------------------------------------------
# dist.context
# --------------------------------------------------------------------------

def test_context_binds_clears_and_restores():
    spec = C.MeshSpec(("pod", "data", "model"), (2, 4, 8))
    assert (C.dp_size(), C.tp_size(), C.mesh()) == (1, 1, None)
    C.set_activation_axes(dp=("pod", "data"), tp="model", mesh=spec)
    assert C.activation_axes() == (("pod", "data"), "model")
    assert (C.dp_size(), C.tp_size()) == (8, 8)
    with C.act_ctx(dp="data", tp=None, mesh=MESHES["16x16"]):
        assert (C.dp_size(), C.tp_size()) == (16, 1)
        with C.act_ctx():
            assert C.mesh() is None and C.dp_size() == 1
        assert C.mesh() is MESHES["16x16"]
    assert C.mesh() is spec and C.dp_size() == 8
    C.set_activation_axes()
    assert C.activation_axes() == (None, None) and C.mesh() is None


def test_context_matches_reference_sizes():
    for m in MESHES.values():
        for dp, tp in ((None, None), ("data", "model"),
                       (tuple(a for a in m.axis_names if a != "model"),
                        "model")):
            RC.set_activation_axes(dp=dp, tp=tp, mesh=m)
            C.set_activation_axes(dp=dp, tp=tp, mesh=m)
            assert (C.dp_size(), C.tp_size()) == (RC.dp_size(),
                                                  RC.tp_size())
    RC.set_activation_axes()


def test_constrain_is_identity_and_keeps_values():
    from torch.distributed.tensor import DTensor, Replicate, Shard
    x = torch.arange(24.).reshape(4, 6)
    assert C.constrain(x, ("dp", None)) is x          # no mesh
    mesh = make_host_mesh("cpu")
    with C.act_ctx(dp="data", tp="model", mesh=mesh):
        assert C.constrain(x, ("dp", "tp")) is x      # a plain tensor
        d = DTensor.from_local(x, mesh, (Replicate(), Replicate()))
        assert C.constrain(d, (None, None)) is d      # nothing to place
        y = C.constrain(d, ("dp", "tp"))
        assert y.placements == (Shard(0), Shard(1))
        assert torch.equal(y.full_tensor(), x)


def test_collectives_on_meta_shapes_and_tally():
    spec = C.MeshSpec(("pod", "data", "model"), (2, 4, 8))
    x = torch.empty((16, 6), device="meta")
    with C.act_ctx(dp=("pod", "data"), tp="model", mesh=spec), \
            C.count_collectives() as tally:
        assert C.all_gather(x, ("pod", "data"), dim=1).shape == (16, 48)
        assert C.reduce_scatter(x, "model", dim=0).shape == (2, 6)
        assert C.all_reduce(x, "data").shape == (16, 6)
        assert C.all_to_all(x, "model").shape == (16, 6)
        assert C.axis_index("model") == 0
    b = 16 * 6 * 4
    assert tally == {"all-gather": b * 4 + b * 8, "reduce-scatter": b / 8,
                     "all-reduce": b, "all-to-all": b}
    one = C.MeshSpec(("data", "model"), (1, 1))
    with C.act_ctx(dp="data", tp="model", mesh=one), \
            C.count_collectives() as tally:
        C.all_reduce(x, ("data", "model"))
    assert tally == {}       # a one-rank collective moves nothing


def test_collectives_are_the_identity_over_one_rank(monkeypatch):
    """Over the host mesh's one-rank axes each collective returns its
    input itself: nothing reaches the process group, nothing is tallied."""
    mesh = make_host_mesh("cpu")
    x = torch.arange(8.0).reshape(2, 4)

    def no_call():
        raise AssertionError("a one-rank collective reached the group")

    monkeypatch.setattr(C, "_nnf", no_call)
    with C.act_ctx(dp="data", tp="model", mesh=mesh), \
            C.count_collectives() as tally:
        assert C.all_reduce(x, ("data", "model")) is x
        assert C.all_gather(x, "model", dim=1) is x
        assert C.reduce_scatter(x, "data", dim=0) is x
        assert C.all_to_all(x, "model") is x
    assert tally == {}


def test_collectives_refuse_a_mesh_description_on_real_tensors():
    with C.act_ctx(tp="model", mesh=C.MeshSpec(("data", "model"), (1, 2))):
        with pytest.raises(RuntimeError, match="no processes"):
            C.all_reduce(torch.ones(2), "model")


# --------------------------------------------------------------------------
# dist.sharding against the reference
# --------------------------------------------------------------------------

def test_placements_and_local_shape():
    from torch.distributed.tensor import Replicate, Shard
    m = C.MeshSpec(("pod", "data", "model"), (2, 16, 16))
    spec = S.PartitionSpec(None, ("pod", "data"), "model")
    assert S.placements(m, spec) == (Shard(1), Shard(1), Shard(2))
    assert S.placements(m, S.PartitionSpec()) == (Replicate(),) * 3
    assert S.local_shape((3, 64, 32), spec, m) == (3, 2, 2)
    assert S.NamedSharding(m, spec).placements == S.placements(m, spec)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_spec_matches_reference(mesh):
    m = MESHES[mesh]
    assert tuple(S.batch_spec(m)) == tuple(RSH.batch_spec(m))


@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, mesh, mode):
    """The same abstract shapes give the reference's specs, leaf by leaf."""
    m, ab = MESHES[mesh], _ref_params(arch)
    want = _ref_specs(RSH.param_specs(ab, m, mode=mode))
    got = _port_specs(ab, S.param_specs(ab, m, mode=mode))
    assert got == want


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, mesh, shape):
    m, cache = MESHES[mesh], _ref_cache(arch, shape)
    assert (_port_specs(cache, S.cache_specs(cache, m))
            == _ref_specs(RSH.cache_specs(cache, m)))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_weights_resident_matches_reference(arch):
    """With the reference's default capacity passed explicitly; the
    port's default is the H100's 80 GB."""
    ab = _ref_params(arch)
    for m in MESHES.values():
        for p in (ab, RSP.state_specs(ref_configs.get_config(arch, "full"),
                                      with_opt=False,
                                      param_dtype=jnp.bfloat16)["params"]):
            assert (S.serve_weights_resident(
                p, m, hbm_bytes_per_chip=16 * 1024**3)
                == RSH.serve_weights_resident(p, m))
            assert (S.serve_weights_resident(p, m)
                    == RSH.serve_weights_resident(
                        p, m, hbm_bytes_per_chip=80e9))
    import inspect
    dflt = inspect.signature(S.serve_weights_resident).parameters[
        "hbm_bytes_per_chip"].default
    assert dflt == 80e9


def _dev_bytes(shape, spec, m, item=4):
    n = math.prod(shape)
    for e in spec:
        for a in C.as_axes(e):
            n //= m.shape[a]
    return n * item


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_per_layer_specs_against_stacked(arch, mesh):
    """On the port's per-layer leaves: a layer's spec is the reference's
    stacked spec without its layer entry wherever that entry is None, and
    ``_LAYER_AXIS_PINS`` counts the leaves where it is not (train mode;
    serve mode never shards the layer axis)."""
    m = MESHES[mesh]
    cfg = get_config(arch, "full")
    prefix, period = T.unit_period(cfg)
    reps = (cfg.n_layers - prefix) // period
    port = T.init(cfg, device="meta", param_dtype=torch.float32)
    ab = _ref_params(arch)
    for mode in ("train", "serve"):
        ref = RSH.param_specs(ab, m, mode=mode)
        ps = S.param_specs(port, m, mode=mode)
        shapes = {jax.tree_util.keystr(p): leaf.shape for p, leaf in
                  jax.tree_util.tree_leaves_with_path(ab)}
        n_diff = ref_b = port_b = 0
        for path, spec in jax.tree_util.tree_leaves_with_path(
                ref, is_leaf=lambda x: isinstance(x, JP)):
            keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
            spec = tuple(spec)
            if keys[0] == "prefix":
                node = ps["layers"][keys[1]]
                for k in keys[2:]:
                    node = node[k]
                assert tuple(node) == spec, keys
                continue
            if keys[0] != "stack":
                node = ps
                for k in keys:
                    node = node[k]
                assert tuple(node) == spec, keys
                continue
            shape = shapes[jax.tree_util.keystr(path)]
            layers = []
            for r in range(reps):
                node = ps["layers"][prefix + r * period + keys[1]]
                for k in keys[2:]:
                    node = node[k]
                layers.append(tuple(node))
            if spec[0] is None:
                assert all(s == spec[1:] for s in layers), keys
                continue
            n_diff += 1
            ref_b += _dev_bytes(shape, spec, m)
            port_b += sum(_dev_bytes(shape[1:], s, m) for s in layers)
        want = (_LAYER_AXIS_PINS.get((arch, mesh), (0, 0, 0))
                if mode == "train" else (0, 0, 0))
        assert (n_diff, ref_b, port_b) == want, mode


def test_modules_export_reference_names():
    assert set(RC.__all__) <= set(C.__all__)
    assert set(RSH.__all__) <= set(S.__all__)
    import repro.dist as RD
    import repro_torch.dist as PD
    assert set(RD.__all__) == set(PD.__all__)


# --------------------------------------------------------------------------
# MoE's distributed paths on one rank
# --------------------------------------------------------------------------

def _moe_cfgs():
    kw = dict(name="m", n_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
              head_dim=8, d_ff=64, vocab=64, n_experts=4, top_k=2,
              n_shared_experts=1, moe_d_ff=48, dtype="float32")
    from repro.models.common import ModelConfig as RModelConfig
    return RModelConfig(**kw), ModelConfig(**kw)


def _moe_params():
    cfg_ref, cfg = _moe_cfgs()
    p = RMoE.init(jax.random.PRNGKey(0), cfg_ref)
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 8, 32))
    to_t = lambda t: jax.tree.map(  # noqa: E731
        lambda a: torch.from_numpy(np.array(a, np.float32)), t)
    return cfg_ref, cfg, p, x, to_t(p), to_t(x)


def test_moe_distributed_matches_local_one_rank():
    """The counterpart of the reference's
    ``test_moe_distributed_matches_local`` on a world-1 gloo group, and
    the port's local path against the reference's."""
    cfg_ref, cfg, p_ref, x_ref, p, x = _moe_params()
    y_local, aux_local = MoE._fwd_local(p, cfg, x)
    ry, raux = RMoE._fwd_local(p_ref, cfg_ref, x_ref)
    np.testing.assert_allclose(y_local.numpy(), np.asarray(ry), rtol=2e-4,
                               atol=2e-4)
    mesh = make_host_mesh("cpu")
    with C.act_ctx(dp="data", tp="model", mesh=mesh):
        y_ep, aux_ep = MoE._fwd_ep(p, cfg, x)
        y_tp, aux_tp = MoE._fwd_tp(p, cfg, x)
    for y, aux in ((y_ep, aux_ep), (y_tp, aux_tp)):
        np.testing.assert_allclose(y.numpy(), y_local.numpy(), rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(float(aux["moe_lb_loss"]),
                                   float(aux_local["moe_lb_loss"]),
                                   rtol=1e-3)
        assert float(aux["moe_drop_frac"]) == float(
            aux_local["moe_drop_frac"])


def test_moe_ep_matches_reference_ep_one_rank():
    """The port's ``_fwd_ep`` on a world-1 gloo group against the
    reference's ``_fwd_ep`` (``shard_map``) on its (1, 1) mesh."""
    cfg_ref, cfg, p_ref, x_ref, p, x = _moe_params()
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    with jax.set_mesh(jmesh):
        RC.set_activation_axes(dp="data", tp="model", mesh=jmesh)
        try:
            ry, raux = jax.jit(
                lambda pp, xx: RMoE._fwd_ep(pp, cfg_ref, xx))(p_ref, x_ref)
        finally:
            RC.set_activation_axes()
    with C.act_ctx(dp="data", tp="model", mesh=make_host_mesh("cpu")):
        y, aux = MoE._fwd_ep(p, cfg, x)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=2e-4,
                               atol=2e-4)
    for k in ("moe_lb_loss", "moe_z_loss", "moe_drop_frac"):
        np.testing.assert_allclose(float(aux[k]), float(raux[k]), rtol=1e-3)


def test_moe_fwd_dispatch():
    """``MoE.fwd`` takes the reference's path: local with no mesh or a
    model axis of 1, expert parallelism where E divides the model axis,
    tensor parallelism otherwise (on ``meta``, a mesh description)."""
    _, cfg = _moe_cfgs()
    p = MoE.init(torch.Generator(), cfg, dtype=torch.float32, device="meta")
    x = torch.empty((2, 8, 32), device="meta")
    calls = []
    orig = {k: getattr(MoE, k) for k in ("_fwd_ep", "_fwd_tp", "_fwd_local")}

    def spy(k):
        return lambda *a, **kw: calls.append(k) or orig[k](*a, **kw)
    try:
        for k in orig:
            setattr(MoE, k, staticmethod(spy(k)))
        MoE.fwd(p, cfg, x)
        for tp, want in ((1, "_fwd_local"), (2, "_fwd_ep"), (4, "_fwd_ep"),
                         (8, "_fwd_tp")):
            m = C.MeshSpec(("data", "model"), (1, tp))
            with C.act_ctx(dp="data", tp="model", mesh=m):
                y, _ = MoE.fwd(p, cfg, x)
            assert y.shape == x.shape and calls[-1] == want, (tp, calls)
    finally:
        for k, f in orig.items():
            setattr(MoE, k, staticmethod(f))
    assert calls[0] == "_fwd_local"


# --------------------------------------------------------------------------
# Elastic restore
# --------------------------------------------------------------------------

def test_elastic_checkpoint_reshard(tmp_path):
    """The counterpart of the reference's test: a checkpoint restores onto
    a (1, 1) mesh with explicit shardings, as DTensors with the requested
    placements and the saved bits."""
    from torch.distributed.tensor import DTensor, Shard
    tree = {"w": torch.arange(32, dtype=torch.float32).reshape(8, 4),
            "opt": {"step": torch.tensor(3, dtype=torch.int32)}}
    save_checkpoint(str(tmp_path), 3, tree)
    mesh = make_host_mesh("cpu")
    shard = {"w": S.NamedSharding(mesh, S.PartitionSpec("data", "model")),
             "opt": {"step": S.NamedSharding(mesh, S.PartitionSpec())}}
    restored, _ = restore_checkpoint(str(tmp_path), tree, shardings=shard)
    w = restored["w"]
    assert isinstance(w, DTensor) and w.placements == (Shard(0), Shard(1))
    assert torch.equal(w.full_tensor(), tree["w"])
    assert restored["opt"]["step"].full_tensor().item() == 3
    # and saved again from DTensors: whole arrays, the same bits
    save_checkpoint(str(tmp_path), 4, restored)
    again, _ = restore_checkpoint(str(tmp_path), tree, step=4)
    assert torch.equal(again["w"], tree["w"])


def test_train_state_blocks_round_trip():
    """The sharded step's state between steps: on the host mesh each
    block is the whole tensor itself; as DTensors (for a save) and back
    it is the same storage, with the placements of
    ``train_state_shardings``."""
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_config
    from repro_torch.pytree import flatten
    from repro_torch.train import init_train_state
    from repro_torch.train.sharded import (as_dtensors, local_blocks,
                                           shard_train_state,
                                           train_state_shardings)
    mesh = make_host_mesh("cpu")
    p, o = init_train_state(get_config("qwen1.5-0.5b", "smoke"),
                            device="cpu")
    bp, bo = shard_train_state(p, o, mesh)
    state, blocks = {"params": p, "opt": o}, {"params": bp, "opt": bo}
    for (_, t), (_, b) in zip(flatten(state), flatten(blocks)):
        assert b is t
    shd = train_state_shardings(p, mesh)
    dt = as_dtensors(blocks, shd)
    for (_, d), (_, sh), (_, b) in zip(flatten(dt), flatten(shd),
                                       flatten(blocks)):
        assert isinstance(d, DTensor) and d.placements == sh.placements
        assert d.shape == b.shape
        assert d.to_local().data_ptr() == b.data_ptr()
    for (_, d), (_, b) in zip(flatten(local_blocks(dt)), flatten(blocks)):
        assert d.data_ptr() == b.data_ptr() and torch.equal(d, b)
