"""The port's live incremental composition (``repro_torch.serve.live``,
``SchedulerPolicy.composition="incremental"``) and the frontier it keeps
(``repro_torch.graph.constrained.GreedyFrontier``) against the JAX
reference, on the CPU.

Each test runs one case of the reference's ``tests/test_live.py`` in
both packages.  The frontier and the live composition are host NumPy in
float64, copied from the reference apart from their import paths, so
rounds, orders, modelled times and the live counters
(``incremental_joins``, ``incremental_leaves``, ``frontier_rebuilds``)
are bit-equal; served tokens are f32 and identical to the reference's
and to the port's own batch composition's, on the three traced archs."""

import functools
import random
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.core.tpu as RTPU
import repro.graph.constrained as RGC
import repro.models.attention as ref_attention
import repro.obs as RObs
import repro.serve as RServe
import repro.serve.engine as RServeEngine
import repro.slice as RS
from repro.dist.context import set_activation_axes
from repro.kernels import ops as ref_ops
from repro.models import transformer as RT

import repro_torch.configs as pt_configs
import repro_torch.core.tpu as PTPU
import repro_torch.graph.constrained as PGC
import repro_torch.obs as PObs
import repro_torch.serve as PServe
import repro_torch.slice as PS
from repro_torch import interop

_ARCHS = ("qwen1.5-0.5b", "mixtral-8x7b", "deepseek-v2-236b")

_REF = SimpleNamespace(name="ref", tpu=RTPU, gc=RGC, obs=RObs,
                       serve=RServe, slice=RS)
_PORT = SimpleNamespace(name="port", tpu=PTPU, gc=PGC, obs=PObs,
                        serve=PServe, slice=PS)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's smoke-size ops gain nothing from intra-op threads, and
    test workers that each spin a full pool of them on a shared CPU slow
    every test; this module runs on one and restores the count after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reference_engine(monkeypatch):
    """No activation axes bound (another test on this worker may leave a
    mesh behind, which would break the reference engine), and the
    reference's GQA decode pointed at the function its TPU kernel
    computes: f32 softmax weights, as the port's kernel keeps them (its
    model path rounds them to the cache dtype, ROADMAP §3)."""
    set_activation_axes()
    monkeypatch.setattr(ref_attention, "decode_sdpa", _kernel_decode_sdpa)
    init = RServeEngine.ServingEngine.__init__

    def shared_decode(self, cfg, *args, **kwargs):
        init(self, cfg, *args, **kwargs)
        self._decode_jit = _ref_decode_step(cfg)
    monkeypatch.setattr(RServeEngine.ServingEngine, "__init__", shared_decode)
    yield


@functools.lru_cache(maxsize=None)
def _ref_decode_step(cfg):
    """One jitted reference ``decode_step`` per config, shared by every
    reference engine here (each engine jits its own, and compiling it
    again for every engine of a test dominates the test's time)."""
    return jax.jit(lambda p, t, c, s: RT.decode_step(p, cfg, t, c, s))


def _kernel_decode_sdpa(q, k, v, length_mask, *, scale):
    del scale
    lengths = length_mask.sum(-1).astype(np.int32)
    return ref_ops.decode_attention(q, k, v, lengths, interpret=True)


def _both(case):
    """Run ``case(pkg)`` in each package; the port's result must equal
    the reference's.  Returns the port's."""
    ref, port = case(_REF), case(_PORT)
    assert port == ref
    return port


# --------------------------------------------------------------------------
# frontier mechanics (no model, no engine)
# --------------------------------------------------------------------------

def _chain_profiles(pkg, rng: random.Random, tag: str, n: int):
    out = []
    for i in range(n):
        if i == 0 and rng.random() < 0.5:
            it = pkg.tpu.prefill_profile(f"{tag}:p{i}", n_params=7e9,
                                         seq_len=rng.choice([128, 256, 512]),
                                         kv_bytes_per_token=131072)
        else:
            it = pkg.tpu.decode_profile(f"{tag}:d{i}", n_params=7e9,
                                        kv_len=rng.randint(1, 4096),
                                        kv_bytes_per_token=131072)
        out.append(it.profile())
    return out


def _chain_workload(pkg, rng: random.Random, n_chains: int):
    profs, edges = [], set()
    for c in range(n_chains):
        chain = _chain_profiles(pkg, rng, f"r{c}", rng.randint(1, 4))
        base = len(profs)
        profs.extend(chain)
        edges |= {(base + i, base + i + 1) for i in range(len(chain) - 1)}
    return profs, edges


def _seeded_frontier(pkg, profs, edges):
    dev = pkg.tpu.make_serving_device()
    f = pkg.gc.GreedyFrontier(dev)
    sched = pkg.gc.greedy_order_dag(profs, dev, edges=edges, frontier=f)
    return f, sched


def _assert_chain_order(frontier, chains):
    at = {name: i for i, rd in enumerate(frontier.round_names())
          for name in rd}
    for chain in chains:
        idxs = [at[p.name] for p in chain]
        assert idxs == sorted(idxs) and len(set(idxs)) == len(idxs)


def test_frontier_sink_matches_greedy_rounds():
    def case(pkg):
        out = []
        for seed in range(8):
            rng = random.Random(seed)
            profs, edges = _chain_workload(pkg, rng, rng.randint(2, 6))
            f, sched = _seeded_frontier(pkg, profs, edges)
            assert f.round_names() == [rd.names for rd in sched.rounds]
            assert [p.name for p in f.order()] == \
                [p.name for p in sched.order]
            out.append(f.round_names())
        return out
    _both(case)


def test_frontier_insert_chain_keeps_precedence():
    def case(pkg):
        out = []
        for seed in range(6):
            rng = random.Random(100 + seed)
            profs, edges = _chain_workload(pkg, rng, 3)
            f, _ = _seeded_frontier(pkg, profs, edges)
            new = _chain_profiles(pkg, rng, "rx", 3)
            f.insert_chain(new)
            assert {p.name for p in f.order()} == \
                {p.name for p in profs} | {p.name for p in new}
            _assert_chain_order(f, [new])
            out.append(f.round_names())
        return out
    _both(case)


def test_frontier_remove_and_leave_of_just_joined():
    def case(pkg):
        rng = random.Random(7)
        profs, edges = _chain_workload(pkg, rng, 3)
        f, _ = _seeded_frontier(pkg, profs, edges)
        before = f.round_names()
        new = _chain_profiles(pkg, rng, "rx", 3)
        f.insert_chain(new)
        f.remove({p.name for p in new})
        assert {p.name for p in f.order()} == {p.name for p in profs}
        assert [rd for rd in f.round_names() if rd] == \
            [rd for rd in before if rd]
        f.insert_chain(_chain_profiles(pkg, rng, "ry", 2))
        return before, f.round_names()
    _both(case)


def test_frontier_refresh_swaps_drifted_profiles():
    def case(pkg):
        rng = random.Random(11)
        profs, edges = _chain_workload(pkg, rng, 3)
        f, _ = _seeded_frontier(pkg, profs, edges)
        drifted = {p.name: pkg.tpu.decode_profile(
            p.name, n_params=7e9, kv_len=4097,
            kv_bytes_per_token=131072).profile()
            for p in profs if p.name.split(":")[1].startswith("d")}
        f.refresh(drifted)
        by_name = {p.name: p for p in f.order()}
        assert all(by_name[n] is p for n, p in drifted.items())
        f.insert_chain(_chain_profiles(pkg, rng, "rz", 2))
        assert len(f.order()) == len(profs) + 2
        return f.round_names()
    _both(case)


# --------------------------------------------------------------------------
# serving: incremental == batch, port == reference (smoke, f32)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _model(arch: str):
    cfg_ref = ref_configs.get_config(arch, "smoke").replace(dtype="float32")
    cfg = pt_configs.get_config(arch, "smoke").replace(dtype="float32")
    params = jax.jit(lambda key: RT.init(key, cfg_ref))(jax.random.PRNGKey(0))
    port = interop.params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                     device="cpu")
    return {"ref": (cfg_ref, params), "port": (cfg, port)}


def _engine(pkg, arch, device=None, **policy):
    cfg, params = _model(arch)[pkg.name]
    return pkg.serve.ServingEngine(
        cfg, params, max_len=32, device=device,
        policy=pkg.serve.SchedulerPolicy(respect_deps=True, **policy))


def _served(s):
    """The parts of ``run()`` that must be bit-equal across packages."""
    return {k: s[k] for k in ("rounds", "modelled_time_s", "schedule_cache",
                              "outputs", "total_new_tokens")}


def _churn(pkg, arch, composition, device=None, slice_policy=None,
           drift_tol=0.05):
    """Staggered arrivals with different lifetimes, so requests join and
    leave the mix at different steps."""
    eng = _engine(pkg, arch, device, kind="symbiotic",
                  composition=composition, slice_policy=slice_policy,
                  replay_drift_tol=drift_tol)
    rng = np.random.default_rng(0)
    R = pkg.serve.Request
    eng.submit([R(i, rng.integers(0, 128, size=4), max_new_tokens=3 + i)
                for i in range(2)])
    late = [(2, [R(10, rng.integers(0, 128, size=4), max_new_tokens=2)]),
            (4, [R(11, rng.integers(0, 128, size=4), max_new_tokens=3)])]
    return _served(eng.run(arrivals=late))


@pytest.mark.parametrize("arch", _ARCHS)
def test_incremental_tokens_bit_identical_under_churn(arch):
    batch = _both(lambda pkg: _churn(pkg, arch, "batch"))
    inc = _both(lambda pkg: _churn(pkg, arch, "incremental"))
    assert inc["outputs"] == batch["outputs"]
    assert inc["schedule_cache"]["incremental_joins"] >= 1
    assert inc["schedule_cache"]["incremental_leaves"] >= 1


def _run_once(pkg, arch, seed, lifetimes, composition, blip=None, **kw):
    eng = _engine(pkg, arch, composition=composition, **kw)
    rng = np.random.default_rng(seed)
    R = pkg.serve.Request
    eng.submit([R(i, rng.integers(0, 128, size=4), max_new_tokens=n)
                for i, n in enumerate(lifetimes)])
    arrivals = None
    if blip is not None:
        arrivals = [(2, [R(9, rng.integers(0, 128, size=4),
                           max_new_tokens=blip)])]
    return _served(eng.run(arrivals=arrivals))


@pytest.mark.parametrize("arch", _ARCHS)
def test_incremental_leave_of_just_joined_request(arch):
    """A request that joins and finishes one decode step after its
    prefill retires cleanly from the live frontier."""
    out = {c: _both(lambda pkg: _run_once(pkg, arch, 1, (6, 6), c, blip=1,
                                          kind="symbiotic"))
           for c in ("batch", "incremental")}
    assert out["incremental"]["outputs"] == out["batch"]["outputs"]
    assert len(out["incremental"]["outputs"][9]) >= 1


@pytest.mark.parametrize("arch", _ARCHS)
def test_untriggered_incremental_matches_batch(arch):
    """One cohort, equal lifetimes: the frontier machinery is invisible
    to the tokens."""
    out = {c: _both(lambda pkg: _run_once(pkg, arch, 2, (4, 4, 4), c,
                                          kind="symbiotic"))
           for c in ("batch", "incremental")}
    assert out["incremental"]["outputs"] == out["batch"]["outputs"]
    assert out["incremental"]["total_new_tokens"] == \
        out["batch"]["total_new_tokens"]


def test_incremental_drift_backstop_rebuilds():
    """A hair-trigger drift tolerance forces cold rebuilds as the KV
    grows: counted the same in both packages, tokens unchanged."""
    batch = _both(lambda pkg: _churn(pkg, "qwen1.5-0.5b", "batch"))
    inc = _both(lambda pkg: _churn(pkg, "qwen1.5-0.5b", "incremental",
                                   drift_tol=1e-9))
    assert inc["outputs"] == batch["outputs"]
    assert inc["schedule_cache"]["frontier_rebuilds"] >= 1


@pytest.mark.parametrize("arch", _ARCHS)
def test_incremental_with_slicing_tokens_identical(arch):
    """Slice-aware live joins (``frontier_solo_expander``) on a shrunken
    slot budget, where cutting triggers on both paths."""
    def run(composition):
        return _both(lambda pkg: _churn(
            pkg, arch, composition,
            device=pkg.tpu.make_serving_device(token_budget=6),
            slice_policy=pkg.slice.SlicePolicy()))
    assert run("incremental")["outputs"] == run("batch")["outputs"]


def test_incremental_fifo_kind_passes_through():
    out = {c: _both(lambda pkg: _run_once(pkg, "qwen1.5-0.5b", 3, (3, 3),
                                          c, kind="fifo"))
           for c in ("batch", "incremental")}
    assert out["incremental"]["outputs"] == out["batch"]["outputs"]
    assert out["incremental"]["modelled_time_s"] == pytest.approx(
        out["batch"]["modelled_time_s"])


def test_gated_guard_reuses_checkpoints_across_candidates():
    out = {g: _both(lambda pkg: _run_once(pkg, "qwen1.5-0.5b", 4,
                                          (3, 3, 3), "batch",
                                          kind="symbiotic", dag_guard=g,
                                          cache=False))
           for g in ("rounds", "gated")}
    assert out["gated"]["outputs"] == out["rounds"]["outputs"]
    assert out["gated"]["schedule_cache"]["gated_sims_saved"] > 0.0
    assert out["rounds"]["schedule_cache"]["gated_sims_saved"] == 0.0


def test_live_composition_records_rebuilds_and_joins():
    """The live frontier's flight-recorder events (the composer's
    ``schedule`` and ``rebuild`` notes) are the reference's, event for
    event."""
    def case(pkg):
        rec = pkg.obs.FlightRecorder()
        cfg, params = _model("qwen1.5-0.5b")[pkg.name]
        eng = pkg.serve.ServingEngine(
            cfg, params, max_len=32, recorder=rec,
            policy=pkg.serve.SchedulerPolicy(
                respect_deps=True, composition="incremental",
                replay_drift_tol=1e-9))
        rng = np.random.default_rng(5)
        R = pkg.serve.Request
        eng.submit([R(i, rng.integers(0, 128, size=4),
                      max_new_tokens=2 + i) for i in range(3)])
        eng.run()
        return rec.events
    events = _both(case)
    kinds = {e["kind"] for e in events}
    assert {"rebuild", "schedule"} <= kinds
    assert any(e.get("path") == "live" for e in events)
