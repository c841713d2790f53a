"""The port's kernel slicing (``repro_torch.slice``), the composer's
sliced branches and the sliced ``respect_deps`` engine against the JAX
reference, on the CPU.

Slicing is host NumPy in float64, copied from the reference apart from
its import paths, so every comparison here is bit-equal: slice counts,
slice profiles, expansions, orders, rounds, gated makespans, engine
rounds, modelled times and cache counters.  Each test runs one case of
the reference's ``tests/test_slice.py`` (or the sliced cases of
``tests/test_gated_delta.py``) in both packages, holds the port to that
case's properties and to the reference's numbers.  Served tokens are
f32 and identical to the reference's and to the port's unsliced
path's."""

import dataclasses
import functools
import random
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import repro.configs as ref_configs
import repro.core as RC
import repro.core.resources as RRes
import repro.core.tpu as RTPU
import repro.graph as RG
import repro.models.attention as ref_attention
import repro.serve as RServe
import repro.serve.engine as RServeEngine
import repro.slice as RS
from repro.dist.context import set_activation_axes
from repro.kernels import ops as ref_ops
from repro.graph.delta import _FastGatedSim as RFastGated
from repro.models import transformer as RT

import repro_torch.configs as pt_configs
import repro_torch.core as PC
import repro_torch.core.resources as PRes
import repro_torch.core.tpu as PTPU
import repro_torch.graph as PG
import repro_torch.serve as PServe
import repro_torch.slice as PS
from repro_torch import interop
from repro_torch.graph.delta import _FastGatedSim as PFastGated
from torch_threads import one_torch_thread  # noqa: F401

_ARCHS = ("qwen1.5-0.5b", "mixtral-8x7b", "deepseek-v2-236b")

#: one side of a comparison: a package's modules under common names
_REF = SimpleNamespace(name="ref", core=RC, res=RRes, tpu=RTPU, graph=RG,
                       slice=RS, serve=RServe, configs=ref_configs,
                       fast_gated=RFastGated)
_PORT = SimpleNamespace(name="port", core=PC, res=PRes, tpu=PTPU,
                        graph=PG, slice=PS, serve=PServe,
                        configs=pt_configs, fast_gated=PFastGated)


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


def _t(prof):
    return dataclasses.astuple(prof)


def _tpu(pkg, **kw):
    return pkg.tpu.make_serving_device(**kw)


def _tpu_items(pkg, rng: random.Random, n: int, *, oversized_frac=0.25):
    items = []
    for i in range(n):
        if rng.random() < oversized_frac:
            items.append(pkg.tpu.prefill_profile(
                f"r{i}:p:L0:attn", n_params=7e9,
                seq_len=rng.choice([6144, 8192, 12288]),
                kv_bytes_per_token=131072))
        else:
            items.append(pkg.tpu.decode_profile(
                f"r{i}:d:L0:attn", n_params=7e9,
                kv_len=rng.randint(256, 8192),
                kv_bytes_per_token=131072))
    return items


def _gpu_kernels(pkg, rng: random.Random, n: int):
    fams = [pkg.res.ep_kernel, pkg.res.bs_kernel, pkg.res.es_kernel,
            pkg.res.sw_kernel]
    return [rng.choice(fams)(f"k{i}",
                             grid=rng.choice([8, 16, 32, 48, 64, 96]),
                             shm=rng.choice([0, 4096, 8192, 16384]),
                             inst=rng.uniform(1e6, 5e8))
            for i in range(n)]


def _random_dag_edges(rng: random.Random, n: int, density=1.0) -> set:
    edges = set()
    for _ in range(int(density * n)):
        u, v = rng.randrange(n), rng.randrange(n)
        if u != v:
            edges.add((min(u, v), max(u, v)))
    return edges


def _round_names(sched):
    return [rd.names for rd in sched.rounds]


def _sliced(res):
    """Everything a SlicedSchedule holds, as comparable values."""
    return (_round_names(res.schedule), [k.name for k in res.order],
            [_t(k) for k in res.kernels], sorted(res.edges), res.sliced,
            res.parent_of, res.passes)


# --------------------------------------------------------------------------
# package surface, naming, policy
# --------------------------------------------------------------------------

def test_slice_package_exports_reference_names():
    assert sorted(PS.__all__) == sorted(RS.__all__)
    for name in PS.__all__:
        assert getattr(PS, name).__module__.startswith("repro_torch.slice")
    assert dataclasses.asdict(PS.SlicePolicy()) == \
        dataclasses.asdict(RS.SlicePolicy())


def test_name_helpers():
    names = ["r0:p:L3:moe#s1of4", "r0:p:L3:moe#join", "r0:p:L3:moe",
             "a#s0of2", "a#join", "k#s0+2of4"]

    def case(pkg):
        s = pkg.slice
        return [(s.parent_name(n), s.is_slice(n), s.is_join(n))
                for n in names]
    out = _both(case)
    assert out[0][0] == out[1][0] == out[2][0] == "r0:p:L3:moe"
    assert out[3][1] and not out[4][1] and out[4][2] and not out[3][2]


def test_policy_validation():
    for pkg in (_REF, _PORT):
        for kw in (dict(mode="nope"), dict(target_fill=0.0),
                   dict(fixed_k=0)):
            with pytest.raises(ValueError):
                pkg.slice.SlicePolicy(**kw)


def test_slice_count_modes():
    def case(pkg):
        S, dev = pkg.slice, _tpu(pkg)
        sl_occ = S.KernelSlicer(S.SlicePolicy(), dev)
        sl_fill = S.KernelSlicer(S.SlicePolicy(mode="round_fill",
                                               target_fill=0.5), dev)
        sl_fix = S.KernelSlicer(S.SlicePolicy(mode="fixed", fixed_k=5),
                                dev)
        big = pkg.tpu.prefill_profile("r0:p:L0", n_params=7e9,
                                      seq_len=8192,
                                      kv_bytes_per_token=131072).profile()
        small = pkg.tpu.decode_profile("r1:d:L0", n_params=7e9,
                                       kv_len=512,
                                       kv_bytes_per_token=131072).profile()
        cut = sl_occ.slice_profile(big, 3)[0]
        return (sl_occ.footprint_frac(big), sl_occ.slice_count(big),
                sl_fill.slice_count(big), sl_fix.slice_count(big),
                sl_occ.slice_count(small), sl_fix.slice_count(small),
                sl_occ.slice_count(cut),
                sl_occ.slice_count(S.join_profile(big)))
    out = _both(case)
    assert out[0] == pytest.approx(2.0)
    assert out[1:] == (3, 4, 5, 1, 1, 1, 1)


def test_slice_count_clamps_to_granularity():
    def case(pkg):
        S = pkg.slice
        sl = S.KernelSlicer(S.SlicePolicy(mode="fixed", trigger_frac=0.0,
                                          fixed_k=16), _tpu(pkg))
        one_tok = pkg.tpu.decode_profile("r0:d:L0", n_params=7e9,
                                         kv_len=4096,
                                         kv_bytes_per_token=131072)
        four = pkg.tpu.prefill_profile("r1:p:L0", n_params=1e9, seq_len=4,
                                       kv_bytes_per_token=131072)
        return ([_t(p) for p in sl.slice_item(one_tok, 16)],
                [_t(p) for p in sl.slice_item(four, 16)])
    one, four = _both(case)
    assert len(one) == 1 and len(four) == 4


# --------------------------------------------------------------------------
# conservation
# --------------------------------------------------------------------------

def test_item_slices_conserve_parent():
    def case(pkg):
        rng = random.Random(3)
        sl = pkg.slice.KernelSlicer(pkg.slice.SlicePolicy(), _tpu(pkg))
        out = []
        for _ in range(30):
            it = pkg.tpu.prefill_profile(
                f"r0:p:L{rng.randrange(9)}",
                n_params=rng.uniform(1e9, 3e11),
                seq_len=rng.choice([4097, 6144, 8192, 16384]),
                kv_bytes_per_token=rng.uniform(1e3, 2e5))
            it = dataclasses.replace(it, weight_bytes=2e9)
            k = rng.randint(2, 8)
            parts = sl.slice_item(it, k)
            assert len(parts) == k
            assert sum(p.flops for p in parts) == pytest.approx(it.flops)
            assert sum(p.hbm_bytes for p in parts) == pytest.approx(
                it.hbm_bytes)
            assert sum(p.vmem_bytes for p in parts) == pytest.approx(
                it.vmem_bytes)
            assert sum(p.tokens for p in parts) == it.tokens
            for p in parts:
                assert p.weight_bytes == it.weight_bytes
                assert p.intensity == pytest.approx(it.intensity)
                assert pkg.slice.parent_name(p.name) == it.name
            out.append([(_t(p), _t(p.profile())) for p in parts])
        return out
    _both(case)


def test_profile_slices_conserve_parent():
    def case(pkg):
        rng = random.Random(7)
        sl = pkg.slice.KernelSlicer(pkg.slice.SlicePolicy(), pkg.core.GTX580)
        fams = [pkg.res.ep_kernel, pkg.res.bs_kernel, pkg.res.es_kernel,
                pkg.res.sw_kernel]
        out = []
        for _ in range(30):
            prof = rng.choice(fams)(f"k{rng.randrange(99)}",
                                    grid=rng.choice([16, 48, 96, 256]),
                                    shm=rng.choice([0, 8192, 16384]),
                                    inst=rng.uniform(1e6, 1e9))
            k = rng.randint(2, 6)
            parts = sl.slice_profile(prof, k)
            assert len(parts) == min(k, prof.n_blocks)
            assert sum(p.n_blocks for p in parts) == prof.n_blocks
            for p in parts:
                assert p.inst_per_block == prof.inst_per_block
                assert p.demands == prof.demands and p.r == prof.r
            out.append([_t(p) for p in parts])
        return out
    _both(case)


def test_single_block_profile_slices_scale_mass():
    def case(pkg):
        sl = pkg.slice.KernelSlicer(pkg.slice.SlicePolicy(), _tpu(pkg))
        prof = pkg.tpu.prefill_profile("r0:p:L0", n_params=7e9,
                                       seq_len=8193,
                                       kv_bytes_per_token=131072).profile()
        parts = sl.slice_profile(prof, 3)
        for dim in prof.demands:
            assert sum(p.demands[dim] for p in parts) == \
                pytest.approx(prof.demands[dim])
        assert sum(p.inst_per_block for p in parts) == \
            pytest.approx(prof.inst_per_block)
        assert all(p.r == prof.r for p in parts)
        return [_t(p) for p in parts]
    assert len(_both(case)) == 3


# --------------------------------------------------------------------------
# expansion topology
# --------------------------------------------------------------------------

def _exp_fields(exp):
    return ([_t(k) for k in exp.kernels], sorted(exp.edges), exp.new_of,
            exp.join_of, exp.parent_of)


def test_expand_nodes_rewires_the_diamond():
    def case(pkg):
        rng = random.Random(11)
        S = pkg.slice
        sl = S.KernelSlicer(S.SlicePolicy(), pkg.core.GTX580)
        out = []
        for _ in range(20):
            n = rng.randint(4, 20)
            ks = _gpu_kernels(pkg, rng, n)
            edges = _random_dag_edges(rng, n, 1.5)
            t = rng.randrange(n)
            parts = sl.slice_profile(ks[t], rng.randint(2, 4))
            if len(parts) < 2:
                continue
            exp = S.expand_nodes(ks, edges, {t: (parts, S.join_profile(
                ks[t]))})
            pkg.graph.KernelGraph(exp.kernels, exp.edges).validate()
            slice_idx, join_idx = set(exp.new_of[t]), exp.join_of[t]
            for u, v in edges:
                if v == t:
                    assert all((exp.new_of[u][0], s) in exp.edges
                               for s in slice_idx)
                if u == t:
                    assert (join_idx, exp.new_of[v][0]) in exp.edges
            for s in slice_idx:
                assert (s, join_idx) in exp.edges
                assert not any((s, s2) in exp.edges for s2 in slice_idx)
            assert exp.parent_of[join_idx] == t
            out.append(_exp_fields(exp))
        return out
    assert _both(case)


def test_expansion_preserves_topological_input_order():
    def case(pkg):
        rng = random.Random(13)
        S = pkg.slice
        sl = S.KernelSlicer(S.SlicePolicy(), pkg.core.GTX580)
        out = []
        for _ in range(10):
            n = rng.randint(5, 16)
            ks = _gpu_kernels(pkg, rng, n)
            edges = _random_dag_edges(rng, n, 1.0)
            exps = {}
            for t in rng.sample(range(n), rng.randint(1, 3)):
                parts = sl.slice_profile(ks[t], 3)
                if len(parts) >= 2:
                    exps[t] = (parts, S.join_profile(ks[t]))
            if not exps:
                continue
            exp = S.expand_nodes(ks, edges, exps)
            assert all(u < v for u, v in exp.edges)
            out.append(_exp_fields(exp))
        return out
    assert _both(case)


def test_greedy_order_slices_emits_topological_orders():
    def case(pkg):
        rng = random.Random(17)
        pol = pkg.slice.SlicePolicy(mode="round_fill", target_fill=0.5)
        dev, out = _tpu(pkg), []
        for _ in range(15):
            n = rng.randint(4, 20)
            profs = [it.profile() for it in
                     _tpu_items(pkg, rng, n, oversized_frac=0.4)]
            edges = _random_dag_edges(rng, n, rng.uniform(0.0, 1.5))
            res = pkg.slice.greedy_order_slices(profs, dev, edges=edges,
                                                policy=pol)
            g = res.graph()
            g.validate()
            assert g.is_topological(res.order)
            eids = res.edges_by_id()
            for rd in res.rounds:
                ids = [id(k) for k in rd.kernels]
                assert not any((a, b) in eids for a in ids for b in ids)
            assert len(res.parent_of) == len(res.kernels)
            out.append(_sliced(res))
        return out
    assert any(r[4] for r in _both(case))      # something was cut


def test_refine_order_slices_respects_slice_edges():
    def case(pkg):
        rng = random.Random(19)
        dev = _tpu(pkg)
        profs = [it.profile() for it in
                 _tpu_items(pkg, rng, 10, oversized_frac=0.5)]
        edges = {(i, i + 1) for i in range(0, 8, 2)}
        res = pkg.slice.greedy_order_slices(profs, dev, edges=edges,
                                            policy=pkg.slice.SlicePolicy())
        assert res.sliced
        out = []
        for model in ("event", "round", "gated"):
            order, t, evals = pkg.slice.refine_order_slices(
                res, dev, budget=30, model=model)
            assert res.graph().is_topological(order)
            out.append(([k.name for k in order], t, evals))
        return _sliced(res), out
    _both(case)


# --------------------------------------------------------------------------
# slice-factor-1 identity
# --------------------------------------------------------------------------

def test_factor1_identity_no_policy():
    def case(pkg):
        rng = random.Random(23)
        dev, out = _tpu(pkg), []
        for _ in range(20):
            n = rng.randint(2, 24)
            profs = [it.profile() for it in
                     _tpu_items(pkg, rng, n, oversized_frac=0.3)]
            edges = _random_dag_edges(rng, n, 1.0)
            ref = pkg.graph.greedy_order_dag(profs, dev, edges=edges)
            res = pkg.slice.greedy_order_slices(profs, dev, edges=edges,
                                                policy=None)
            assert _round_names(res.schedule) == _round_names(ref)
            assert res.sliced == {} and res.passes == 0
            eids = pkg.graph.KernelGraph(profs, edges).edges_by_id()
            t_ref = pkg.graph.DagEventSimulator(dev, eids).simulate(
                ref.order)
            t_res = pkg.graph.DagEventSimulator(
                dev, res.edges_by_id()).simulate(res.order)
            assert t_res == t_ref
            out.append((_round_names(res.schedule), t_res))
        return out
    _both(case)


def test_factor1_identity_untriggered_policy():
    def case(pkg):
        rng = random.Random(29)
        dev, out = _tpu(pkg), []
        for _ in range(10):
            n = rng.randint(2, 16)
            profs = [it.profile() for it in
                     _tpu_items(pkg, rng, n, oversized_frac=0.0)]
            edges = _random_dag_edges(rng, n, 0.8)
            ref = pkg.graph.greedy_order_dag(profs, dev, edges=edges)
            res = pkg.slice.greedy_order_slices(
                profs, dev, edges=edges, policy=pkg.slice.SlicePolicy())
            assert _round_names(res.schedule) == _round_names(ref)
            assert res.passes == 0
            out.append(_round_names(res.schedule))
        return out
    _both(case)


# --------------------------------------------------------------------------
# gated simulator: joins + saturating profiles
# --------------------------------------------------------------------------

def _diamond(pkg, tail: bool):
    S, dev = pkg.slice, _tpu(pkg)
    prof = pkg.tpu.prefill_profile("r0:p:L0", n_params=7e9, seq_len=8192,
                                   kv_bytes_per_token=131072).profile()
    parts = S.KernelSlicer(S.SlicePolicy(mode="fixed", fixed_k=2),
                           dev).slice_profile(prof, 2)
    ks, edges = [prof], set()
    if tail:
        ks.append(pkg.tpu.decode_profile(
            "r0:d:L1", n_params=7e9, kv_len=4096,
            kv_bytes_per_token=131072).profile())
        edges = {(0, 1)}
    exp = S.expand_nodes(ks, edges, {0: (parts, S.join_profile(prof))})
    g = pkg.graph.KernelGraph(exp.kernels, exp.edges)
    return dev, prof, parts, ks, exp, g


def test_join_markers_add_no_gated_time():
    def case(pkg):
        dev, prof, _, _, exp, g = _diamond(pkg, tail=False)
        t_un = pkg.graph.DagEventSimulator(dev, set()).simulate([prof])
        t_sl = pkg.graph.DagEventSimulator(
            dev, g.edges_by_id()).simulate(exp.kernels)
        assert t_sl == pytest.approx(t_un, rel=1e-9)
        return t_un, t_sl
    _both(case)


def test_sliced_makespan_no_worse_on_saturating_profiles():
    def case(pkg):
        rng = random.Random(31)
        dev, out, wins = _tpu(pkg), [], 0
        for _ in range(12):
            n = rng.randint(6, 18)
            items = _tpu_items(pkg, rng, n, oversized_frac=0.35)
            if not any(it.tokens > 4096 for it in items):
                continue
            profs = [it.profile() for it in items]
            un = pkg.graph.greedy_order_dag(profs, dev)
            t_un = pkg.graph.DagEventSimulator(dev, set()).simulate(
                un.order)
            res = pkg.slice.greedy_order_slices(
                profs, dev, policy=pkg.slice.SlicePolicy())
            t_sl = pkg.graph.DagEventSimulator(
                dev, res.edges_by_id()).simulate(res.order)
            assert t_sl <= t_un * (1 + 1e-9)
            wins += t_sl < t_un * (1 - 1e-6)
            out.append((t_un, t_sl, res.sliced))
        assert wins >= 3
        return out
    _both(case)


def test_zero_work_join_requires_drained_predecessors():
    def case(pkg):
        dev, _, parts, ks, exp, g = _diamond(pkg, tail=True)
        sim = pkg.graph.DagEventSimulator(dev, g.edges_by_id())
        t_chain = sim.simulate(exp.kernels)
        solo = pkg.graph.DagEventSimulator(dev, set())
        t_parts = solo.simulate(parts) + solo.simulate([ks[1]])
        assert t_chain == pytest.approx(t_parts, rel=1e-9)
        bad = [exp.kernels[i] for i in (exp.join_of[0], *exp.new_of[0])] \
            + [ks[1]]
        with pytest.raises(ValueError):
            sim.simulate(bad)
        return t_chain, t_parts
    _both(case)


def _sliced_workload(pkg, rng: random.Random, dev):
    """The reference's ``test_gated_delta`` sliced workload: oversized
    prefills beside decodes on random edges, cut by the default
    policy."""
    n = rng.randint(6, 14)
    profs = [it.profile() for it in
             _tpu_items(pkg, rng, n, oversized_frac=0.4)]
    edges = _random_dag_edges(rng, n, rng.uniform(0.3, 1.2))
    return pkg.slice.greedy_order_slices(profs, dev, edges=edges,
                                         policy=pkg.slice.SlicePolicy())


def test_gated_delta_slice_join_graphs_exact():
    """Delta evaluation and checkpoint resume stay exact through the
    zero-work joins of sliced workloads, with the same times in both
    packages."""
    def case(pkg):
        rng = random.Random(17)
        dev, out = _tpu(pkg), []
        while len(out) < 4:
            sl = _sliced_workload(pkg, rng, dev)
            if not sl.sliced:
                continue
            eids, order = sl.edges_by_id(), sl.order
            n = len(order)
            ref = pkg.graph.DagEventSimulator(dev, eids)
            t_full = ref.simulate(order)
            t_fast, fck = pkg.fast_gated(dev, eids).simulate(order,
                                                             record=True)
            assert t_fast == t_full
            for p in (0, n // 3, n // 2, n - 1):
                assert ref.simulate(order, start_state=fck[p]) == t_full
            ev = pkg.graph.GatedDeltaEvaluator(dev, eids)
            row = [ev.rebase(order)]
            for _ in range(25):
                i, j = rng.randrange(n), rng.randrange(n)
                if i == j:
                    continue
                cand = list(order)
                cand[i], cand[j] = cand[j], cand[i]
                if ev.legal(cand):
                    t = ev.evaluate(cand, min(i, j))
                    assert t == ref.simulate(cand)
                    row.append(t)
            out.append((_sliced(sl), row))
        return out
    _both(case)


def test_refine_order_slices_gated_never_worse_and_exact():
    def case(pkg):
        rng = random.Random(29)
        dev = _tpu(pkg, n_units=4)
        sl = _sliced_workload(pkg, rng, dev)
        sim = pkg.graph.DagEventSimulator(dev, sl.edges_by_id())
        t_sl = sim.simulate(sl.order)
        order, t, evals = pkg.slice.refine_order_slices(
            sl, dev, budget=40, model="gated", neighborhood="adjacent")
        assert sl.graph().is_topological(order)
        assert t <= t_sl + 1e-15 and t == sim.simulate(order)
        return [k.name for k in order], t, evals
    _both(case)


def test_sliced_chain_dag_n256_sweep():
    """The reference's chain-structured sweep (64 chains, oversized
    stages), at 256 nodes: topological, sliced, no worse than unsliced,
    and the same schedule in both packages."""
    def case(pkg):
        rng = random.Random(37)
        dev = _tpu(pkg)
        profs = [it.profile() for it in
                 _tpu_items(pkg, rng, 256, oversized_frac=0.1)]
        edges, chains = set(), [[] for _ in range(64)]
        for i in range(256):
            c = chains[rng.randrange(64)]
            if c:
                edges.add((c[-1], i))
            c.append(i)
        res = pkg.slice.greedy_order_slices(profs, dev, edges=edges,
                                            policy=pkg.slice.SlicePolicy())
        assert res.graph().is_topological(res.order) and res.sliced
        un = pkg.graph.greedy_order_dag(profs, dev, edges=edges)
        eids = pkg.graph.KernelGraph(profs, edges).edges_by_id()
        t_un = pkg.graph.DagEventSimulator(dev, eids).simulate(un.order)
        t_sl = pkg.graph.DagEventSimulator(
            dev, res.edges_by_id()).simulate(res.order)
        assert t_sl <= t_un * (1 + 1e-9)
        return _round_names(res.schedule), res.sliced, t_un, t_sl
    _both(case)


# --------------------------------------------------------------------------
# coalescing
# --------------------------------------------------------------------------

def _work_mass(ks):
    inst = sum(k.inst_per_block * k.n_blocks for k in ks)
    dims = {d for k in ks for d in k.demands}
    return inst, {d: sum(k.demands.get(d, 0.0) * k.n_blocks for k in ks)
                  for d in dims}


def test_merge_slice_profiles_full_merge_restores_parent():
    def case(pkg):
        rng = random.Random(61)
        S, out = pkg.slice, []
        for prof in _gpu_kernels(pkg, rng, 6):
            sl = S.KernelSlicer(S.SlicePolicy(mode="fixed", fixed_k=3),
                                pkg.core.GTX580)
            merged = S.merge_slice_profiles(sl.slice_profile(prof, 3))
            assert merged.name == prof.name and not S.is_slice(merged.name)
            (i0, d0), (i1, d1) = _work_mass([prof]), _work_mass([merged])
            assert i1 == pytest.approx(i0, rel=1e-12)
            assert all(d1[d] == pytest.approx(d0[d], rel=1e-12) for d in d0)
            out.append(_t(merged))
        return out
    _both(case)


def test_merge_slice_profiles_partial_naming_roundtrip():
    def case(pkg):
        rng = random.Random(62)
        S = pkg.slice
        prof = _gpu_kernels(pkg, rng, 1)[0]
        parts = S.KernelSlicer(S.SlicePolicy(mode="fixed", fixed_k=4),
                               pkg.core.GTX580).slice_profile(prof, 4)
        merged = S.merge_slice_profiles([parts[1], parts[3]])
        assert S.is_slice(merged.name)
        assert S.parent_name(merged.name) == prof.name
        assert S.slice_indices(merged.name) == ([1, 3], 4)
        done = S.merge_slice_profiles([merged, parts[0], parts[2]])
        assert done.name == prof.name and done.n_blocks == prof.n_blocks
        return _t(merged), _t(done)
    _both(case)


def test_merge_slice_profiles_mass_slices_conserve_totals():
    def case(pkg):
        S, dev = pkg.slice, _tpu(pkg)
        prof = pkg.tpu.prefill_profile("r0:p:L0", n_params=7e9,
                                       seq_len=8192,
                                       kv_bytes_per_token=131072).profile()
        parts = S.KernelSlicer(S.SlicePolicy(mode="fixed", fixed_k=2),
                               dev).slice_profile(prof, 2)
        merged = S.merge_slice_profiles(parts)
        (i0, d0), (i1, d1) = _work_mass([prof]), _work_mass([merged])
        assert i1 == pytest.approx(i0, rel=1e-12)
        assert all(d1[d] == pytest.approx(d0[d], rel=1e-12) for d in d0)
        return _t(merged)
    _both(case)


def test_merge_slice_profiles_rejects_bad_groups():
    for pkg in (_REF, _PORT):
        S = pkg.slice
        a, b = _gpu_kernels(pkg, random.Random(63), 2)
        sl = S.KernelSlicer(S.SlicePolicy(mode="fixed", fixed_k=2),
                            pkg.core.GTX580)
        pa, pb = sl.slice_profile(a, 2), sl.slice_profile(b, 2)
        for group in ([pa[0], pb[1]], [pa[0], pa[0]], []):
            with pytest.raises(ValueError):
                S.merge_slice_profiles(group)


def test_coalesce_rounds_conserves_and_keeps_makespan():
    def case(pkg):
        rng = random.Random(64)
        dev, out = _tpu(pkg), []
        for _ in range(6):
            profs = [it.profile() for it in _tpu_items(
                pkg, rng, rng.randint(8, 16), oversized_frac=0.9)]
            res = pkg.slice.greedy_order_slices(
                profs, dev, policy=pkg.slice.SlicePolicy(
                    mode="round_fill", target_fill=0.2))
            co = pkg.slice.coalesce_rounds(res)
            (i0, d0), (i1, d1) = (_work_mass(res.kernels),
                                  _work_mass(co.kernels))
            assert i1 == pytest.approx(i0, rel=1e-12)
            assert all(d1[d] == pytest.approx(d0.get(d, 0.0), rel=1e-12)
                       for d in d0)
            assert co.graph().is_topological(co.order)
            t0 = pkg.graph.DagEventSimulator(
                dev, res.edges_by_id()).simulate(res.order)
            t1 = pkg.graph.DagEventSimulator(
                dev, co.edges_by_id()).simulate(co.order)
            assert t1 == pytest.approx(t0, rel=1e-9)
            names = {k.name for k in co.kernels}
            S = pkg.slice
            for k in co.kernels:            # no orphan joins left
                if S.is_join(k.name):
                    assert any(S.is_slice(nm) and not S.is_join(nm) and
                               S.parent_name(nm) == S.parent_name(k.name)
                               for nm in names)
            out.append((len(res.kernels), len(co.kernels), _sliced(co),
                        t0, t1))
        return out
    assert any(n_co < n_res for n_res, n_co, *_ in _both(case))


def test_coalesce_rounds_noop_when_siblings_spread():
    def case(pkg):
        rng = random.Random(65)
        profs = [it.profile() for it in
                 _tpu_items(pkg, rng, 10, oversized_frac=0.35)]
        res = pkg.slice.greedy_order_slices(
            profs, _tpu(pkg), policy=pkg.slice.SlicePolicy())
        co = pkg.slice.coalesce_rounds(res)
        return co is res, _sliced(co)
    _both(case)


# --------------------------------------------------------------------------
# the composer's sliced branches and the engine (smoke, f32)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _model(arch: str):
    cfg_ref = ref_configs.get_config(arch, "smoke").replace(dtype="float32")
    cfg = pt_configs.get_config(arch, "smoke").replace(dtype="float32")
    params = jax.jit(lambda key: RT.init(key, cfg_ref))(jax.random.PRNGKey(0))
    port = interop.params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                     device="cpu")
    return {"ref": (cfg_ref, params), "port": (cfg, port)}


def _engine(pkg, arch, policy, device):
    cfg, params = _model(arch)[pkg.name]
    return pkg.serve.ServingEngine(cfg, params, max_len=64, policy=policy,
                                   device=device)


def _requests(pkg, n=3, size=8):
    rng = np.random.default_rng(0)
    return [pkg.serve.Request(i, rng.integers(0, 512, size=size),
                              max_new_tokens=4) for i in range(n)]


def _served(s):
    """The parts of ``run()`` that must be bit-equal across packages."""
    return (s["rounds"], s["modelled_time_s"], s["schedule_cache"],
            s["outputs"])


def _labels(rounds):
    return [[(t[0].name, t[2]) for t in rd] for rd in rounds]


@pytest.mark.parametrize("arch", _ARCHS)
def test_serving_tokens_bit_identical_with_slice_policy(arch):
    """A shrunken slot budget makes the 8-token prefill stages oversized,
    so slicing triggers; the rounds, modelled time and counters are the
    reference's, the tokens the unsliced path's."""
    def case(pkg):
        dev = _tpu(pkg, token_budget=6)
        out = []
        for sp in (None, pkg.slice.SlicePolicy()):
            eng = _engine(pkg, arch, pkg.serve.SchedulerPolicy(
                kind="symbiotic", respect_deps=True, slice_policy=sp), dev)
            eng.submit(_requests(pkg))
            out.append(_served(eng.run()))
        return out
    base, sliced = _both(case)
    assert sliced[3] == base[3]
    assert all(len(v) >= 4 for v in sliced[3].values())


def test_serving_gated_guard_token_identity():
    def case(pkg):
        S = pkg.serve.SchedulerPolicy
        dev = _tpu(pkg, token_budget=6)
        out = []
        for kw in (dict(slice_policy=pkg.slice.SlicePolicy()),
                   dict(slice_policy=pkg.slice.SlicePolicy(),
                        dag_guard="gated"),
                   dict(dag_guard="gated")):
            eng = _engine(pkg, "qwen1.5-0.5b",
                          S(kind="symbiotic", respect_deps=True, **kw), dev)
            eng.submit(_requests(pkg))
            out.append(_served(eng.run()))
        return out
    out = _both(case)
    assert out[0][3] == out[1][3] == out[2][3]


def _hand_cut(pkg, eng):
    """The first request's head stage cut into a slice diamond, as the
    composer's ``mk_slices`` closure would."""
    triples, traced = eng._work_items_dag()
    it0, r0, kind0 = triples[0]
    S = pkg.slice
    parts = S.KernelSlicer(S.SlicePolicy(mode="fixed", trigger_frac=0.0,
                                         fixed_k=2),
                           eng.device).slice_item(it0, 2)
    assert len(parts) == 2
    ji = S.join_item(it0)
    rest = [[trip] for trip in triples[1:]]
    good = [[(parts[0], r0, "frag"), (parts[1], r0, "frag")],
            [(ji, r0, kind0)]] + rest
    bad = [[(ji, r0, kind0)],
           [(parts[0], r0, "frag"), (parts[1], r0, "frag")]] + rest
    return traced, good, bad


def test_serving_gated_guard_scores_sliced_composition():
    """``_dag_gated_time`` on the port's engine: finite on a composition
    whose first stage was cut into slices and a join, ``inf`` when the
    join launches before its slices; the reference's numbers."""
    def case(pkg):
        eng = _engine(pkg, "qwen1.5-0.5b", pkg.serve.SchedulerPolicy(
            kind="symbiotic", respect_deps=True,
            slice_policy=pkg.slice.SlicePolicy(), dag_guard="gated",
            cache=False), _tpu(pkg, token_budget=6))
        eng.submit(_requests(pkg))
        traced, good, bad = _hand_cut(pkg, eng)
        return eng._dag_gated_time(good, traced), \
            eng._dag_gated_time(bad, traced)
    t, t_bad = _both(case)
    assert 0.0 < t < float("inf") and t_bad == float("inf")


@pytest.mark.parametrize("arch", _ARCHS)
def test_gated_guard_unlocks_slicing_win_round_guard_hides(arch):
    """``_compose_dag`` on the port's engine: the round guard serves
    unsliced fifo, the gated guard accepts the slices at a strictly
    better gated makespan — the reference's rounds and times."""
    def case(pkg):
        dev = _tpu(pkg, token_budget=6)
        out = {}
        for guard in ("rounds", "gated"):
            eng = _engine(pkg, arch, pkg.serve.SchedulerPolicy(
                kind="symbiotic", respect_deps=True,
                slice_policy=pkg.slice.SlicePolicy(), dag_guard=guard,
                cache=False), dev)
            rng = np.random.default_rng(0)
            R = pkg.serve.Request
            eng.submit([R(i, rng.integers(0, 512, size=12),
                          max_new_tokens=4) for i in range(2)] +
                       [R(10 + i, rng.integers(0, 512, size=2),
                          max_new_tokens=6) for i in range(6)])
            triples, traced = eng._work_items_dag()
            rounds = eng._compose_dag(triples, traced)
            out[guard] = (_labels(rounds),
                          eng._dag_gated_time(rounds, traced))
        return out
    out = _both(case)
    n_slices = {g: sum("#s" in nm for rd in v[0] for nm, _ in rd)
                for g, v in out.items()}
    if arch == "qwen1.5-0.5b":
        assert n_slices["rounds"] == 0 < n_slices["gated"]
        assert out["gated"][1] < out["rounds"][1]


def test_serving_refine_model_gated_runs():
    def case(pkg):
        dev = _tpu(pkg)
        out = []
        for kw in (dict(kind="symbiotic"),
                   dict(kind="refined", refine_model="gated",
                        refine_budget=20, dag_guard="gated",
                        slice_policy=pkg.slice.SlicePolicy())):
            eng = _engine(pkg, "qwen1.5-0.5b", pkg.serve.SchedulerPolicy(
                respect_deps=True, **kw), dev)
            eng.submit(_requests(pkg))
            out.append(_served(eng.run()))
        return out
    base, refined = _both(case)
    assert refined[3] == base[3]


@pytest.mark.parametrize("arch", _ARCHS)
def test_serving_dag_cache_warms_up(arch):
    def case(pkg):
        eng = _engine(pkg, arch, pkg.serve.SchedulerPolicy(
            kind="symbiotic", respect_deps=True,
            slice_policy=pkg.slice.SlicePolicy()), _tpu(pkg))
        eng.submit(_requests(pkg))
        return _served(eng.run())
    stats = _both(case)[2]
    assert stats["dag_hits"] >= 1 and stats["hits"] == stats["dag_hits"]


def test_dag_replay_reproduces_cold_composition():
    def case(pkg):
        eng = _engine(pkg, "qwen1.5-0.5b", pkg.serve.SchedulerPolicy(
            kind="symbiotic", respect_deps=True), _tpu(pkg))
        eng.submit(_requests(pkg))
        cold = eng._compose_dag(*eng._work_items_dag())
        warm = eng._compose_dag(*eng._work_items_dag())
        assert eng.schedule_cache.dag_hits == 1
        assert _labels(warm) == _labels(cold)
        return _labels(cold)
    _both(case)


def test_sliced_dag_replay_recuts_cached_slice_counts():
    """A cached sliced pattern replays onto the same step by re-cutting
    each stage with the cached slice count (``dag_apply_pattern``'s
    sliced branch): the cold composition, round for round, in both
    packages."""
    def case(pkg):
        eng = _engine(pkg, "qwen1.5-0.5b", pkg.serve.SchedulerPolicy(
            kind="symbiotic", respect_deps=True, dag_guard="gated",
            slice_policy=pkg.slice.SlicePolicy()),
            _tpu(pkg, token_budget=6))
        R = pkg.serve.Request
        rng = np.random.default_rng(0)
        eng.submit([R(i, rng.integers(0, 512, size=12), max_new_tokens=4)
                    for i in range(2)] +
                   [R(10 + i, rng.integers(0, 512, size=2),
                      max_new_tokens=6) for i in range(6)])
        triples, traced = eng._work_items_dag()
        cold = eng._compose_dag(triples, traced)
        key, labels = eng._dag_key_and_labels(triples, traced)
        pattern = eng.schedule_cache.lookup(key, namespace="dag")
        replay = eng.composer.dag_apply_pattern(pattern, triples, labels)
        warm = eng._compose_dag(*eng._work_items_dag())
        assert any("#s" in t[0].name for rd in cold for t in rd)
        assert _labels(replay) == _labels(cold) == _labels(warm)
        assert [eng._dag_round_time(rd) for rd in replay] == \
            [eng._dag_round_time(rd) for rd in cold]
        return _labels(warm), eng.schedule_cache.stats()
    assert _both(case)[1]["dag_hits"] == 1


def test_replay_drift_triggers_revalidation():
    def case(pkg):
        eng = _engine(pkg, "qwen1.5-0.5b", pkg.serve.SchedulerPolicy(
            kind="symbiotic", respect_deps=True, replay_drift_tol=0.05),
            _tpu(pkg))
        eng.submit(_requests(pkg))
        triples, traced = eng._work_items_dag()
        eng._compose_dag(triples, traced)
        key, _ = eng._dag_key_and_labels(triples, traced)
        cache = eng.schedule_cache
        t0 = cache.time_of(key)
        assert t0 is not None and t0 > 0
        cache._times[key] = t0 * 2.0
        eng._compose_dag(*eng._work_items_dag())
        assert cache.replay_revalidations == 1
        assert cache.time_of(key) == pytest.approx(t0)
        cache._times[key] = t0 * 2.0
        eng.policy.replay_drift_tol = 0.0
        eng._compose_dag(*eng._work_items_dag())
        assert cache.replay_revalidations == 1
        return t0, cache.stats()
    _both(case)
