"""The port's dependency-aware composition (``repro_torch.graph``, the
composer's DAG path, the engine's ``respect_deps``, ``audit_dag``)
against the JAX reference, on the CPU.

The DAG path is host NumPy in float64, copied from the reference apart
from its import paths, so everything here is bit-equal: orders, rounds,
makespans, traced work items, audit verdicts, engine rounds, modelled
times and cache counters.  Served tokens equal the reference's and the
port's own flat path's (the reference's
``test_system.py::test_serving_respect_deps_matches_flat_tokens``, which
its mesh caveat keeps from running)."""

import dataclasses
import functools
import random

import jax
import numpy as np
import pytest

import repro.configs as ref_configs
import repro.core as RC
import repro.core.resources as RRes
import repro.core.tpu as RTPU
import repro.graph as RG
from repro.dist.context import set_activation_axes
from repro.graph.delta import _FastGatedSim as RFastGated
from repro.models import transformer as RT
from repro.obs import MetricsRegistry as RMetrics
from repro.serve import Composer as RComposer
from repro.serve import Request as RRequest
from repro.serve import ScheduleCache as RCache
from repro.serve import SchedulerPolicy as RPolicy
from repro.serve import ServingEngine as REngine
from repro.serve import build_dag_triples as r_build_dag_triples

import repro_torch.configs as pt_configs
import repro_torch.core as PC
import repro_torch.core.resources as PRes
import repro_torch.core.tpu as PTPU
import repro_torch.graph as PG
from repro_torch import interop
from repro_torch.graph.delta import _FastGatedSim as PFastGated
from repro_torch.obs import MetricsRegistry as PMetrics
from repro_torch.serve import (Composer, Request, ScheduleCache,
                               SchedulerPolicy, ServingEngine,
                               build_dag_triples)
from torch_threads import one_torch_thread  # noqa: F401

_ARCHS = ("qwen1.5-0.5b", "mixtral-8x7b", "deepseek-v2-236b")

#: one side of a comparison: a package's names under common keys
_REF = dict(core=RC, res=RRes, tpu=RTPU, graph=RG, fast_gated=RFastGated,
            configs=ref_configs, composer=RComposer, cache=RCache,
            policy=RPolicy, request=RRequest, metrics=RMetrics,
            build=r_build_dag_triples)
_PORT = dict(core=PC, res=PRes, tpu=PTPU, graph=PG, fast_gated=PFastGated,
             configs=pt_configs, composer=Composer, cache=ScheduleCache,
             policy=SchedulerPolicy, request=Request, metrics=PMetrics,
             build=build_dag_triples)


@pytest.fixture(autouse=True)
def _no_mesh():
    """A mesh left bound by another test on this worker (the reference's
    train() never clears its activation axes) would break the reference
    engine."""
    set_activation_axes()
    yield


# --------------------------------------------------------------------------
# Seeded workloads, built the same way in either package
# --------------------------------------------------------------------------

def _gpu_kernels(pkg, rng: random.Random, n: int):
    fams = [pkg["res"].ep_kernel, pkg["res"].bs_kernel, pkg["res"].es_kernel,
            pkg["res"].sw_kernel]
    return [rng.choice(fams)(f"k{i}",
                             grid=rng.choice([8, 16, 32, 48, 64, 96]),
                             shm=rng.choice([0, 4096, 8192, 16384, 24576]),
                             inst=rng.uniform(1e6, 5e8))
            for i in range(n)]


def _tpu_profiles(pkg, rng: random.Random, n: int):
    tpu = pkg["tpu"]
    items = []
    for i in range(n):
        if rng.random() < 0.4:
            items.append(tpu.prefill_profile(
                f"p{i}", n_params=7e9,
                seq_len=rng.choice([128, 256, 512, 1024]),
                kv_bytes_per_token=131072))
        else:
            items.append(tpu.decode_profile(
                f"d{i}", n_params=7e9, kv_len=rng.randint(1, 8192),
                kv_bytes_per_token=131072))
    return [it.profile() for it in items]


def _random_dag_edges(rng: random.Random, n: int,
                      density: float = 1.0) -> set:
    """Random forward edges (u < v): acyclic by construction."""
    edges = set()
    for _ in range(int(density * n)):
        u, v = rng.randrange(n), rng.randrange(n)
        if u != v:
            edges.add((min(u, v), max(u, v)))
    return edges


_DEVICES = ["gtx580", "tpu", "tpu4"]


def _workload(pkg, device: str, seed: int):
    """(device model, graph, a random topological order, rng) drawn from
    ``seed``: the same kernels, edges and order in either package."""
    rng = random.Random(seed)
    n = rng.randint(3, 20)
    if device == "gtx580":
        dev, ks = pkg["core"].GTX580, _gpu_kernels(pkg, rng, n)
    else:
        dev = pkg["tpu"].make_serving_device(
            **({"n_units": 4} if device == "tpu4" else {}))
        ks = _tpu_profiles(pkg, rng, n)
    g = pkg["graph"].KernelGraph(ks, _random_dag_edges(
        rng, n, rng.uniform(0.0, 2.0)))
    return dev, g, g.random_topological_order(rng), rng


def _names(rounds):
    return [[k.name for k in rd] for rd in rounds]


# --------------------------------------------------------------------------
# repro_torch.graph: bit-equal to repro.graph
# --------------------------------------------------------------------------

@pytest.mark.parametrize("device", _DEVICES)
@pytest.mark.parametrize("seed", range(6))
def test_greedy_order_dag_bit_identical(device, seed):
    """The ready-set greedy's rounds and order, with and without edges
    (without, it is Algorithm 1's fast greedy)."""
    out = {}
    for side, pkg in (("ref", _REF), ("port", _PORT)):
        dev, g, _, _ = _workload(pkg, device, seed)
        sched = pkg["graph"].greedy_order_dag(g.kernels, dev, edges=g.edges)
        free = pkg["graph"].greedy_order_dag(g.kernels, dev)
        assert g.is_topological(sched.order)
        assert _names([rd.kernels for rd in free.rounds]) == _names(
            [rd.kernels for rd in pkg["core"].greedy_order_fast(
                g.kernels, dev).rounds])
        out[side] = (_names([rd.kernels for rd in sched.rounds]),
                     _names([rd.kernels for rd in free.rounds]))
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("model", ["event", "round", "gated"])
@pytest.mark.parametrize("device", _DEVICES)
@pytest.mark.parametrize("seed", range(3))
def test_refine_order_dag_bit_identical(model, device, seed):
    """The precedence-respecting local search: the same order, the same
    time and the same number of evaluations, under each model, with the
    batched evaluator too where it applies."""
    backends = [None, 16] if model in ("event", "round") else [None]
    for batch in backends:
        out = {}
        for side, pkg in (("ref", _REF), ("port", _PORT)):
            dev, g, _, _ = _workload(pkg, device, seed)
            sched = pkg["graph"].greedy_order_dag(g.kernels, dev,
                                                  edges=g.edges)
            order, t, evals = pkg["graph"].refine_order_dag(
                sched.order, dev, edge_ids=g.edges_by_id(), model=model,
                budget=40, neighborhood="full", batch_size=batch)
            assert g.is_topological(order)
            out[side] = ([k.name for k in order], t, evals)
        assert out["port"] == out["ref"], batch


@pytest.mark.parametrize("device", _DEVICES)
@pytest.mark.parametrize("seed", range(4))
def test_gated_simulator_and_fifo_rounds_dag_bit_identical(device, seed):
    """The gated makespan of random topological orders (and of their
    checkpoint resumes), and the dependency-aware arrival-order
    packing."""
    out = {}
    for side, pkg in (("ref", _REF), ("port", _PORT)):
        dev, g, order, rng = _workload(pkg, device, seed)
        eids = g.edges_by_id()
        sim = pkg["graph"].DagEventSimulator(dev, eids)
        times = [sim.simulate(o) for o in
                 [order] + g.random_topological_orders(4, seed=seed)]
        t_fast, ck = pkg["fast_gated"](dev, eids).simulate(order,
                                                          record=True)
        resumed = [sim.simulate(order, start_state=ck[p])
                   for p in range(0, len(order), 3)]
        rounds = pkg["graph"].fifo_rounds_dag(
            order, dev, eids, demands_of=lambda k: k.demands)
        out[side] = (times, t_fast, resumed, _names(rounds))
    assert out["port"] == out["ref"]
    assert out["port"][1] == out["port"][0][0]


@pytest.mark.parametrize("device", _DEVICES)
@pytest.mark.parametrize("seed", range(4))
def test_gated_delta_bit_identical(device, seed):
    """Delta evaluation from the first divergence equals the full gated
    re-simulation in both packages, with equal costed fractions."""
    out = {}
    for side, pkg in (("ref", _REF), ("port", _PORT)):
        dev, g, order, rng = _workload(pkg, device, seed)
        eids = g.edges_by_id()
        ev = pkg["graph"].GatedDeltaEvaluator(dev, eids)
        base = ev.rebase(order)
        full = pkg["graph"].DagEventSimulator(dev, eids)
        n = len(order)
        rows = []
        for _ in range(30):
            i, j = rng.randrange(n), rng.randrange(n)
            if i == j:
                continue
            cand = list(order)
            cand.insert(j, cand.pop(i))
            if not ev.legal(cand):
                rows.append(None)
                continue
            t, frac = ev.evaluate_costed(cand, min(i, j))
            assert t == full.simulate(cand)
            rows.append((t, frac))
        out[side] = (base, rows)
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("seed", range(3))
def test_assign_streams_bit_identical(seed):
    out = {}
    for side, pkg in (("ref", _REF), ("port", _PORT)):
        dev, g, _, _ = _workload(pkg, "tpu", seed)
        sched = pkg["graph"].greedy_order_dag(g.kernels, dev, edges=g.edges)
        sa = pkg["graph"].assign_streams(sched, g.edges_by_id(), k=3)
        out[side] = [[k.name for k in s] for s in sa.streams]
    assert out["port"] == out["ref"]


def _chain(pkg, rng: random.Random, tag: str, n: int):
    """One request-like chain: a prefill head and decode stages."""
    out = []
    for i in range(n):
        if i == 0 and rng.random() < 0.5:
            it = pkg["tpu"].prefill_profile(
                f"{tag}:p{i}", n_params=7e9,
                seq_len=rng.choice([128, 256, 512]),
                kv_bytes_per_token=131072)
        else:
            it = pkg["tpu"].decode_profile(
                f"{tag}:d{i}", n_params=7e9, kv_len=rng.randint(1, 4096),
                kv_bytes_per_token=131072)
        out.append(it.profile())
    return out


@pytest.mark.parametrize("seed", range(6))
def test_greedy_frontier_bit_identical(seed):
    """The frontier sink of the ready-set greedy, then a chain inserted,
    the same chain retired, drifted profiles refreshed and another chain
    inserted: the rounds after every step (the reference's test_live
    mechanics, port against reference)."""
    out = {}
    for side, pkg in (("ref", _REF), ("port", _PORT)):
        rng = random.Random(seed)
        dev = pkg["tpu"].make_serving_device()
        profs, edges = [], set()
        for c in range(rng.randint(2, 6)):
            chain = _chain(pkg, rng, f"r{c}", rng.randint(1, 4))
            edges |= {(len(profs) + i, len(profs) + i + 1)
                      for i in range(len(chain) - 1)}
            profs.extend(chain)
        f = pkg["graph"].constrained.GreedyFrontier(dev)
        sched = pkg["graph"].greedy_order_dag(profs, dev, edges=edges,
                                              frontier=f)
        assert f.round_names() == [rd.names for rd in sched.rounds]
        steps = [f.round_names()]
        new = _chain(pkg, rng, "rx", 3)
        f.insert_chain(new)
        steps.append(f.round_names())
        f.remove({q.name for q in new})
        steps.append(f.round_names())
        f.refresh({q.name: pkg["tpu"].decode_profile(
            q.name, n_params=7e9, kv_len=4097,
            kv_bytes_per_token=131072).profile()
            for q in profs if q.name.split(":")[1].startswith("d")})
        f.insert_chain(_chain(pkg, rng, "ry", 2))
        steps.append(f.round_names())
        out[side] = steps
    assert out["port"] == out["ref"]


def _traced_fields(tw):
    return ([dataclasses.astuple(it) for it in tw.items],
            [dataclasses.astuple(p) for p in tw.graph.kernels],
            sorted(tw.graph.edges), tw.owners, tw.tail_of)


@pytest.mark.parametrize("max_stages", [None, 4, 6])
@pytest.mark.parametrize("variant", ["smoke", "full"])
@pytest.mark.parametrize("arch", _ARCHS)
def test_trace_arch_bit_identical(arch, variant, max_stages):
    """trace_arch's chains, shares and coarsening, the parameter estimate
    it normalises by and the KV bytes per token, on the three traced
    archs; with n_params from the estimate and from a model count."""
    specs = (("prefill", 64), ("decode", 128), ("decode", 1024),
             ("prefill", 16))
    out = {}
    for side, pkg in (("ref", _REF), ("port", _PORT)):
        cfg = pkg["configs"].get_config(arch, variant)
        kg = pkg["graph"].kernel_graph
        est = kg.estimate_n_params(cfg)
        kvb = kg.arch_kv_bytes_per_token(cfg)
        tws = [pkg["graph"].trace_arch(cfg, specs, max_stages=max_stages),
               pkg["graph"].trace_arch(cfg, specs, n_params=1.2345e9,
                                       kv_bytes_per_token=kvb,
                                       max_stages=max_stages),
               pkg["graph"].trace_arch(cfg, max_stages=max_stages)]
        for tw in tws:
            tw.graph.validate()
            if max_stages is not None:
                assert max(tw.owners.count(r) for r in set(tw.owners)) <= \
                    max_stages
        out[side] = (est, kvb, [_traced_fields(tw) for tw in tws])
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("arch", _ARCHS)
def test_estimate_matches_engine_kv_bytes(arch):
    """arch_kv_bytes_per_token mirrors the engine's own, and the engine's
    n_params (a count of the model) is what the traced step is scaled
    to, in both packages alike."""
    cfg = pt_configs.get_config(arch, "smoke")
    from repro_torch.models import transformer as PT
    eng = ServingEngine(cfg, PT.init(cfg, device="cpu"))
    assert (PG.kernel_graph.arch_kv_bytes_per_token(cfg)
            == eng._kv_bytes_per_token())
    cfg_ref = ref_configs.get_config(arch, "smoke")
    shapes = jax.eval_shape(lambda k: RT.init(k, cfg_ref),
                            jax.random.PRNGKey(0))
    assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes)) == \
        eng.n_params


# --------------------------------------------------------------------------
# The composer's DAG path and audit_dag
# --------------------------------------------------------------------------

_DECODED = object()   # a populated cache: build_dag_triples checks None


def _traced_step(pkg, arch, *, max_stages=8,
                 spec=(("prefill", 64), ("prefill", 32), ("decode", 128),
                       ("decode", 256), ("decode", 512))):
    cfg = pkg["configs"].get_config(arch, "full")
    kg = pkg["graph"].kernel_graph
    n_params = kg.estimate_n_params(cfg)
    reqs = []
    for rid, (phase, n) in enumerate(spec):
        r = pkg["request"](rid, np.zeros(n, np.int32))
        if phase == "decode":
            r.cache, r.pos = _DECODED, n
        reqs.append(r)
    triples, traced = pkg["build"](
        cfg, reqs, n_params=n_params,
        kv_bytes_per_token=kg.arch_kv_bytes_per_token(cfg),
        max_stages=max_stages)
    return n_params, triples, traced


def _composer(pkg, n_params, **kw):
    pol = pkg["policy"](respect_deps=True, audit_frac=1.0, audit_k=50,
                        **kw)
    cache = pkg["cache"](metrics=pkg["metrics"]())
    return pkg["composer"](pol, pkg["tpu"].make_serving_device(n_units=4),
                           2.0 * n_params, cache)


def _labels(rounds):
    return [[(t[0].name, t[2]) for t in rd] for rd in rounds]


_COMPOSE_CASES = [dict(kind="symbiotic", dag_guard="rounds"),
                  dict(kind="symbiotic", dag_guard="gated"),
                  dict(kind="fifo"),
                  dict(kind="refined", refine_model="gated",
                       dag_guard="gated", cache=False),
                  dict(kind="refined", refine_model="event",
                       refine_backend="batched", refine_batch=32)]


@pytest.mark.parametrize("case", range(len(_COMPOSE_CASES)))
@pytest.mark.parametrize("arch", _ARCHS)
def test_compose_dag_and_audit_dag_bit_identical(arch, case):
    """compose_dag on a traced full-width step (rounds, round times, the
    gated time), then the same step again (a cache replay where the
    cache is on), and audit_dag's verdict and counters."""
    kw = _COMPOSE_CASES[case]
    out = {}
    for side, pkg in (("ref", _REF), ("port", _PORT)):
        n_params, triples, traced = _traced_step(pkg, arch)
        comp = _composer(pkg, n_params, **kw)
        rounds = comp.compose_dag(triples, traced)
        again = comp.compose_dag(triples, traced)
        verdict = comp.auditor.audit_dag(rounds, traced, arch=arch,
                                         kind=kw["kind"])
        assert verdict is not None
        snap = comp.cache.metrics.snapshot()
        out[side] = (_labels(rounds), _labels(again),
                     [comp.dag_round_time(rd) for rd in rounds],
                     comp.dag_gated_time(rounds, traced),
                     {k: v for k, v in verdict.items()},
                     comp.cache.stats(),
                     {k: v for k, v in snap.items()
                      if not k.startswith("phase_")
                      and not k.endswith(("_s", ".sum"))})
    assert out["port"] == out["ref"]


def test_audit_dag_skips_unmappable_rounds():
    """A composition scored against another step's graph, or missing a
    round, is skipped with the reference's reason counters."""
    out = {}
    for side, pkg in (("ref", _REF), ("port", _PORT)):
        n_params, triples, traced = _traced_step(pkg, "qwen1.5-0.5b")
        comp = _composer(pkg, n_params, kind="symbiotic")
        rounds = comp.compose_dag(triples, traced)
        _, _, other = _traced_step(pkg, "qwen1.5-0.5b",
                                   spec=(("prefill", 48), ("decode", 192)))
        aud = comp.auditor
        got = (aud.audit_dag(rounds, other, arch="q", kind="s"),
               aud.audit_dag(rounds[:-1], traced, arch="q", kind="s"))
        snap = comp.cache.metrics.snapshot()
        out[side] = (got, snap["audit_skipped{reason=sliced}"],
                     snap["audit_skipped{reason=partial}"],
                     snap["audit_steps"])
    assert out["port"] == out["ref"] == ((None, None), 1.0, 1.0, 0.0)


# --------------------------------------------------------------------------
# The engine with respect_deps on the three traced archs (smoke, f32)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _model(arch: str):
    cfg_ref = ref_configs.get_config(arch, "smoke").replace(dtype="float32")
    cfg = pt_configs.get_config(arch, "smoke").replace(dtype="float32")
    params = RT.init(jax.random.PRNGKey(0), cfg_ref)
    port = interop.params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                     device="cpu")
    return cfg_ref, cfg, params, port


def _kernel_decode_sdpa(q, k, v, length_mask, *, scale):
    """The function the TPU decode kernel computes (f32 softmax weights,
    as the port's kernel keeps them), in ``decode_sdpa``'s signature."""
    from repro.kernels import ops as ref_ops
    del scale
    lengths = length_mask.sum(-1).astype(np.int32)
    return ref_ops.decode_attention(q, k, v, lengths, interpret=True)


def _scenario(req_cls, cfg):
    rng = np.random.default_rng(0)
    reqs = [req_cls(i, rng.integers(0, cfg.vocab, size=4 + 2 * i),
                    max_new_tokens=5) for i in range(3)]
    return reqs, [(2, [req_cls(10, rng.integers(0, cfg.vocab, size=4),
                               max_new_tokens=4)])]


def _run(eng, req_cls, cfg):
    reqs, arr = _scenario(req_cls, cfg)
    eng.submit(reqs)
    return eng.run(arrivals=arr)


@pytest.mark.parametrize("max_stages", [None, 4])
@pytest.mark.parametrize("guard", ["rounds", "gated"])
@pytest.mark.parametrize("arch", _ARCHS)
def test_engine_respect_deps_matches_reference(monkeypatch, arch, guard,
                                               max_stages):
    """Rounds, modelled time and cache counters bit-equal to the
    reference's engine (built with no activation axes bound), tokens
    equal to its and to the port's flat path's (a request joins at
    iteration 2)."""
    import repro.models.attention as ref_attention
    monkeypatch.setattr(ref_attention, "decode_sdpa", _kernel_decode_sdpa)
    cfg_ref, cfg, params, port = _model(arch)
    kw = dict(kind="symbiotic", respect_deps=True, dag_guard=guard,
              dag_max_stages=max_stages)
    ref = _run(REngine(cfg_ref, params, max_len=32, policy=RPolicy(**kw)),
               RRequest, cfg)
    out = _run(ServingEngine(cfg, port, max_len=32,
                             policy=SchedulerPolicy(**kw)), Request, cfg)
    flat = _run(ServingEngine(cfg, port, max_len=32,
                              policy=SchedulerPolicy(kind="symbiotic")),
                Request, cfg)
    assert out["rounds"] == ref["rounds"]
    assert out["modelled_time_s"] == ref["modelled_time_s"]
    assert out["schedule_cache"] == ref["schedule_cache"]
    assert out["outputs"] == ref["outputs"] == flat["outputs"]
    assert out["rounds"] > flat["rounds"]   # stage rounds, not requests
    assert all(len(t) >= 4 for t in out["outputs"].values())


def test_engine_respect_deps_audits_every_step():
    """audit_frac 1.0 on the traced path: every step's verdict in the
    gated currency, the same metrics as the reference's."""
    cfg_ref, cfg, params, port = _model("qwen1.5-0.5b")
    kw = dict(kind="refined", respect_deps=True, refine_model="gated",
              dag_guard="gated", audit_frac=1.0, audit_k=20,
              dag_max_stages=6)
    ref = _run(REngine(cfg_ref, params, max_len=32, policy=RPolicy(**kw)),
               RRequest, cfg)
    out = _run(ServingEngine(cfg, port, max_len=32,
                             policy=SchedulerPolicy(**kw)), Request, cfg)

    def stable(snap):
        return {k: v for k, v in snap.items()
                if k.startswith(("audit_", "cache_", "dag_", "engine_"))
                and not k.endswith(("_s", ".sum"))}
    assert stable(out["metrics"]) == stable(ref["metrics"])
    assert out["metrics"]["audit_steps"] == out["metrics"]["engine_steps"] \
        - 1   # the last step finds an empty queue
    assert out["outputs"] == ref["outputs"]
    assert out["modelled_time_s"] == ref["modelled_time_s"]


def test_serve_cli_respect_deps_on_cpu(capsys):
    """``launch.serve --respect-deps`` on deepseek smoke: the same tokens
    as the flat path, in more (stage) rounds."""
    from repro_torch.launch.serve import main, serve
    argv = ["--arch", "deepseek-v2-236b", "--device", "cpu", "--requests",
            "3", "--max-len", "32", "--max-new-tokens", "3"]
    assert main(argv + ["--respect-deps"]) == 0
    assert "respect_deps=True" in capsys.readouterr().out
    kw = dict(n_requests=3, max_len=32, max_new_tokens=3, device="cpu")
    flat = serve("deepseek-v2-236b", **kw)
    deps = serve("deepseek-v2-236b", respect_deps=True, **kw)
    assert deps["outputs"] == flat["outputs"]
    assert all(len(t) == 3 for t in deps["outputs"].values())
    assert deps["rounds"] > flat["rounds"]


def test_policy_knobs_match_reference_defaults():
    for knob in ("respect_deps", "slice_policy", "dag_max_stages",
                 "dag_guard", "composition"):
        assert getattr(SchedulerPolicy(), knob) == getattr(RPolicy(), knob)
