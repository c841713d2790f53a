"""The port's continuous-batching front end (``repro_torch.serve.frontend``)
and load generator (``repro_torch.serve.loadgen``) against the JAX
reference, on the CPU.

Each test runs one case of the reference's ``tests/test_frontend.py`` or
``tests/test_loadgen.py`` in both packages.  Both modules are host code
on a virtual clock, copied from the reference apart from their import
paths: arrival traces, admission decisions, routing, the flight
recorder's events and the seeded reports are equal to the reference's
(byte-equal as JSON), the golden traces and latency summary reproduce
exactly, and served tokens are f32 and identical to the reference's and
to a synchronous engine's.  Latencies here are modelled seconds of the
scheduler's TPU v5e cost model, not times of any device."""

import functools
import inspect
import json
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import repro.configs as ref_configs
import repro.core.tpu as RTPU
import repro.models.attention as ref_attention
import repro.obs as RObs
import repro.serve as RServe
import repro.serve.engine as RServeEngine
import repro.serve.loadgen as RLoad
from repro.dist.context import set_activation_axes
from repro.kernels import ops as ref_ops
from repro.models import transformer as RT

import repro_torch.configs as pt_configs
import repro_torch.core.tpu as PTPU
import repro_torch.obs as PObs
import repro_torch.serve as PServe
import repro_torch.serve.loadgen as PLoad
from proptest import cases
from repro_torch import interop
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.frontend

_ARCHS = ("qwen1.5-0.5b", "mixtral-8x7b", "deepseek-v2-236b")
#: high virtual arrival rate: gaps ~1e-6 s against modelled steps
#: ~1e-5 s, so arrivals queue behind in-flight work
_RATE = 1e6

_REF = SimpleNamespace(name="ref", tpu=RTPU, obs=RObs, serve=RServe,
                       loadgen=RLoad)
_PORT = SimpleNamespace(name="port", tpu=PTPU, obs=PObs, serve=PServe,
                        loadgen=PLoad)


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
    the reference's, as JSON too.  Returns the port's."""
    ref, port = case(_REF), case(_PORT)
    assert port == ref
    assert json.dumps(port, sort_keys=True, default=repr) == \
        json.dumps(ref, sort_keys=True, default=repr)
    return port


@functools.lru_cache(maxsize=None)
def _model(arch: str):
    cfg_ref = ref_configs.get_config(arch, "smoke").replace(dtype="float32")
    cfg = pt_configs.get_config(arch, "smoke").replace(dtype="float32")
    params = jax.jit(lambda key: RT.init(key, cfg_ref))(jax.random.PRNGKey(0))
    port = interop.params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                     device="cpu")
    return {"ref": (cfg_ref, params), "port": (cfg, port)}


def _tiny_device(pkg):
    """~10 prompt tokens per round: admission cost climbs one round per
    couple of live prompts."""
    return pkg.tpu.make_serving_device(token_budget=10)


def _frontend(pkg, arch="qwen1.5-0.5b", *, n_replicas=1, policy=None,
              admission=None, shared_cache=False, recorder=None,
              device=None):
    cfg, params = _model(arch)[pkg.name]
    return pkg.serve.ServingFrontend.build(
        cfg, params, n_replicas=n_replicas, max_len=32,
        policy=policy or pkg.serve.SchedulerPolicy(), admission=admission,
        shared_cache=shared_cache, recorder=recorder, device=device)


def _budget(fe, workload, slack: float):
    return slack * min(fe.solo_cost_s(0, r) for _, r in workload)


def _wl(pkg, process, n, seed, **kw):
    return pkg.serve.make_workload(process, n, _RATE, seed=seed, **kw)


def _workload_fields(wl):
    return [(t, r.rid, r.prompt.tolist(), r.max_new_tokens) for t, r in wl]


# --------------------------------------------------------------------------
# package surface
# --------------------------------------------------------------------------

def test_serve_package_exports_reference_names():
    assert sorted(PServe.__all__) == sorted(RServe.__all__)
    for name in PServe.__all__:
        obj = getattr(PServe, name)
        if inspect.isclass(obj) or inspect.isfunction(obj):
            assert obj.__module__.startswith("repro_torch.serve")
    assert sorted(PServe.ARRIVAL_PROCESSES) == sorted(RServe.ARRIVAL_PROCESSES)
    assert vars(PServe.AdmissionPolicy()) == vars(RServe.AdmissionPolicy())


# --------------------------------------------------------------------------
# admission invariants
# --------------------------------------------------------------------------

def test_admission_never_exceeds_budget():
    def case(pkg):
        wl = _wl(pkg, "poisson", 10, 3, prompt_len=(3, 8))
        budget = _budget(_frontend(pkg, device=_tiny_device(pkg)), wl, 1.25)
        rec = pkg.obs.FlightRecorder()
        fe = _frontend(pkg, device=_tiny_device(pkg), recorder=rec,
                       admission=pkg.serve.AdmissionPolicy(
                           round_cost_budget_s=budget, max_defer=4))
        st = fe.run(wl)
        admits = [e for e in rec.events if e["kind"] == "admit"]
        assert admits and any(e["kind"] == "defer" for e in rec.events)
        assert all(e["est_with"] <= e["budget"] + 1e-12 for e in admits)
        assert st["latency"]["completed"] == len(admits)
        return rec.events, st, fe.outputs()
    _both(case)


@cases(n=3, seed=11)
def test_deferred_never_starved(rng):
    seed = rng.randrange(1 << 16)

    def case(pkg):
        wl = _wl(pkg, "poisson", 10, seed, prompt_len=(3, 8))
        probe = _frontend(pkg, device=_tiny_device(pkg))
        rec = pkg.obs.FlightRecorder()
        fe = _frontend(pkg, device=_tiny_device(pkg), recorder=rec,
                       admission=pkg.serve.AdmissionPolicy(
                           round_cost_budget_s=_budget(probe, wl, 1.25),
                           max_defer=2))
        st = fe.run(wl)
        outs = fe.outputs()
        assert len(outs) == st["admitted"] == \
            st["submitted"] - st["rejected"]
        by_rid = {r.rid: r for _, r in wl}
        assert all(len(t) == by_rid[rid].max_new_tokens
                   for rid, t in outs.items())
        blocked: set[int] = set()
        for e in rec.events:
            if e["kind"] == "defer" and e["deferrals"] >= 2:
                blocked.add(e["rid"])
            elif e["kind"] == "admit":
                blocked.discard(e["rid"])
                assert all(e["rid"] < b for b in blocked)
        assert not blocked
        return rec.events, st, outs
    _both(case)


def test_oversized_and_queue_full_rejections():
    def case(pkg):
        wl = _wl(pkg, "bursty", 6, 5, prompt_len=(5, 5))
        solo = min(_frontend(pkg, device=_tiny_device(pkg)).solo_cost_s(
            0, r) for _, r in wl)
        fe = _frontend(pkg, device=_tiny_device(pkg),
                       admission=pkg.serve.AdmissionPolicy(
                           round_cost_budget_s=0.5 * solo))
        st = fe.run(wl)
        assert st["rejected"] == st["submitted"] == 6
        assert st["rejection_rate"] == 1.0 and fe.outputs() == {}
        assert int(fe.metrics.counter("frontend_rejected",
                                      reason="oversized").value) == 6
        fe2 = _frontend(pkg, device=_tiny_device(pkg),
                        admission=pkg.serve.AdmissionPolicy(
                            round_cost_budget_s=1.05 * solo,
                            max_queue_depth=1))
        st2 = fe2.run(_wl(pkg, "bursty", 6, 5, prompt_len=(5, 5)))
        qf = int(fe2.metrics.counter("frontend_rejected",
                                     reason="queue_full").value)
        assert qf > 0
        assert st2["admitted"] + st2["rejected"] == st2["submitted"]
        assert len(fe2.outputs()) == st2["admitted"]
        return st, st2, qf, fe2.outputs()
    _both(case)


# --------------------------------------------------------------------------
# bit-identity, routing determinism, cache conservation
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", _ARCHS)
def test_tokens_bit_identical_vs_synchronous(arch):
    """Two replicas on the sliced, incremental ``respect_deps`` path
    (joins and retires through the live frontier) serve the tokens of a
    synchronous batch-composed engine, and the reference's report."""
    def case(pkg):
        cfg, params = _model(arch)[pkg.name]
        S = pkg.serve.SchedulerPolicy
        fe = pkg.serve.ServingFrontend.build(
            cfg, params, n_replicas=2, max_len=32,
            policy=S(respect_deps=True, composition="incremental"))
        st = fe.run(_wl(pkg, "poisson", 6, 9, max_new_tokens=(2, 4)))
        sync = pkg.serve.ServingEngine(
            cfg, params, max_len=32,
            policy=S(respect_deps=True, composition="batch"))
        sync.submit([r for _, r in _wl(pkg, "poisson", 6, 9,
                                       max_new_tokens=(2, 4))])
        assert fe.outputs() == sync.run()["outputs"]
        return st, fe.outputs()
    _both(case)


def test_replica_routing_determinism():
    def case(pkg):
        def one():
            rec = pkg.obs.FlightRecorder()
            fe = _frontend(pkg, n_replicas=2, device=_tiny_device(pkg),
                           recorder=rec)
            st = fe.run(_wl(pkg, "bursty", 8, 21, prompt_len=(3, 8)))
            return [(e["rid"], e["replica"]) for e in rec.events
                    if e["kind"] == "admit"], st
        a, b = one(), one()
        assert a[0] and a == b
        return a
    _both(case)


def test_cache_stats_conservation_across_replicas():
    def case(pkg):
        adm = pkg.serve.AdmissionPolicy(route="round_robin")
        fe = _frontend(pkg, n_replicas=2, admission=adm)
        fe.run(_wl(pkg, "poisson", 8, 13))
        for i, eng in enumerate(fe.engines):
            s = eng.schedule_cache.stats()
            assert s["hits"] + s["misses"] == fe._steps[i]
        fe2 = _frontend(pkg, n_replicas=2, shared_cache=True, admission=adm)
        fe2.run(_wl(pkg, "poisson", 8, 13))
        assert fe2.engines[0].schedule_cache is \
            fe2.engines[1].schedule_cache
        shared = fe2.engines[0].schedule_cache.stats()
        assert shared["hits"] + shared["misses"] == sum(fe2._steps)
        assert fe2.outputs() == fe.outputs()
        return fe.stats(), fe2.stats(), fe.outputs()
    _both(case)


def test_cache_affinity_routes_same_signature_together():
    def case(pkg):
        rec = pkg.obs.FlightRecorder()
        fe = _frontend(pkg, n_replicas=2, recorder=rec,
                       admission=pkg.serve.AdmissionPolicy(
                           route="cache_affinity"))
        fe.run(_wl(pkg, "poisson", 8, 2, prompt_len=(5, 5)))
        picks = {e["replica"] for e in rec.events if e["kind"] == "admit"}
        assert len(picks) == 1
        return sorted(picks)
    _both(case)


def test_audit_sampling_keys_on_engine_local_steps():
    def case(pkg):
        fe = _frontend(pkg, n_replicas=2,
                       policy=pkg.serve.SchedulerPolicy(audit_frac=0.5,
                                                        audit_k=3),
                       admission=pkg.serve.AdmissionPolicy(
                           route="round_robin"))
        fe.run(_wl(pkg, "poisson", 8, 7))
        assert all(s > 0 for s in fe._steps)
        out = []
        for i, eng in enumerate(fe.engines):
            seen = eng.composer.auditor._steps_seen
            assert seen == fe._steps[i] < fe._tick
            expected = sum(pkg.obs.QualityAuditor.crossed(s, 0.5)
                           for s in range(1, seen + 1))
            audited = int(eng.metrics.counter("audit_steps").value)
            assert audited == expected
            out.append((seen, audited))
        return out
    _both(case)


def test_frontend_step_events_carry_both_counters():
    def case(pkg):
        rec = pkg.obs.FlightRecorder()
        fe = _frontend(pkg, n_replicas=2, recorder=rec,
                       admission=pkg.serve.AdmissionPolicy(
                           route="round_robin"))
        fe.run(_wl(pkg, "poisson", 6, 4))
        steps = [e for e in rec.events if e["kind"] == "frontend_step"]
        assert [e["tick"] for e in steps] == list(range(1, fe._tick + 1))
        assert all(e["dt"] >= 0 and e["t_end"] >= e["t_start"]
                   for e in steps)
        for i in range(2):
            assert [e["engine_step"] for e in steps
                    if e["replica"] == i] == list(range(1, fe._steps[i] + 1))
        return steps
    _both(case)


# --------------------------------------------------------------------------
# the load generator: golden traces, rates, shapes, the virtual clock
# --------------------------------------------------------------------------

_GOLDEN_TRACES = {
    "poisson": [0.255015071819, 0.261347281579, 0.341753297598,
                0.404899844016, 0.738298012218, 1.020591264417],
    "bursty": [0.025501507182, 0.026134728158, 0.034175329760,
               0.040489984402, 0.073829801222, 0.102059126442],
    "diurnal": [0.141675039899, 0.186345048799, 0.680911822737,
                0.757029344876, 0.791295552648, 0.795030886492],
}


@pytest.mark.parametrize("process", sorted(_GOLDEN_TRACES))
def test_arrival_trace_goldens(process):
    got = _both(lambda pkg: pkg.serve.ARRIVAL_PROCESSES[process](
        6, 4.0, seed=42))
    assert got == pytest.approx(_GOLDEN_TRACES[process], rel=1e-9)


def test_bursty_shares_poisson_scale():
    assert _GOLDEN_TRACES["bursty"] == pytest.approx(
        [t / 10.0 for t in _both(lambda pkg: pkg.serve.poisson_arrivals(
            6, 4.0, seed=42))], rel=1e-9)


@pytest.mark.parametrize("process", sorted(_GOLDEN_TRACES))
def test_long_run_rate(process):
    ts = _both(lambda pkg: pkg.serve.ARRIVAL_PROCESSES[process](
        2000, 8.0, seed=1))
    assert 2000 / ts[-1] == pytest.approx(8.0, rel=0.15)


@cases(n=25, seed=5)
def test_arrival_processes_monotone(rng):
    seed = rng.randrange(1 << 30)
    rate = rng.choice([0.5, 4.0, 1e3, 1e6])
    t0 = rng.choice([0.0, 3.5])

    def case(pkg):
        out = []
        for fn in (pkg.serve.poisson_arrivals, pkg.serve.bursty_arrivals,
                   pkg.serve.diurnal_arrivals):
            ts = fn(20, rate, seed=seed, t0=t0)
            assert len(ts) == 20 and ts[0] > t0
            assert all(b > a for a, b in zip(ts, ts[1:]))
            out.append(ts)
        return out
    _both(case)


@cases(n=10, seed=6)
def test_workload_shapes_seeded(rng):
    seed = rng.randrange(1 << 30)

    def case(pkg):
        wl = pkg.serve.make_workload("poisson", 12, 4.0, seed=seed,
                                     prompt_len=(3, 9),
                                     max_new_tokens=(2, 5))
        assert [r.rid for _, r in wl] == list(range(12))
        assert all(3 <= len(r.prompt) <= 9 and 2 <= r.max_new_tokens <= 5
                   for _, r in wl)
        return _workload_fields(wl)
    _both(case)


def test_virtual_clock_monotone():
    for pkg in (_REF, _PORT):
        clk = pkg.serve.VirtualClock(1.0)
        assert clk.now() == 1.0
        assert clk.advance(0.5) == 1.5
        assert clk.advance_to(1.2) == 1.5
        assert clk.advance_to(2.0) == 2.0
        with pytest.raises(ValueError):
            clk.advance(-1e-9)
        assert clk.now() == 2.0


@cases(n=50, seed=8)
def test_virtual_clock_monotone_under_random_ops(rng):
    clk = PServe.VirtualClock()
    prev = clk.now()
    for _ in range(40):
        if rng.random() < 0.5:
            clk.advance(rng.random())
        else:
            clk.advance_to(rng.uniform(-1.0, prev + 1.0))
        assert clk.now() >= prev
        prev = clk.now()


def test_completions_monotone_in_virtual_time():
    def case(pkg):
        fe = _frontend(pkg)
        gen = pkg.serve.LoadGenerator(process="diurnal", n_requests=8,
                                      rate=1e6, seed=3)
        rep = gen.drive(fe)
        arrive = {r.rid: t for t, r in gen.workload()}
        by_replica: dict = {}
        for rid, t, rep_i in fe.completions:
            assert t >= arrive[rid] and t >= by_replica.get(rep_i, 0.0)
            by_replica[rep_i] = t
        return fe.completions, rep
    _both(case)


_GOLDEN_REPORT = {
    "completed": 6,
    "p50_s": 1.0307835959760038e-05,
    "p99_s": 1.2883820582646234e-05,
    "queue_p50_s": 0.0,
    "queue_p99_s": 0.0,
    "goodput_rps": 430749.4915622427,
    "goodput_tokens_per_s": 1507623.2204678494,
    "virtual_time_s": 1.3929209708963773e-05,
    "rejection_rate": 0.0,
    "queue_depth_max": 1,
}


def test_latency_summary_golden():
    """The reference's pinned summary of a seeded run, exactly, from the
    port's front end (modelled seconds, not a device's)."""
    rep = _both(lambda pkg: pkg.serve.LoadGenerator(
        process="poisson", n_requests=6, rate=1e6, seed=42,
        max_new_tokens=(2, 4)).drive(_frontend(pkg)))
    for key, want in _GOLDEN_REPORT.items():
        assert rep[key] == pytest.approx(want, rel=1e-9), key


def test_report_deterministic_across_runs():
    def case(pkg):
        gen = pkg.serve.LoadGenerator(process="bursty", n_requests=8,
                                      rate=1e6, seed=17)
        a, b = gen.drive(_frontend(pkg)), gen.drive(_frontend(pkg))
        assert json.dumps(a, sort_keys=True) == json.dumps(b,
                                                           sort_keys=True)
        return a
    _both(case)
