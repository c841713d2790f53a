"""The port's schedule tracing (``repro_torch.obs.trace``) and export
layer (``repro_torch.obs.export``: Prometheus exposition and the flight
recorder) against the JAX reference, on the CPU.

Each test runs one trace or export case of the reference's
``tests/test_obs.py`` in both packages.  Both modules are host Python,
copied from the reference apart from their import paths, so spans,
instants, busy time, Chrome trace-event documents, Gantt text,
exposition text and recorded events are equal to the reference's, and
a recorder never changes a modelled time or a served token."""

import functools
import inspect
import json
import math
import random
import re
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import repro.configs as ref_configs
import repro.core as RC
import repro.core.refine as RRefine
import repro.core.resources as RRes
import repro.core.tpu as RTPU
import repro.graph as RG
import repro.graph.delta as RGD
import repro.models.attention as ref_attention
import repro.obs as RObs
import repro.serve as RServe
import repro.serve.engine as RServeEngine
import repro.slice as RS
from repro.dist.context import set_activation_axes
from repro.kernels import ops as ref_ops
from repro.models import transformer as RT

import repro_torch.configs as pt_configs
import repro_torch.core as PC
import repro_torch.core.refine as PRefine
import repro_torch.core.resources as PRes
import repro_torch.core.tpu as PTPU
import repro_torch.graph as PG
import repro_torch.graph.delta as PGD
import repro_torch.obs as PObs
import repro_torch.serve as PServe
import repro_torch.slice as PS
from repro_torch import interop
from torch_threads import one_torch_thread  # noqa: F401

_REF = SimpleNamespace(name="ref", core=RC, refine=RRefine, res=RRes,
                       tpu=RTPU, graph=RG, delta=RGD, obs=RObs,
                       serve=RServe, slice=RS, configs=ref_configs)
_PORT = SimpleNamespace(name="port", core=PC, refine=PRefine, res=PRes,
                        tpu=PTPU, graph=PG, delta=PGD, obs=PObs,
                        serve=PServe, slice=PS, configs=pt_configs)

#: busy time against the span union: both sum the same float dts in
#: different orders
_CONS_RTOL = 1e-9


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


def _trace_fields(tr):
    return (tr.label, tr.spans, tr.instants,
            {u: tr.busy_of(u) for u in tr.units()}, tr.makespan)


def _gpu_kernels(pkg, rng: random.Random, n: int):
    fams = [pkg.res.ep_kernel, pkg.res.bs_kernel, pkg.res.es_kernel,
            pkg.res.sw_kernel]
    return [rng.choice(fams)(f"k{i}",
                             grid=rng.choice([8, 16, 32, 48, 64, 96]),
                             shm=rng.choice([0, 4096, 8192, 16384]),
                             inst=rng.uniform(1e6, 5e8))
            for i in range(n)]


def _tpu_profiles(pkg, rng: random.Random, n: int):
    out = []
    for i in range(n):
        if rng.random() < 0.4:
            out.append(pkg.tpu.prefill_profile(
                f"p{i}", n_params=7e9,
                seq_len=rng.choice([128, 512, 2048, 8192]),
                kv_bytes_per_token=131072).profile())
        else:
            out.append(pkg.tpu.decode_profile(
                f"d{i}", n_params=7e9, kv_len=rng.randint(1, 8192),
                kv_bytes_per_token=131072).profile())
    return out


def _random_dag_edges(rng: random.Random, n: int, density=1.0) -> set:
    edges = set()
    for _ in range(int(density * n)):
        u, v = rng.randrange(n), rng.randrange(n)
        if u != v:
            edges.add((min(u, v), max(u, v)))
    return edges


def _device(pkg, which: str):
    if which == "gtx580":
        return pkg.core.GTX580, _gpu_kernels
    return (pkg.tpu.make_serving_device(
        **({"n_units": 4} if which == "tpu4" else {})), _tpu_profiles)


def _assert_conserved(tr) -> None:
    assert tr.spans, "trace recorded no spans"
    for u in tr.units():
        assert math.isclose(tr.span_union(u), tr.busy_of(u),
                            rel_tol=_CONS_RTOL, abs_tol=1e-15)


def test_obs_package_exports_reference_names():
    assert sorted(PObs.__all__) == sorted(RObs.__all__)
    for name in PObs.__all__:
        obj = getattr(PObs, name)
        if inspect.isclass(obj) or inspect.isfunction(obj):
            assert obj.__module__.startswith("repro_torch.obs")


# --------------------------------------------------------------------------
# trace identity: recorder on vs off, port vs reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["gtx580", "tpu", "tpu4"])
def test_event_trace_identity_and_conservation(which):
    def case(pkg):
        rng = random.Random(5)
        device, maker = _device(pkg, which)
        out = []
        for _ in range(8):
            ks = maker(pkg, rng, rng.randint(2, 24))
            t_plain = pkg.core.EventSimulator(device).simulate(ks)
            tr = pkg.obs.ScheduleTrace()
            assert pkg.core.EventSimulator(device).simulate(
                ks, trace=tr) == t_plain
            assert tr.makespan == pytest.approx(t_plain, rel=1e-12)
            _assert_conserved(tr)
            tr2 = pkg.obs.ScheduleTrace()
            t_fast, _ = pkg.refine._FastEventSim(device).simulate(
                ks, trace=tr2)
            assert t_fast == t_plain and tr2.spans == tr.spans
            out.append((t_plain, _trace_fields(tr)))
        return out
    _both(case)


@pytest.mark.parametrize("which", ["gtx580", "tpu"])
def test_round_trace_identity(which):
    def case(pkg):
        rng = random.Random(7)
        device, maker = _device(pkg, which)
        out = []
        for _ in range(8):
            ks = maker(pkg, rng, rng.randint(2, 20))
            t_plain = pkg.core.RoundSimulator(device).simulate(ks)
            tr = pkg.obs.ScheduleTrace()
            assert pkg.core.RoundSimulator(device).simulate(
                ks, trace=tr) == t_plain
            assert tr.units() == [0]
            assert tr.busy_of(0) == pytest.approx(t_plain, rel=1e-12)
            rounds = [i for i in tr.instants if i[3] == "round"]
            assert rounds and rounds[-1][1] == pytest.approx(t_plain)
            tr2 = pkg.obs.ScheduleTrace()
            t_fast, _ = pkg.refine._FastRoundSim(device).simulate(
                ks, trace=tr2)
            assert t_fast == t_plain and tr2.spans == tr.spans
            out.append((t_plain, _trace_fields(tr)))
        return out
    _both(case)


@pytest.mark.parametrize("which", ["gtx580", "tpu4"])
def test_gated_trace_identity_and_conservation(which):
    def case(pkg):
        rng = random.Random(11)
        device, maker = _device(pkg, which)
        out = []
        for _ in range(8):
            n = rng.randint(4, 24)
            ks = maker(pkg, rng, n)
            eids = {(id(ks[u]), id(ks[v])) for u, v in
                    _random_dag_edges(rng, n, rng.uniform(0.5, 2.0))}
            t_plain = pkg.graph.DagEventSimulator(device, eids).simulate(ks)
            tr = pkg.obs.ScheduleTrace()
            assert pkg.graph.DagEventSimulator(device, eids).simulate(
                ks, trace=tr) == t_plain
            _assert_conserved(tr)
            tr2 = pkg.obs.ScheduleTrace()
            t_fast, _ = pkg.delta._FastGatedSim(device, eids).simulate(
                ks, trace=tr2)
            assert t_fast == t_plain and tr2.spans == tr.spans
            out.append((t_plain, _trace_fields(tr)))
        return out
    _both(case)


def test_sliced_trace_identity_and_conservation():
    def case(pkg):
        rng = random.Random(13)
        dev = pkg.tpu.make_serving_device(n_units=4)
        out = []
        for _ in range(6):
            n = rng.randint(4, 14)
            profs = []
            for i in range(n):
                if rng.random() < 0.4:
                    profs.append(pkg.tpu.prefill_profile(
                        f"r{i}:p:L0:attn", n_params=7e9,
                        seq_len=rng.choice([6144, 8192, 12288]),
                        kv_bytes_per_token=131072).profile())
                else:
                    profs.append(pkg.tpu.decode_profile(
                        f"r{i}:d:L0:attn", n_params=7e9,
                        kv_len=rng.randint(256, 8192),
                        kv_bytes_per_token=131072).profile())
            edges = _random_dag_edges(rng, n, rng.uniform(0.0, 1.0))
            res = pkg.slice.greedy_order_slices(
                profs, dev, edges=edges, policy=pkg.slice.SlicePolicy())
            eids = res.edges_by_id()
            t_plain = pkg.graph.DagEventSimulator(dev, eids).simulate(
                res.order)
            tr = pkg.obs.ScheduleTrace()
            assert pkg.graph.DagEventSimulator(dev, eids).simulate(
                res.order, trace=tr) == t_plain
            _assert_conserved(tr)
            if res.sliced:
                joins = [i for i in tr.instants if i[3] == "join"]
                assert joins and all(i[2] is None for i in joins)
                assert not any("#join" in s[1] for s in tr.spans)
            out.append((res.sliced, t_plain, _trace_fields(tr)))
        return out
    assert any(r[0] for r in _both(case))


def test_delta_evaluator_rebase_forwards_trace():
    def case(pkg):
        ks = _gpu_kernels(pkg, random.Random(17), 12)
        out = []
        for model in ("round", "event"):
            t_plain = pkg.refine.DeltaEvaluator(pkg.core.GTX580,
                                                model=model).rebase(ks)
            tr = pkg.obs.ScheduleTrace()
            assert pkg.refine.DeltaEvaluator(
                pkg.core.GTX580, model=model).rebase(ks, trace=tr) == t_plain
            assert tr.spans and tr.makespan == pytest.approx(t_plain)
            out.append(_trace_fields(tr))
        return out
    _both(case)


def test_max_resident_blocks_within_device_caps():
    def case(pkg):
        rng = random.Random(19)
        gtx, out = pkg.core.GTX580, []
        for _ in range(6):
            ks = [pkg.res.ep_kernel(f"k{i}", grid=rng.choice([8, 16, 32]),
                                    shm=8192, inst=2e7) for i in range(10)]
            cap = min(int(gtx.cap(d) // v)
                      for d, v in ks[0].demands.items() if v > 0)
            tr = pkg.obs.ScheduleTrace()
            pkg.core.EventSimulator(gtx).simulate(ks, trace=tr)
            peaks = [tr.max_resident_blocks(u) for u in tr.units()]
            assert all(1 <= p <= cap for p in peaks)
            out.append(peaks)
        return out
    _both(case)


# --------------------------------------------------------------------------
# Chrome trace-event export and the terminal Gantt
# --------------------------------------------------------------------------

def test_chrome_trace_structure_from_traced_arch():
    def case(pkg):
        cfg = pkg.configs.get_config("qwen1.5-0.5b", "full")
        dev = pkg.tpu.make_serving_device(n_units=4)
        g = pkg.graph.trace_arch(cfg, [("prefill", 128), ("decode", 256),
                                       ("decode", 512)], max_stages=8).graph
        sched = pkg.graph.greedy_order_dag(g.kernels, dev, edges=g.edges)
        tr = pkg.obs.ScheduleTrace(label="traced-arch")
        t = pkg.graph.DagEventSimulator(dev, g.edges_by_id()).simulate(
            sched.order, trace=tr)
        doc = json.loads(json.dumps(tr.to_chrome()))
        assert doc["displayTimeUnit"] == "ms"
        evs = doc["traceEvents"]
        units = set(tr.units())
        metas = [e for e in evs if e["ph"] == "M"]
        assert {m["pid"] for m in metas} == units
        xs = [e for e in evs if e["ph"] == "X"]
        assert len(xs) == len(tr.spans) == len(sched.order)
        for e in xs:
            assert e["pid"] in units and e["tid"] == 0
            assert e["ts"] >= 0.0 and e["dur"] >= 0.0
            assert e["ts"] + e["dur"] <= t * 1e6 * (1 + 1e-9)
            assert e["args"]["blocks"] >= 1
        assert {e["ph"] for e in evs} <= {"M", "X", "i"}
        return doc
    _both(case)


def test_gantt_renders_every_unit():
    def case(pkg):
        tr = pkg.obs.ScheduleTrace(label="gantt")
        pkg.core.EventSimulator(pkg.tpu.make_serving_device(
            n_units=4)).simulate(_tpu_profiles(pkg, random.Random(23), 12),
                                 trace=tr)
        text = tr.gantt(width=40)
        assert "gantt" in text and "legend:" in text
        assert all(f"unit {u:>2} |" in text for u in tr.units())
        assert pkg.obs.ScheduleTrace().gantt() == "(empty trace)"
        return text
    _both(case)


def test_gantt_golden_fixed_schedule():
    tr = PObs.ScheduleTrace(label="g")
    tr.span(0, "a", 0.0, 1.0)
    tr.span(0, "b", 1.0, 2.0)
    tr.span(1, "c", 0.0, 2.0)
    tr.span(1, "d", 0.5, 1.0)
    tr.instant("round", 2.0)
    assert tr.gantt(width=8) == (
        "g  (makespan 2s, 1 col = 0.25s)\n"
        "unit  0 |aaaabbbb|\n"
        "unit  1 |cc**cccc|\n"
        "legend: a=a, b=b, c=c, d=d\n"
        "  @2s [device] round")


def test_gantt_width_clamping():
    def case(pkg):
        tr = pkg.obs.ScheduleTrace(label="clamp")
        tr.span(0, "a", 0.0, 2.0)
        tr.span(0, "z", 2.0, 2.0)
        text = tr.gantt(width=8)
        row = next(ln for ln in text.splitlines() if ln.startswith("unit"))
        assert row == "unit  0 |aaaaaaa*|"
        for w in (1, 3, 72):
            for ln in tr.gantt(width=w).splitlines():
                if ln.startswith("unit"):
                    assert len(ln) == len("unit  0 ||") + w
        return [tr.gantt(width=w) for w in (1, 3, 8, 72)]
    _both(case)


def test_gantt_empty_trace_and_instant_only():
    for pkg in (_REF, _PORT):
        assert pkg.obs.ScheduleTrace().gantt() == "(empty trace)"
        tr = pkg.obs.ScheduleTrace()
        tr.instant("round", 1.0)
        assert tr.gantt() == "(empty trace)"


# --------------------------------------------------------------------------
# Prometheus exposition + JSONL flight recorder
# --------------------------------------------------------------------------

def _random_registry(pkg, rng: random.Random):
    m = pkg.obs.MetricsRegistry()
    for _ in range(rng.randint(1, 5)):
        m.counter("cache_hits", namespace=rng.choice(["flat", "dag"])
                  ).inc(rng.randint(0, 50))
    m.counter("engine_steps").inc(rng.randint(1, 9))
    m.gauge("cache_entries").set(rng.uniform(0, 100))
    h = m.histogram("phase_compose")
    for _ in range(rng.randint(1, 40)):
        h.observe(rng.uniform(1e-6, 2.0))
    m.histogram("audit_quality_percentile", arch="qwen1.5-0.5b",
                kind="refined").observe(rng.uniform(0, 100))
    return m


def test_prometheus_roundtrip_property():
    """Every counter and gauge sample and every histogram sum and count
    survive the text exposition exactly, quantiles match the reservoir;
    the exposition text is the reference's, byte for byte."""
    def case(pkg):
        rng = random.Random(29)
        texts = []
        for _ in range(10):
            m = _random_registry(pkg, rng)
            text = pkg.obs.prometheus_text(m)
            parsed = pkg.obs.parse_prometheus_text(text)
            for key, v in m.snapshot().items():
                name, _, field = key.partition(".")
                if not field:
                    pk = "repro_" + re.sub(r"=([^,}]*)", r'="\1"', name)
                    assert parsed[pk] == v, key
            h = m.histogram("phase_compose")
            assert parsed["repro_phase_compose_count"] == h.count
            assert parsed["repro_phase_compose_sum"] == pytest.approx(
                h.total, rel=1e-15)
            assert parsed['repro_phase_compose{quantile="0.5"}'] == \
                h.quantile(0.5)
            texts.append((text, parsed))
        return texts
    _both(case)


def test_prometheus_text_structure():
    def case(pkg):
        m = pkg.obs.MetricsRegistry()
        m.counter("cache_hits", namespace="flat").inc(3)
        m.gauge("cache_entries").set(2)
        m.histogram("phase_compose").observe(0.5)
        text = pkg.obs.prometheus_text(m)
        for line in ("# TYPE repro_cache_hits counter",
                     "# TYPE repro_cache_entries gauge",
                     "# TYPE repro_phase_compose summary",
                     'repro_cache_hits{namespace="flat"} 3',
                     "repro_phase_compose_count 1"):
            assert line in text
        m.counter("cache_hits", namespace="dag").inc()
        text2 = pkg.obs.prometheus_text(m)
        assert text2.count("# TYPE repro_cache_hits counter") == 1
        return text, text2
    _both(case)


def test_flight_recorder_roundtrip_and_timeline(tmp_path):
    def case(pkg):
        rng = random.Random(31)
        FR = pkg.obs.FlightRecorder
        rec = FR()
        want = []
        for i in range(rng.randint(5, 40)):
            kind = rng.choice(("schedule", "cache", "audit", "rebuild"))
            fields = {"step": i, "ok": rng.random() < 0.5,
                      "ratio": rng.uniform(0, 2)}
            rec.event(kind, **fields)
            want.append({"seq": i, "kind": kind, **fields})
        assert rec.events == want
        assert FR.load(rec.to_jsonl()) == want
        p = tmp_path / f"flight-{pkg.name}.jsonl"
        rec.dump(str(p))
        assert FR.load(str(p)) == want
        tl = FR.timeline(want)
        assert tl["n_events"] == len(want) == sum(tl["by_kind"].values())
        assert len(tl["lines"]) == len(want)
        assert tl["lines"][0].startswith("#0 ")
        return rec.to_jsonl(), p.read_text(), tl
    _both(case)


def test_flight_recorder_caps_events():
    def case(pkg):
        rec = pkg.obs.FlightRecorder(max_events=10)
        for i in range(25):
            rec.event("schedule", step=i)
        assert len(rec.events) == 10 and rec.dropped == 15
        assert rec.events[0]["step"] == 15 and rec.events[-1]["seq"] == 24
        return rec.events
    _both(case)


# --------------------------------------------------------------------------
# the serving engine: instrumentation is invisible to outputs
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _model(arch: str):
    cfg_ref = ref_configs.get_config(arch, "smoke").replace(dtype="float32")
    cfg = pt_configs.get_config(arch, "smoke").replace(dtype="float32")
    params = jax.jit(lambda key: RT.init(key, cfg_ref))(jax.random.PRNGKey(0))
    port = interop.params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                     device="cpu")
    return {"ref": (cfg_ref, params), "port": (cfg, port)}


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mixtral-8x7b",
                                  "deepseek-v2-236b"])
def test_engine_instrumentation_bit_identical_and_phased(arch):
    """A sliced, incremental ``respect_deps`` engine with a registry, a
    schedule trace and a flight recorder attached: the same tokens and
    modelled time as without them; the trace spans the modelled
    timeline; trace, events and exposition are the reference's."""
    def case(pkg):
        cfg, params = _model(arch)[pkg.name]

        def run(**obs):
            eng = pkg.serve.ServingEngine(
                cfg, params, max_len=32,
                policy=pkg.serve.SchedulerPolicy(
                    kind="symbiotic", respect_deps=True,
                    slice_policy=pkg.slice.SlicePolicy(),
                    composition="incremental"), **obs)
            rng = np.random.default_rng(0)
            eng.submit([pkg.serve.Request(i, rng.integers(0, 128, size=4),
                                          max_new_tokens=3)
                        for i in range(2)])
            return eng.run()

        plain = run()
        m, tr = pkg.obs.MetricsRegistry(), pkg.obs.ScheduleTrace()
        rec = pkg.obs.FlightRecorder()
        inst = run(metrics=m, trace=tr, recorder=rec)
        for key in ("outputs", "total_new_tokens", "modelled_time_s"):
            assert inst[key] == plain[key]
        pb = inst["phases"]
        assert pb["compose"]["calls"] > 0 and pb["execute"]["calls"] > 0
        assert tr.spans and tr.makespan == pytest.approx(
            inst["modelled_time_s"], rel=1e-9)
        text = pkg.obs.prometheus_text(m)
        stable = {k: v for k, v in pkg.obs.parse_prometheus_text(
            text).items() if "phase_" not in k and "_s" not in k}
        return (inst["outputs"], inst["modelled_time_s"],
                _trace_fields(tr), rec.events, stable)
    _both(case)
