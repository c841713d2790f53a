"""The port's host scheduler and flat serving engine against the JAX
reference: bit-identical orders, rounds, modelled times and cache
counters, and equal tokens; plus the port's import and device rules."""

import ast
import pathlib
import random

import jax
import numpy as np
import pytest
import torch

import repro.core as RC
import repro.core.tpu as RTPU
import repro.models.attention as ref_attention
from repro.configs import get_config as ref_get_config
from repro.dist.context import set_activation_axes
from repro.kernels import ops as ref_ops
from repro.models import transformer as RT
from repro.serve import Request as RRequest
from repro.serve import SchedulerPolicy as RPolicy
from repro.serve import ServingEngine as REngine

import repro_torch.core as PC
import repro_torch.core.tpu as PTPU
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import serve
from repro_torch.models import transformer as PT
from repro_torch.serve import Request, SchedulerPolicy, ServingEngine

_ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _no_mesh():
    """A mesh left bound by another test on this worker (the reference's
    train() never clears its activation axes) would break the reference
    engine."""
    set_activation_axes()
    yield


def kernel_decode_sdpa(q, k, v, length_mask, *, scale):
    """The function the TPU kernel computes, in ``decode_sdpa``'s
    signature (f32 softmax weights, as the port's kernel keeps them)."""
    del scale
    lengths = length_mask.sum(-1).astype(np.int32)
    return ref_ops.decode_attention(q, k, v, lengths, interpret=True)


# --------------------------------------------------------------------------
# Host scheduler: bit-identical
# --------------------------------------------------------------------------

def _random_profiles(pkg, seed, n=14):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        block = rng.choice([64, 128, 256])
        out.append(pkg.KernelProfile(
            name=f"k{i}", n_blocks=rng.choice([8, 16, 32, 48]),
            demands={"shm": float(rng.choice([0, 4096, 8192, 16384])),
                     "reg": float(rng.randint(16, 40) * block),
                     "warp": float(block // 32)},
            inst_per_block=rng.uniform(1e6, 1e8),
            r=rng.uniform(0.5, 20.0)))
    return out


def _names(sched):
    return [[k.name for k in rd.kernels] for rd in sched.rounds]


@pytest.mark.parametrize("seed", range(4))
def test_greedy_order_fast_bit_identical(seed):
    for dev in ("GTX580", None):
        ref_dev = getattr(RC, dev) if dev else RTPU.make_serving_device()
        pt_dev = getattr(PC, dev) if dev else PTPU.make_serving_device()
        if dev:
            ref_ks = _random_profiles(RC, seed)
            pt_ks = _random_profiles(PC, seed)
        else:
            ref_ks = [it.profile() for it in _items(RTPU, seed)]
            pt_ks = [it.profile() for it in _items(PTPU, seed)]
        ref_s = RC.greedy_order_fast(ref_ks, ref_dev)
        pt_s = PC.greedy_order_fast(pt_ks, pt_dev)
        assert _names(pt_s) == _names(ref_s)
        assert _names(PC.greedy_order(pt_ks, pt_dev)) == _names(ref_s)


@pytest.mark.parametrize("seed", range(4))
def test_warm_start_insert_bit_identical(seed):
    ref_ks = _random_profiles(RC, seed)
    pt_ks = _random_profiles(PC, seed)
    ref_rounds = [rd.kernels for rd in
                  RC.greedy_order_fast(ref_ks[:-1], RC.GTX580).rounds]
    by_name = {k.name: k for k in pt_ks}
    pt_rounds = [[by_name[k.name] for k in rd] for rd in ref_rounds]
    assert (PC.warm_start_insert(pt_rounds, pt_ks[-1], PC.GTX580)
            == RC.warm_start_insert(ref_rounds, ref_ks[-1], RC.GTX580))


def _items(tpu, seed, n=10):
    """Prefill and decode work items as the engine builds them (full
    qwen's parameter count and KV bytes per token)."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        if rng.random() < 0.4:
            out.append(tpu.prefill_profile(
                f"prefill:{i}", n_params=463_987_712.0,
                seq_len=rng.randint(4, 512), kv_bytes_per_token=98304.0))
        else:
            out.append(tpu.decode_profile(
                f"decode:{i}", n_params=463_987_712.0,
                kv_len=rng.randint(1, 4096), kv_bytes_per_token=98304.0))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_fifo_rounds_and_round_time_bit_identical(seed):
    ref_dev, pt_dev = RTPU.make_serving_device(), PTPU.make_serving_device()
    ref_its, pt_its = _items(RTPU, seed), _items(PTPU, seed)
    ref_r = RTPU.fifo_rounds(ref_its, ref_dev)
    pt_r = PTPU.fifo_rounds(pt_its, pt_dev)
    assert [[i.name for i in rd] for rd in pt_r] == \
        [[i.name for i in rd] for rd in ref_r]
    for w in (2 * 463_987_712.0, 0.0):
        assert [PTPU.round_time(rd, pt_dev, w) for rd in pt_r] == \
            [RTPU.round_time(rd, ref_dev, w) for rd in ref_r]


# --------------------------------------------------------------------------
# Flat serving engine: port vs reference
# --------------------------------------------------------------------------

def _scenario(req_cls, name):
    """The requests of ``tests/test_system.py``'s serving tests: three
    4-token prompts, and for "warm" a late request joining at
    iteration 2 (a cache near-miss that the engine adapts)."""
    rng = np.random.default_rng(0)
    new = 4 if name == "plain" else 6
    reqs = [req_cls(i, rng.integers(0, 512, size=4), max_new_tokens=new)
            for i in range(3)]
    arrivals = None
    if name == "warm":
        arrivals = [(2, [req_cls(10, rng.integers(0, 512, size=4),
                                 max_new_tokens=4)])]
    return reqs, arrivals


@pytest.fixture(scope="module")
def smoke_f32():
    cfg_ref = ref_get_config("qwen1.5-0.5b", "smoke").replace(dtype="float32")
    cfg = get_config("qwen1.5-0.5b", "smoke").replace(dtype="float32")
    params = RT.init(jax.random.PRNGKey(0), cfg_ref)
    port = interop.params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                     device="cpu")
    return cfg_ref, params, cfg, port


@pytest.mark.parametrize("scenario", ["plain", "warm"])
@pytest.mark.parametrize("kind", ["fifo", "symbiotic"])
def test_engine_matches_reference(smoke_f32, monkeypatch, scenario, kind):
    monkeypatch.setattr(ref_attention, "decode_sdpa", kernel_decode_sdpa)
    cfg_ref, params, cfg, port = smoke_f32
    reqs, arr = _scenario(RRequest, scenario)
    ref_eng = REngine(cfg_ref, params, max_len=32,
                      policy=RPolicy(kind=kind))
    ref_eng.submit(reqs)
    ref = ref_eng.run(arrivals=arr)
    reqs, arr = _scenario(Request, scenario)
    eng = ServingEngine(cfg, port, max_len=32,
                        policy=SchedulerPolicy(kind=kind))
    assert eng.n_params == ref_eng.n_params
    eng.submit(reqs)
    out = eng.run(arrivals=arr)
    assert out["rounds"] == ref["rounds"]
    assert out["modelled_time_s"] == ref["modelled_time_s"]
    assert out["schedule_cache"] == ref["schedule_cache"]
    assert out["outputs"] == ref["outputs"]
    if scenario == "warm" and kind == "symbiotic":
        assert out["schedule_cache"]["warm_hits"] >= 1


@pytest.mark.parametrize("refine_backend", ["host", "batched"])
@pytest.mark.parametrize("refine_model", ["rounds", "event", "round"])
def test_refined_engine_matches_reference(smoke_f32, monkeypatch,
                                          refine_model, refine_backend):
    """kind="refined" under every objective and move backend: rounds,
    modelled time and cache counters bit-equal, tokens equal (the warm
    scenario: a request joins at iteration 2)."""
    monkeypatch.setattr(ref_attention, "decode_sdpa", kernel_decode_sdpa)
    cfg_ref, params, cfg, port = smoke_f32
    kw = dict(kind="refined", refine_model=refine_model,
              refine_backend=refine_backend)
    reqs, arr = _scenario(RRequest, "warm")
    ref_eng = REngine(cfg_ref, params, max_len=32, policy=RPolicy(**kw))
    ref_eng.submit(reqs)
    ref = ref_eng.run(arrivals=arr)
    reqs, arr = _scenario(Request, "warm")
    eng = ServingEngine(cfg, port, max_len=32, policy=SchedulerPolicy(**kw))
    eng.submit(reqs)
    out = eng.run(arrivals=arr)
    assert out["rounds"] == ref["rounds"]
    assert out["modelled_time_s"] == ref["modelled_time_s"]
    assert out["schedule_cache"] == ref["schedule_cache"]
    assert out["outputs"] == ref["outputs"]
    assert out["phases"]["refine"]["calls"] >= 1
    for knob in ("refine_budget", "neighborhood", "refine_model",
                 "refine_backend", "refine_batch"):
        assert getattr(SchedulerPolicy(), knob) == getattr(RPolicy(), knob)


def test_unported_policies_raise(smoke_f32):
    """Kernel slicing and the live composition, once refused at
    construction, now construct and serve: the same tokens as the flat
    path (their parity with the reference is in
    tests/test_torch_slice.py and tests/test_torch_live.py)."""
    from repro_torch.slice import SlicePolicy
    _, _, cfg, port = smoke_f32
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=4 + 3 * i) for i in range(3)]
    outs = []
    for kw in ({}, dict(respect_deps=True, slice_policy=SlicePolicy()),
               dict(respect_deps=True, composition="incremental"),
               dict(respect_deps=True, slice_policy=SlicePolicy(),
                    composition="incremental")):
        eng = ServingEngine(cfg, port, max_len=32,
                            policy=SchedulerPolicy(**kw))
        assert (eng.live is not None) == ("composition" in kw)
        eng.submit([Request(i, p, max_new_tokens=3)
                    for i, p in enumerate(prompts)])
        outs.append(eng.run()["outputs"])
    assert all(o == outs[0] for o in outs)
    assert all(len(t) == 3 for t in outs[0].values())


def test_serve_on_cpu_when_asked():
    stats = serve("qwen1.5-0.5b", variant="smoke", n_requests=2, max_len=32,
                  max_new_tokens=3, device="cpu")
    assert all(len(t) == 3 for t in stats["outputs"].values())
    assert stats["prompt_tokens"] > 0 and stats["modelled_time_s"] > 0


def test_serve_cli_refined_on_cpu(capsys):
    assert serve_main(["--policy", "refined", "--device", "cpu",
                       "--requests", "3", "--max-len", "32",
                       "--max-new-tokens", "3"]) == 0
    assert "policy=refined" in capsys.readouterr().out
    stats = serve("qwen1.5-0.5b", n_requests=3, max_len=32, max_new_tokens=3,
                  policy="refined", refine_model="event",
                  refine_backend="batched", device="cpu")
    assert all(len(t) == 3 for t in stats["outputs"].values())


def test_entry_points_default_to_cuda():
    """Without a device the entry points go to the card; with none
    present they raise rather than quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    reset_launch_counts()
    cfg = get_config("qwen1.5-0.5b", "smoke")
    jamba = get_config("jamba-v0.1-52b", "smoke")
    table = PC.ProfileTable.build(PC.experiment("EP-6-shm"), PC.GTX580)
    for call in (lambda: PT.init(cfg),
                 lambda: PT.init_cache(cfg, 1, 8),
                 lambda: PT.init(jamba),
                 lambda: PT.init_cache(jamba, 1, 8),
                 lambda: serve("qwen1.5-0.5b", variant="smoke"),
                 lambda: serve_main(["--variant", "smoke"]),
                 lambda: PC.pair_score_matrix_batched(table),
                 lambda: PC.audit_pair_scores(table)):
        with pytest.raises((AssertionError, RuntimeError)):
            call()
    assert launch_counts() == {"rmsnorm": 0, "decode_attention": 0,
                               "flash_attention": 0, "event_scan": 0,
                               "mamba_scan": 0}


# --------------------------------------------------------------------------
# The port stands alone
# --------------------------------------------------------------------------

def _port_files():
    return sorted((_ROOT / "src" / "repro_torch").rglob("*.py")) + \
        sorted((_ROOT / "tools").glob("*_turns.py")) + \
        [_ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = _port_files()
    assert len(files) > 20 and files[-1].is_file()
    port = _ROOT / "src" / "repro_torch"
    for mod in ("core/simulator.py", "core/refine.py", "core/batched.py",
                "core/experiments.py", "kernels/event_scan.py"):
        assert port / mod in files, mod
    assert _ROOT / "tools" / "decode_turns.py" in files
    bad = [(p.relative_to(_ROOT), m) for p in files
           for m in _imported_modules(p)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
