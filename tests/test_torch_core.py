"""The port's scheduling core (simulators, refiners, batched evaluators,
the paper's six experiments) against the JAX package's, on the CPU.

Every host module is NumPy float64 in both packages and must agree bit
for bit: simulated times, checkpoints and their resumes, refined orders
and their times.  The one float32 piece, ``pair_score_matrix_batched``,
runs in PyTorch here and is held against the reference's jnp path
within ``F32_SCORE_RTOL``.  The pins of ``tests/test_fastscore.py`` and
``tests/test_event_delta.py`` are repeated on the port.  Inputs come
from the reference tests' seeded generators, built once per package.
"""

import math
import random

import numpy as np
import pytest

import repro.core as RC
import repro.core.batched as RB
import repro.core.refine as RR
import repro.core.tpu as RTPU

import repro_torch.core as PC
import repro_torch.core.batched as PB
import repro_torch.core.refine as PR
import repro_torch.core.seeded as S
import repro_torch.core.tpu as PTPU
from torch_threads import one_torch_thread  # noqa: F401

_PKGS = {"ref": (RC, RR, RB, RTPU), "port": (PC, PR, PB, PTPU)}
_MAKERS = {"gpu": S.gpu_kernels, "tpu": S.serving_profiles,
           "adversarial": S.adversarial}


def _device(pkg, maker):
    C, _, _, tpu = _PKGS[pkg]
    return tpu.make_serving_device() if maker == "tpu" else C.GTX580


def _both(maker, seed, n):
    """The same profiles (and their device) in both packages."""
    return {pkg: (_MAKERS[maker](_PKGS[pkg][0], random.Random(seed), n),
                  _device(pkg, maker)) for pkg in _PKGS}


def _perms(n, count, seed):
    rng = random.Random(seed)
    out = []
    for _ in range(count):
        p = list(range(n))
        rng.shuffle(p)
        out.append(p)
    return out


def _names(order):
    return [k.name for k in order]


def _ckpt_view(cp):
    """A checkpoint with kernels by name, comparable across packages."""
    if isinstance(cp, (RC.RoundCheckpoint, PC.RoundCheckpoint)):
        return (cp.pos, cp.blocks_left, cp.time)
    return (cp.pos, cp.blocks_left, cp.time, cp.rr,
            tuple((used, nres, tuple((k.name, nb, fl, ta)
                                     for k, nb, fl, ta in cohorts))
                  for used, nres, cohorts in cp.units))


_CASES = [(m, s) for m in _MAKERS for s in range(3)]


# --------------------------------------------------------------------------
# simulators
# --------------------------------------------------------------------------

@pytest.mark.parametrize("maker,seed", _CASES)
@pytest.mark.parametrize("model", ["event", "round"])
def test_simulate_bit_equal(maker, seed, model):
    both = _both(maker, 10 + seed, 6 + 5 * seed)
    n = len(both["ref"][0])
    for perm in _perms(n, 4, seed):
        t = {pkg: _PKGS[pkg][0].simulate([ks[i] for i in perm], dev,
                                         model=model)
             for pkg, (ks, dev) in both.items()}
        assert t["port"] == t["ref"]


@pytest.mark.parametrize("maker,seed", _CASES)
def test_event_checkpoints_and_resume_bit_equal(maker, seed):
    """EventSimulator and _FastEventSim record the reference's
    checkpoints, and resuming from any of them (either package's, either
    implementation's) gives the reference's time."""
    both = _both(maker, 20 + seed, 5 + 4 * seed)
    (rks, rdev), (pks, pdev) = both["ref"], both["port"]
    t_ref, ref_ck = RC.EventSimulator(rdev).simulate(rks, record=True)
    t_port, port_ck = PC.EventSimulator(pdev).simulate(pks, record=True)
    t_fast, fast_ck = PR._FastEventSim(pdev).simulate(pks, record=True)
    assert t_port == t_ref == t_fast
    assert [_ckpt_view(c) for c in port_ck] == \
        [_ckpt_view(c) for c in ref_ck] == [_ckpt_view(c) for c in fast_ck]
    n = len(pks)
    cand = list(pks)
    cand[-1], cand[n // 2] = cand[n // 2], cand[-1]
    rcand = [next(k for k in rks if k.name == c.name) for c in cand]
    for p in sorted({0, n // 2}):
        want = RC.EventSimulator(rdev).simulate(rcand,
                                                start_state=ref_ck[p])
        assert PC.EventSimulator(pdev).simulate(
            cand, start_state=port_ck[p]) == want
        assert PR._FastEventSim(pdev).simulate(
            cand, start_state=port_ck[p])[0] == want
        assert PR._FastEventSim(pdev).simulate(
            cand, start_state=fast_ck[p])[0] == want


@pytest.mark.parametrize("maker,seed", _CASES)
def test_round_checkpoints_and_resume_bit_equal(maker, seed):
    both = _both(maker, 30 + seed, 6 + 4 * seed)
    (rks, rdev), (pks, pdev) = both["ref"], both["port"]
    t_ref, ref_ck = RR._FastRoundSim(rdev).simulate(rks, record=True)
    fast = PR._FastRoundSim(pdev)
    t_port, port_ck = fast.simulate(pks, record=True)
    assert t_port == t_ref == PC.RoundSimulator(pdev).simulate(pks)
    assert [_ckpt_view(c) for c in port_ck] == \
        [_ckpt_view(c) for c in ref_ck]
    for cp in port_ck:
        assert fast.simulate(pks, start_pos=cp.pos,
                             head_blocks=cp.blocks_left,
                             t0=cp.time)[0] == t_ref


@pytest.mark.parametrize("maker,seed", _CASES)
@pytest.mark.parametrize("model", ["event", "round"])
def test_delta_evaluators_bit_equal(maker, seed, model):
    both = _both(maker, 40 + seed, 8 + 3 * seed)
    ev = {pkg: _PKGS[pkg][1].DeltaEvaluator(dev, model=model)
          for pkg, (ks, dev) in both.items()}
    for pkg, (ks, _) in both.items():
        ev[pkg].rebase(ks)
    assert ev["port"].boundaries() == ev["ref"].boundaries()
    rng = random.Random(seed)
    n = len(both["ref"][0])
    for _ in range(6):
        i, j = rng.randrange(n), rng.randrange(n)
        out = {}
        for pkg, (ks, _) in both.items():
            cand = list(ks)
            cand.insert(j, cand.pop(i))
            out[pkg] = ev[pkg].evaluate_costed(cand, min(i, j))
        assert out["port"] == out["ref"]


# --------------------------------------------------------------------------
# refiners
# --------------------------------------------------------------------------

@pytest.mark.parametrize("maker,seed", _CASES)
@pytest.mark.parametrize("how", ["event", "round", "time_fn", "event-b8",
                                 "round-b8"])
def test_refine_order_bit_equal(maker, seed, how):
    both = _both(maker, 50 + seed, 7 + 2 * seed)
    out = {}
    for pkg, (ks, dev) in both.items():
        C, R = _PKGS[pkg][:2]
        model = how.split("-")[0]
        kw = dict(budget=40, neighborhood="full")
        if model == "time_fn":
            kw["time_fn"] = C.RoundSimulator(dev).simulate
        else:
            kw["model"] = model
        if how.endswith("b8"):
            kw["batch_size"] = 8
        order, t, evals = R.refine_order(ks, dev, **kw)
        out[pkg] = (_names(order), t, evals)
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("maker,seed", _CASES)
@pytest.mark.parametrize("batch_size", [None, 8])
def test_refined_schedule_bit_equal(maker, seed, batch_size):
    both = _both(maker, 60 + seed, 6 + 2 * seed)
    out = {pkg: _PKGS[pkg][1].refined_schedule(ks, dev, budget=30,
                                               batch_size=batch_size)
           for pkg, (ks, dev) in both.items()}
    assert _names(out["port"][0]) == _names(out["ref"][0])
    assert out["port"][1] == out["ref"][1]


@pytest.mark.parametrize("maker,seed", _CASES)
@pytest.mark.parametrize("model", ["event", "round"])
@pytest.mark.parametrize("neighborhood", ["full", "adjacent"])
def test_refine_order_batched_bit_equal(maker, seed, model, neighborhood):
    both = _both(maker, 70 + seed, 9 + seed)
    out = {}
    for pkg, (ks, dev) in both.items():
        order, t, evals = _PKGS[pkg][2].refine_order_batched(
            ks, dev, model=model, budget=25, neighborhood=neighborhood,
            batch_size=16)
        out[pkg] = (_names(order), t, evals)
    assert out["port"] == out["ref"]


# --------------------------------------------------------------------------
# batched simulators
# --------------------------------------------------------------------------

def _batched_inputs(maker, seed):
    """Rows of shuffled orders and, for half of them, a resume
    checkpoint recorded on the identity order (both packages)."""
    both = _both(maker, 80 + seed, 8 + 4 * seed)
    n = len(both["ref"][0])
    perms = [list(range(n))] + _perms(n, 7, seed)
    out = {}
    for pkg, (ks, dev) in both.items():
        C, R, B, _ = _PKGS[pkg]
        packed = B.PackedKernels.for_table(C.ProfileTable.build(ks, dev))
        orders = [[ks[i] for i in p] for p in perms]
        rows = np.stack([packed.rows(o) for o in orders])
        out[pkg] = (ks, dev, packed, orders, rows)
    return out, n


@pytest.mark.parametrize("maker,seed", _CASES)
def test_batched_round_sim_bit_equal(maker, seed):
    data, n = _batched_inputs(maker, seed)
    got = {}
    for pkg, (ks, dev, packed, orders, rows) in data.items():
        R, B = _PKGS[pkg][1:3]
        _, cps = R._FastRoundSim(dev).simulate(orders[0], record=True)
        use = [None if b % 2 or not cps else cps[min(b, len(cps) - 1)]
               for b in range(len(orders))]
        # a resume needs an order agreeing before the checkpoint: the
        # identity order itself
        rows_r = np.where(np.array([u is None for u in use])[:, None],
                          rows, rows[0][None, :])
        got[pkg] = (B.BatchedRoundSim(packed).times_from_checkpoints(
            rows, [None] * len(orders)),
            B.BatchedRoundSim(packed).times_from_checkpoints(rows_r, use))
        fast = R._FastRoundSim(dev)
        assert list(got[pkg][0]) == [fast.simulate(o)[0] for o in orders]
    for a, b in zip(got["port"], got["ref"]):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("maker,seed", _CASES)
def test_batched_event_sim_bit_equal(maker, seed):
    data, n = _batched_inputs(maker, seed)
    got = {}
    for pkg, (ks, dev, packed, orders, rows) in data.items():
        R, B = _PKGS[pkg][1:3]
        _, cps = R._FastEventSim(dev).simulate(orders[0], record=True)
        use = [None if b % 2 else cps[b % n] for b in range(len(orders))]
        rows_r = np.where(np.array([u is None for u in use])[:, None],
                          rows, rows[0][None, :])
        got[pkg] = (B.BatchedEventSim(packed).times(rows, [None] * len(rows)),
                    B.BatchedEventSim(packed).times(rows_r, use))
        fast = R._FastEventSim(dev)
        for b, o in enumerate(orders):
            want = fast.simulate(o)[0]
            assert abs(got[pkg][0][b] - want) <= B.EVENT_TIME_RTOL * want
    for a, b in zip(got["port"], got["ref"]):
        assert np.array_equal(a, b)


# --------------------------------------------------------------------------
# float32 pair scores, the experiments
# --------------------------------------------------------------------------

@pytest.mark.parametrize("maker,seed", _CASES)
def test_pair_score_matrix_batched_torch_cpu(maker, seed):
    both = _both(maker, 90 + seed, 10 + 5 * seed)
    tables = {pkg: _PKGS[pkg][0].ProfileTable.build(ks, dev)
              for pkg, (ks, dev) in both.items()}
    ref64 = RC.pair_score_matrix(tables["ref"])
    scale = max(float(np.max(np.abs(ref64))), 1.0)
    ref32 = RB.pair_score_matrix_batched(tables["ref"], backend="jax")
    got = PB.pair_score_matrix_batched(tables["port"], device="cpu")
    host = PB.pair_score_matrix_batched(tables["port"], backend="numpy")
    assert got.dtype == np.float32 and got.shape == ref32.shape
    assert np.array_equal(PC.pair_score_matrix(tables["port"]), ref64)
    assert np.abs(got.astype(np.float64) - ref32).max() \
        <= PB.F32_SCORE_RTOL * scale
    assert np.abs(got.astype(np.float64) - ref64).max() \
        <= PB.F32_SCORE_RTOL * scale
    assert np.array_equal(host, RB.pair_score_matrix_batched(
        tables["ref"], backend="numpy"))
    audit = PB.audit_pair_scores(tables["port"], device="cpu")
    assert audit["within_tol"] and audit["rtol"] == RB.F32_SCORE_RTOL
    with pytest.raises(ValueError):
        PB.pair_score_matrix_batched(tables["port"], backend="jax")


def test_tolerances_equal_the_reference():
    assert PB.F32_SCORE_RTOL == RB.F32_SCORE_RTOL
    assert PB.EVENT_TIME_RTOL == RB.EVENT_TIME_RTOL


_PROFILE_FIELDS = ("name", "n_blocks", "demands", "inst_per_block", "r",
                   "agg_blocks_per_unit")


@pytest.mark.parametrize("name", list(RC.EXPERIMENTS))
def test_experiments_field_equal(name):
    assert list(PC.EXPERIMENTS) == list(RC.EXPERIMENTS)
    ref, port = RC.experiment(name), PC.experiment(name)
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        for f in _PROFILE_FIELDS:
            assert getattr(a, f) == getattr(b, f), (name, f)
        assert a.mem_per_block() == b.mem_per_block()
    # the design-space protocol on one experiment: greedy and refined
    # event times equal
    assert (PC.simulate(PC.greedy_order_fast(port, PC.GTX580).order,
                        PC.GTX580)
            == RC.simulate(RC.greedy_order_fast(ref, RC.GTX580).order,
                           RC.GTX580))
    assert PC.refined_schedule(port, PC.GTX580, budget=50)[1] == \
        RC.refined_schedule(ref, RC.GTX580, budget=50)[1]


# --------------------------------------------------------------------------
# the reference tests' pins, on the port
# --------------------------------------------------------------------------

def test_event_delta_costs_suffix_fraction():
    ks = S.gpu_kernels(PC, random.Random(2), 16)
    ev = PC.DeltaEvaluator(PC.GTX580, model="event")
    ev.rebase(ks)
    cand = list(ks)
    cand[14], cand[15] = cand[15], cand[14]
    t, frac = ev.evaluate_costed(cand, 14)
    assert t == PC.EventSimulator(PC.GTX580).simulate(cand)
    assert frac == pytest.approx(2 / 16)
    assert ev.boundaries() is None


def test_cohort_merge_same_instant_only():
    dev = PC.DeviceModel(name="tiny", n_units=2, caps={"s": 4.0},
                         max_resident=8, compute_rate=1e9, mem_bw=1e9,
                         r_balanced=1.0)
    mk = PC.KernelProfile
    B = mk("B", n_blocks=1, demands={"s": 2.0}, inst_per_block=1e30, r=1e9)
    F = mk("F", n_blocks=1, demands={"s": 4.0}, inst_per_block=1e6, r=1e9)
    X = mk("X", n_blocks=1, demands={"s": 4.0}, inst_per_block=1e6, r=1e9)
    S = mk("S", n_blocks=1, demands={"s": 4.0}, inst_per_block=1e6, r=1e9)
    for sim_cls in (PC.EventSimulator, PR._FastEventSim):
        cp = sim_cls(dev).simulate([B, F, X, B, S], record=True)[1][4]
        b_cohorts = [c for c in cp.units[0][2] if c[0] is B]
        assert len(b_cohorts) == 2
        (_, n1, f1, t1), (_, n2, _, t2) = b_cohorts
        assert n1 == n2 == 1 and f1 == 1.0
        assert t1 == 0.0 and t2 > 0.0


def test_oversized_block_event_matches_round_exactly():
    dev = PC.DeviceModel(name="occ", n_units=2, caps={"s": 4.0, "w": 8.0},
                         max_resident=4, compute_rate=1e9, mem_bw=1e9,
                         r_balanced=1.0, sat_dim="w", sat_compute=4.0,
                         sat_memory=8.0)
    for nb in (1, 2, 5, 7):
        k = PC.KernelProfile("big", n_blocks=nb,
                             demands={"s": 8.0, "w": 2.0},
                             inst_per_block=3e8, r=2.0)
        t_event = PC.EventSimulator(dev).simulate([k])
        assert t_event == PC.RoundSimulator(dev).simulate([k])
        assert PR._FastEventSim(dev).simulate([k])[0] == t_event
    k = PC.KernelProfile("big", n_blocks=1, demands={"s": 8.0, "w": 2.0},
                         inst_per_block=3e8, r=2.0)
    raw = max(k.inst_per_block / dev.compute_rate,
              k.mem_per_block() / dev.mem_bw)
    assert PC.EventSimulator(dev).simulate([k]) > raw


@pytest.mark.parametrize("model", ["event", "round"])
def test_sat_dim_configs_match_reference(model):
    """Under the three sat_dim configurations (in caps, empty,
    set-but-untracked) the fast simulators equal the oracles, and the
    untracked one runs at peak."""
    rng = random.Random(31)
    base = dict(n_units=4, caps={"a": 100.0, "b": 50.0}, max_resident=4,
                compute_rate=1e9, mem_bw=1e9, r_balanced=2.0)
    devs = [PC.DeviceModel(name="insat", sat_dim="a", sat_compute=30.0,
                           sat_memory=80.0, **base),
            PC.DeviceModel(name="nosat", **base),
            PC.DeviceModel(name="oddsat", sat_dim="zz", sat_compute=30.0,
                           sat_memory=80.0, **base)]
    ks = [PC.KernelProfile(f"k{i}", n_blocks=rng.randint(1, 8),
                           demands={"a": rng.uniform(1, 40),
                                    "b": rng.uniform(1, 20)},
                           inst_per_block=rng.uniform(1e5, 1e7),
                           r=rng.uniform(0.5, 8.0)) for i in range(10)]
    fast = PR._FastEventSim if model == "event" else PR._FastRoundSim
    for dev in devs:
        assert fast(dev).simulate(ks)[0] == PC.simulate(ks, dev, model=model)
    assert (PC.simulate(ks, devs[2], model=model)
            == PC.simulate(ks, devs[1], model=model))


def test_refine_never_worse_and_exact():
    for model in ("event", "round"):
        for neighborhood in ("full", "adjacent", "auto"):
            ks = S.gpu_kernels(PC, random.Random(3), 12)
            t0 = PC.simulate(ks, PC.GTX580, model=model)
            order, t, _ = PC.refine_order(ks, PC.GTX580, model=model,
                                          budget=60,
                                          neighborhood=neighborhood)
            assert t <= t0 + 1e-15
            assert t == PC.simulate(order, PC.GTX580, model=model)


def test_percentile_rank_and_zero_r_pins():
    assert PC.percentile_rank(1.0, [2.0, 1.5, 1.0, 0.5]) == 75.0
    assert PC.percentile_rank(0.5, [2.0, 1.5, 1.0, 0.5]) == 100.0
    assert PC.percentile_rank(3.0, [2.0, 1.5, 1.0, 0.5]) == 0.0
    assert PC.percentile_rank(1.0, []) == 0.0
    a = PC.KernelProfile("zero", n_blocks=4, demands={"shm": 0.0},
                         inst_per_block=1e6, r=0.0)
    b = PC.KernelProfile("busy", n_blocks=4, demands={"shm": 0.0},
                         inst_per_block=1e6, r=10.0)
    rc = PC.combined_ratio(a, b, mode="harmonic")
    assert math.isfinite(rc) and rc == pytest.approx(0.0, abs=1e-12)
