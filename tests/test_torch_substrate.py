"""``tests/test_substrate.py``'s twelve cases on the port (data
determinism, checkpoint atomicity and GC, optimizer behaviour, gradient
compression, the train loop's fault tolerance, compute/comm overlap),
plus its parity with the reference: byte-equal batches, bit-exact
checkpoint round trips, and the reference's on-disk layout and manifest.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data as RD
import repro.train as RTr
import repro.train.overlap as ROv

from repro_torch.data import BucketedBatcher, DataConfig, SyntheticLM
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               clip_by_global_norm, compress_int8,
                               decompress_int8, global_norm)
from repro_torch.train import (AsyncCheckpointer, LoopConfig, TrainLoop,
                               latest_step, restore_checkpoint,
                               save_checkpoint)
from torch_threads import one_torch_thread  # noqa: F401


# --------------------------------------------------------------------------
# data pipeline
# --------------------------------------------------------------------------

def test_data_deterministic_and_restorable():
    cfg = DataConfig(vocab=128, seq_len=32, global_batch=4)
    a = SyntheticLM(cfg)
    b1 = [a.next_batch() for _ in range(3)]
    state = a.state_dict()
    b2 = a.next_batch()
    # restore mid-stream on a "replacement host"
    c = SyntheticLM(cfg)
    c.load_state_dict(state)
    b2r = c.next_batch()
    np.testing.assert_array_equal(b2["inputs"], b2r["inputs"])
    # full determinism from scratch
    d = SyntheticLM(cfg)
    np.testing.assert_array_equal(b1[0]["inputs"],
                                  d.next_batch()["inputs"])


def test_data_host_sharding_disjoint_streams():
    k = dict(vocab=128, seq_len=16, global_batch=8, n_hosts=2)
    h0 = SyntheticLM(DataConfig(host_id=0, **k))
    h1 = SyntheticLM(DataConfig(host_id=1, **k))
    b0, b1 = h0.next_batch(), h1.next_batch()
    assert b0["inputs"].shape == (4, 16)
    assert not np.array_equal(b0["inputs"], b1["inputs"])


def test_bucketed_batcher():
    b = BucketedBatcher(buckets=(8, 16, 32))
    lengths = np.array([3, 9, 30, 33, 15])
    out = b.assign(lengths)
    assert list(out[8]) == [0]
    assert sorted(out[16]) == [1, 4]
    assert sorted(out[32]) == [2, 3]


@pytest.mark.parametrize("kw", [
    dict(vocab=128, seq_len=32, global_batch=4),
    dict(vocab=151936, seq_len=64, global_batch=8, seed=3),
    dict(vocab=512, seq_len=16, global_batch=8, n_hosts=2, host_id=1,
         zipf_a=1.1, ngram=2)], ids=["small", "qwen-vocab", "host1"])
def test_batches_byte_equal_to_reference(kw):
    """Seeded batches, a restored stream and the bucketing are the
    reference's, byte for byte."""
    ref, port = RD.SyntheticLM(RD.DataConfig(**kw)), \
        SyntheticLM(DataConfig(**kw))
    for _ in range(3):
        a, b = ref.next_batch(), port.next_batch()
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
                b[k].tobytes()
    assert ref.state_dict() == port.state_dict()
    lengths = np.random.default_rng(0).integers(1, 5000, 40)
    ra, pa = RD.BucketedBatcher().assign(lengths), \
        BucketedBatcher().assign(lengths)
    assert ra.keys() == pa.keys()
    assert all(ra[k].tobytes() == pa[k].tobytes() for k in ra)


def test_prefetcher_yields_in_order():
    from repro_torch.data import Prefetcher
    p = Prefetcher(iter(range(7)), depth=2)
    assert list(p) == list(range(7))
    p.close()


# --------------------------------------------------------------------------
# optimizer
# --------------------------------------------------------------------------

def test_adamw_decreases_quadratic():
    cfg = AdamWConfig(lr=0.1, warmup_steps=1, total_steps=100,
                      weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw_init(params)
    for _ in range(60):
        grads = {"w": 2 * params["w"]}   # d/dw of w^2
        params, state, _ = adamw_update(cfg, params, grads, state)
    assert float(params["w"].abs().max()) < 0.5


def test_grad_clip():
    tree = {"a": torch.full((4,), 10.0)}
    clipped, norm = clip_by_global_norm(tree, 1.0)
    assert float(norm) == pytest.approx(20.0)
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)


def test_int8_compression_roundtrip():
    x = {"g": torch.linspace(-3, 3, 100)}
    dec = decompress_int8(compress_int8(x))
    err = (dec["g"] - x["g"]).abs().max()
    assert float(err) <= 3.0 / 127 + 1e-6


# --------------------------------------------------------------------------
# checkpointing
# --------------------------------------------------------------------------

def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.bfloat16)}}


def test_checkpoint_roundtrip(tmp_path):
    d = str(tmp_path)
    t = _tree()
    save_checkpoint(d, 7, t, extra={"step": 7})
    assert latest_step(d) == 7
    restored, extra = restore_checkpoint(d, t)
    assert extra["step"] == 7
    np.testing.assert_array_equal(restored["a"].numpy(), t["a"].numpy())
    assert restored["b"]["c"].dtype == torch.bfloat16


def test_checkpoint_atomic_publish(tmp_path):
    """A torn tmp dir must not be visible as a checkpoint."""
    d = str(tmp_path)
    t = _tree()
    save_checkpoint(d, 1, t)
    os.makedirs(os.path.join(d, "step_00000002.tmp"))  # simulated crash
    assert latest_step(d) == 1
    restored, _ = restore_checkpoint(d, t)
    assert restored is not None


def test_checkpoint_gc_keeps_last(tmp_path):
    d = str(tmp_path)
    ck = AsyncCheckpointer(d, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _tree(), extra={"step": s})
        ck.wait()
    steps = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    assert steps == ["step_00000003", "step_00000004"]


def _mixed_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"layers": [{"w": torch.randn(3, 5, generator=g)
                                   .to(torch.bfloat16),
                                   "scale": torch.randn(5, generator=g)}],
                       "embed": torch.randn(7, 2, generator=g)},
            "opt": {"step": torch.tensor(12, dtype=torch.int32),
                    "m": torch.randn(2, 2, generator=g, dtype=torch.float64)}}


def test_checkpoint_bit_exact_and_casts_to_target(tmp_path):
    """Every leaf back bit for bit in its dtype (bf16 through its f32
    copy); a target of other dtypes gets its own; a target that leaves
    out a subtree restores the rest by key; resharding is refused until
    ``dist`` is ported."""
    d = str(tmp_path)
    t = _mixed_tree()
    save_checkpoint(d, 3, t, extra={"step": 3, "data": {"step": 3}})
    back, extra = restore_checkpoint(d, t)
    assert extra == {"step": 3, "data": {"step": 3}}
    for (a, b) in zip(_leaves(back), _leaves(t)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    other = {"params": {"layers": [{"w": torch.zeros(3, 5),
                                    "scale": torch.zeros(5,
                                                         dtype=torch.bfloat16)}],
                        "embed": torch.zeros(7, 2)}, "opt": None}
    part, _ = restore_checkpoint(d, other)
    assert part["opt"] is None
    assert part["params"]["layers"][0]["w"].dtype == torch.float32
    assert torch.equal(part["params"]["layers"][0]["w"],
                       t["params"]["layers"][0]["w"].float())
    assert part["params"]["layers"][0]["scale"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="shardings has 0 leaves"):
        restore_checkpoint(d, t, shardings={})
    with pytest.raises(KeyError):
        restore_checkpoint(d, {"params": {"nope": torch.zeros(1)}})


def _leaves(tree):
    from repro_torch.pytree import flatten
    return [v for _, v in flatten(tree)]


def test_checkpoint_layout_matches_reference(tmp_path):
    """The same tree saved by both packages: the same files, the same
    manifest (keys, shapes, dtype names, step, extra), and each package
    reads the other's checkpoint."""
    t = _mixed_tree(1)
    t["opt"]["m"] = t["opt"]["m"].float()
    ref_t = {"params": {"layers": [{
        "w": jnp.asarray(t["params"]["layers"][0]["w"].float().numpy(),
                         jnp.bfloat16),
        "scale": jnp.asarray(t["params"]["layers"][0]["scale"].numpy())}],
        "embed": jnp.asarray(t["params"]["embed"].numpy())},
        "opt": {"step": jnp.int32(12),
                "m": np.asarray(t["opt"]["m"].numpy())}}
    extra = {"step": 5, "data": {"step": 5}}
    save_checkpoint(str(tmp_path / "port"), 5, t, extra=extra)
    RTr.save_checkpoint(str(tmp_path / "ref"), 5, ref_t, extra=extra)
    for root in ("port", "ref"):
        assert sorted(os.listdir(tmp_path / root)) == ["LATEST",
                                                      "step_00000005"]
        assert sorted(os.listdir(tmp_path / root / "step_00000005")) == \
            ["MANIFEST.json", "shard_0.npz"]
    m_port, m_ref = (json.loads((tmp_path / r / "step_00000005" /
                                 "MANIFEST.json").read_text())
                     for r in ("port", "ref"))
    assert m_port == m_ref
    # each reads the other's
    back, _ = restore_checkpoint(str(tmp_path / "ref"), t)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(back), _leaves(t)))
    ref_back, _ = RTr.restore_checkpoint(str(tmp_path / "port"), ref_t)
    np.testing.assert_array_equal(
        np.asarray(ref_back["params"]["layers"][0]["w"], np.float32),
        t["params"]["layers"][0]["w"].float().numpy())


# --------------------------------------------------------------------------
# fault-tolerant loop
# --------------------------------------------------------------------------

def test_loop_retries_transient_failures(tmp_path):
    calls = {"n": 0}

    def flaky_step(params, opt_state, batch):
        calls["n"] += 1
        if calls["n"] == 2:           # one transient failure
            raise RuntimeError("simulated preemption")
        return params, opt_state, {"loss": torch.tensor(1.0)}

    data = SyntheticLM(DataConfig(vocab=16, seq_len=4, global_batch=2))
    loop = TrainLoop(step_fn=flaky_step, data=data,
                     cfg=LoopConfig(total_steps=3, ckpt_every=0,
                                    ckpt_dir=str(tmp_path),
                                    retry_backoff_s=0.0))
    p, o, hist = loop.run({}, {})
    assert len(hist) == 3
    assert calls["n"] == 4  # 3 successes + 1 retry


def test_loop_skips_nan_updates(tmp_path):
    step_count = {"n": 0}

    def nan_step(params, opt_state, batch):
        step_count["n"] += 1
        loss = torch.tensor(np.nan if step_count["n"] == 1 else 0.5)
        return {"w": params.get("w", 0) + 1}, opt_state, {"loss": loss}

    data = SyntheticLM(DataConfig(vocab=16, seq_len=4, global_batch=2))
    loop = TrainLoop(step_fn=nan_step, data=data,
                     cfg=LoopConfig(total_steps=2, ckpt_every=0,
                                    ckpt_dir=str(tmp_path)))
    p, o, hist = loop.run({"w": 0}, {})
    assert loop.nan_skips == 1
    assert len(hist) == 1  # the NaN update was discarded


# --------------------------------------------------------------------------
# compute/comm overlap scheduling
# --------------------------------------------------------------------------

def test_overlap_schedule_interleaves_and_reduces_exposed_comm():
    from repro_torch.train.overlap import (CommTask, ComputeTask,
                                           exposed_comm_time,
                                           overlap_schedule)
    # realistic magnitudes: one layer's backward ~4e12 FLOPs vs a
    # ~1 GB gradient bucket — combined intensity sits near R_B
    tasks = [ComputeTask(f"c{i}", 4e12) for i in range(4)] + \
            [CommTask(f"g{i}", 1e9) for i in range(4)]
    naive = [t.name for t in tasks]           # all compute then all comm
    sched = overlap_schedule(tasks)
    assert sorted(sched) == sorted(naive)
    t_naive = exposed_comm_time(naive, tasks)
    t_sched = exposed_comm_time(sched, tasks)
    assert t_sched < t_naive * 0.8            # overlap hides >=20%
    ref_tasks = [ROv.ComputeTask(f"c{i}", 4e12) for i in range(4)] + \
                [ROv.CommTask(f"g{i}", 1e9) for i in range(4)]
    assert sched == ROv.overlap_schedule(ref_tasks)
    assert t_sched == ROv.exposed_comm_time(sched, ref_tasks)


# --------------------------------------------------------------------------
# the port's test files: one torch thread each
# --------------------------------------------------------------------------

def test_every_port_test_file_runs_on_one_torch_thread():
    """Each ``tests/test_torch_*.py`` imports the module-scoped autouse
    fixture of ``tests/torch_threads.py`` at its top level, so that six
    test workers on a shared CPU do not each spin a full intra-op pool;
    and that fixture is in force in this module."""
    import ast
    from pathlib import Path

    files = sorted(Path(__file__).parent.glob("test_torch_*.py"))
    assert len(files) >= 20
    missing = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        if not any(isinstance(node, ast.ImportFrom)
                   and node.module == "torch_threads"
                   and any(a.name == "one_torch_thread" and a.asname is None
                           for a in node.names)
                   for node in tree.body):
            missing.append(path.name)
    assert not missing, f"no one-thread fixture in {missing}"
    assert torch.get_num_threads() == 1
