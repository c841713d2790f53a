"""Deterministic synthetic LM data pipeline (the port of the reference's
``repro.data.pipeline``: host NumPy, bit for bit the same batches).

Host-sharded, checkpointable, with sequence-length bucketing that feeds
the scheduler's heterogeneous-microbatch composer.

The token stream is a seeded Zipfian mixture with local n-gram
structure — enough signal that a ~10M-param model's loss drops
measurably within a few hundred steps (used by the end-to-end example
and the integration tests), while requiring no external data.
"""

from __future__ import annotations

import threading
import queue as _queue
from dataclasses import dataclass, field
from typing import Iterator

import numpy as np

__all__ = ["DataConfig", "SyntheticLM", "BucketedBatcher", "Prefetcher"]


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1
    zipf_a: float = 1.3
    ngram: int = 3


class SyntheticLM:
    """Infinite deterministic token stream, shardable by host.

    State is the (host-local) step counter — checkpoint/restore is a
    single integer in the training manifest.
    """

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        self.cfg = cfg
        self.step = start_step
        # Fixed n-gram transition structure derived from the seed.
        rng = np.random.default_rng(cfg.seed)
        self._mix = rng.permutation(cfg.vocab)
        zipf_p = 1.0 / np.arange(1, cfg.vocab + 1) ** cfg.zipf_a
        self._p = zipf_p / zipf_p.sum()

    def _batch_rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.cfg.seed, self.cfg.host_id, step))

    @property
    def host_batch(self) -> int:
        return self.cfg.global_batch // self.cfg.n_hosts

    def next_batch(self) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = self._batch_rng(self.step)
        base = rng.choice(cfg.vocab, size=(self.host_batch, cfg.seq_len),
                          p=self._p)
        # n-gram structure: token depends on previous via fixed mixing.
        toks = base.copy()
        for i in range(1, cfg.seq_len):
            carry = self._mix[toks[:, i - 1]]
            mask = rng.random(self.host_batch) < 0.5
            toks[:, i] = np.where(mask, (carry + base[:, i]) % cfg.vocab,
                                  base[:, i])
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = toks[:, 0]
        self.step += 1
        return {"inputs": toks.astype(np.int32),
                "labels": labels.astype(np.int32)}

    # -- checkpointing -------------------------------------------------
    def state_dict(self) -> dict:
        return {"step": self.step}

    def load_state_dict(self, d: dict) -> None:
        self.step = int(d["step"])


@dataclass
class BucketedBatcher:
    """Groups variable-length sequences into per-bucket microbatches.

    Produces (bucket_len, batch) work items whose roofline profiles the
    scheduler (repro_torch.core.tpu) can order — long buckets are compute-
    bound, short buckets memory-bound relative to the step overhead.
    """

    buckets: tuple[int, ...] = (512, 1024, 2048, 4096)
    batch_per_bucket: int = 8

    def assign(self, lengths: np.ndarray) -> dict[int, np.ndarray]:
        out: dict[int, list[int]] = {b: [] for b in self.buckets}
        for i, ln in enumerate(lengths):
            for b in self.buckets:
                if ln <= b:
                    out[b].append(i)
                    break
            else:
                out[self.buckets[-1]].append(i)
        return {b: np.asarray(v, np.int32) for b, v in out.items() if v}


class Prefetcher:
    """Background-thread prefetch with bounded queue (pipeline overlap)."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: _queue.Queue = _queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def run():
            for item in it:
                if self._stop.is_set():
                    return
                self._q.put(item)
            self._q.put(None)

        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
