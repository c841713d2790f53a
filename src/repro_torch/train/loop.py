"""Fault-tolerant training loop (the port of the reference's
``repro.train.loop``).

Wraps the train step with the operational machinery a fleet
deployment needs:

* auto-resume from the latest valid checkpoint (atomic-publish format,
  see :mod:`repro_torch.train.checkpoint`), including data-pipeline state,
* periodic async checkpoints,
* retry-with-backoff around transient step failures (preemption,
  flaky interconnect); after ``max_retries`` the loop re-raises so the
  cluster scheduler can reschedule the job — which then auto-resumes,
* NaN/inf loss guard: skip the update (grads discarded) and count it;
  abort if the guard trips persistently,
* elastic restart: the checkpoint stores global logical shapes and is
  restored onto whatever mesh ``shardings`` describes.  With
  ``shardings`` the state between steps is this rank's blocks, plain
  tensors (what :func:`repro_torch.train.sharded.make_sharded_train_step`
  takes): a restore is cut to them, and a save wraps them as DTensors.

Straggler note: on real fleets the per-step all-reduce acts as a
barrier; mitigation here is (a) deterministic host-sharded data (any
host can be replaced and replays its stream from the manifest step) and
(b) bounded-staleness checkpoint cadence so a lost host costs at most
``ckpt_every`` steps of work.
"""

from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from ..data.pipeline import SyntheticLM
from .checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from .sharded import as_dtensors, local_blocks

__all__ = ["LoopConfig", "TrainLoop"]


@dataclass
class LoopConfig:
    total_steps: int = 200
    ckpt_every: int = 50
    ckpt_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    keep: int = 3
    log_every: int = 10
    max_retries: int = 3
    retry_backoff_s: float = 1.0
    max_nan_skips: int = 10


@dataclass
class TrainLoop:
    step_fn: Callable          # (params, opt_state, batch) -> (p, o, metrics)
    data: SyntheticLM
    cfg: LoopConfig
    log_fn: Callable[[int, dict], None] = lambda s, m: None
    # {"params", "opt"} NamedShardings when the state is this rank's blocks
    shardings: Any = None

    nan_skips: int = 0

    def resume_or_init(self, params, opt_state, shardings=None):
        """Returns (params, opt_state, start_step).  ``shardings``, where
        given, stands in for the ``shardings`` field for this call: the
        restore lands on it and is cut to this rank's blocks."""
        step = latest_step(self.cfg.ckpt_dir)
        if step is None:
            return params, opt_state, 0
        if shardings is None:
            shardings = self.shardings
        tree = {"params": params, "opt": opt_state}
        tree, extra = restore_checkpoint(self.cfg.ckpt_dir, tree,
                                         shardings=shardings)
        if shardings is not None:
            tree = local_blocks(tree)
        self.data.load_state_dict(extra.get("data", {"step": 0}))
        return tree["params"], tree["opt"], int(extra.get("step", step))

    def _saved(self, params, opt_state) -> dict:
        tree = {"params": params, "opt": opt_state}
        return (tree if self.shardings is None
                else as_dtensors(tree, self.shardings))

    def run(self, params, opt_state, start_step: int = 0) -> tuple:
        ckpt = AsyncCheckpointer(self.cfg.ckpt_dir, keep=self.cfg.keep)
        metrics_hist = []
        for step in range(start_step, self.cfg.total_steps):
            batch = self.data.next_batch()
            for attempt in range(self.cfg.max_retries + 1):
                try:
                    new_p, new_o, metrics = self.step_fn(
                        params, opt_state, batch)
                    break
                except Exception:
                    if attempt == self.cfg.max_retries:
                        ckpt.wait()
                        raise
                    time.sleep(self.cfg.retry_backoff_s * (2 ** attempt))
            loss = float(metrics["loss"])
            if not np.isfinite(loss):
                self.nan_skips += 1
                if self.nan_skips > self.cfg.max_nan_skips:
                    ckpt.wait()
                    raise FloatingPointError(
                        f"loss non-finite {self.nan_skips} times")
                continue  # skip the poisoned update
            params, opt_state = new_p, new_o
            metrics_hist.append(loss)
            if step % self.cfg.log_every == 0:
                self.log_fn(step, metrics)
            if self.cfg.ckpt_every and (step + 1) % self.cfg.ckpt_every == 0:
                ckpt.save(step + 1, self._saved(params, opt_state),
                          extra={"step": step + 1,
                                 "data": self.data.state_dict()})
        ckpt.save(self.cfg.total_steps, self._saved(params, opt_state),
                  extra={"step": self.cfg.total_steps,
                         "data": self.data.state_dict()})
        ckpt.wait()
        return params, opt_state, metrics_hist
