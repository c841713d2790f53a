"""Serving engine with symbiotic round scheduling (the port of the
reference's ``repro.serve.engine``, flat path).

Every unit of pending work is characterised as a roofline work item —
a **prefill chunk** (compute-bound) or a **decode step**
(memory-bound) — and the unmodified Algorithm 1 composes execution
rounds that mix the two (:class:`~repro_torch.serve.composer.Composer`).
The rounds' ``modelled_time_s`` comes from the reference's TPU v5e
round cost model, unchanged, so the port composes exactly the rounds
the reference composes.

Execution is exact and eager: a prefill replays the prompt token by
token through :func:`repro_torch.models.transformer.decode_step`, a
decode is one ``decode_step``, and the next token is the argmax, all
under ``torch.inference_mode()`` on the parameters' device.  On a CUDA
device every ``decode_step`` goes through the port's RMSNorm and
decode-attention kernels.

The dependency-aware path (``respect_deps``) comes with the DAG slice.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.tpu import (TpuWorkItem, decode_profile, make_serving_device,
                        prefill_profile, round_time)
from ..models import transformer as T
from ..models.common import ModelConfig
from ..obs import LatencyTracker, MetricsRegistry, phase_breakdown
from .cache import ScheduleCache
from .composer import Composer

__all__ = ["Request", "ServingEngine", "SchedulerPolicy"]


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                    # (S,) int
    max_new_tokens: int = 16
    # runtime state
    generated: list[int] = field(default_factory=list)
    cache: object = None
    pos: int = 0
    done: bool = False


@dataclass
class SchedulerPolicy:
    kind: str = "symbiotic"               # fifo | symbiotic
    #: Schedule the per-layer dependency graph instead of flat
    #: per-request items (not ported yet: raises).
    respect_deps: bool = False
    #: ScheduleCache: reuse round compositions across steps whose
    #: work-item mix is equivalent (decode kv-lens bucketized).
    cache: bool = True
    kv_bucket: int = 256
    #: On a cache near-miss (exactly one request joined or left the
    #: mix since a cached step), adapt the cached composition instead
    #: of recomputing greedy + guard from scratch.
    warm_start: bool = True
    #: Stale-replay re-validation: a replayed cached pattern whose
    #: modelled time drifts more than this fraction from the time
    #: recorded when the pattern was stored — or whose rounds no
    #: longer fit device capacity on actual demands — is not replayed;
    #: the engine recomposes cold (``replay_revalidations``).  <= 0
    #: disables (optimistic replay).
    replay_drift_tol: float = 0.05
    #: Warm-start quality tracking: audit this fraction of warm hits by
    #: also recomputing the cold greedy composition and recording the
    #: modelled regret (``warm_regret_mean`` / ``warm_sampled``).
    warm_audit_frac: float = 0.0
    #: Online quality audit: deterministically sample this fraction of
    #: served steps and score the served composition against
    #: ``audit_k`` seeded random orders under the round cost model
    #: (``audit_quality_percentile{arch,kind}``; a verdict under
    #: ``audit_floor`` bumps ``audit_below_floor``).
    audit_frac: float = 0.0
    audit_k: int = 50
    audit_floor: float = 90.0
    audit_seed: int = 0


def _param_device(params) -> torch.device:
    node = params
    while isinstance(node, (dict, list)):
        node = next(iter(node.values())) if isinstance(node, dict) \
            else node[0]
    return node.device


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, *, max_len: int = 256,
                 n_params: float | None = None,
                 policy: SchedulerPolicy | None = None,
                 device=None, metrics: MetricsRegistry | None = None,
                 trace=None, recorder=None, schedule_cache=None):
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.policy = policy or SchedulerPolicy()
        if self.policy.respect_deps:
            raise NotImplementedError(
                "respect_deps needs repro.graph, repro.slice and "
                "serve.live, which are not ported yet (ROADMAP: "
                "'Dependency-aware composition')")
        self.n_params = n_params or float(T.count_params(params))
        #: the scheduler's device model (the v5e round cost model); the
        #: tensors run on :attr:`exec_device`
        self.device = device or make_serving_device()
        self.exec_device = _param_device(params)
        self.weights_bytes = 2.0 * self.n_params  # bf16 weight stream
        self.queue: list[Request] = []
        self._round_times: list[float] = []
        #: the unified registry: cache counters, composer guard timers
        #: and the engine's own phase timers all land here; ``run()``
        #: re-exports its snapshot.
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        #: optional schedule trace — when set, ``step()`` records one
        #: span per executed round member on the engine's modelled-round
        #: timeline (round boundaries as instants).  Read-only over
        #: already-computed round times.
        self.trace = trace
        self._trace_t = 0.0
        #: optional flight recorder: the composer and auditor emit
        #: schedule decisions, cache outcomes and audit verdicts.
        self.recorder = recorder
        #: a pre-built :class:`ScheduleCache` may be injected so several
        #: engine replicas share one pattern store; an injected cache
        #: keeps its own metrics registry.
        self.schedule_cache = (
            schedule_cache if schedule_cache is not None else
            ScheduleCache(kv_bucket=self.policy.kv_bucket,
                          metrics=self.metrics))
        self.composer = Composer(self.policy, self.device,
                                 self.weights_bytes,
                                 self.schedule_cache,
                                 recorder=recorder)
        #: per-request arrival→completion latency spans
        self.latency = LatencyTracker(self.metrics)
        self._completed_rids: set[int] = set()

    # -- workload characterisation -------------------------------------
    def _kv_bytes_per_token(self) -> float:
        cfg = self.cfg
        n_attn = sum(1 for i in range(cfg.n_layers)
                     if cfg.layer_kind(i) == "attn")
        if cfg.attn_type == "mla":
            per = cfg.kv_lora_rank + cfg.qk_rope_head_dim
        else:
            per = 2 * cfg.n_kv_heads * cfg.head_dim
        return float(n_attn * per * 2)  # bf16

    def _work_items(self) -> list[tuple[TpuWorkItem, Request, str]]:
        items = []
        kvb = self._kv_bytes_per_token()
        for r in self.queue:
            if r.done:
                continue
            if r.cache is None:
                it = prefill_profile(f"prefill:{r.rid}",
                                     n_params=self.n_params,
                                     seq_len=int(len(r.prompt)),
                                     kv_bytes_per_token=kvb)
                items.append((it, r, "prefill"))
            else:
                it = decode_profile(f"decode:{r.rid}",
                                    n_params=self.n_params,
                                    kv_len=r.pos,
                                    kv_bytes_per_token=kvb)
                items.append((it, r, "decode"))
        return items

    # -- execution -------------------------------------------------------
    def submit(self, reqs: list[Request]) -> None:
        self.queue.extend(reqs)
        for r in reqs:
            self.latency.arrive(r.rid)

    def _exec_prefill(self, r: Request) -> None:
        dev = self.exec_device
        toks = torch.as_tensor(np.asarray(r.prompt), dtype=torch.long,
                               device=dev)[None, :]
        cache = T.init_cache(self.cfg, 1, self.max_len, device=dev)
        # replay prompt through decode steps (correctness-first prefill)
        for s in range(toks.shape[1]):
            logits, cache = T.decode_step(self.params, self.cfg, toks[:, s],
                                          cache, s)
        r.cache = cache
        r.pos = int(toks.shape[1])
        r.generated.append(int(torch.argmax(logits[0])))

    def _exec_decode(self, r: Request) -> None:
        tok = torch.tensor([r.generated[-1]], dtype=torch.long,
                           device=self.exec_device)
        logits, r.cache = T.decode_step(self.params, self.cfg, tok, r.cache,
                                        r.pos)
        r.pos += 1
        r.generated.append(int(torch.argmax(logits[0])))
        if (len(r.generated) >= r.max_new_tokens or
                r.pos >= self.max_len - 1):
            r.done = True

    def step(self) -> int:
        """One scheduling iteration: compose rounds from the current
        queue and execute them.  Returns the number of rounds run.

        The composition pipeline is timed under the ``phase_compose``
        histogram and the execution loop under ``phase_execute``;
        sampled steps run the online quality audit under
        ``phase_audit``; with :attr:`trace` set, each executed round is
        recorded on the modelled-round timeline; the step's measured
        phase wall times are attributed to the requests it served."""
        self.metrics.counter("engine_steps").inc()
        phase0 = {ph: self.metrics.histogram(f"phase_{ph}").total
                  for ph in ("compose", "guard", "refine", "execute")}
        with self.metrics.timer("phase_compose"):
            items = self._work_items()
            if not items:
                return 0
            rounds = self.composer.compose(items)
        aud = self.composer.auditor
        if aud.sample_step():
            with self.metrics.timer("phase_audit"):
                aud.audit_flat(rounds, weights_bytes=self.weights_bytes,
                               arch=self.cfg.name, kind=self.policy.kind)
        n = 0
        with self.metrics.timer("phase_execute"), torch.inference_mode():
            for rd in rounds:
                rt = round_time([t[0] for t in rd], self.device,
                                self.weights_bytes)
                self._round_times.append(rt)
                if self.trace is not None:
                    t0 = self._trace_t
                    for it, r, kind in rd:
                        self.trace.span(0, it.name, t0, t0 + rt,
                                        cat=kind)
                    self.trace.instant(
                        f"round {len(self._round_times) - 1}",
                        t0 + rt, unit=0, cat="round")
                    self.trace.add_busy(0, rt)
                self._trace_t += rt
                for it, r, kind in rd:
                    if kind == "prefill":
                        self._exec_prefill(r)
                    else:
                        self._exec_decode(r)
                n += 1
        # Latency accounting: split this step's measured phase wall
        # times across the requests it served ("compose" net of its
        # guard/refine sub-intervals, so the shares partition the step),
        # then close spans for requests that just finished.
        delta = {ph: self.metrics.histogram(f"phase_{ph}").total - t0
                 for ph, t0 in phase0.items()}
        delta["compose"] = max(
            0.0, delta["compose"] - delta["guard"] - delta["refine"])
        served = {r.rid: r for rd in rounds for _, r, _ in rd}
        self.latency.attribute(served.keys(), delta)
        for rid, r in served.items():
            if r.done and rid not in self._completed_rids:
                self._completed_rids.add(rid)
                self.latency.complete(rid, tokens=len(r.generated))
        return n

    def run(self, max_iters: int = 10_000,
            arrivals: list[tuple[int, list[Request]]] | None = None) -> dict:
        """Run to completion; returns stats incl. modelled round times.

        ``arrivals``: optional [(iteration, requests)] injections — a
        continuous-arrival workload where prefill and decode work
        coexist in the queue.  The stats carry a ``"latency"`` block
        (per-request arrival→completion p50/p95/p99, queue quantiles,
        mean per-phase attribution and goodput over the run's wall
        time)."""
        t_wall0 = time.perf_counter()
        arrivals = list(arrivals or [])
        n_rounds = 0
        iters = 0
        while iters < max_iters:
            for when, reqs in list(arrivals):
                if when <= iters:
                    self.submit(reqs)
                    arrivals.remove((when, reqs))
            ran = self.step()
            if ran == 0 and not arrivals:
                break
            n_rounds += ran
            iters += 1
        total_tokens = sum(len(r.generated) for r in self.queue)
        return {
            "rounds": n_rounds,
            "total_new_tokens": total_tokens,
            "modelled_time_s": float(sum(self._round_times)),
            "modelled_tokens_per_s": total_tokens /
            max(sum(self._round_times), 1e-12),
            "schedule_cache": self.schedule_cache.stats(),
            "metrics": self.metrics.snapshot(),
            "phases": phase_breakdown(self.metrics),
            "latency": self.latency.stats(
                time.perf_counter() - t_wall0),
            "outputs": {r.rid: list(r.generated) for r in self.queue},
        }
