"""Seeded load generation for the serving front end (the port of
the reference's ``repro.serve.loadgen``, byte-equal to it).

Three arrival processes, all driven by plain :mod:`random` seeded
generators so fixed-seed traces are bit-stable goldens
(``tests/test_loadgen.py``):

* :func:`poisson_arrivals` — homogeneous Poisson: i.i.d. exponential
  inter-arrival gaps at ``rate`` requests per virtual second.
* :func:`bursty_arrivals` — on/off modulated Poisson: bursts of
  ``burst`` arrivals at ``rate * (1 + on_off_ratio)``, separated by
  exponential off-gaps sized so the long-run mean rate stays ``rate``.
* :func:`diurnal_arrivals` — inhomogeneous Poisson by thinning:
  ``lambda(t) = rate * (1 + depth * sin(2*pi*t / period))`` (a
  day/night cycle compressed to virtual seconds).

:func:`make_workload` turns a trace into ``(t_arrive, Request)`` pairs
with seeded prompt lengths and token budgets;
:class:`LoadGenerator` is the closed-loop driver: it shares the
frontend's virtual clock (arrivals beyond capacity queue up, so the
report captures real backpressure) and reduces
``ServingFrontend.stats()`` to the flat serving report —
p50/p99 latency, queue depth, goodput, rejection rate — that
``benchmarks/serving.py``'s ``frontend_bench`` section pins in
``BENCH_serving.json``.  Every number in the report derives from
seeded draws and modelled round times; none from the wall clock.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field

import numpy as np

from .engine import Request

__all__ = ["poisson_arrivals", "bursty_arrivals", "diurnal_arrivals",
           "ARRIVAL_PROCESSES", "make_workload", "LoadGenerator"]


def poisson_arrivals(n: int, rate: float, *, seed: int = 0,
                     t0: float = 0.0) -> list[float]:
    """``n`` arrival instants of a homogeneous Poisson process."""
    if rate <= 0:
        raise ValueError(f"rate must be positive (got {rate})")
    rng = random.Random(seed)
    t, out = float(t0), []
    for _ in range(n):
        t += rng.expovariate(rate)
        out.append(t)
    return out


def bursty_arrivals(n: int, rate: float, *, seed: int = 0,
                    t0: float = 0.0, burst: int = 8,
                    on_off_ratio: float = 9.0) -> list[float]:
    """On/off modulated Poisson: bursts at ``rate * (1+on_off_ratio)``
    with exponential off-gaps restoring the long-run mean ``rate``."""
    if rate <= 0 or on_off_ratio <= 0 or burst < 1:
        raise ValueError("need rate > 0, on_off_ratio > 0, burst >= 1")
    rng = random.Random(seed)
    hot = rate * (1.0 + on_off_ratio)
    gap_mean = burst * (1.0 / rate - 1.0 / hot)
    t, out = float(t0), []
    while len(out) < n:
        for _ in range(min(burst, n - len(out))):
            t += rng.expovariate(hot)
            out.append(t)
        t += rng.expovariate(1.0 / gap_mean)
    return out


def diurnal_arrivals(n: int, rate: float, *, seed: int = 0,
                     t0: float = 0.0, period: float = 32.0,
                     depth: float = 0.8) -> list[float]:
    """Inhomogeneous Poisson by thinning against the peak rate
    ``rate * (1 + depth)``; ``depth`` in [0, 1)."""
    if rate <= 0 or not 0.0 <= depth < 1.0 or period <= 0:
        raise ValueError("need rate > 0, 0 <= depth < 1, period > 0")
    rng = random.Random(seed)
    peak = rate * (1.0 + depth)
    t, out = float(t0), []
    while len(out) < n:
        t += rng.expovariate(peak)
        lam = rate * (1.0 + depth * math.sin(2.0 * math.pi * t / period))
        if rng.random() * peak <= lam:
            out.append(t)
    return out


ARRIVAL_PROCESSES = {
    "poisson": poisson_arrivals,
    "bursty": bursty_arrivals,
    "diurnal": diurnal_arrivals,
}


def make_workload(process: str, n: int, rate: float, *, seed: int = 0,
                  prompt_len: tuple[int, int] = (4, 8),
                  max_new_tokens: tuple[int, int] = (2, 6),
                  vocab: int = 128, rid0: int = 0,
                  **process_kw) -> list[tuple[float, Request]]:
    """``[(t_arrive, Request), ...]`` for a seeded arrival process.

    Request shapes (prompt length, token budget, prompt tokens) draw
    from an independent stream derived from the same seed, so the
    trace *and* the request mix are pinned together by one seed.
    """
    instants = ARRIVAL_PROCESSES[process](n, rate, seed=seed,
                                          **process_kw)
    rng = random.Random(seed ^ 0x5EED)
    out = []
    for k, t in enumerate(instants):
        plen = rng.randint(*prompt_len)
        prompt = np.array([rng.randrange(vocab) for _ in range(plen)],
                          np.int32)
        out.append((t, Request(rid0 + k, prompt,
                               max_new_tokens=rng.randint(
                                   *max_new_tokens))))
    return out


@dataclass
class LoadGenerator:
    """Closed-loop seeded load generator.

    :meth:`drive` runs the workload through a
    :class:`~repro_torch.serve.frontend.ServingFrontend` on its virtual
    clock and returns :meth:`report` — the flat, fully deterministic
    serving summary (p50/p99, queue depth, goodput, rejection rate).
    """

    process: str = "poisson"
    n_requests: int = 16
    rate: float = 4.0
    seed: int = 0
    prompt_len: tuple[int, int] = (4, 8)
    max_new_tokens: tuple[int, int] = (2, 6)
    vocab: int = 128
    #: extra kwargs for the arrival process (burst=, period=, ...)
    process_kw: dict = field(default_factory=dict)

    def workload(self, *, rid0: int = 0) -> list[tuple[float, Request]]:
        return make_workload(self.process, self.n_requests, self.rate,
                             seed=self.seed, prompt_len=self.prompt_len,
                             max_new_tokens=self.max_new_tokens,
                             vocab=self.vocab, rid0=rid0,
                             **self.process_kw)

    def drive(self, frontend, *, rid0: int = 0) -> dict:
        frontend.run(self.workload(rid0=rid0))
        return self.report(frontend)

    def report(self, frontend) -> dict:
        st = frontend.stats()
        lat = st["latency"]
        return {
            "process": self.process,
            "n_requests": self.n_requests,
            "rate": self.rate,
            "seed": self.seed,
            "virtual_time_s": st["virtual_time_s"],
            "completed": lat["completed"],
            "p50_s": lat["p50_s"],
            "p99_s": lat["p99_s"],
            "queue_p50_s": lat["queue_p50_s"],
            "queue_p99_s": lat["queue_p99_s"],
            "queue_depth_max": st["queue_depth_max"],
            "goodput_rps": lat["goodput_rps"],
            "goodput_tokens_per_s": lat["goodput_tokens_per_s"],
            "rejection_rate": st["rejection_rate"],
            "rejected": st["rejected"],
            "deferred_events": st["deferred_events"],
            "max_deferrals": st["max_deferrals"],
            "replica_steps": [r["steps"] for r in st["replicas"]],
        }
