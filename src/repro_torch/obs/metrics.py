"""Unified metrics registry for the scheduler/serving stack.

Without it every component would keep its own ad-hoc counters — plain int
attributes on :class:`repro_torch.serve.cache.ScheduleCache`, a float on the
gated guard, nothing at all on the refiners — and ``stats()`` dicts
with no shared shape.  ``MetricsRegistry`` is the one sink they all
write to now:

* **Counters** — monotone floats (``cache_hits``, ``refine_evals``,
  ``gated_sims_saved``); support labels, so the cache's flat and dag
  namespaces share one name (``cache_hits{namespace=flat}``).
* **Gauges** — last-write-wins values (``cache_entries``).
* **Histograms** — count/total/min/max summaries of observations, fed
  either directly (:meth:`Histogram.observe`) or through the
  wall-clock :meth:`MetricsRegistry.timer` context (the profiling
  hooks around the engine's compose/guard/refine/execute phases).

The registry is deliberately dependency-free and cheap: metric
objects are plain ``__slots__`` instances resolved once and mutated
in place, so hot paths hold a reference instead of re-looking-up by
name.  ``snapshot()`` renders the whole registry as a flat
``{name_with_labels: value}`` dict (histograms expand to
``name.count`` / ``name.total_s`` / ...), which is what
``ServingEngine.run()`` re-exports and ``benchmarks/serving.py``
prints.
"""

from __future__ import annotations

import random
import time
import zlib

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]

#: Reservoir size for histogram quantiles.  256 samples bound the
#: p99 estimate's standard error to a few percentile points while
#: keeping ``observe()`` O(1) and the memory per series fixed.
RESERVOIR_SIZE = 256


def _fmt(name: str, labels: tuple[tuple[str, str], ...]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


class Counter:
    """Monotone accumulator.  ``inc()`` only; never decremented."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Gauge:
    """Last-write-wins value (e.g. current cache entry count)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Streaming count/total/min/max summary plus quantile reservoir.

    No buckets: the consumers here want means (seconds per phase per
    step), extrema, and tail quantiles, and a bucketed histogram would
    force a bucket layout choice on every caller.  Quantiles come from
    a fixed-size reservoir (Vitter's algorithm R) seeded from the
    series name, so two runs observing the same sequence produce
    bit-identical p50/p95/p99 — determinism the engine's
    bit-identity tests rely on.  ``observe()`` stays O(1).
    """

    __slots__ = ("name", "count", "total", "vmin", "vmax",
                 "_reservoir", "_rng")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        self._reservoir: list[float] = []
        # Seed from the labelled name: deterministic across runs and
        # processes (zlib.crc32, unlike hash(), is not salted).
        self._rng = random.Random(zlib.crc32(name.encode()))

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        if len(self._reservoir) < RESERVOIR_SIZE:
            self._reservoir.append(v)
        else:
            j = self._rng.randrange(self.count)
            if j < RESERVOIR_SIZE:
                self._reservoir[j] = v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Reservoir estimate of the ``q``-quantile (``0 <= q <= 1``).

        Exact while ``count <= RESERVOIR_SIZE``; an unbiased sample
        estimate beyond that.  Returns 0.0 for an empty histogram so
        snapshots stay schema-stable.
        """
        if not self._reservoir:
            return 0.0
        xs = sorted(self._reservoir)
        idx = min(len(xs) - 1, max(0, round(q * (len(xs) - 1))))
        return xs[idx]


class _Timer:
    """``with registry.timer("phase_compose"):`` wall-clock context.

    Re-entrant-safe because each ``with`` statement gets its own
    instance via :meth:`MetricsRegistry.timer`."""

    __slots__ = ("hist", "_t0")

    def __init__(self, hist: Histogram):
        self.hist = hist
        self._t0 = 0.0

    def __enter__(self) -> "_Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.hist.observe(time.perf_counter() - self._t0)


class MetricsRegistry:
    """Get-or-create registry of named counters/gauges/histograms.

    Labels are keyword arguments; ``counter("cache_hits",
    namespace="flat")`` and ``counter("cache_hits", namespace="dag")``
    are distinct series under one logical name.  Metric kinds share a
    namespace: registering ``x`` as a counter and again as a gauge is
    a programming error and raises.
    """

    def __init__(self):
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}

    def _get(self, cls, name: str, labels: dict) -> object:
        key = _fmt(name, tuple(sorted(labels.items())))
        m = self._metrics.get(key)
        if m is None:
            m = cls(key)
            self._metrics[key] = m
        elif type(m) is not cls:
            raise TypeError(
                f"metric {key!r} already registered as "
                f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def timer(self, name: str, **labels) -> _Timer:
        """Fresh wall-clock context feeding ``histogram(name)``."""
        return _Timer(self.histogram(name, **labels))

    def snapshot(self) -> dict:
        """Flat ``{labelled_name: value}`` view of every series.

        Counters and gauges render as their value; a histogram ``h``
        expands to ``h.count`` / ``h.total_s`` / ``h.mean_s`` /
        ``h.min_s`` / ``h.max_s`` plus reservoir-sampled quantiles
        ``h.p50_s`` / ``h.p95_s`` / ``h.p99_s`` (empty histograms
        report zeros so snapshots are schema-stable across runs).
        """
        out: dict[str, float | int] = {}
        for key, m in sorted(self._metrics.items()):
            if isinstance(m, Histogram):
                out[f"{key}.count"] = m.count
                out[f"{key}.total_s"] = m.total
                out[f"{key}.mean_s"] = m.mean
                out[f"{key}.min_s"] = m.vmin if m.count else 0.0
                out[f"{key}.max_s"] = m.vmax if m.count else 0.0
                out[f"{key}.p50_s"] = m.quantile(0.50)
                out[f"{key}.p95_s"] = m.quantile(0.95)
                out[f"{key}.p99_s"] = m.quantile(0.99)
            else:
                out[key] = m.value
        return out

    def reset(self, prefix: str | None = None) -> None:
        """Zero registered series in place (references held by hot
        paths stay valid).  ``prefix`` restricts the reset to series
        whose labelled name starts with it (``"cache_"`` lets
        :meth:`repro_torch.serve.cache.ScheduleCache.reset` zero its own
        series without touching an engine-shared registry's phase
        timers)."""
        for key, m in self._metrics.items():
            if prefix is not None and not key.startswith(prefix):
                continue
            if isinstance(m, Histogram):
                m.count, m.total = 0, 0.0
                m.vmin, m.vmax = float("inf"), float("-inf")
                m._reservoir.clear()
                m._rng = random.Random(zlib.crc32(m.name.encode()))
            else:
                m.value = 0.0
