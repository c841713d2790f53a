"""Export layer: Prometheus text exposition and a JSONL flight
recorder.

Everything the stack observes — cache counters, phase timers, audit
verdicts, latency spans — lives in a
:class:`repro_torch.obs.MetricsRegistry` or happens as a discrete event.
This module gets both out of the process:

* :func:`prometheus_text` renders any registry in the Prometheus text
  exposition format (``# TYPE`` annotated; counters and gauges as
  single samples, histograms as summaries with ``quantile`` labels
  from the seeded reservoir plus ``_sum`` / ``_count``).
  :func:`parse_prometheus_text` is the matching reader — it exists so
  the round-trip is property-testable, and doubles as a minimal
  scrape parser for tests and tooling.

* :class:`FlightRecorder` is the JSONL event log: composers, the live
  frontier, the auditor, and the cache-replay paths emit discrete
  events (schedule decisions, cache outcomes, audit verdicts, rebuild
  reasons) via :meth:`FlightRecorder.event`.  Events carry a
  monotone ``seq`` instead of wall timestamps, so recorded runs are
  byte-identical across machines; :meth:`FlightRecorder.load` reads a
  dump back and :meth:`FlightRecorder.timeline` reconstructs a
  postmortem view (ordered, human-readable, with per-kind counts) —
  the mined-history substrate the ROADMAP's cross-step
  global-optimization direction will consume.

A ``None`` recorder is the null path everywhere (``if recorder is not
None`` at every emission site), mirroring the ``trace=None``
contract: recording must never change modelled times or served
tokens.
"""

from __future__ import annotations

import json
import re
from collections import Counter as _Counter

from .metrics import Counter, Gauge, Histogram, MetricsRegistry

__all__ = ["prometheus_text", "parse_prometheus_text",
           "FlightRecorder"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
#: summary quantiles exported per histogram (matches the reservoir
#: quantiles surfaced in ``MetricsRegistry.snapshot()``)
_QUANTILES = (0.5, 0.95, 0.99)


def _split_labels(key: str) -> tuple[str, list[tuple[str, str]]]:
    """``"cache_hits{namespace=flat}"`` -> ``("cache_hits",
    [("namespace", "flat")])`` (the registry's labelled-name format,
    see :func:`repro_torch.obs.metrics._fmt`)."""
    name, brace, rest = key.partition("{")
    if not brace:
        return key, []
    labels = []
    for part in rest.rstrip("}").split(","):
        k, _, v = part.partition("=")
        labels.append((k, v))
    return name, labels


def _sanitize(name: str) -> str:
    return _NAME_RE.sub("_", name)


def _label_str(labels: list[tuple[str, str]]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{_sanitize(k)}="{v}"' for k, v in labels)
    return "{" + inner + "}"


def prometheus_text(metrics: MetricsRegistry, *,
                    prefix: str = "repro_") -> str:
    """Prometheus text exposition of every series in ``metrics``.

    Counters/gauges render as single samples; a histogram renders as
    a summary — ``quantile``-labelled samples from its seeded
    reservoir plus ``_sum`` and ``_count``.  Series sharing a base
    name (label variants) share one ``# TYPE`` header.  Names are
    sanitized to the Prometheus charset and prefixed (default
    ``repro_``) so a scrape of several processes stays collision-free.
    """
    by_name: dict[str, list[tuple[list[tuple[str, str]], object]]] = {}
    kinds: dict[str, str] = {}
    for key, m in sorted(metrics._metrics.items()):
        name, labels = _split_labels(key)
        pname = prefix + _sanitize(name)
        by_name.setdefault(pname, []).append((labels, m))
        kinds[pname] = ("counter" if isinstance(m, Counter)
                        else "gauge" if isinstance(m, Gauge)
                        else "summary")
    lines: list[str] = []
    for pname, series in by_name.items():
        lines.append(f"# TYPE {pname} {kinds[pname]}")
        for labels, m in series:
            if isinstance(m, Histogram):
                for q in _QUANTILES:
                    ql = labels + [("quantile", repr(q))]
                    lines.append(f"{pname}{_label_str(ql)} "
                                 f"{m.quantile(q):.17g}")
                lines.append(f"{pname}_sum{_label_str(labels)} "
                             f"{m.total:.17g}")
                lines.append(f"{pname}_count{_label_str(labels)} "
                             f"{m.count}")
            else:
                lines.append(f"{pname}{_label_str(labels)} "
                             f"{m.value:.17g}")
    return "\n".join(lines) + ("\n" if lines else "")


def parse_prometheus_text(text: str) -> dict[str, float]:
    """Minimal exposition reader: ``{sample_name_with_labels: value}``
    for every non-comment sample line.  The inverse of
    :func:`prometheus_text` up to float formatting — the round-trip
    property ``tests/test_obs.py`` pins."""
    out: dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        # labels may contain spaces in values; split on the last space
        name, _, value = line.rpartition(" ")
        out[name] = float(value)
    return out


class FlightRecorder:
    """Append-only JSONL event log for serving decisions.

    Emission sites pass a short ``kind`` plus JSON-safe fields:
    ``rec.event("rebuild", reason="capacity")``.  Events get a
    monotone ``seq``; no wall timestamps, so a recorded run is
    deterministic and diffable.  ``max_events`` bounds memory (the
    oldest events are dropped FIFO once exceeded; the drop count is
    kept so a truncated log says so).
    """

    def __init__(self, max_events: int = 100_000):
        self.max_events = max_events
        self.events: list[dict] = []
        self.dropped = 0
        self._seq = 0

    def event(self, kind: str, **fields) -> None:
        ev = {"seq": self._seq, "kind": kind}
        ev.update(fields)
        self._seq += 1
        self.events.append(ev)
        if len(self.events) > self.max_events:
            del self.events[0]
            self.dropped += 1

    def __len__(self) -> int:
        return len(self.events)

    # -- serialization --------------------------------------------------
    def to_jsonl(self) -> str:
        """One JSON object per line, key-sorted for diffability."""
        return "".join(json.dumps(ev, sort_keys=True) + "\n"
                       for ev in self.events)

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_jsonl())

    @staticmethod
    def load(source: str) -> list[dict]:
        """Read a JSONL dump back into an event list.  ``source`` is a
        file path, or the JSONL text itself (anything containing a
        newline or starting with ``{`` is treated as text)."""
        if "\n" in source or source.lstrip().startswith("{"):
            text = source
        else:
            with open(source) as f:
                text = f.read()
        return [json.loads(line) for line in text.splitlines()
                if line.strip()]

    # -- postmortem -----------------------------------------------------
    @staticmethod
    def timeline(events: list[dict]) -> dict:
        """Reconstruct a postmortem view of a loaded event log.

        Returns ``{"n_events", "by_kind", "lines"}``: total count,
        per-kind counts, and one ordered human-readable line per
        event (``#seq kind: k=v ...``, fields key-sorted) — what a
        human reads first when a serving run went sideways, and the
        machine-readable substrate for mining schedule history."""
        events = sorted(events, key=lambda e: e.get("seq", 0))
        lines = []
        for ev in events:
            extra = " ".join(
                f"{k}={ev[k]}" for k in sorted(ev)
                if k not in ("seq", "kind"))
            lines.append(f"#{ev.get('seq', '?')} "
                         f"{ev.get('kind', '?')}"
                         + (f": {extra}" if extra else ""))
        return {"n_events": len(events),
                "by_kind": dict(_Counter(
                    e.get("kind", "?") for e in events)),
                "lines": lines}
