"""Schedule tracing: per-kernel admission/completion timelines.

The paper's claim is a *timeline* claim — reordered launches fill
units that FIFO order leaves idle — but without a recorder the
simulators report only scalar makespans.  :class:`ScheduleTrace` is the
recorder the simulators feed when a caller passes ``trace=``:

* a **span** per kernel residency on a device unit — admitted at
  ``t0``, fully drained at ``t1``, carrying the block count;
* an **instant** per structural event — round boundaries from the
  round-based model, zero-work join retirements from the DAG models;
* a per-unit **busy-time** accumulator maintained independently of
  the spans (the dispatcher loop adds each ``dt`` it advances a unit
  through), which is what the conservation property in
  ``tests/test_obs.py`` checks span unions against.

The recorder is write-only during simulation — plain list appends and
float adds, no branching on content — and every instrumentation site
is guarded by ``if trace is not None``, so the null path costs one
pointer comparison (the bit-identity property: traced and untraced
runs produce the same floats because tracing only *reads* simulator
state).

Exports: :meth:`ScheduleTrace.to_chrome` renders Chrome-trace-event
JSON (one "process" per device unit, so Perfetto groups rows the way
the dispatcher does; load the file at https://ui.perfetto.dev), and
:meth:`ScheduleTrace.gantt` renders a terminal Gantt chart.
"""

from __future__ import annotations

import json

__all__ = ["ScheduleTrace"]


class ScheduleTrace:
    """Recorder for one (or several, via resume) simulator runs.

    ``label`` names the traced schedule in exports.  All times are in
    the simulators' modelled-time unit (seconds); Chrome export scales
    to microseconds, the trace-event wire unit.
    """

    def __init__(self, label: str = "schedule"):
        self.label = label
        #: (unit, name, t0, t1, blocks, category) complete spans
        self.spans: list[tuple[int, str, float, float, int, str]] = []
        #: (name, t, unit_or_None, category) instant events
        self.instants: list[tuple[str, float, int | None, str]] = []
        #: unit -> accumulated busy time (sum of dispatcher ``dt``
        #: advances while >= 1 cohort was resident)
        self.busy: dict[int, float] = {}
        self._t_max = 0.0

    # -- recording (called from inside simulator loops) ---------------

    def span(self, unit: int, name: str, t0: float, t1: float,
             blocks: int = 1, cat: str = "kernel") -> None:
        """Kernel ``name`` resident on ``unit`` from ``t0`` to ``t1``."""
        self.spans.append((unit, name, t0, t1, blocks, cat))
        if t1 > self._t_max:
            self._t_max = t1

    def instant(self, name: str, t: float, unit: int | None = None,
                cat: str = "event") -> None:
        """Zero-duration structural event (round boundary, join
        retirement).  ``unit=None`` scopes it to the whole device."""
        self.instants.append((name, t, unit, cat))
        if t > self._t_max:
            self._t_max = t

    def add_busy(self, unit: int, dt: float) -> None:
        self.busy[unit] = self.busy.get(unit, 0.0) + dt

    # -- derived views -------------------------------------------------

    @property
    def makespan(self) -> float:
        """Latest recorded event time."""
        return self._t_max

    def units(self) -> list[int]:
        us = {s[0] for s in self.spans} | set(self.busy)
        us.update(i[2] for i in self.instants if i[2] is not None)
        return sorted(us)

    def busy_of(self, unit: int) -> float:
        return self.busy.get(unit, 0.0)

    def span_union(self, unit: int) -> float:
        """Total time >= 1 span covers ``unit`` (interval union, so
        merged-cohort overlaps are not double-counted)."""
        ivs = sorted((t0, t1) for u, _, t0, t1, _, _ in self.spans
                     if u == unit)
        total, end = 0.0, float("-inf")
        for t0, t1 in ivs:
            if t0 > end:
                total += t1 - t0
                end = t1
            elif t1 > end:
                total += t1 - end
                end = t1
        return total

    def max_resident_blocks(self, unit: int) -> int:
        """Peak simultaneous resident blocks on ``unit`` over the
        trace (event sweep; span boundaries are half-open so a drain
        and a same-instant admit don't stack)."""
        events: list[tuple[float, int, int]] = []
        for u, _, t0, t1, blocks, _ in self.spans:
            if u != unit:
                continue
            events.append((t0, 1, blocks))   # admits after drains at t
            events.append((t1, 0, -blocks))
        events.sort()
        cur = peak = 0
        for _, _, d in events:
            cur += d
            if cur > peak:
                peak = cur
        return peak

    # -- exports -------------------------------------------------------

    def to_chrome(self) -> dict:
        """Chrome-trace-event JSON object (``traceEvents`` array).

        One trace-event *process* per device unit (``pid`` = unit
        index) so Perfetto renders a row group per unit, mirroring the
        dispatcher; spans are ``ph="X"`` complete events, structural
        instants ``ph="i"``.  Modelled seconds scale to the wire's
        microseconds.
        """
        ev: list[dict] = []
        units = self.units() or [0]
        for u in units:
            ev.append({"name": "process_name", "ph": "M", "pid": u,
                       "tid": 0,
                       "args": {"name": f"{self.label}: unit {u}"}})
        for u, name, t0, t1, blocks, cat in self.spans:
            ev.append({"name": name, "cat": cat, "ph": "X",
                       "ts": t0 * 1e6, "dur": (t1 - t0) * 1e6,
                       "pid": u, "tid": 0,
                       "args": {"blocks": blocks}})
        for name, t, u, cat in self.instants:
            ev.append({"name": name, "cat": cat, "ph": "i",
                       "ts": t * 1e6,
                       "pid": units[0] if u is None else u, "tid": 0,
                       "s": "g" if u is None else "t"})
        return {"traceEvents": ev, "displayTimeUnit": "ms"}

    def dump(self, path: str) -> None:
        """Write :meth:`to_chrome` JSON to ``path`` (open the file at
        https://ui.perfetto.dev or chrome://tracing)."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)

    def gantt(self, width: int = 72) -> str:
        """Plain-text Gantt chart: one row per unit, one symbol per
        kernel (legend below), ``*`` where distinct kernels overlap
        in a cell, ``.`` for idle."""
        span_end = self._t_max
        if not self.spans or span_end <= 0:
            return "(empty trace)"
        symbols = ("abcdefghijklmnopqrstuvwxyz"
                   "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789")
        sym: dict[str, str] = {}
        for _, name, _, _, _, _ in self.spans:
            if name not in sym:
                sym[name] = symbols[len(sym) % len(symbols)]
        scale = width / span_end
        lines = [f"{self.label}  (makespan {span_end:.4g}s, "
                 f"1 col = {span_end / width:.3g}s)"]
        for u in self.units():
            row = ["."] * width
            for su, name, t0, t1, _, _ in self.spans:
                if su != u:
                    continue
                i0 = min(width - 1, int(t0 * scale))
                i1 = min(width, max(i0 + 1, int(t1 * scale + 0.5)))
                ch = sym[name]
                for i in range(i0, i1):
                    row[i] = ch if row[i] in (".", ch) else "*"
            lines.append(f"unit {u:>2} |{''.join(row)}|")
        legend = ", ".join(f"{c}={n}" for n, c in
                           list(sym.items())[:24])
        lines.append(f"legend: {legend}"
                     + (" ..." if len(sym) > 24 else ""))
        for name, t, u, _ in self.instants[:16]:
            where = "device" if u is None else f"unit {u}"
            lines.append(f"  @{t:.4g}s [{where}] {name}")
        if len(self.instants) > 16:
            lines.append(f"  ... {len(self.instants) - 16} more events")
        return "\n".join(lines)
