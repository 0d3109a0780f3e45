"""Host-side span tracer for the windowed engine's control loop.

Monotonic-clock wall-time spans with *explicit* begin/end. Every
timestamp is taken in the host loop between dispatches; the captured
programs never see a clock, so tracing changes nothing the device runs.

A :class:`SpanTracer` is installed for the dynamic extent of a run with
:func:`tracing`; the engine's instrumentation points go through
:func:`obs_begin` / :func:`obs_end`, which are no-ops (and take no
clock samples) when no tracer is installed.

Canonical span names emitted by the engine
(``tests/test_torch_obs.py`` asserts these):

  ``run``             whole ``_run_windowed_batch`` invocation
  ``compile``         a dispatch that captured at least one CUDA graph
                      (on the CPU: that ran a program for the first time
                      in its cached set, ``chunk_trace_count`` moving)
  ``dispatch``        replay of an already-captured chunk/superchunk
                      program, and the start of its drain
  ``drain_wait``      blocking wait for a dispatch's drained queue;
                      ``args.overlapped`` is True when the fetched
                      dispatch had a successor already in flight (the
                      drain overlapped device work)
  ``window_growth``   adaptive 2x window growth (state re-pad)
  ``dense_migration`` windowed -> dense layout fallback
  ``final_flush``     terminal state fetch + retire scatter
  ``plan_floors``     a commit-floor callback at a chunk boundary
                      (``cat="plan"``; topology runs)
  ``run_topology``    a whole ``repro_torch.topology.run_topology``
  ``checkpoint``      a recorder checkpoint (``cat="snapshot"``;
                      ``args.nbytes``: the host bytes it holds)
  ``replay_resume``   a whole ``repro_torch.replay`` resume

Export: :meth:`SpanTracer.export_chrome_trace` writes Chrome
trace-event JSON loadable in Perfetto / ``chrome://tracing``;
:meth:`SpanTracer.summary` renders a flamegraph-style text table.
Whether drains overlap the next dispatch is a number:
:meth:`SpanTracer.drain_overlap_ratio`.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

__all__ = [
    "Span",
    "CounterSample",
    "InstantEvent",
    "SpanTracer",
    "tracing",
    "current_tracer",
    "obs_begin",
    "obs_end",
    "obs_span",
]


@dataclass
class Span:
    """One closed wall-time interval."""

    name: str
    start_ns: int
    dur_ns: int
    cat: str = "host"
    args: Dict[str, Any] = field(default_factory=dict)


@dataclass
class CounterSample:
    """One sample on a named Perfetto counter track (``ph: "C"``)."""

    name: str
    ts_ns: int
    values: Dict[str, float] = field(default_factory=dict)


@dataclass
class InstantEvent:
    """One point-in-time marker (``ph: "i"``) — e.g. an SLO breach."""

    name: str
    ts_ns: int
    cat: str = "host"
    args: Dict[str, Any] = field(default_factory=dict)


class SpanTracer:
    """Collects :class:`Span` records against one monotonic origin.

    Besides duration spans it carries two live-telemetry event kinds:
    counter samples (numeric track values — throughput, backlog, p99 —
    rendered as Perfetto counter tracks) and instant events (SLO
    watchdog breaches / recoveries on the same timeline).
    """

    def __init__(self, pid: int = 0, tid: int = 0):
        self.pid = pid
        self.tid = tid
        self.origin_ns = time.monotonic_ns()
        self.spans: List[Span] = []
        self.counters: List[CounterSample] = []
        self.instants: List[InstantEvent] = []

    # -- recording ---------------------------------------------------

    def begin(self) -> int:
        return time.monotonic_ns()

    def counter(self, name: str, **values: float) -> CounterSample:
        cs = CounterSample(name=name, ts_ns=time.monotonic_ns(),
                           values={k: float(v) for k, v in values.items()})
        self.counters.append(cs)
        return cs

    def instant(self, name: str, cat: str = "host",
                **args: Any) -> InstantEvent:
        ev = InstantEvent(name=name, ts_ns=time.monotonic_ns(),
                          cat=cat, args=dict(args))
        self.instants.append(ev)
        return ev

    def end(self, begin_ns: int, name: str, cat: str = "host",
            **args: Any) -> Span:
        sp = Span(name=name, start_ns=begin_ns,
                  dur_ns=time.monotonic_ns() - begin_ns,
                  cat=cat, args=dict(args))
        self.spans.append(sp)
        return sp

    @contextmanager
    def span(self, name: str, cat: str = "host", **args: Any):
        b = self.begin()
        try:
            yield
        finally:
            self.end(b, name, cat, **args)

    # -- queries -----------------------------------------------------

    def names(self) -> List[str]:
        return [s.name for s in self.spans]

    def count(self, name: str) -> int:
        return sum(1 for s in self.spans if s.name == name)

    def total_ns(self, name: str) -> int:
        return sum(s.dur_ns for s in self.spans if s.name == name)

    def wall_ns(self) -> int:
        if not self.spans:
            return 0
        end = max(s.start_ns + s.dur_ns for s in self.spans)
        start = min(s.start_ns for s in self.spans)
        return end - start

    def no_drains(self) -> bool:
        """True when the run recorded zero ``drain_wait`` spans — the
        0.0 returned by :meth:`drain_overlap_ratio` then means "nothing
        to overlap", not "overlap failed" (dense path, empty runs)."""
        return not any(s.name == "drain_wait" for s in self.spans)

    def drain_overlap_ratio(self) -> float:
        """Fraction of drain-wait time spent with a successor dispatch
        already in flight (1.0 = every drain overlapped compute).

        Defined as 0.0 when there were no drain spans at all; check
        :meth:`no_drains` (exported as the ``no_drains`` field in
        :meth:`to_dict` / ``RunReport``) to tell the cases apart."""
        tot = over = 0
        for s in self.spans:
            if s.name != "drain_wait":
                continue
            tot += s.dur_ns
            if s.args.get("overlapped"):
                over += s.dur_ns
        return over / tot if tot else 0.0

    # -- export ------------------------------------------------------

    def to_chrome_trace(self) -> dict:
        events = []
        for s in self.spans:
            events.append({
                "name": s.name,
                "cat": s.cat,
                "ph": "X",
                "ts": (s.start_ns - self.origin_ns) / 1000.0,
                "dur": s.dur_ns / 1000.0,
                "pid": self.pid,
                "tid": self.tid,
                "args": s.args,
            })
        for c in self.counters:
            events.append({
                "name": c.name,
                "cat": "counter",
                "ph": "C",
                "ts": (c.ts_ns - self.origin_ns) / 1000.0,
                "pid": self.pid,
                "tid": self.tid,
                "args": c.values,
            })
        for ev in self.instants:
            events.append({
                "name": ev.name,
                "cat": ev.cat,
                "ph": "i",
                "s": "t",   # thread-scoped marker
                "ts": (ev.ts_ns - self.origin_ns) / 1000.0,
                "pid": self.pid,
                "tid": self.tid,
                "args": ev.args,
            })
        events.sort(key=lambda e: e["ts"])
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f, indent=None)
        return path

    def to_dict(self) -> dict:
        return {
            "origin_ns": self.origin_ns,
            "drain_overlap_ratio": self.drain_overlap_ratio(),
            "no_drains": self.no_drains(),
            "counter_samples": len(self.counters),
            "instant_events": len(self.instants),
            "spans": [{
                "name": s.name, "cat": s.cat,
                "start_ns": s.start_ns - self.origin_ns,
                "dur_ns": s.dur_ns, "args": s.args,
            } for s in self.spans],
        }

    def summary(self) -> str:
        """Flamegraph-style text rollup, widest spans first."""
        agg: Dict[str, List[int]] = {}
        for s in self.spans:
            ent = agg.setdefault(s.name, [0, 0])
            ent[0] += 1
            ent[1] += s.dur_ns
        wall = max(self.wall_ns(), 1)
        lines = ["%-16s %6s %12s %10s %7s"
                 % ("span", "count", "total_ms", "avg_ms", "%wall")]
        for name, (n, tot) in sorted(agg.items(),
                                     key=lambda kv: -kv[1][1]):
            lines.append("%-16s %6d %12.3f %10.3f %6.1f%%"
                         % (name, n, tot / 1e6, tot / 1e6 / n,
                            100.0 * tot / wall))
        if self.no_drains():
            lines.append("drain_overlap_ratio n/a (no_drains)")
        else:
            lines.append("drain_overlap_ratio %.3f"
                         % self.drain_overlap_ratio())
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Ambient tracer — engine hooks are no-ops unless one is installed.
# ---------------------------------------------------------------------------

_CURRENT: List[Optional[SpanTracer]] = [None]


def current_tracer() -> Optional[SpanTracer]:
    return _CURRENT[0]


@contextmanager
def tracing(tracer: SpanTracer):
    """Install ``tracer`` as the ambient tracer for this block."""
    prev = _CURRENT[0]
    _CURRENT[0] = tracer
    try:
        yield tracer
    finally:
        _CURRENT[0] = prev


def obs_begin() -> Optional[int]:
    """Timestamp for a prospective span; None (no clock sample) when
    tracing is disabled."""
    tr = _CURRENT[0]
    return tr.begin() if tr is not None else None


def obs_end(begin_ns: Optional[int], name: str, cat: str = "host",
            **args: Any) -> None:
    tr = _CURRENT[0]
    if tr is not None and begin_ns is not None:
        tr.end(begin_ns, name, cat, **args)


@contextmanager
def obs_span(name: str, cat: str = "host", **args: Any):
    b = obs_begin()
    try:
        yield
    finally:
        obs_end(b, name, cat, **args)
