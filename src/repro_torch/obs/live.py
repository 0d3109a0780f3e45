"""Online aggregation over the engine's per-chunk drain feed.

Every drained chunk already carries a cumulative
:class:`~repro_torch.obs.metrics.MetricsBlock` snapshot (no extra
dispatch or transfer), and this module turns that feed into rolling
service telemetry:

  * :class:`LatencySketch` — a mergeable power-of-two latency sketch.
    Snapshots are cumulative, so consecutive ones are differenced into
    per-interval sketches
    (:func:`~repro_torch.obs.metrics.delta_metrics_block`) and re-merged
    (:func:`~repro_torch.obs.metrics.merge_metrics_blocks`); integer
    counters make every fold *bit-exact* in any association order, so
    the live totals equal a post-hoc ``RunReport`` of the same prefix
    exactly.
  * :class:`LiveAggregator` — folds the per-chunk feed into cumulative
    and windowed sketches, throughput/goodput/resend rates over a
    sliding chunk window, and GC-frontier-lag / backlog trend lines;
    emits one :class:`LiveSample` per chunk.
  * :class:`SLOWatchdog` — edge-triggered watchdogs (p99 delivery
    latency, resend rate, frontier stall) producing structured
    :class:`SLOEvent` records on breach/recovery transitions.
  * :class:`LiveReport` — bounded in-memory dashboard rows plus an
    append-only JSON-lines stream on disk; host memory stays O(1) in
    stream length.

The stream layer feeds it from the engine's drains (the JAX
package's horizon mode, ``drain_sink``); ``LiveAggregator.observe``
takes one drained chunk at a time from any caller.

Everything here is host-side numpy.
"""

from __future__ import annotations

import dataclasses
import json
import os
from collections import deque
from typing import Deque, List, Optional, Tuple

import numpy as np

from .metrics import (MetricsBlock, delta_metrics_block,
                      merge_metrics_blocks, percentile_from_hist,
                      zero_metrics_block)

__all__ = [
    "LatencySketch",
    "TrendLine",
    "LiveSample",
    "LiveAggregator",
    "SLOConfig",
    "SLOEvent",
    "SLOWatchdog",
    "LiveReport",
]


@dataclasses.dataclass
class LatencySketch:
    """Mergeable delivery-latency sketch (power-of-two histogram).

    Buckets are the engine's static edges, counts are integers — merging
    two sketches is elementwise addition, exact and associative.
    """

    hist: np.ndarray     # (..., NUM_LATENCY_BUCKETS) int64

    @classmethod
    def empty(cls, n_lanes: Optional[int] = None) -> "LatencySketch":
        return cls(hist=zero_metrics_block(n_lanes).latency_hist)

    def merge(self, other: "LatencySketch") -> "LatencySketch":
        return LatencySketch(hist=self.hist + other.hist)

    def lane_sum(self) -> np.ndarray:
        h = self.hist
        return h.sum(axis=0) if h.ndim > 1 else h

    def total(self) -> int:
        return int(self.hist.sum())

    def percentile(self, q: float) -> int:
        return percentile_from_hist(self.lane_sum(), q)

    def percentiles(self, qs=(50, 95, 99)) -> dict:
        return {"p%g" % q: self.percentile(q) for q in qs}


class TrendLine:
    """Bounded (t, value) series — the last ``maxlen`` observations."""

    def __init__(self, name: str, maxlen: int = 256):
        self.name = name
        self.points: Deque[Tuple[int, float]] = deque(maxlen=maxlen)

    def add(self, t: int, value: float) -> None:
        self.points.append((int(t), float(value)))

    def last(self) -> float:
        return self.points[-1][1] if self.points else 0.0

    def slope_per_round(self) -> float:
        """Least-squares slope over the retained points (0 if < 2)."""
        if len(self.points) < 2:
            return 0.0
        ts = np.array([p[0] for p in self.points], dtype=np.float64)
        vs = np.array([p[1] for p in self.points], dtype=np.float64)
        dt = ts - ts.mean()
        denom = float((dt * dt).sum())
        return float((dt * (vs - vs.mean())).sum() / denom) if denom else 0.0

    def to_list(self) -> List[Tuple[int, float]]:
        return list(self.points)


@dataclasses.dataclass
class LiveSample:
    """One per-chunk digest of the live feed (all lanes folded)."""

    t: int                    # protocol round at the chunk boundary
    delivered: int            # unique messages delivered, cumulative
    retired: int              # messages GC-retired out of the window
    backlog: int              # arrived (scheduled) - delivered
    gc_lag: int               # dispatched-by-now - slowest lane frontier
    resends: int              # cumulative resent messages
    losses: int               # cumulative loss-quorum triggers
    throughput: float         # wire msgs / round over the rate window
    goodput: float            # delivered msgs / round over the rate window
    resend_rate: float        # resends per delivered msg over the window
    p50: int                  # cumulative bucketed percentiles (rounds)
    p95: int
    p99: int
    p99_recent: int           # percentile over the rate window only
    occupancy_hwm: int
    rounds_elapsed: int

    def to_row(self) -> dict:
        return dataclasses.asdict(self)


class LiveAggregator:
    """Folds the horizon-mode drain feed into online aggregates.

    ``arrivals_cum[t]`` is the number of messages whose schedule round
    is ``< t`` (from the workload generator) — it prices backlog and
    frontier lag without touching the device.  The cumulative sketch is
    rebuilt purely through the delta/merge algebra, so the live path
    exercises exactly the code the merge-associativity tests pin down.
    """

    def __init__(self, n_lanes: int, arrivals_cum: np.ndarray,
                 window_chunks: int = 8, trend_len: int = 256):
        self.n_lanes = n_lanes
        self.arrivals_cum = np.asarray(arrivals_cum, dtype=np.int64)
        self.window_chunks = max(int(window_chunks), 1)
        self.prev_block: Optional[MetricsBlock] = None
        self.cum = zero_metrics_block(n_lanes)
        # (t, delta-block, delivered_cum, wire_cum) ring for rates
        self._ring: Deque[Tuple[int, MetricsBlock, int, int]] = deque(
            maxlen=self.window_chunks)
        self.delivered = np.zeros(n_lanes, dtype=np.int64)
        self.retired = np.zeros(n_lanes, dtype=np.int64)
        self.wire_total = 0
        self.chunks = 0
        self.gc_lag_trend = TrendLine("gc_lag", trend_len)
        self.backlog_trend = TrendLine("backlog", trend_len)
        self.occupancy_trend = TrendLine("occupancy", trend_len)

    def _arrived_by(self, t: int) -> int:
        idx = min(int(t), len(self.arrivals_cum) - 1)
        return int(self.arrivals_cum[idx]) if idx >= 0 else 0

    def observe(self, t_end: int, metrics, bases: np.ndarray,
                block: Optional[MetricsBlock]) -> LiveSample:
        """Fold one drained chunk; returns the chunk's digest."""
        self.chunks += 1
        if block is not None:
            delta = delta_metrics_block(self.prev_block, block)
            self.cum = merge_metrics_blocks(self.cum, delta)
            self.prev_block = block
        else:
            delta = zero_metrics_block(self.n_lanes)
        # StepMetrics.delivered is cumulative per round; cross/intra
        # are per-round wire counts
        dl = np.asarray(metrics.delivered)
        self.delivered = dl[..., -1].astype(np.int64).reshape(-1)
        self.retired = np.asarray(bases, dtype=np.int64).reshape(-1)
        wire = int(np.asarray(metrics.cross_msgs).sum()
                   + np.asarray(metrics.intra_msgs).sum())
        self.wire_total += wire
        self._ring.append((int(t_end), delta,
                           int(self.delivered.sum()), self.wire_total))

        arrived = self._arrived_by(t_end)
        backlog = max(arrived * self.n_lanes - int(self.delivered.sum()),
                      0)
        gc_lag = max(arrived - int(self.retired.min()), 0)
        occ = int(np.asarray(self.cum.occupancy_hwm).max())
        self.gc_lag_trend.add(t_end, gc_lag)
        self.backlog_trend.add(t_end, backlog)
        self.occupancy_trend.add(t_end, occ)

        t0, _, d0, w0 = self._ring[0]
        rounds = max(int(t_end) - t0, 1) if len(self._ring) > 1 else \
            max(int(t_end), 1)
        if len(self._ring) == 1:
            d0, w0 = 0, 0
        good = (int(self.delivered.sum()) - d0) / rounds
        thr = (self.wire_total - w0) / rounds
        recent = LatencySketch.empty(self.n_lanes)
        for _, dblk, _, _ in self._ring:
            recent = recent.merge(LatencySketch(hist=dblk.latency_hist))
        win_delivered = max(int(self.delivered.sum()) - d0, 0)
        win_resends = sum(int(np.asarray(dblk.resend_total).sum())
                          for _, dblk, _, _ in self._ring)
        cum_sketch = self.sketch()
        return LiveSample(
            t=int(t_end),
            delivered=int(self.delivered.sum()),
            retired=int(self.retired.sum()),
            backlog=backlog,
            gc_lag=gc_lag,
            resends=int(np.asarray(self.cum.resend_total).sum()),
            losses=int(np.asarray(self.cum.loss_events).sum()),
            throughput=thr,
            goodput=good,
            resend_rate=(win_resends / win_delivered
                         if win_delivered else 0.0),
            p50=cum_sketch.percentile(50),
            p95=cum_sketch.percentile(95),
            p99=cum_sketch.percentile(99),
            p99_recent=recent.percentile(99),
            occupancy_hwm=occ,
            rounds_elapsed=int(t_end),
        )

    def sketch(self) -> LatencySketch:
        """Cumulative latency sketch (folded deltas == latest snapshot,
        bit-exactly — the merge-algebra invariant)."""
        return LatencySketch(hist=np.asarray(self.cum.latency_hist))


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Breach thresholds; ``None`` disables a watchdog."""

    p99_latency_rounds: Optional[int] = 64    # recent p99 above this
    resend_rate: Optional[float] = 0.5        # resends per delivered msg
    frontier_stall_chunks: Optional[int] = 8  # chunks with no GC advance
                                              # while backlog is non-zero


@dataclasses.dataclass
class SLOEvent:
    """One edge-triggered watchdog transition."""

    kind: str          # "p99_latency" | "resend_rate" | "frontier_stall"
    t: int             # protocol round of the observation
    value: float
    threshold: float
    recovered: bool = False   # False = breach edge, True = recovery edge

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class SLOWatchdog:
    """Edge-triggered SLO monitors over :class:`LiveSample` digests.

    Emits one event when a rule first breaches and one when it
    recovers — not one per sample — so the tracer timeline stays
    readable at horizon scale.
    """

    def __init__(self, config: SLOConfig):
        self.config = config
        self._breached = {"p99_latency": False, "resend_rate": False,
                          "frontier_stall": False}
        self._stall_chunks = 0
        self._last_retired: Optional[int] = None
        self.events: List[SLOEvent] = []

    def _edge(self, kind: str, bad: bool, value: float,
              threshold: float, t: int, out: List[SLOEvent]) -> None:
        if bad != self._breached[kind]:
            self._breached[kind] = bad
            out.append(SLOEvent(kind=kind, t=t, value=float(value),
                                threshold=float(threshold),
                                recovered=not bad))

    def check(self, sample: LiveSample) -> List[SLOEvent]:
        cfg, out = self.config, []
        if cfg.p99_latency_rounds is not None:
            self._edge("p99_latency",
                       sample.p99_recent > cfg.p99_latency_rounds,
                       sample.p99_recent, cfg.p99_latency_rounds,
                       sample.t, out)
        if cfg.resend_rate is not None:
            self._edge("resend_rate",
                       sample.resend_rate > cfg.resend_rate,
                       sample.resend_rate, cfg.resend_rate,
                       sample.t, out)
        if cfg.frontier_stall_chunks is not None:
            stalled = (self._last_retired is not None
                       and sample.retired == self._last_retired
                       and sample.backlog > 0)
            self._stall_chunks = self._stall_chunks + 1 if stalled else 0
            self._last_retired = sample.retired
            self._edge("frontier_stall",
                       self._stall_chunks >= cfg.frontier_stall_chunks,
                       self._stall_chunks, cfg.frontier_stall_chunks,
                       sample.t, out)
        self.events.extend(out)
        return out


class LiveReport:
    """Bounded dashboard rows + append-only JSON-lines stream.

    ``rows`` keeps only the last ``maxlen`` samples in memory; when
    ``jsonl_path`` is given every row is also appended to disk as it
    happens, so a crash loses nothing and memory stays flat.
    """

    COLUMNS = ("t", "delivered", "backlog", "gc_lag", "throughput",
               "goodput", "resend_rate", "p50", "p95", "p99",
               "p99_recent")

    def __init__(self, maxlen: int = 256,
                 jsonl_path: Optional[str] = None):
        self.rows: Deque[dict] = deque(maxlen=maxlen)
        self.jsonl_path = jsonl_path
        self._fh = None
        self.total_rows = 0
        if jsonl_path:
            d = os.path.dirname(jsonl_path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._fh = open(jsonl_path, "w")

    def add(self, sample: LiveSample,
            slo_events: Optional[List[SLOEvent]] = None) -> dict:
        row = sample.to_row()
        if slo_events:
            row["slo_events"] = [e.to_dict() for e in slo_events]
        self.rows.append(row)
        self.total_rows += 1
        if self._fh is not None:
            self._fh.write(json.dumps(row, default=float) + "\n")
            self._fh.flush()
        return row

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def dashboard(self, last_n: int = 12) -> str:
        """Fixed-width text table over the most recent rows."""
        hdr = ("%8s %10s %9s %7s %8s %8s %7s %5s %5s %5s %6s"
               % ("t", "delivered", "backlog", "gclag", "thr/rnd",
                  "good/rnd", "resend", "p50", "p95", "p99", "p99w"))
        lines = [hdr]
        for row in list(self.rows)[-last_n:]:
            lines.append(
                "%8d %10d %9d %7d %8.2f %8.2f %6.1f%% %5d %5d %5d %6d"
                % (row["t"], row["delivered"], row["backlog"],
                   row["gc_lag"], row["throughput"], row["goodput"],
                   100.0 * row["resend_rate"], row["p50"], row["p95"],
                   row["p99"], row["p99_recent"]))
            for ev in row.get("slo_events", ()):
                tag = "recovered" if ev["recovered"] else "BREACH"
                lines.append("  !! slo:%s %s value=%.2f thr=%.2f"
                             % (ev["kind"], tag, ev["value"],
                                ev["threshold"]))
        return "\n".join(lines)
