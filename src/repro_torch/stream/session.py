"""Streaming session driver — the engine as a resident service.

A :class:`StreamSession` builds an arrival-driven spec from a workload
(:mod:`repro_torch.stream.workload`), points the engine's horizon-mode
``drain_sink`` at a live telemetry pipeline (:mod:`repro_torch.obs.live`),
and runs the unbounded horizon in one engine invocation, on the card
unless the caller names another device:

  * per drained chunk (riding the pinned drain that already happens
    once a dispatch — zero extra dispatches or transfers), the sink folds the
    cumulative ``MetricsBlock`` snapshot into mergeable sketches,
    windowed rates and trend lines, runs the SLO watchdogs, and emits
    periodic ``LiveReport`` rows plus Perfetto counter samples;
  * host memory stays O(1) in stream length — no (B, M) output
    mirrors exist anywhere in the path;
  * offered and sustained load are priced against the analytic
    capacity model (``core/network.py``), so the result states
    "X% of analytic capacity sustained at fleet size N".

Multi-link sessions run the same workload across ``links`` engine
lanes — independent (fan-out) or chained through the topology engine's
:class:`~repro_torch.topology.engine.FloorPlanner` with history
retention off.

The signatures are the JAX package's, with one addition: ``device``
(default CUDA; with no card and no device named, ``run`` raises).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

import numpy as np

from ..core.simulator import (SimSpec, _resolve_device, _run_windowed_batch,
                              chunk_dispatch_count, chunk_trace_count,
                              host_sync_count, spec_with_failures)
from ..core.types import NetworkModel, RSMConfig, SimConfig
from ..obs.live import (LatencySketch, LiveAggregator, LiveReport,
                        LiveSample, SLOConfig, SLOEvent, SLOWatchdog)
from ..obs.metrics import ObsMetrics, obs_from_final
from ..obs.tracer import SpanTracer, current_tracer, tracing
from .workload import ArrivalProcess, arrivals_per_round, build_stream_spec

__all__ = ["StreamConfig", "StreamResult", "StreamSession",
           "analytic_capacity", "run_stream"]


def analytic_capacity(sender: RSMConfig, receiver: RSMConfig,
                      net: NetworkModel, window: int = 8,
                      resend_factor: float = 0.0) -> dict:
    """Analytic PICSOU capacity of one link, in per-second and
    per-round (one round = one cross-RSM RTT) units."""
    from ..core.protocols import analytic_throughput
    terms = analytic_throughput("picsou", sender, receiver, net,
                                resend_factor=resend_factor,
                                window=window)
    per_s = float(terms["throughput_msgs_per_s"])
    return {
        "msgs_per_s": per_s,
        "msgs_per_round": per_s * net.rtt_s,
        "bottleneck": terms["bottleneck"],
        "fleet": sender.n + receiver.n,
        "n_senders": sender.n,
        "n_receivers": receiver.n,
    }


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """One streaming session's service description."""

    horizon: int = 65536              # messages fed through the session
    process: ArrivalProcess = ArrivalProcess()
    utilization: Optional[float] = None  # calibrate rate to this
                                         # fraction of analytic capacity
    net: NetworkModel = NetworkModel()   # capacity model + RTT pricing
    slo: SLOConfig = SLOConfig()
    links: int = 1                    # engine lanes fed the workload
    chained: bool = False             # lane i gated on lane i-1's frontier
    report_every: int = 8             # chunks per LiveReport row/counter
    window_chunks: int = 8            # sliding window width (chunks)
    jsonl_path: Optional[str] = None  # stream LiveReport rows to disk
    echo: bool = False                # print dashboard rows as they land


@dataclasses.dataclass
class StreamResult:
    """Everything a finished (or drained-so-far) session knows."""

    config: StreamConfig
    spec: SimSpec
    delivered: int
    retired: int
    rounds: int                       # protocol rounds executed
    horizon: int
    sketch: LatencySketch             # cumulative, merge-built
    obs: List[ObsMetrics]             # per-lane device totals
    live: LiveReport
    slo_events: List[SLOEvent]
    capacity: dict                    # offered/sustained vs analytic
    counters: dict                    # dispatches/traces/syncs deltas
    final_window_slots: int
    growth_events: tuple
    spans: dict
    problems: List[str]               # live-vs-device invariant breaks

    def percentiles(self, qs=(50, 95, 99)) -> dict:
        return {"p%g" % q: self.sketch.percentile(q) for q in qs}

    def summary(self) -> str:
        cap = self.capacity
        p = self.percentiles()
        lines = [
            "stream session: %d/%d msgs delivered over %d rounds "
            "(%d lanes%s)" % (self.delivered,
                              self.horizon * self.config.links,
                              self.rounds, self.config.links,
                              ", chained" if self.config.chained else ""),
            "latency p50/p95/p99 = %d/%d/%d rounds; resends=%d "
            "losses=%d" % (p["p50"], p["p95"], p["p99"],
                           sum(int(o.resend_total) for o in self.obs),
                           sum(int(o.loss_events) for o in self.obs)),
            "offered %.2f msg/round (%.0f%% of analytic capacity); "
            "sustained %.2f msg/round = %.1f msg/s (%.0f%% of "
            "analytic, fleet %d, bottleneck %s)"
            % (cap["offered_msgs_per_round"],
               100.0 * cap["offered_frac"],
               cap["sustained_msgs_per_round"],
               cap["sustained_msgs_per_s"],
               100.0 * cap["sustained_frac"], cap["fleet"],
               cap["bottleneck"]),
            "dispatches=%d traces=%d syncs=%d window=%d slo_events=%d"
            % (self.counters["dispatches"], self.counters["traces"],
               self.counters["syncs"], self.final_window_slots,
               len(self.slo_events)),
        ]
        if self.problems:
            lines.append("PROBLEMS: " + "; ".join(self.problems))
        return "\n".join(lines)

    def to_json_dict(self) -> dict:
        return {
            "horizon": self.horizon,
            "links": self.config.links,
            "chained": self.config.chained,
            "process": dataclasses.asdict(self.config.process),
            "delivered": self.delivered,
            "retired": self.retired,
            "rounds": self.rounds,
            "latency_hist": np.asarray(
                self.sketch.lane_sum()).tolist(),
            "percentiles": self.percentiles(),
            "capacity": self.capacity,
            "counters": self.counters,
            "final_window_slots": self.final_window_slots,
            "growth_events": len(self.growth_events),
            "slo_events": [e.to_dict() for e in self.slo_events],
            "live_rows": self.live.total_rows,
            "problems": self.problems,
        }

    def save(self, prefix: str) -> dict:
        d = os.path.dirname(prefix)
        if d:
            os.makedirs(d, exist_ok=True)
        jpath = prefix + ".json"
        with open(jpath, "w") as f:
            json.dump(self.to_json_dict(), f, indent=1, default=float)
        paths = {"json": jpath}
        tpath = prefix + ".txt"
        with open(tpath, "w") as f:
            f.write(self.summary() + "\n\n" + self.live.dashboard())
        paths["dashboard"] = tpath
        return paths


class _EngineSink:
    """The engine's horizon-mode drain sink: aggregate, watch, report."""

    def __init__(self, cfg: StreamConfig, agg: LiveAggregator,
                 watchdog: SLOWatchdog, report: LiveReport):
        self.cfg = cfg
        self.agg = agg
        self.watchdog = watchdog
        self.report = report
        self.chunks = 0
        self.last_sample: Optional[LiveSample] = None
        self.final_state = None
        self.final_mc = None
        self.final_bases = None
        self.final_w = 0
        self.growth_events: tuple = ()
        self.rounds = 0

    def on_chunk(self, t_end, metrics, queue, block, bases) -> None:
        sample = self.agg.observe(t_end, metrics, bases, block)
        self.last_sample = sample
        self.chunks += 1
        events = self.watchdog.check(sample)
        tracer = current_tracer()
        if tracer is not None:
            for ev in events:
                tracer.instant(
                    "slo:%s" % ev.kind, cat="slo",
                    recovered=ev.recovered, t=ev.t,
                    value=ev.value, threshold=ev.threshold)
        if events or self.chunks % max(self.cfg.report_every, 1) == 0:
            self.report.add(sample, events)
            if tracer is not None:
                tracer.counter("stream/rate",
                               throughput=sample.throughput,
                               goodput=sample.goodput)
                tracer.counter("stream/backlog",
                               backlog=sample.backlog,
                               gc_lag=sample.gc_lag)
                tracer.counter("stream/latency", p99=sample.p99,
                               p99_recent=sample.p99_recent)
            if self.cfg.echo:
                print(self.report.dashboard(last_n=1).splitlines()[-1])

    def on_final(self, state, mc, bases, w, growth_events, t) -> None:
        # state: the final window's outputs; mc: the final MetricsBlock
        self.final_state = state
        self.final_mc = mc
        self.final_bases = np.asarray(bases)
        self.final_w = int(w)
        self.growth_events = tuple(growth_events)
        self.rounds = int(t)


class StreamSession:
    """One resident engine session fed by a workload generator."""

    def __init__(self, sender: RSMConfig, receiver: RSMConfig,
                 sim: SimConfig = SimConfig(),
                 config: StreamConfig = StreamConfig(),
                 failures=None, device=None):
        self.sender, self.receiver = sender, receiver
        self.device = device
        self.capacity = analytic_capacity(sender, receiver, config.net,
                                          window=sim.window)
        process = config.process
        if config.utilization is not None:
            rate = max(config.utilization
                       * self.capacity["msgs_per_round"], 1e-3)
            process = dataclasses.replace(process, rate=rate)
            config = dataclasses.replace(config, process=process)
        self.config = config
        self.spec = build_stream_spec(sender, receiver, sim, process,
                                      config.horizon)
        if failures is not None:
            self.spec = spec_with_failures(self.spec, failures)
        self.arrivals = arrivals_per_round(process, config.horizon)

    def _specs(self) -> List[SimSpec]:
        return [self.spec] * max(self.config.links, 1)

    def _compile_schedule(self, fail_schedule, n_lanes: int):
        """Normalize an attack schedule into the engine callback.

        Accepts the engine's native callable form, or a mapping
        ``{round: FailureScenario | SimSpec}`` applied to every lane —
        the convenient way to switch a palette adversary on and off
        mid-stream (``{t_on: scenario, t_off: FailureScenario.none()}``)
        and watch the SLO watchdogs breach and recover. Swap rounds
        must be chunk boundaries (the only host-observable points).
        """
        if fail_schedule is None or callable(fail_schedule):
            return fail_schedule
        chunk = max(self.spec.chunk_steps, 1)
        swaps = {}
        for t, f in fail_schedule.items():
            if int(t) % chunk != 0:
                raise ValueError(
                    f"attack schedule round {t} is not a chunk boundary "
                    f"(chunk_steps={chunk}); swaps can only take effect "
                    f"where the scan state is host-observable")
            s = f if isinstance(f, SimSpec) else \
                spec_with_failures(self.spec, f)
            swaps[int(t)] = [s] * n_lanes
        return lambda t: swaps.get(int(t))

    def run(self, tracer: Optional[SpanTracer] = None,
            fail_schedule=None) -> StreamResult:
        cfg = self.config
        device = _resolve_device(self.device)   # before any file opens
        specs = self._specs()
        n_lanes = len(specs)
        schedule = self._compile_schedule(fail_schedule, n_lanes)
        arrivals_cum = np.concatenate(
            [[0], np.cumsum(self.arrivals)]).astype(np.int64)
        agg = LiveAggregator(n_lanes, arrivals_cum,
                             window_chunks=cfg.window_chunks)
        watchdog = SLOWatchdog(cfg.slo)
        report = LiveReport(jsonl_path=cfg.jsonl_path)
        sink = _EngineSink(cfg, agg, watchdog, report)
        commit_floors = None
        if cfg.chained and n_lanes > 1:
            from ..topology.engine import FloorPlanner
            commit_floors = FloorPlanner.chain(n_lanes, self.spec.m,
                                               keep_history=False)
        tracer = tracer or SpanTracer()
        t0, d0, s0 = (chunk_trace_count(), chunk_dispatch_count(),
                      host_sync_count())
        try:
            with tracing(tracer):
                out = _run_windowed_batch(specs, device,
                                          commit_floors=commit_floors,
                                          fail_schedule=schedule,
                                          drain_sink=sink)
            assert out == []          # horizon mode returns no mirrors
        finally:
            report.close()
        counters = {"traces": chunk_trace_count() - t0,
                    "dispatches": chunk_dispatch_count() - d0,
                    "syncs": host_sync_count() - s0,
                    "chunks_drained": sink.chunks,
                    "live_rows": report.total_rows}

        obs = [obs_from_final(sink.final_mc, [], b)
               for b in range(n_lanes)]
        problems = self._validate(agg, obs)
        delivered = int(agg.delivered.sum())
        rounds = max(sink.rounds, 1)
        cap = dict(self.capacity)
        # sustained rate over the *loaded* rounds (the drain tail after
        # the last arrival serves stragglers, not offered load)
        active_rounds = max(len(self.arrivals), 1)
        sus_round = delivered / n_lanes / active_rounds
        cap.update(
            offered_msgs_per_round=float(cfg.process.rate),
            offered_frac=float(cfg.process.rate)
            / max(cap["msgs_per_round"], 1e-12),
            sustained_msgs_per_round=sus_round,
            sustained_msgs_per_s=sus_round / max(cfg.net.rtt_s, 1e-12),
            sustained_frac=sus_round / max(cap["msgs_per_round"], 1e-12),
        )
        return StreamResult(
            config=cfg, spec=self.spec, delivered=delivered,
            retired=int(agg.retired.sum()), rounds=rounds,
            horizon=cfg.horizon, sketch=agg.sketch(), obs=obs,
            live=report, slo_events=list(watchdog.events),
            capacity=cap, counters=counters,
            final_window_slots=sink.final_w,
            growth_events=sink.growth_events,
            spans=tracer.to_dict(), problems=problems)

    @staticmethod
    def _validate(agg: LiveAggregator, obs: List[ObsMetrics]) -> List[str]:
        """The live invariant: the sketch built purely by folding
        per-chunk deltas must equal the device's final cumulative
        histogram bit-exactly."""
        problems = []
        final_hist = np.stack([np.asarray(o.latency_hist, dtype=np.int64)
                               for o in obs])
        live_hist = np.asarray(agg.sketch().hist, dtype=np.int64)
        if live_hist.shape != final_hist.shape or \
                not np.array_equal(live_hist, final_hist):
            problems.append("live merged histogram != device final "
                            "histogram")
        for name in ("quack_events", "loss_events", "resend_total",
                     "uncounted", "occupancy_hwm", "gc_lag_hwm"):
            live_v = np.asarray(getattr(agg.cum, name)).reshape(-1)
            dev_v = np.asarray([getattr(o, name) for o in obs])
            if not np.array_equal(live_v, dev_v):
                problems.append(f"live {name} != device final")
        return problems


def run_stream(sender: RSMConfig, receiver: RSMConfig,
               sim: SimConfig = SimConfig(),
               config: StreamConfig = StreamConfig(),
               device=None) -> StreamResult:
    """One-call convenience wrapper around :class:`StreamSession`."""
    return StreamSession(sender, receiver, sim, config,
                         device=device).run()
