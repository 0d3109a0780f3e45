"""RunReport — the merged reporting surface of the observability stack.

One :class:`RunReport` joins the two halves of ``repro_torch.obs`` for a
single engine run:

  * the *device* half — per-lane
    :class:`~repro_torch.obs.metrics.ObsMetrics` drained from the metrics
    fabric (latency histograms, HWMs, event counters) plus the exact
    per-message ``delivery_latency`` arrays,
  * the *host* half — the :class:`~repro_torch.obs.tracer.SpanTracer`
    wall timeline (compile/dispatch/drain spans, drain-overlap ratio) and
    its Chrome-trace export.

Persistence is the repo's usual split: arrays go to one compressed
``.npz``, everything scalar/structural to a sibling ``.json``
(:meth:`RunReport.save` / :meth:`RunReport.load` round-trip
bit-exactly). :func:`validate_chrome_trace` schema-checks a trace
document against the Chrome Trace Event Format subset Perfetto loads;
:meth:`RunReport.validate` cross-checks the device histograms against
the per-message latency oracle and the drained delivery counts.

This module imports the simulator, so it is deliberately *not*
re-exported from ``repro_torch.obs.__init__`` (which the simulator
itself imports) — import it directly::

    from repro_torch.obs.report import run_reported
    result, report = run_reported(spec)            # on CUDA
    result, report = run_reported(spec, device="cpu")
    report.save("obs_out/report")

``python -m repro_torch.obs --selftest`` (``repro_torch.obs.__main__``)
drives this end to end; ``run_reported_topology`` does the same for a
whole ``repro_torch.topology.Topology``, one report lane per link.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.graphs import replay_count
from ..core.simulator import (SimSpec, _resolve_device, chunk_dispatch_count,
                              chunk_trace_count, host_sync_count,
                              run_simulation)
from .metrics import ObsMetrics, bucket_label, latency_histogram_np
from .tracer import SpanTracer, tracing

__all__ = ["RunReport", "validate_chrome_trace", "report_from_results",
           "run_reported", "run_reported_topology"]


def validate_chrome_trace(doc: dict) -> List[str]:
    """Schema-check a Chrome Trace Event Format document.

    Returns a list of problems (empty = valid): the subset Perfetto /
    ``chrome://tracing`` require for the event phases the tracer emits —
    complete spans ("ph": "X", with a non-negative numeric ``dur``),
    counter-track samples ("ph": "C", with all-numeric ``args``) and
    instant markers ("ph": "i") — plus ``traceEvents`` list shape,
    per-event name/cat/ts/pid/tid and JSON-serializable args.
    """
    problems: List[str] = []
    if not isinstance(doc, dict):
        return [f"document is {type(doc).__name__}, expected dict"]
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["missing/invalid traceEvents list"]
    last_ts = None
    for i, e in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(e, dict):
            problems.append(f"{where}: not a dict")
            continue
        for key, types in (("name", str), ("cat", str), ("ph", str),
                           ("ts", (int, float)),
                           ("pid", int), ("tid", int), ("args", dict)):
            if not isinstance(e.get(key), types):
                problems.append(f"{where}: bad/missing {key!r}")
        ph = e.get("ph")
        if isinstance(e.get("dur"), (int, float)) and e["dur"] < 0:
            problems.append(f"{where}: negative dur")
        if ph == "X":
            if not isinstance(e.get("dur"), (int, float)):
                problems.append(f"{where}: bad/missing 'dur'")
        elif ph == "C":
            args = e.get("args")
            if isinstance(args, dict) and (
                    not args or any(not isinstance(v, (int, float))
                                    for v in args.values())):
                problems.append(f"{where}: counter args must be "
                                f"non-empty numeric")
        elif ph == "i":
            if e.get("s") not in (None, "g", "p", "t"):
                problems.append(f"{where}: bad instant scope "
                                f"{e.get('s')!r}")
        else:
            problems.append(f"{where}: ph={ph!r}, expected one of "
                            f"'X'/'C'/'i'")
        if isinstance(e.get("ts"), (int, float)):
            if last_ts is not None and e["ts"] < last_ts:
                problems.append(f"{where}: ts not sorted")
            last_ts = e["ts"]
        try:
            json.dumps(e.get("args", {}))
        except TypeError:
            problems.append(f"{where}: args not JSON-serializable")
    return problems


@dataclasses.dataclass
class RunReport:
    """Merged device-metrics + host-span record of one engine run."""

    lane_names: List[str]
    obs: Dict[str, ObsMetrics]             # lane name -> device metrics
    latency: Dict[str, np.ndarray]         # lane name -> (M,) int32
    spans: dict                            # SpanTracer.to_dict()
    chrome_trace: dict                     # SpanTracer.to_chrome_trace()
    meta: dict = dataclasses.field(default_factory=dict)

    # -- tables ------------------------------------------------------

    def percentile_table(self) -> str:
        """Per-link latency/counter table (bucketed percentiles)."""
        hdr = ("%-12s %8s %6s %6s %6s %6s %6s %8s %8s"
               % ("link", "counted", "p50", "p95", "p99", "occ",
                  "gclag", "quacks", "resends"))
        lines = [hdr]
        for name in self.lane_names:
            o = self.obs[name]
            p = o.percentiles()
            lines.append("%-12s %8d %6d %6d %6d %6d %6d %8d %8d"
                         % (name, o.total_counted(), p["p50"], p["p95"],
                            p["p99"], o.occupancy_hwm, o.gc_lag_hwm,
                            o.quack_events, o.resend_total))
        return "\n".join(lines)

    def histogram_table(self, name: str) -> str:
        """One lane's latency histogram as label,count rows."""
        o = self.obs[name]
        rows = [f"# {name} delivery-latency histogram (rounds)"]
        for i, c in enumerate(np.asarray(o.latency_hist)):
            if c:
                rows.append("%-10s %d" % (bucket_label(i), int(c)))
        return "\n".join(rows)

    def no_drains(self) -> bool:
        """True when the traced run recorded zero drain spans (the
        overlap ratio is then vacuously 0.0, not a pipelining failure)."""
        return bool(self.spans.get("no_drains", False))

    def summary(self) -> str:
        parts = [self.percentile_table()]
        if self.no_drains():
            parts.append("drain_overlap_ratio n/a (no_drains)")
        else:
            ratio = self.spans.get("drain_overlap_ratio", 0.0)
            parts.append("drain_overlap_ratio %.3f" % ratio)
        if self.meta:
            parts.append("meta " + json.dumps(self.meta, sort_keys=True,
                                              default=str))
        return "\n".join(parts)

    # -- validation --------------------------------------------------

    def validate(self) -> List[str]:
        """Cross-check the report against its own oracles.

        Empty list = consistent: every lane's device histogram must
        equal the numpy histogram of its per-message latency array,
        histogram totals must equal drained (delivered) counts, and the
        Chrome trace must pass :func:`validate_chrome_trace`.
        """
        problems = list(validate_chrome_trace(self.chrome_trace))
        for name in self.lane_names:
            o, lat = self.obs[name], np.asarray(self.latency[name])
            oracle = latency_histogram_np(lat)
            if not np.array_equal(np.asarray(o.latency_hist), oracle):
                problems.append(f"{name}: device histogram != oracle "
                                f"({np.asarray(o.latency_hist).tolist()}"
                                f" vs {oracle.tolist()})")
            delivered = int((lat >= 0).sum())
            if o.total_counted() + o.uncounted != delivered:
                problems.append(
                    f"{name}: histogram total {o.total_counted()} + "
                    f"uncounted {o.uncounted} != delivered {delivered}")
            if o.per_chunk_hist is not None:
                part = np.asarray(o.per_chunk_hist)
                if part.size and not np.array_equal(
                        part[-1], np.asarray(o.latency_hist)):
                    problems.append(f"{name}: last per-chunk snapshot "
                                    f"!= final histogram")
        return problems

    # -- persistence -------------------------------------------------

    def to_json_dict(self) -> dict:
        return {
            "lane_names": list(self.lane_names),
            "meta": self.meta,
            "obs": {n: self.obs[n].to_dict() for n in self.lane_names},
            "spans": self.spans,
            "chrome_trace": self.chrome_trace,
        }

    def save(self, prefix: str) -> Dict[str, str]:
        """Write ``<prefix>.json`` + ``<prefix>.npz``; returns paths."""
        d = os.path.dirname(prefix)
        if d:
            os.makedirs(d, exist_ok=True)
        jpath, npath = prefix + ".json", prefix + ".npz"
        with open(jpath, "w") as f:
            json.dump(self.to_json_dict(), f, indent=1)
        arrays: Dict[str, np.ndarray] = {}
        for i, name in enumerate(self.lane_names):
            o = self.obs[name]
            p = f"l{i}."
            arrays[p + "latency_hist"] = np.asarray(o.latency_hist,
                                                    dtype=np.int64)
            arrays[p + "delivery_latency"] = np.asarray(
                self.latency[name], dtype=np.int32)
            if o.per_chunk_hist is not None:
                arrays[p + "per_chunk_hist"] = np.asarray(
                    o.per_chunk_hist, dtype=np.int64)
        np.savez_compressed(npath, **arrays)
        return {"json": jpath, "npz": npath}

    @classmethod
    def load(cls, prefix: str) -> "RunReport":
        with open(prefix + ".json") as f:
            meta = json.load(f)
        lane_names = list(meta["lane_names"])
        obs: Dict[str, ObsMetrics] = {}
        latency: Dict[str, np.ndarray] = {}
        with np.load(prefix + ".npz", allow_pickle=False) as d:
            for i, name in enumerate(lane_names):
                p, jo = f"l{i}.", meta["obs"][name]
                obs[name] = ObsMetrics(
                    latency_hist=d[p + "latency_hist"],
                    occupancy_hwm=int(jo["occupancy_hwm"]),
                    gc_lag_hwm=int(jo["gc_lag_hwm"]),
                    quack_events=int(jo["quack_events"]),
                    loss_events=int(jo["loss_events"]),
                    resend_total=int(jo["resend_total"]),
                    uncounted=int(jo["uncounted"]),
                    per_chunk_hist=(d[p + "per_chunk_hist"]
                                    if p + "per_chunk_hist" in d
                                    else None),
                )
                latency[name] = d[p + "delivery_latency"]
        return cls(lane_names=lane_names, obs=obs, latency=latency,
                   spans=meta["spans"], chrome_trace=meta["chrome_trace"],
                   meta=meta["meta"])


def report_from_results(results, tracer: SpanTracer,
                        lane_names: Optional[List[str]] = None,
                        meta: Optional[dict] = None) -> RunReport:
    """Assemble a :class:`RunReport` from engine outputs + a tracer.

    Every result must carry ``obs`` (run with
    ``SimConfig.collect_metrics=True``) and ``delivery_latency``.
    """
    names = (list(lane_names) if lane_names is not None
             else [f"lane{i}" for i in range(len(results))])
    obs: Dict[str, ObsMetrics] = {}
    latency: Dict[str, np.ndarray] = {}
    for name, r in zip(names, results):
        if r.obs is None:
            raise ValueError(
                f"lane {name!r} has no device metrics — run with "
                f"SimConfig.collect_metrics=True to build a RunReport")
        obs[name] = r.obs
        latency[name] = np.asarray(r.delivery_latency)
    return RunReport(lane_names=names, obs=obs, latency=latency,
                     spans=tracer.to_dict(),
                     chrome_trace=tracer.to_chrome_trace(),
                     meta=dict(meta or {}))


def _metrics_spec(spec: SimSpec) -> SimSpec:
    return (spec if spec.collect_metrics
            else dataclasses.replace(spec, collect_metrics=True))


def _traced(run, dev: torch.device):
    """``run()`` under a fresh tracer: ``(its result, the tracer, meta)``
    with the device and the engine's counter deltas (programs first used,
    dispatches, host syncs, CUDA graph replays)."""
    tracer = SpanTracer()
    before = _engine_counts()
    with tracing(tracer):
        result = run()
    traces, dispatches, syncs, replays = (
        a - b for a, b in zip(_engine_counts(), before))
    meta = {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "chunk_traces": traces,
        "chunk_dispatches": dispatches,
        "host_syncs": syncs,
        "graph_replays": replays,
    }
    return result, tracer, meta


def run_reported(spec: SimSpec, device=None):
    """Run one spec with the full observability stack on, on ``device``
    (default: CUDA; raises if it is absent).

    Forces ``collect_metrics`` on, installs a fresh tracer for the run,
    and returns ``(SimResult, RunReport)`` with the engine's counter
    deltas (programs first used, dispatches, host syncs, CUDA graph
    replays) and the device in ``report.meta``.
    """
    spec = _metrics_spec(spec)
    dev = _resolve_device(device)
    result, tracer, meta = _traced(
        lambda: run_simulation(spec, device=dev), dev)
    meta.update({
        "m": spec.m, "steps": spec.steps,
        "window_slots": int(spec.window_slots or 0),
        "superchunk": spec.superchunk,
        "delivered": int((np.asarray(result.deliver_time) >= 0).sum()),
    })
    return result, report_from_results([result], tracer,
                                       lane_names=["link"], meta=meta)


def run_reported_topology(topo, device=None):
    """Run a topology with the full observability stack on, on ``device``
    (default: CUDA; raises if it is absent).

    Returns ``(TopologyResult, RunReport)`` with one report lane per
    link, named by link name, and the engine's counter deltas and the
    device in ``report.meta``.
    """
    # local import: topology.engine imports the simulator like we do,
    # keeping the obs package's import surface acyclic
    from ..topology.engine import run_topology
    if not topo.sim.collect_metrics:
        topo = dataclasses.replace(
            topo, sim=dataclasses.replace(topo.sim, collect_metrics=True))
    dev = _resolve_device(device)
    tres, tracer, meta = _traced(lambda: run_topology(topo, device=dev),
                                 dev)
    names = [l.name for l in topo.links]
    meta["links"] = names
    results = [tres.links[n].result for n in names]
    return tres, report_from_results(results, tracer, lane_names=names,
                                     meta=meta)


def _engine_counts():
    """(programs first used, dispatches, host syncs, graph replays)."""
    return (chunk_trace_count(), chunk_dispatch_count(), host_sync_count(),
            replay_count())
