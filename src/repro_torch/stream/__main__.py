"""CLI driver for the streaming session engine.

``python -m repro_torch.stream --selftest`` is the smoke check: it runs
a bounded 512-message horizon through the streaming session (constant
arrivals, K=8 pipelining) on the card (``--device cpu``: on the CPU) and
checks the live path against the batch path on the *same spec*:

  * live-aggregated percentiles / histograms must equal a post-hoc
    ``RunReport`` of the bounded prefix bit-exactly (the mergeable
    sketch algebra against the device oracle),
  * the streaming session must issue **zero additional device
    dispatches** versus plain batch-mode ``run_simulation`` of the
    identical spec (the telemetry rides the drains that already happen),
  * every message must be delivered, the SLO watchdogs must stay
    quiet on the failure-free stream, and the exported Chrome trace
    (now with counter tracks + instant events) must validate,

and writes the LiveReport artifacts (``stream.json`` / ``live.jsonl``
/ ``dashboard.txt`` / ``trace.json``) into ``--out``.
Exit code 0 = all checks passed.

Without ``--selftest`` it runs a session at user-chosen shape/workload
and prints the live dashboard + capacity calibration — e.g.::

    python -m repro_torch.stream --horizon 65536 --kind diurnal --rate 6
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from ..core.simulator import chunk_dispatch_count, run_simulation
from ..core.types import RSMConfig, SimConfig
from ..obs.report import report_from_results, validate_chrome_trace
from ..obs.tracer import SpanTracer, tracing
from .session import StreamConfig, StreamSession
from .workload import ArrivalProcess

_REQUIRED_SPANS = ("run", "drain_wait", "final_flush")


def _session(args) -> StreamSession:
    sim = SimConfig(window=4, phi=6, window_slots="auto",
                    chunk_steps=args.chunk_steps, superchunk=args.k)
    process = ArrivalProcess(kind=args.kind, rate=args.rate,
                             period=args.period, seed=args.seed)
    cfg = StreamConfig(
        horizon=args.horizon, process=process,
        utilization=args.utilization, links=args.links,
        chained=args.chained, report_every=args.report_every,
        jsonl_path=os.path.join(args.out, "live.jsonl"),
        echo=args.echo)
    return StreamSession(RSMConfig.bft(1), RSMConfig.bft(1), sim, cfg,
                         device=args.device)


def _write_artifacts(result, tracer, out: str) -> dict:
    os.makedirs(out, exist_ok=True)
    paths = result.save(os.path.join(out, "stream"))
    tpath = os.path.join(out, "trace.json")
    with open(tpath, "w") as f:
        json.dump(tracer.to_chrome_trace(), f)
    paths["trace"] = tpath
    print("# wrote " + " ".join(sorted(paths.values())))
    return paths


def selftest(args) -> int:
    """Bounded-horizon streaming gate; returns exit code."""
    session = _session(args)
    tracer = SpanTracer()
    d0 = chunk_dispatch_count()
    result = session.run(tracer=tracer)
    stream_dispatches = chunk_dispatch_count() - d0
    problems = list(result.problems)

    # (1) live aggregates vs a post-hoc RunReport of the same prefix:
    # batch-run the *identical spec* and compare sketches bit-exactly
    batch_tracer = SpanTracer()
    db = chunk_dispatch_count()
    with tracing(batch_tracer):
        batch = run_simulation(session.spec, device=args.device)
    batch_dispatches = chunk_dispatch_count() - db
    report = report_from_results([batch], batch_tracer,
                                 lane_names=["link"])
    problems += [f"posthoc: {p}" for p in report.validate()]
    live_hist = np.asarray(result.sketch.lane_sum(), dtype=np.int64)
    post_hist = np.asarray(report.obs["link"].latency_hist,
                           dtype=np.int64)
    if not np.array_equal(live_hist, post_hist):
        problems.append(f"live hist != post-hoc RunReport hist "
                        f"({live_hist.tolist()} vs {post_hist.tolist()})")
    if result.percentiles() != report.obs["link"].percentiles():
        problems.append(
            f"live percentiles {result.percentiles()} != post-hoc "
            f"{report.obs['link'].percentiles()}")

    # (2) zero extra device dispatches vs batch mode of the same spec
    if stream_dispatches != batch_dispatches:
        problems.append(f"stream mode used {stream_dispatches} "
                        f"dispatches, batch mode {batch_dispatches}")

    # (3) full delivery + quiet watchdogs on the failure-free stream
    if result.delivered != session.spec.m * args.links:
        problems.append(f"only {result.delivered}/"
                        f"{session.spec.m * args.links} delivered")
    breaches = [e for e in result.slo_events if not e.recovered]
    if breaches:
        problems.append(f"SLO breaches on failure-free stream: "
                        f"{[e.kind for e in breaches]}")

    # (4) trace schema (counter tracks + instants included) and the
    # canonical engine spans
    trace = tracer.to_chrome_trace()
    problems += [f"trace: {p}" for p in validate_chrome_trace(trace)]
    names = {e["name"] for e in trace["traceEvents"]}
    for want in _REQUIRED_SPANS:
        if want not in names:
            problems.append(f"span {want!r} missing from trace")
    if not any(e.get("ph") == "C" for e in trace["traceEvents"]):
        problems.append("no counter tracks in the live trace")

    # (5) flat-memory proxies: bounded dashboard, no O(M) mirrors
    if len(result.live.rows) > result.live.rows.maxlen:
        problems.append("LiveReport rows exceeded bound")

    print(result.summary())
    print()
    print(result.live.dashboard())
    _write_artifacts(result, tracer, args.out)
    if problems:
        print("\nSELFTEST FAILED:")
        for p in problems:
            print(f"  - {p}")
        return 1
    print(f"\nSELFTEST OK: {result.delivered} deliveries, "
          f"{stream_dispatches} dispatches (batch: {batch_dispatches}), "
          f"{result.counters['live_rows']} live rows, "
          f"{len(trace['traceEvents'])} trace events")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.stream",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--selftest", action="store_true",
                    help="run the streaming smoke check (512-msg horizon)")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: CUDA)")
    ap.add_argument("--horizon", type=int, default=512,
                    help="messages fed through the session")
    ap.add_argument("--kind", default="constant",
                    choices=("constant", "diurnal", "bursty",
                             "heavytail"))
    ap.add_argument("--rate", type=float, default=4.0,
                    help="mean arrivals per protocol round")
    ap.add_argument("--utilization", type=float, default=None,
                    help="calibrate rate to this fraction of analytic "
                         "capacity (overrides --rate)")
    ap.add_argument("--period", type=int, default=512,
                    help="diurnal cycle length in rounds")
    ap.add_argument("--links", type=int, default=1)
    ap.add_argument("--chained", action="store_true",
                    help="chain lane i behind lane i-1's GC frontier")
    ap.add_argument("--k", type=int, default=8,
                    help="superchunk fusion depth")
    ap.add_argument("--chunk-steps", type=int, default=16)
    ap.add_argument("--report-every", type=int, default=8,
                    help="chunks per LiveReport row / counter sample")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--echo", action="store_true",
                    help="print dashboard rows as chunks drain")
    ap.add_argument("--out", default="stream_out",
                    help="artifact directory (report + live jsonl + "
                         "chrome trace)")
    args = ap.parse_args(argv)

    if args.selftest:
        return selftest(args)
    session = _session(args)
    tracer = SpanTracer()
    result = session.run(tracer=tracer)
    print(result.summary())
    print()
    print(result.live.dashboard())
    _write_artifacts(result, tracer, args.out)
    for p in result.problems:
        print(f"WARNING: {p}")
    return 1 if result.problems else 0


if __name__ == "__main__":
    sys.exit(main())
