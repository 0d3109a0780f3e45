"""Command line of the observability stack.

``python -m repro_torch.obs --selftest`` runs a 512-message K=8
pipelined windowed stream with the metrics fabric on and the span tracer
installed, on the card (``--device cpu`` runs it on the CPU), then
checks

  * the exported Chrome trace against the trace-event schema
    (:func:`repro_torch.obs.report.validate_chrome_trace`),
  * every device histogram against the numpy latency oracle and the
    drained delivery counts (:meth:`RunReport.validate`),
  * that the canonical engine span names actually showed up,
  * that metrics collection added no dispatch, host sync or CUDA graph
    replay and changed no output, against the metrics-off run of the
    same spec,

and writes the RunReport artifact (``report.json`` / ``report.npz`` /
``trace.json``) into ``--out``. Exit code 0 = all checks passed.

Without ``--selftest`` it runs the same pipeline at user-chosen shape
and prints the percentile table + span summary — a quick way to eyeball
a run's timeline before loading ``trace.json`` into Perfetto.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

from ..core.simulator import build_spec, run_simulation
from ..core.types import RSMConfig, SimConfig
from .report import _engine_counts, run_reported

# spans the engine must emit for any chunked windowed run
_REQUIRED_SPANS = ("run", "drain_wait", "final_flush")
_OUTPUTS = ("quack_time", "deliver_time", "retry", "recv_has",
            "gc_frontiers", "delivery_latency")


def _build(args) -> SimConfig:
    steps = args.msgs // args.window + 96
    return SimConfig(
        n_msgs=args.msgs, steps=steps, window=args.window, phi=6,
        window_slots=args.window_slots, chunk_steps=args.chunk_steps,
        superchunk=args.k, collect_metrics=True)


def _run(args):
    sim = _build(args)
    spec = build_spec(RSMConfig.bft(1), RSMConfig.bft(1), sim)
    result, report = run_reported(spec, device=args.device)
    return spec, result, report


def _write_artifacts(report, out: str) -> None:
    os.makedirs(out, exist_ok=True)
    paths = report.save(os.path.join(out, "report"))
    tpath = os.path.join(out, "trace.json")
    with open(tpath, "w") as f:
        json.dump(report.chrome_trace, f)
    print(f"# wrote {paths['json']} {paths['npz']} {tpath}")


def selftest(args) -> int:
    """512-msg K=8 observability self-test; returns exit code."""
    spec, result, report = _run(args)
    problems = report.validate()

    names = {e["name"] for e in report.chrome_trace["traceEvents"]}
    for want in _REQUIRED_SPANS:
        if want not in names:
            problems.append(f"span {want!r} missing from trace "
                            f"(got {sorted(names)})")
    if "compile" not in names and "dispatch" not in names:
        problems.append("neither compile nor dispatch spans recorded")

    lat = np.asarray(result.delivery_latency)
    delivered = int((lat >= 0).sum())
    if delivered != spec.m:
        problems.append(f"only {delivered}/{spec.m} messages delivered "
                        f"in the failure-free selftest stream")
    o = report.obs["link"]
    if o.total_counted() != delivered:
        problems.append(f"histogram total {o.total_counted()} != "
                        f"drained count {delivered}")

    # metrics-off twin: collection must add no dispatch, host sync or
    # graph replay, and change no output
    off = dataclasses.replace(spec, collect_metrics=False)
    before = _engine_counts()
    off_res = run_simulation(off, device=args.device)
    _, off_dispatches, off_syncs, off_replays = (
        a - b for a, b in zip(_engine_counts(), before))
    meta = report.meta
    for what, on_n, off_n in (
            ("dispatches", meta["chunk_dispatches"], off_dispatches),
            ("host syncs", meta["host_syncs"], off_syncs),
            ("graph replays", meta["graph_replays"], off_replays)):
        if on_n != off_n:
            problems.append(f"metrics-on used {on_n} {what}, metrics-off "
                            f"used {off_n}")
    for f in _OUTPUTS:
        if not np.array_equal(np.asarray(getattr(off_res, f)),
                              np.asarray(getattr(result, f))):
            problems.append(f"metrics collection changed {f}")

    print(report.summary())
    _write_artifacts(report, args.out)
    if problems:
        print("\nSELFTEST FAILED:")
        for p in problems:
            print(f"  - {p}")
        return 1
    print(f"\nSELFTEST OK on {meta['device']}: {delivered} deliveries, "
          f"{len(report.chrome_trace['traceEvents'])} spans, "
          f"{meta['chunk_dispatches']} dispatches, {meta['host_syncs']} "
          f"host syncs, {meta['graph_replays']} graph replays "
          f"(metrics-off: {off_dispatches}, {off_syncs}, {off_replays})")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--selftest", action="store_true",
                    help="run the observability self-test (512 msgs, K=8)")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: CUDA; 'cpu' "
                         "runs on the CPU)")
    ap.add_argument("--msgs", type=int, default=512)
    ap.add_argument("--k", type=int, default=8,
                    help="superchunk fusion depth")
    ap.add_argument("--window", type=int, default=4,
                    help="sender dispatch window per round")
    ap.add_argument("--window-slots", default=128,
                    help="W (int) or 'auto' (default 128: small streams "
                         "must still exercise the windowed kernel)")
    ap.add_argument("--chunk-steps", type=int, default=16)
    ap.add_argument("--out", default="obs_out",
                    help="artifact directory (report + chrome trace)")
    args = ap.parse_args(argv)
    if isinstance(args.window_slots, str) and args.window_slots != "auto":
        args.window_slots = int(args.window_slots)

    if args.selftest:
        return selftest(args)
    spec, result, report = _run(args)
    print(report.summary())
    print()
    print(report.histogram_table("link"))
    _write_artifacts(report, args.out)
    problems = report.validate()
    for p in problems:
        print(f"WARNING: {p}")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
