#!/usr/bin/env python3
"""Trace the device memory of ``chip_smoke.py`` phase 10b on one card.

    python3 tools/stream_memory_trace.py [--pairs 1048576,262144 ...]
                                         [--out PATH] [--plain]

Runs phase 10b (``chip_smoke.stream_full_phase``: a cold session at the
first horizon, its batch run, a cold session at the second) once per
horizon pair, with every measured run under
``torch.cuda.memory._record_memory_history``. From each run's allocator
trace the allocated bytes are replayed event by event (``alloc`` adds a
block, ``free_completed`` takes it off, as the allocator's own
``allocated_bytes`` counter does), which finds the peak and the blocks
live at it; those are grouped by their innermost frame in
``repro_torch`` (and, inside a graph capture, by whether the block was
made by the warm-up on cloned state or by the capture itself). Beside
each session: M, the initial and final window width, the growth events,
the rounds, the peak of ``max_memory_allocated`` less what was held
before the run, the captured programs of the layout's set with the bytes
of their output buffers, and the plan's tensors. The first pair given is
run first and may be a small one: a fresh process's first session also
makes the allocations that stay for the life of the process.

With ``--plain`` nothing is recorded: the phase runs as in the script,
for its seconds and its own flatness lines. The phase's flatness verdict
is printed and does not stop the script. A summary goes to stdout, the whole record as JSON to ``--out``
(default ``chiprun_out/stream_memory_trace.json``). It needs one CUDA
card and imports no JAX.
"""

from __future__ import annotations

import argparse
import collections
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def _site(frames) -> str:
    """The innermost ``repro_torch`` frame of an allocation's stack, and
    under a capture whether the warm-up or the capture made it."""
    inner = None
    capture = None
    for f in frames:
        name = f.get("filename", "")
        if "repro_torch" not in name:
            continue
        where = (f"{name.split('repro_torch/')[-1]}:{f.get('line')} "
                 f"{f.get('name')}")
        if inner is None:
            inner = where
        if f.get("name") == "_capture" and name.endswith("graphs.py"):
            capture = f"graphs._capture:{f.get('line')}"
    if inner is None:
        inner = " <- ".join(f"{Path(f.get('filename', '?')).name}:"
                            f"{f.get('line')} {f.get('name')}"
                            for f in frames[:3]) or "(no frames)"
    return inner if capture is None else f"{inner} [in {capture}]"


def replay(trace):
    """(peak bytes above the start, index of the peak, the live blocks at
    the peak {addr: (size, site)}, bytes at the end)."""
    live = {}
    cur = peak = 0
    at = -1
    for i, e in enumerate(trace):
        act = e["action"]
        if act == "alloc":
            live[e["addr"]] = e["size"]
            cur += e["size"]
            if cur > peak:
                peak, at = cur, i
        elif act == "free_completed":
            live.pop(e["addr"], None)
            cur -= e["size"]
    end = cur
    blocks = {}
    for e in trace[:at + 1]:
        if e["action"] == "alloc":
            blocks[e["addr"]] = (e["size"], _site(e.get("frames", [])))
        elif e["action"] == "free_completed":
            blocks.pop(e["addr"], None)
    return peak, at, blocks, end


def grouped(blocks):
    """[(site, count, bytes)] of live blocks, largest first."""
    g = collections.defaultdict(lambda: [0, 0])
    for size, site in blocks.values():
        g[site][0] += 1
        g[site][1] += size
    return sorted(((s, c, b) for s, (c, b) in g.items()),
                  key=lambda x: -x[2])


def _set_record():
    """The cached program sets: each one's captured keys and the bytes of
    their output buffers, its state and its kept tensors (inputs, plan)."""
    from repro_torch.core import graphs
    out = []
    for key, ps in graphs._SETS.items():
        progs = {str(k): sum(t.untyped_storage().nbytes()
                             for t in p.outputs)
                 for k, p in ps._progs.items()}
        plan = ps.keep[1] if len(ps.keep) > 1 else None
        out.append(dict(
            width=key[3], lanes=key[1],
            programs=progs, outputs=sum(progs.values()),
            state=sum(t.untyped_storage().nbytes()
                      for t in graphs._leaves(ps.state)),
            fail=sum(t.untyped_storage().nbytes()
                     for t in graphs._leaves(ps.keep[0])),
            plan=None if plan is None else {
                name: [t.numel() * t.element_size()
                       for t in graphs._leaves(list(part.values())
                                               if isinstance(part, dict)
                                               else part)]
                for name, part in zip(plan._fields, plan)}))
    return out


RECORDS = []


class TracedMeasured(chip_smoke.Measured):
    """``chip_smoke.Measured`` with the run under the allocator's history;
    the trace starts after the cache is emptied and the held bytes
    read."""

    def __init__(self, fn, plan_s: float = 0.0, cold: bool = True):
        rec = {"cold": cold}

        def traced():
            torch.cuda.memory._record_memory_history(
                max_entries=4_000_000, stacks="python")
            try:
                return fn()
            finally:
                torch.cuda.synchronize()
                rec["snapshot"] = torch.cuda.memory._snapshot()
                torch.cuda.memory._record_memory_history(enabled=None)
                rec["sets"] = _set_record()

        super().__init__(traced, plan_s=plan_s, cold=cold)
        rec["peak_mib"] = self.peak_mib
        rec["held_mib"] = self.held_mib
        rec["wall_s"] = self.wall
        res = self.result
        if hasattr(res, "sketch"):      # a StreamResult
            rec.update(kind="session", m=res.spec.m, steps=res.spec.steps,
                       window_slots=res.spec.window_slots,
                       final_window_slots=res.final_window_slots,
                       growth=[(e.step, e.old_w, e.new_w)
                               for e in res.growth_events])
        else:
            rec.update(kind="batch")
        RECORDS.append(rec)


def analyse(rec) -> dict:
    snap = rec.pop("snapshot")
    trace = snap["device_traces"][0] if snap["device_traces"] else []
    peak, at, blocks, end = replay(trace)
    groups = grouped(blocks)
    out = {k: v for k, v in rec.items()}
    out.update(trace_events=len(trace), trace_peak=peak,
               trace_peak_mib=peak / 2 ** 20, trace_end=end,
               at_peak=[dict(site=s, blocks=c, bytes=b) for s, c, b in
                        groups],
               at_peak_total=sum(b for _, _, b in groups))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", nargs="+", default=[
        "65536,16384", "1048576,262144", "524288,131072"])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "stream_memory_trace.json"))
    ap.add_argument("--plain", action="store_true",
                    help="record nothing: the phase's seconds and lines")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("stream_memory_trace: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
    if not args.plain:
        chip_smoke.Measured = TracedMeasured
    report = []
    for pair in args.pairs:
        horizons = tuple(int(x) for x in pair.split(","))
        chip_smoke.STREAM_HORIZONS = horizons
        del RECORDS[:]
        t0 = time.perf_counter()
        try:
            chip_smoke.stream_full_phase()
            verdict = "passed"
        except AssertionError as e:
            verdict = f"failed: {e}"
        sec = time.perf_counter() - t0
        runs = [analyse(r) for r in RECORDS]
        gc.collect()
        report.append(dict(horizons=horizons, phase_s=sec, verdict=verdict,
                           runs=runs))
        print(f"== pair {horizons}: phase 10b {verdict} in {sec:.1f} s "
              f"(recording {'off' if args.plain else 'on'})", flush=True)
        for r in runs:
            head = (f"-- {r['kind']}" + (
                f" M={r['m']} steps={r['steps']} W={r['window_slots']} "
                f"final W={r['final_window_slots']} growth {r['growth']}"
                if r["kind"] == "session" else ""))
            print(f"{head}: peak {r['peak_mib']:.4f} MiB above "
                  f"{r['held_mib']:.3f} held (trace peak "
                  f"{r['trace_peak_mib']:.4f} MiB, {r['trace_events']} "
                  f"events, end {r['trace_end'] / 2 ** 20:.4f} MiB)")
            for s in r["sets"]:
                print(f"   set W={s['width']}: state {s['state']} B, fail "
                      f"{s['fail']} B, plan {s['plan']}, outputs "
                      f"{s['outputs']} B of {s['programs']}")
            for g in r["at_peak"][:25]:
                print(f"   {g['bytes']:>12,} B {g['blocks']:>6} blocks  "
                      f"{g['site']}")
    if not args.plain:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=1))
        print(f"written {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
