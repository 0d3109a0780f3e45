#!/usr/bin/env python3
"""Drive the torch port of the PICSOU simulator on one CUDA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each of which raises on failure (exit code non-zero):

1. The card's name and power limit, as nvidia-smi reports them.
2. Build every CUDA kernel of the main path from ``src/repro_torch/
   kernels/csrc`` (timed).
3. Kernel phase: ``quack_scan``'s CUDA result against its plain torch
   version on the card, both ``compute_lost`` settings, at the main
   path's shape (19, 19, 65536), ragged widths and R = 33 with random
   real stakes; mismatches must be 0. Device time per call at the main
   path's shape (CUDA events around a CUDA-graph replay that rotates over
   input sets totalling more than the 50 MB L2, so every call reads cold
   data), the plain version's time the same way, and the bytes bound.
4. Path phase: BFT f = 1, M = 1,024, a crashed sender and a Byzantine
   receiver, run on CUDA and on an explicitly requested CPU; every output
   must be bit-identical and the kernel must launch 2 x steps times.
5. Full-size phase: BFT f = 6 <-> f = 6 (n = 19, the paper's largest
   §6.1 network), M = 65,536, window 4, phi 32, failure-free and with
   ``crash_fraction(19, 19, 0.3, seed=2)``, through ``run_picsou``. Both
   runs must end fully delivered and fully quacked, with 2 x steps kernel
   launches each; failure-free exactly one cross copy per message and no
   resend, the crash run some resends.
6. Where a full-size round's time goes: torch.profiler over 60 rounds of
   the crash configuration (kernel time per round, device busy share).

The last lines are the ``kernels`` JSON line, and then
``{"ok": true, "device": {...}}``. Exits non-zero without printing a
result when there is no CUDA card or when the package is not beside it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s
# outside the tensor cores
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
SHAPE = (19, 19, 65536)          # (n_s, n_r, M) of the full-size phase
# rounds of the full-size runs: failure-free completes at round 869; the
# crash run is deterministic and completes at round 63,171
STEPS_FREE = 900
STEPS_CRASH = 64000
CU_SOURCE = "src/repro_torch/kernels/csrc/quack_scan.cu"
TPU_KERNEL = "src/repro/kernels/quack_scan.py:84"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


# ------------------------------------------------------------ phase 3
def quack_inputs(s, r, w, gen, real_stakes, dev):
    claims = torch.rand((s, r, w), generator=gen, device=dev) < 0.7
    comps = torch.rand((s, r, w), generator=gen, device=dev) < 0.3
    claims[:, : r // 2 + 1, : w // 3] = True     # long quacked prefixes
    if real_stakes:
        stakes = torch.rand((r,), generator=gen, device=dev) + 0.5
    else:
        stakes = torch.ones((r,), device=dev)
    qthr = (stakes.sum() * 0.6).reshape(())
    dthr = (stakes.sum() * 0.3).reshape(())
    return claims, comps, stakes, qthr, dthr


def compare(kernel_out, plain_out):
    """(mismatching entries, max |difference|) over all outputs."""
    bad, worst = 0, 0
    for k, p in zip(kernel_out, plain_out):
        if k is None or p is None:
            if not (k is None and p is None):
                raise AssertionError("one side returned no loss bitmap")
            continue
        if k.dtype != p.dtype or k.shape != p.shape:
            raise AssertionError(f"dtype/shape differ: {k.dtype}{k.shape} "
                                 f"vs {p.dtype}{p.shape}")
        d = (k.to(torch.int64) - p.to(torch.int64)).abs()
        bad += int((d != 0).sum())
        worst = max(worst, int(d.max()) if d.numel() else 0)
    return bad, worst


def graph_ms(fn, sets, calls_per_graph=16, replays=5, windows=5):
    """Device ms per call: CUDA events around ``replays`` replays of a
    CUDA graph of ``calls_per_graph`` calls rotating over ``sets`` (no
    host gaps), in ``windows`` timed windows. Returns the sorted
    per-window times; the median is the figure reported."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for a in sets:                       # warm up outside the graph
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls_per_graph):
            fn(*sets[i % len(sets)])
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / (replays * calls_per_graph))
    return sorted(times)


def bound_ms(s, r, w, compute_lost: bool):
    """Least time for the work: each input byte read once, each output
    byte written once, vs the f32 multiply-adds over the bitmaps."""
    maps = 2 if compute_lost else 1
    nbytes = maps * s * r * w + 4 * r + 4 * maps + maps * s * w + 4 * s
    flops = maps * 2 * s * r * w
    t_bytes, t_ops = nbytes / HBM_BPS, flops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def kernel_phase(dev):
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import quack_reference

    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = [(SHAPE, False), (SHAPE, True), ((19, 19, 65531), True),
              ((5, 33, 4099), True), ((5, 33, 4096), True)]
    result = {}
    for compute_lost in (True, False):
        bad = worst = 0
        for (s, r, w), real in shapes:
            a = quack_inputs(s, r, w, gen, real, dev)
            got = ops.quack_scan(*a, compute_lost=compute_lost)
            want = quack_reference(*a, compute_lost=compute_lost)
            torch.cuda.synchronize()
            b, wd = compare(got, want)
            log(f"[kernel] quack_scan compute_lost={compute_lost} "
                f"(S,R,W)={(s, r, w)} real_stakes={real}: {b} mismatches "
                f"(tolerance 0: bool/int32 outputs, same f32 sum order)")
            bad += b
            worst = max(worst, wd)
        # four input sets of 47.3 MB rotate, so no call finds its inputs
        # in the 50 MB L2
        sets = [quack_inputs(*SHAPE, gen, False, dev) for _ in range(4)]

        def kern(*a):
            return ops.quack_scan(*a, compute_lost=compute_lost)

        def plain(*a):
            return quack_reference(*a, compute_lost=compute_lost)

        k_times = graph_ms(kern, sets)
        p_times = graph_ms(plain, sets)
        ms, plain_ms = k_times[len(k_times) // 2], p_times[len(p_times) // 2]
        bms, by, nbytes = bound_ms(*SHAPE, compute_lost)
        log(f"[kernel] quack_scan compute_lost={compute_lost} at {SHAPE}: "
            f"{ms * 1e3:.2f} us/call median of {len(k_times)} windows "
            f"(min {k_times[0] * 1e3:.2f}, max {k_times[-1] * 1e3:.2f}); "
            f"plain torch {plain_ms * 1e3:.2f} us (min "
            f"{p_times[0] * 1e3:.2f}, max {p_times[-1] * 1e3:.2f}); bound "
            f"{bms * 1e3:.2f} us by {by} ({nbytes / 1e6:.1f} MB), "
            f"{bms / ms:.1%} of it; mismatches {bad}")
        if bad:
            raise AssertionError(f"quack_scan disagrees with its plain "
                                 f"version in {bad} entries")
        result[compute_lost] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                                    bound_by=by, mismatches=bad,
                                    max_abs_err=worst)
    return result


# --------------------------------------------------------- phases 4, 5
def _launches():
    from repro_torch.kernels.quack_scan import quack_scan
    return quack_scan.launches, quack_scan.launches_no_lost


def _reset_launches():
    from repro_torch.kernels.quack_scan import quack_scan
    quack_scan.launches = 0
    quack_scan.launches_no_lost = 0


def _check_launches(steps: int, what: str):
    total, no_lost = _launches()
    log(f"[{what}] quack_scan launches: {total} "
        f"({total - no_lost} with the loss quorum, {no_lost} without)")
    if total != 2 * steps or no_lost != steps:
        raise AssertionError(f"{what}: {total} launches ({no_lost} without "
                             f"the loss quorum) for {steps} rounds; "
                             f"expected {2 * steps} ({steps})")


def path_phase():
    from repro_torch.core import (FailureScenario, RSMConfig, SimConfig,
                                  run_picsou)
    cfg = RSMConfig.bft(1)
    sim = SimConfig(n_msgs=1024, steps=200)
    fails = FailureScenario(crash_s=(2, -1, -1, -1),
                            byz_recv_drop=(False, False, True, False))
    _reset_launches()
    gpu = run_picsou(cfg, cfg, sim, fails)
    _check_launches(sim.steps, "path")
    cpu = run_picsou(cfg, cfg, sim, fails, device="cpu")
    fields = ["quack_time", "deliver_time", "retry", "recv_has",
              "send_step", "delivery_latency", "gc_frontiers"]
    for f in fields:
        a, b = getattr(gpu.result, f), getattr(cpu.result, f)
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"path: cuda and cpu runs differ in {f}")
    for f in gpu.result.metrics._fields:
        a, b = getattr(gpu.result.metrics, f), getattr(cpu.result.metrics, f)
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"path: cuda and cpu runs differ in "
                                 f"metric {f}")
    if not (gpu.all_delivered and gpu.all_quacked):
        raise AssertionError("path: the run did not deliver and quack all")
    log(f"[path] BFT f=1 M=1024 steps={sim.steps}: cuda == cpu bit for bit "
        f"({len(fields)} outputs + {len(gpu.result.metrics)} metrics); "
        f"resends/msg {gpu.resends_per_msg:.4f}, "
        f"completion round {gpu.result.completion_step()}")


def full_phase(steps_free: int, steps_crash: int):
    from repro_torch.core import (FailureScenario, RSMConfig, SimConfig,
                                  run_picsou)
    cfg = RSMConfig.bft(6)
    m = SHAPE[2]
    runs = [("failure-free", FailureScenario.none(), steps_free),
            ("crash 0.3", FailureScenario.crash_fraction(19, 19, 0.3,
                                                         seed=2),
             steps_crash)]
    launches = [0, 0]
    for name, fails, steps in runs:
        sim = SimConfig(n_msgs=m, steps=steps, window=4, phi=32)
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        run = run_picsou(cfg, cfg, sim, fails)
        wall = time.perf_counter() - t0      # ends in a device->host copy
        _check_launches(steps, f"full {name}")
        total, no_lost = _launches()
        launches[0] += total - no_lost
        launches[1] += no_lost
        res = run.result
        log(f"[full {name}] BFT f=6 <-> f=6, M={m}, steps={steps}: "
            f"{wall:.3f} s wall, {steps / wall:.1f} rounds/s, "
            f"{m / wall:.1f} msgs/s; completion round "
            f"{res.completion_step()}, delivery round "
            f"{res.delivery_step()}, cross copies/msg "
            f"{run.cross_copies_per_msg}, resends {res.total_resends()}, "
            f"peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        if not (run.all_delivered and run.all_quacked):
            raise AssertionError(f"full {name}: not all delivered and "
                                 f"quacked after {steps} rounds")
        if res.metrics.delivered.shape != (steps,) or \
                int(res.metrics.delivered[-1]) != m:
            raise AssertionError(f"full {name}: delivered metric wrong")
        if fails.crash_s is None:
            if run.cross_copies_per_msg != 1.0 or res.total_resends():
                raise AssertionError("full failure-free: expected one "
                                     "cross copy per message, no resends")
        elif res.total_resends() <= 0:
            raise AssertionError("full crash run: expected resends")
        per_round_ms = wall / steps * 1e3
    return launches, per_round_ms


def profile_rounds(rounds: int, per_round_ms: float) -> None:
    """Where a full-size round's time goes: torch.profiler over a short
    run of the crash configuration. Device busy share = kernel time per
    round over the unprofiled wall time per round of the crash run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import (FailureScenario, RSMConfig, SimConfig,
                                  run_picsou)
    cfg = RSMConfig.bft(6)
    sim = SimConfig(n_msgs=SHAPE[2], steps=rounds, window=4, phi=32)
    fails = FailureScenario.crash_fraction(19, 19, 0.3, seed=2)
    run_picsou(cfg, cfg, sim, fails)                    # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_picsou(cfg, cfg, sim, fails)
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / rounds
    if busy_ms <= 0:
        log("[profile] device time per round: not measured (the profiler "
            "saw no kernels)")
        return
    log(f"[profile] {rounds} full-size crash-config rounds: "
        f"{busy_ms:.4f} ms/round of kernels on the device, "
        f"{sum(e.count for e in kernels) / rounds:.1f} kernels/round; "
        f"{wall / rounds * 1e3:.4f} ms/round wall under the profiler, "
        f"{per_round_ms:.4f} ms/round without it; device busy "
        f"{busy_ms / per_round_ms:.1%} of the unprofiled round")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        log(f"[profile]   {e.self_device_time_total / rounds:9.2f} us/round"
            f" {e.count / rounds:5.1f} launches/round  {e.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one card",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    card = card_line()
    log(f"[card] {card}")
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    for stale in build.BUILD_DIR.glob("libquack_scan-*.so"):
        stale.unlink()                       # build from source, always
    t0 = time.perf_counter()
    lib = build.build("quack_scan")
    log(f"[build] {lib.name} built with nvcc in "
        f"{time.perf_counter() - t0:.2f} s")

    kern = kernel_phase(dev)
    path_phase()
    launches, per_round_ms = full_phase(STEPS_FREE, STEPS_CRASH)
    profile_rounds(60, per_round_ms)

    entries = []
    for compute_lost, name, n in ((True, "quack_scan", launches[0]),
                                  (False, "quack_scan_no_lost",
                                   launches[1])):
        k = kern[compute_lost]
        entries.append(dict(
            name=name, route="cuda", source=CU_SOURCE, replaces=TPU_KERNEL,
            launches=n, max_abs_err=k["max_abs_err"],
            mismatches=k["mismatches"], ms=k["ms"], plain_ms=k["plain_ms"],
            bound_ms=k["bound_ms"], bound_by=k["bound_by"],
            library_ms=None))
    if any(e["launches"] <= 0 for e in entries):
        raise AssertionError("a kernel of the main path never launched")
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
