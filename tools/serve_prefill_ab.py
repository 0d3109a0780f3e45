#!/usr/bin/env python3
"""Time ``chip_smoke.py`` phase 12b's prefill in two or more checkouts of
the port, on one card, in turn.

    python3 tools/serve_prefill_ab.py --tree parent=PATH --tree change=. \\
        --order parent,change,change,parent,parent,change [--out PATH]

Each entry of ``--order`` is one process, started from that checkout's
root with its ``src`` first on the path, so it imports that checkout's
``repro_torch`` and builds that checkout's kernels. The process does
what phase 12b does before its warm prefill: granite-8b at full width
and depth from the phase's seed, the phase's prompts (B 4 x 512,
``SyntheticTokens(seed=3)``), the program cache emptied, then
``launch.serve.generate`` cold and again warm (16 tokens each). Then the
prefill alone, three times while the decode step's program set is still
cached, three times after ``graphs.clear_programs()``, and three times
each right after ``torch.cuda.empty_cache()`` (what ``torch.cuda.graph``
does before a capture); then one prefill under ``torch.profiler``: its
kernels' device time, its kernels, its host launch calls and its wall. Every prefill is timed on the host
clock around work that ends in a device synchronise, with the process's
CPU seconds beside it. A summary goes to stdout, one JSON object a
process to ``--out`` (default ``chiprun_out/serve_prefill_ab.jsonl``).
It needs one CUDA card and imports no JAX.

With ``--script`` each process instead runs that checkout's own
``chip_smoke.py`` phase 12 (``serve_phase``: 12a, then 12b) and reads
12b's cold and warm prefill, its warm decode step, its profiled prefill
and its sample tokens off the phase's log, which goes whole to
``chiprun_out/serve_prefill_ab_<n>_<label>.log``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ARCH, SEED, SHAPE = "granite-8b", 24, (4, 512, 16)
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                "cudaMemcpyAsync", "cudaMemsetAsync")


def _timed(fn, torch):
    torch.cuda.synchronize()
    wall, cpu = time.perf_counter(), time.process_time()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - wall, time.process_time() - cpu


def one() -> dict:
    """The measurements of one process, on the checkout it imports."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core import graphs
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    dev = torch.device("cuda")
    cfg = get_config(ARCH)
    b, plen, n_gen = SHAPE
    params = M.init_model(cfg, torch.Generator(device=dev).manual_seed(SEED),
                          dev)
    prompts = torch.from_numpy(SyntheticTokens(
        vocab=cfg.vocab, seq_len=plen, global_batch=b,
        seed=3).batch_at(0)["tokens"]).to(dev)
    graphs.clear_programs()
    cold = serve.generate(params, cfg, prompts, n_gen)
    warm = serve.generate(params, cfg, prompts, n_gen)

    def prefill():
        M.prefill(params, cfg, prompts, cache_len=plen + n_gen)

    held = [_timed(prefill, torch) for _ in range(3)]
    graphs.clear_programs()
    cleared = [_timed(prefill, torch) for _ in range(3)]
    emptied = []
    for _ in range(3):
        torch.cuda.empty_cache()
        emptied.append(_timed(prefill, torch))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = _timed(prefill, torch)[0]
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    kernel_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    calls = {e.key: e.count for e in events if e.key in LAUNCH_CALLS}
    return {"cold_prefill_s": cold.prefill_s,
            "warm_prefill_s": warm.prefill_s,
            "warm_decode_ms": warm.steady_s * 1e3,
            "held_prefill_s": [w for w, _ in held],
            "held_prefill_cpu_s": [c for _, c in held],
            "cleared_prefill_s": [w for w, _ in cleared],
            "cleared_prefill_cpu_s": [c for _, c in cleared],
            "emptied_prefill_s": [w for w, _ in emptied],
            "emptied_prefill_cpu_s": [c for _, c in emptied],
            "profiled": {"kernel_ms": kernel_ms,
                         "kernels": sum(e.count for e in kernels),
                         "wall_ms": wall * 1e3,
                         "busy": kernel_ms / (wall * 1e3),
                         "host_launch_calls": calls},
            "tokens": warm.tokens.tolist()}


# 12b's log lines, in the parent's wording and the change's
_SCRIPT_READS = {
    "cold_prefill_s": r"\(cold\): prefill ([\d.]+) s",
    "warm_prefill_s": r"again \(warm\): prefill ([\d.]+) s",
    "warm_decode_ms": r"again \(warm\): prefill [\d.]+ s, decode ([\d.]+) ms",
}
_SCRIPT_PROFILE = (r"\[serve 12b\] prefill: ([\d.]+) ms of kernels \((\d+) "
                   r"(?:kernels|launches)\) in ([\d.]+) ms under the profiler")


def script_one() -> None:
    """Phase 12 of the checkout's own ``chip_smoke.py``, logging to stdout."""
    import torch
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    chip_smoke.serve_phase(torch.device("cuda"))


def script_record(log: str) -> dict:
    """12b's readings off phase 12's log."""
    rec = {k: float(re.search(rx, log).group(1))
           for k, rx in _SCRIPT_READS.items()}
    kernel_ms, kernels, wall_ms = re.search(_SCRIPT_PROFILE, log).groups()
    rec["profiled"] = {"kernel_ms": float(kernel_ms), "kernels": int(kernels),
                       "wall_ms": float(wall_ms),
                       "busy": float(kernel_ms) / float(wall_ms),
                       "host_launch_calls": None}
    rec["tokens"] = re.findall(r"^sample: (.*)$", log, re.M)
    return rec


def _summary(rec: dict) -> str:
    def times(name):
        return ", ".join(f"{x:.4f}" for x in rec[name])
    alone = "".join(
        f"{what} {times(name + '_prefill_s')} s (CPU "
        f"{times(name + '_prefill_cpu_s')}); "
        for what, name in (("alone with the decode set held", "held"),
                           ("after clear_programs", "cleared"),
                           ("after empty_cache", "emptied"))
        if rec.get(name + "_prefill_s"))
    p = rec["profiled"]
    return (f"prefill cold {rec['cold_prefill_s']:.4f} s, warm "
            f"{rec['warm_prefill_s']:.4f} s; {alone}profiled: "
            f"{p['kernel_ms']:.3f} ms of kernels ({p['kernels']} kernels) "
            f"in {p['wall_ms']:.3f} ms ({p['busy']:.1%} busy), host calls "
            f"{p['host_launch_calls']}; warm decode "
            f"{rec['warm_decode_ms']:.3f} ms/step; process "
            f"{rec['process_s']:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[],
                    help="LABEL=PATH of a checkout (repeatable)")
    ap.add_argument("--order", default="",
                    help="comma-separated labels, one process each")
    ap.add_argument("--out", default="chiprun_out/serve_prefill_ab.jsonl")
    ap.add_argument("--script", action="store_true",
                    help="time each checkout's own chip_smoke.py phase 12")
    ap.add_argument("--one", action="store_true",
                    help="measure in this process and print one JSON line")
    args = ap.parse_args(argv)
    if args.one:
        if args.script:
            script_one()
        else:
            print(json.dumps(one()))
        return 0
    trees = dict(t.split("=", 1) for t in args.tree)
    order = [x for x in args.order.split(",") if x]
    if not trees or not order or set(order) - set(trees):
        ap.error("--order must name labels given by --tree")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    script = Path(__file__).resolve()
    records = []
    for n, label in enumerate(order):
        root = Path(trees[label]).resolve()
        env = dict(os.environ, PYTHONPATH=str(root / "src"))
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, str(script), "--one"]
            + (["--script"] if args.script else []),
            cwd=root, env=env, capture_output=True, text=True)
        if run.returncode != 0:
            print(run.stdout[-4000:], run.stderr[-4000:], sep="\n")
            raise SystemExit(f"{label}: exit {run.returncode}")
        if args.script:
            (out.parent / f"serve_prefill_ab_{n}_{label}.log").write_text(
                run.stdout)
            rec = script_record(run.stdout)
        else:
            rec = json.loads(run.stdout.strip().splitlines()[-1])
        rec.update(label=label, card=card,
                   process_s=time.perf_counter() - t0)
        records.append(rec)
        print(f"{label}: {_summary(rec)}", flush=True)
    with out.open("w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    same = all(r["tokens"] == records[0]["tokens"] for r in records)
    print(f"tokens equal across processes: {same}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
