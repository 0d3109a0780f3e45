"""CLI driver: run all three analysis passes, emit ANALYSIS.json.

Usage::

    python -m repro_torch.analysis                  # report, exit 0
    python -m repro_torch.analysis --check          # exit 1 on any
                                                    # unbaselined violation
    python -m repro_torch.analysis --json OUT.json  # machine-readable
    python -m repro_torch.analysis --skip-engine    # astlint only (fast)
    python -m repro_torch.analysis --device cpu     # on the CPU

Passes, in the order and under the section names of the JAX package's
command line:

1. **astlint** (``astlint``): the capture-discipline rules over
   ``src/repro_torch``; new findings (not in the port's baseline,
   ``src/repro_torch/analysis/baseline.txt``, not suppressed inline)
   fail the gate. Stale baseline entries are reported.
2. **programlint** (section ``jaxpr``): the engine's dense / chunk /
   superchunk programs, built by the loop's own constructors at a tiny
   shape, run once each under an op recorder and audited for host
   syncs, widenings, CPU operands and (on the card) ``quack_scan``'s
   launch counts; and the model zoo's decode step (``model_steps``),
   audited for host syncs, CPU operands and copy-back bytes (0).
3. **sanitizer** (``sanitizer``): one real windowed run (M=512, C=42
   chunks, K=8, ``debug_checks`` on) under the dispatch contract
   ``<= ceil(C/K)+2`` with zero implicit transfers, then a warm rerun of
   the same spec that must capture (recompile) nothing.

The engine passes run on the card (``--device cpu``: on the CPU); without
a card and without ``--device`` they raise. ``--skip-engine`` runs the
linter alone, on any machine.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


def _astlint_section(root: str, baseline_path: str) -> dict:
    from .astlint import lint_tree, load_baseline, partition
    findings = lint_tree(root)
    baseline = load_baseline(baseline_path)
    new, old = partition(findings, baseline)
    live = {f.fingerprint() for f in findings}
    stale = sorted(baseline - live)
    return {
        "root": root,
        "baseline": baseline_path,
        "n_findings": len(findings),
        "new": [dataclasses.asdict(f) for f in new],
        "grandfathered": [f.fingerprint() for f in old],
        "stale_baseline": stale,
        "ok": not new,
        "rendered": [f.render() for f in new],
    }


def _program_section(device) -> dict:
    from .programlint import audit_decode, audit_engine
    out = audit_engine(device=device)
    decode = audit_decode(device)
    out["model_steps"] = [decode.to_dict()]
    out["violations"] = out["violations"] + decode.violations()
    out["ok"] = not out["violations"]
    return out


def _sanitizer_section(device) -> dict:
    from ..core import RSMConfig, SimConfig
    from ..core.simulator import build_spec, run_simulation
    from .sanitizer import SanitizerError, dispatch_contract, sanitized

    rsm = RSMConfig.bft(1)
    sim = SimConfig(n_msgs=512, steps=168, window=1, phi=6,
                    window_slots=96, chunk_steps=4, superchunk=8,
                    debug_checks=True)
    spec = build_spec(rsm, rsm, sim)
    out = {"shape": dict(m=spec.m, steps=spec.steps,
                         window_slots=spec.window_slots,
                         chunk_steps=spec.chunk_steps,
                         superchunk=spec.superchunk)}
    try:
        with sanitized(dispatch_contract(spec, label="cold")) as cold:
            run_simulation(spec, device=device)
        # second run: every program is captured — the warm contract
        # additionally demands zero captures (the replay-resume
        # guarantee, measured on the same counters resume uses)
        with sanitized(dispatch_contract(spec, warm=True,
                                         label="warm")) as warm:
            run_simulation(dataclasses.replace(spec), device=device)
        out["cold"] = cold.to_dict()
        out["warm"] = warm.to_dict()
        out["ok"] = True
    except SanitizerError as e:
        out["error"] = str(e)
        out["ok"] = False
    return out


def main(argv=None) -> int:
    from .astlint import DEFAULT_BASELINE
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="capture-discipline linter, captured-program auditor "
                    "and runtime dispatch sanitizer")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 on any unbaselined violation")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the full machine-readable report here")
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))),
                    help="tree to lint (default: the repro_torch package)")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="grandfathered-findings file (default: the "
                         "package's baseline.txt)")
    ap.add_argument("--skip-engine", action="store_true",
                    help="run only the AST pass (no engine runs)")
    ap.add_argument("--device", default=None,
                    help="torch device of the engine passes (default: "
                         "CUDA)")
    args = ap.parse_args(argv)
    device = None
    if not args.skip_engine:
        from ..core.simulator import _resolve_device
        device = _resolve_device(args.device)     # raises without a card

    passes = [("astlint", lambda: _astlint_section(args.root,
                                                  args.baseline))]
    if not args.skip_engine:
        passes += [("jaxpr", lambda: _program_section(device)),
                   ("sanitizer", lambda: _sanitizer_section(device))]
    report = {}
    for name, run in passes:
        t0 = time.perf_counter()
        report[name] = run()
        report[name]["seconds"] = time.perf_counter() - t0
    report["ok"] = all(sec.get("ok", True) for sec in report.values()
                       if isinstance(sec, dict))

    ast_sec = report["astlint"]
    print(f"astlint: {ast_sec['n_findings']} finding(s), "
          f"{len(ast_sec['new'])} new, "
          f"{len(ast_sec['grandfathered'])} baselined")
    for text in ast_sec["rendered"]:
        print(text)
    for fp in ast_sec["stale_baseline"]:
        print(f"  stale baseline entry (remove it): {fp}")
    if "jaxpr" in report:
        pr = report["jaxpr"]
        names = ", ".join(p["name"] for p in pr["programs"])
        steps = ", ".join(p["name"] for p in pr["model_steps"])
        print(f"programlint: {len(pr['programs'])} program(s) [{names}] "
              f"and the model step(s) [{steps}] on {pr['shape']['device']} "
              + ("clean" if pr["ok"] else "VIOLATIONS"))
        for v in pr["violations"]:
            print(f"  {v}")
    if "sanitizer" in report:
        sz = report["sanitizer"]
        if sz["ok"]:
            print(f"sanitizer: cold {sz['cold']['dispatches']} dispatches "
                  f"(contract {sz['cold']['contract']['max_dispatches']}), "
                  f"warm {sz['warm']['recompiles']} recompiles, "
                  f"{len(sz['cold']['transfers'])} implicit transfers")
        else:
            print(f"sanitizer: FAILED\n{sz['error']}")

    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1, default=str)
        print(f"wrote {args.json}")

    if args.check and not report["ok"]:
        print("analysis: FAILED", file=sys.stderr)
        return 1
    print("analysis: ok" if report["ok"]
          else "analysis: violations found (informational mode; "
               "use --check to fail)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
