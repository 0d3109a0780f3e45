"""CLI driver: the runtime sanitizer's engine runs, as a JSON report.

Usage::

    python -m repro_torch.analysis                  # report, exit 0
    python -m repro_torch.analysis --check          # exit 1 on violation
    python -m repro_torch.analysis --json OUT.json  # machine-readable
    python -m repro_torch.analysis --device cpu     # on the CPU

One real windowed run (M=512, C=42 chunks, K=8, ``debug_checks`` on) on
the card (``--device cpu``: on the CPU) under the dispatch contract
``<= ceil(C/K)+2`` with zero implicit transfers, then a warm rerun of
the same spec that must capture (recompile) nothing: the JAX package's
sanitizer pass. Its AST and jaxpr passes walk JAX source and staged
JAX programs and have no counterpart here.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


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
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="runtime dispatch/transfer sanitizer of the engine")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 on any violation")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the full machine-readable report here")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: CUDA)")
    args = ap.parse_args(argv)

    report = {"sanitizer": _sanitizer_section(args.device)}
    report["ok"] = report["sanitizer"]["ok"]
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
