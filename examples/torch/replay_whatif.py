"""Replay & what-if walkthrough on the port: fork futures from a shared
prefix.

  PYTHONPATH=src python examples/torch/replay_whatif.py [--device cpu]

The port's twin of ``examples/replay_whatif.py``.

Part 1: disaster recovery as an *injected event*. The primary streams
its log to two backups while ``repro_torch.replay`` records
chunk-boundary checkpoints; the crash is swapped into the running
windowed loop at the last boundary before it hits (the same report as
the static-schedule run), and the pre-crash trace comes back with the
report.

Part 2: a what-if study on that trace. From the pre-crash checkpoint,
fork four futures (no crash, the recorded crash, a later crash, and a
crash with a partitioned backup) and run them as ONE batch (one
dispatch per chunk for all four futures), then compare how much log
each backup would have salvaged in each world.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

from repro_torch.apps import run_disaster_recovery  # noqa: E402
from repro_torch.core import (FailureScenario, RSMConfig,  # noqa: E402
                              SimConfig)
from repro_torch.replay import ForkSpec, Injection, fork_whatif  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' on request)")
    dev = ap.parse_args(argv).device
    cfg = RSMConfig.bft(1)                     # n=4, u=r=1 per cluster
    sim = SimConfig(n_msgs=192, steps=100, window=1, phi=8,
                    window_slots=48, chunk_steps=8)
    crash_at = 20

    print("== disaster recovery, crash injected via replay ==")
    rep = run_disaster_recovery(cfg, cfg, sim, crash_at=crash_at,
                                inject_via_replay=True, device=dev)
    print(f"  crash scheduled at round {crash_at}, injected at chunk "
          f"boundary {rep.injected_at}")
    print(f"  phase-1 prefixes: {rep.phase1_prefixes}")
    print(f"  elected {rep.elected!r}; converged={rep.converged} at "
          f"{rep.recovered_entries}/{sim.n_msgs} entries")

    trace = rep.phase1_trace
    n = cfg.n
    crash_now = FailureScenario(crash_s=(crash_at,) * n)
    t0 = rep.injected_at
    later = t0 + 4 * sim.chunk_steps
    crash_later = FailureScenario(crash_s=(later,) * n)
    partition = FailureScenario(byz_recv_drop=(True,) + (False,) * (n - 1))

    def everywhere(scenario, at):
        return {lane: [Injection(at, scenario)]
                for lane in trace.lane_names}

    futures = [
        ForkSpec("no-crash"),
        ForkSpec("crash-now", everywhere(crash_now, t0)),
        ForkSpec(f"crash@{later}", everywhere(crash_later, later)),
        ForkSpec("crash+partition", {
            trace.lane_names[0]: [Injection(t0, crash_now)],
            trace.lane_names[1]: [Injection(t0, FailureScenario(
                crash_s=(crash_at,) * n,
                byz_recv_drop=partition.byz_recv_drop))],
        }),
    ]

    print(f"\n== what-if: {len(futures)} futures forked from the "
          f"pre-crash checkpoint (round {t0}) ==")
    report = fork_whatif(trace, t0, futures, device=dev)
    print(f"  one batch, {report.chunk_traces} fresh chunk programs")
    print(f"  {'future':<18}" + "".join(f"{l:>16}"
                                        for l in trace.lane_names))
    for fork in report.forks:
        row = "".join(f"{fork.stats[l]['delivered_prefix']:>16}"
                      for l in trace.lane_names)
        print(f"  {fork.name:<18}{row}  (delivered prefix)")
    worst = min(report.forks,
                key=lambda f: min(s["delivered_prefix"]
                                  for s in f.stats.values()))
    print(f"  most lossy future: {worst.name!r}")


if __name__ == "__main__":
    main()
