"""C3B protocol walkthrough on the port: PICSOU vs ATA, failure-free and
under attack.

  PYTHONPATH=src python examples/torch/c3b_simulation.py [--device cpu]

The port's twin of ``examples/c3b_simulation.py``: the same runs in the
paper's configurations on the port's simulator (bit-identical to the JAX
package's), the headline efficiency/robustness numbers next to the
paper's claims, then a two-link disaster-recovery demo on the multi-link
topology layer (primary fanning out to two backups, failover to the
most-caught-up one).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

from repro_torch.apps import run_disaster_recovery  # noqa: E402
from repro_torch.core import (FailureScenario, NetworkModel,  # noqa: E402
                              RSMConfig, SimConfig, analytic_throughput,
                              run_picsou)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' on request)")
    dev = ap.parse_args(argv).device
    bft = RSMConfig.bft(2)               # n=7, u=r=2
    cft = RSMConfig.cft(2)               # n=5, u=2, r=0

    print("== failure-free BFT<->BFT (n=7) ==")
    run = run_picsou(bft, bft, SimConfig(n_msgs=128, steps=80, window=4,
                                         phi=16, window_slots="auto"),
                     device=dev)
    print(f"  delivered: {run.all_delivered}; quacked: {run.all_quacked}")
    print(f"  cross copies/msg: {run.cross_copies_per_msg:.2f} "
          f"(theoretical minimum 1.0)")
    print(f"  intra copies/msg: {run.intra_copies_per_msg:.2f} (= n-1)")

    print("== generality: CFT sender -> BFT receiver ==")
    run = run_picsou(cft, bft, SimConfig(n_msgs=64, steps=80, window=2,
                                         phi=16, window_slots="auto"),
                     device=dev)
    print(f"  delivered: {run.all_delivered}")

    print("== robustness: byzantine receiver drops everything ==")
    fails = FailureScenario(byz_recv_drop=(True,) + (False,) * 6)
    run = run_picsou(bft, bft, SimConfig(n_msgs=64, steps=400, window=1,
                                         phi=16, window_slots="auto"),
                     fails, device=dev)
    print(f"  delivered: {run.all_delivered}; "
          f"resends/msg: {run.resends_per_msg:.3f}; "
          f"max retries: {run.result.max_resends_per_msg()} "
          f"(Lemma-1 bound {bft.u * 2 + 1})")

    print("== disaster recovery: primary -> 2 backups, crash + failover ==")
    bft1 = RSMConfig.bft(1)              # n=4
    rep = run_disaster_recovery(
        bft1, bft1,
        SimConfig(n_msgs=64, steps=120, window=1, phi=16,
                  window_slots="auto"),
        backups=("backup-0", "backup-1"), crash_at=8,
        backup_failures={"backup-1": FailureScenario(
            crash_r=(2, 2, -1, -1))}, device=dev)
    print(f"  primary crashed at round 8; prefixes: "
          f"{rep.phase1_prefixes}")
    print(f"  elected {rep.elected} "
          f"({rep.recovered_entries}/{64} log entries survive); "
          f"converged after catch-up: {rep.converged}")

    print("== throughput model: PICSOU vs ATA (1MB, geo) ==")
    for n in (4, 19):
        f = max((n - 1) // 3, 1)
        cfg = RSMConfig(n=n, u=f, r=f)
        net = NetworkModel.geo(1e6)
        p = analytic_throughput("picsou", cfg, cfg, net)
        a = analytic_throughput("ata", cfg, cfg, net)
        ratio = p['throughput_msgs_per_s'] / a['throughput_msgs_per_s']
        print(f"  n={n:2d}: picsou {p['throughput_msgs_per_s']:8.1f}/s vs "
              f"ata {a['throughput_msgs_per_s']:6.1f}/s -> {ratio:5.1f}x")


if __name__ == "__main__":
    main()
