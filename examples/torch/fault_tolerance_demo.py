"""Fault-tolerance walkthrough on the port: pod failure mid-training +
QUACK-durable checkpoint restart + straggler re-apportionment.

  PYTHONPATH=src python examples/torch/fault_tolerance_demo.py \
      [--device cpu]

The port's twin of ``examples/fault_tolerance_demo.py``: the 2x2x2 mesh
is held on one device, so a "pod" failing is the launcher restarting on
the surviving pod's 2x2 shape from the replicated checkpoint.
"""

import argparse
import os
import shutil
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

import numpy as np  # noqa: E402

from repro_torch.crosspod import ReplicationLedger  # noqa: E402
from repro_torch.launch.elastic import (replan_membership,  # noqa: E402
                                        replan_quotas)
from repro_torch.launch.train import run  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' on request)")
    ap.add_argument("--ckpt-dir", default="/tmp/repro_torch_ft_demo_ckpt")
    a = ap.parse_args(argv)
    ckpt = a.ckpt_dir
    shutil.rmtree(ckpt, ignore_errors=True)
    kw = dict(arch="starcoder2-3b-smoke", seq=64, batch=8, mode="ddp",
              sync="picsou", compress=False, ckpt_every=5, seed=0, lr=3e-3,
              layers=0, device=a.device)

    print("== phase 1: 2-pod training, checkpoint every 5 steps ==")
    run(argparse.Namespace(steps=10, mesh="2x2x2", ckpt_dir=ckpt,
                           restore=False, **kw))

    print("== pod 0 fails! replanning membership ==")
    plan = replan_membership(alive_pods=[1], hosts_per_pod=4,
                             data_parallel=2, model_parallel=2,
                             last_committed_step=9)
    print(f"  new mesh: {plan.mesh_shape} axes {plan.mesh_axes}; "
          f"restore from step {plan.restore_step}")

    print("== phase 2: resume on the surviving pod from the QUACK-durable "
          "checkpoint ==")
    run(argparse.Namespace(steps=5, mesh="2x2", ckpt_dir=ckpt,
                           restore=True, **kw))

    print("== straggler mitigation: host 2 slows to 25% -> DSS re-quota ==")
    before = replan_quotas(np.array([1.0, 1.0, 1.0, 1.0]), quantum=16)
    after = replan_quotas(np.array([1.0, 1.0, 0.25, 1.0]), quantum=16)
    print(f"  quotas before: {before}")
    print(f"  quotas after : {after}")

    print("== replication ledger: lost shard -> deterministic re-election ==")
    led = ReplicationLedger(n_hosts=4, u=1, r=0)
    led.plan_sends(list(range(4)))
    led.record_ack(0, 1)
    led.record_ack(0, 1)            # duplicate: shard 2 missing (CFT: 1 dup)
    lost = led.lost_shards()
    print(f"  lost shards: {lost}; retransmitter: "
          f"{led.elect_retransmitter(lost[0])} (origin+1 mod n)")
    print("demo complete")


if __name__ == "__main__":
    main()
