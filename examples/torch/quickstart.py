"""Quickstart: train a reduced granite-8b for 100 steps, on the port.

  PYTHONPATH=src python examples/torch/quickstart.py            # the card
  PYTHONPATH=src python examples/torch/quickstart.py --device cpu

The port's twin of ``examples/quickstart.py``: the production step
builder (the FSDP x TP pjit step) on a 2x2 mesh held on one device, the
deterministic synthetic data pipeline, cosine LR, and async
QUACK-replicated checkpoints.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

from repro_torch.launch.train import run  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' on request)")
    ap.add_argument("--ckpt-dir", default="/tmp/repro_torch_quickstart_ckpt")
    a = ap.parse_args(argv)
    args = argparse.Namespace(
        arch="granite-8b-smoke", steps=100, seq=64, batch=8, mesh="2x2",
        mode="pjit", sync="picsou", compress=False,
        ckpt_dir=a.ckpt_dir, ckpt_every=25, restore=False, seed=0,
        lr=1e-2, layers=0, device=a.device)
    losses = run(args)
    assert losses[-1] < losses[0], "training should make progress"
    print(f"quickstart done: ce {losses[0]:.3f} -> {losses[-1]:.3f}")


if __name__ == "__main__":
    main()
