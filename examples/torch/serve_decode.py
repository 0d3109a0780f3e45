"""Batched serving on the port: prefill + ring-buffer KV decode.

  PYTHONPATH=src python examples/torch/serve_decode.py \
      --arch mixtral-8x22b-smoke [--device cpu]

The port's twin of ``examples/serve_decode.py`` (on the card by default;
prefill attention takes the hand-written kernel there).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

from repro_torch.launch.serve import run  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x22b-smoke")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' on request)")
    a = ap.parse_args(argv)
    args = argparse.Namespace(arch=a.arch, batch=a.batch, prompt_len=32,
                              gen=a.gen, mesh="2x2", seed=0,
                              device=a.device)
    run(args)


if __name__ == "__main__":
    main()
