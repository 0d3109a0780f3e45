"""The port's five walkthroughs (``examples/torch/``) run to their end on
the CPU (``--device cpu``), each at its seed twin's sizes, and say what
their JAX twins say on the lines held here. Without ``--device`` they
need the card."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(name, *args, timeout=300):
    # one intra-op thread: smoke sizes, and a parallel test run beside
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "torch", name),
         *args], capture_output=True, text=True, env=env, timeout=timeout,
        cwd=REPO)


@pytest.mark.parametrize("name,says", [
    ("quickstart.py", ["quickstart done: ce"]),
    ("serve_decode.py", ["prefill:", "decode:", "sample:"]),
    ("fault_tolerance_demo.py", ["restore from step 9",
                                 "lost shards: [2]; retransmitter: 3",
                                 "demo complete"]),
    ("c3b_simulation.py", ["delivered: True; quacked: True",
                           "converged after catch-up: True",
                           "picsou"]),
    ("replay_whatif.py", ["most lossy future: 'crash+partition'"]),
])
def test_example_runs_on_the_cpu(name, says, tmp_path):
    args = ["--device", "cpu"]
    if name in ("quickstart.py", "fault_tolerance_demo.py"):
        args += ["--ckpt-dir", str(tmp_path / "ckpt")]
    proc = _run(name, *args)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    for line in says:
        assert line in proc.stdout, (line, proc.stdout[-2000:])


def test_examples_need_the_card_unless_asked():
    proc = _run("serve_decode.py")
    if proc.returncode == 0:
        pytest.skip("a CUDA card is present")
    assert "device='cpu'" in proc.stderr
