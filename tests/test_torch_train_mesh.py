"""The port's training launcher against the JAX package's on meshes of
more than one position, on the CPU.

Each case runs ``repro.launch.train.run`` and
``repro_torch.launch.train.run(device="cpu")`` with the same arguments
in one subprocess with 8 host devices (``tests/helpers.py::run_py``):
granite-8b smoke in f32, 4 steps, sequence 32, batch 8, the port's
``init_model`` replaced by the JAX package's init carried across (as
``tests/test_torch_train_launch.py`` does on one position). Per-step
losses agree within ``F32_TOL`` = 1e-4, the launcher tests' f32 limit,
on ddp with PICSOU, ATA and PICSOU + ``--compress`` over (2, 2, 2),
PICSOU + ``--compress`` over (2, 1, 1), and pjit over (2, 2).
"""

import json

import pytest

from helpers import run_py

F32_TOL = 1e-4

MESHES = {"ddp picsou 2x2x2": dict(mesh="2x2x2", mode="ddp",
                                   sync="picsou"),
          "ddp ata 2x2x2": dict(mesh="2x2x2", mode="ddp", sync="ata"),
          "ddp picsou compress 2x2x2": dict(mesh="2x2x2", mode="ddp",
                                            sync="picsou", compress=True),
          "ddp picsou compress 2x1x1": dict(mesh="2x1x1", mode="ddp",
                                            sync="picsou", compress=True),
          "pjit 2x2": dict(mesh="2x2", mode="pjit")}

# both launchers in one process: the JAX package on its 8 host devices,
# the port on the CPU with torch on one thread (smoke-size tensors, and
# the other test workers' processes beside it)
CODE = """
import argparse, dataclasses, json
import jax, torch
torch.set_num_threads(1)
import repro.launch.train as jtrain
import repro_torch.launch.train as ttrain
from repro.models import init_model as j_init_model
from repro_torch.models import params_from_numpy

for mod in (jtrain, ttrain):
    real = mod.get_config
    mod.get_config = lambda arch, real=real: dataclasses.replace(
        real(arch), dtype="float32")

def init(cfg, seed, device):
    params = j_init_model(jtrain.get_config(cfg.name),
                          jax.random.PRNGKey(seed))
    return params_from_numpy(jax.device_get(params), device)
ttrain.init_model = init

kw = dict(arch="granite-8b-smoke", steps=4, seq=32, batch=8, mode="pjit",
          sync="picsou", compress=False, ckpt_dir="", ckpt_every=10,
          restore=False, seed=0, lr=3e-4)
kw.update(json.loads(%r))
assert len(jax.devices()) == 8
want = jtrain.run(argparse.Namespace(**kw))
got = ttrain.run(argparse.Namespace(device="cpu", **kw))
print("LOSSES " + json.dumps({"jax": [float(x) for x in want],
                              "torch": [float(x) for x in got]}))
"""


@pytest.mark.parametrize("case", list(MESHES))
def test_launcher_losses_match_jax_on_a_mesh(case):
    out = run_py(CODE % json.dumps(MESHES[case]), devices=8)
    line = [x for x in out.splitlines() if x.startswith("LOSSES ")][-1]
    losses = json.loads(line[len("LOSSES "):])
    want, got = losses["jax"], losses["torch"]
    assert len(got) == len(want) == 4
    assert all(abs(a - b) <= F32_TOL for a, b in zip(got, want)), (got,
                                                                    want)
