"""The port's training launcher (``repro_torch.launch.train``) against the
JAX package's (``repro.launch.train``), on the CPU.

Launcher parity: ``run(args)`` of both packages with the same arguments
on a one-position mesh (``"1x1"`` pjit; ``"1x1x1"`` ddp with PICSOU, ATA
and ``--compress``), the JAX package in this process on its one CPU
device, the port with ``device="cpu"`` and its initial parameters
replaced by the JAX package's init carried across (the ``init_model``
the launcher uses, monkeypatched). The same ``SyntheticTokens`` stream
feeds both. Per-step losses within 5e-2 in bf16 (granite-8b smoke with
``dtype="bfloat16"``; ``tests/test_system.py``'s own limit between pjit
and ddp), and within 1e-4 in f32 for pjit and for ddp with PICSOU and
``--compress``.

Port-only, as ``tests/test_system.py`` holds the JAX package: ddp PICSOU
against ATA on a (2, 2, 2) mesh within 1e-4; a restart from the step-7
checkpoint continues an uninterrupted run within 2e-3; the loss falls
over 40 steps at lr 1e-2. And the launcher's refusals.
"""

import argparse
import dataclasses

import jax
import pytest
import torch

import repro.launch.train as jtrain
import repro_torch.launch.train as ttrain
from repro.models import init_model as j_init_model
from repro_torch.models import params_from_numpy

BF16_TOL = 5e-2
F32_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size tensors: torch's intra-op threads only cost, and under a
    parallel test run they compete with the other workers'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _args(**kw):
    base = dict(arch="granite-8b-smoke", steps=4, seq=32, batch=8,
                mesh="1x1", mode="pjit", sync="picsou", compress=False,
                ckpt_dir="", ckpt_every=10, restore=False, seed=0, lr=3e-4)
    base.update(kw)
    return argparse.Namespace(**base)


def _with_dtype(monkeypatch, dtype):
    """Both launchers' configs in ``dtype``."""
    for mod in (jtrain, ttrain):
        real = mod.get_config
        monkeypatch.setattr(
            mod, "get_config",
            lambda arch, real=real: dataclasses.replace(real(arch),
                                                        dtype=dtype))


def _jax_init(monkeypatch):
    """The port's launcher starts from the JAX package's init."""
    def init(cfg, seed, device):
        jcfg = jtrain.get_config(cfg.name)
        params = j_init_model(jcfg, jax.random.PRNGKey(seed))
        return params_from_numpy(jax.device_get(params), device)
    monkeypatch.setattr(ttrain, "init_model", init)


MODES = {"pjit 1x1": dict(mesh="1x1", mode="pjit"),
         "ddp picsou 1x1x1": dict(mesh="1x1x1", mode="ddp", sync="picsou"),
         "ddp ata 1x1x1": dict(mesh="1x1x1", mode="ddp", sync="ata"),
         "ddp picsou compress 1x1x1": dict(mesh="1x1x1", mode="ddp",
                                           sync="picsou", compress=True)}


CASES = ([(mode, "bfloat16", BF16_TOL) for mode in MODES]
         + [(mode, "float32", F32_TOL) for mode in ("pjit 1x1",
                                                    "ddp picsou compress "
                                                    "1x1x1")])


@pytest.mark.parametrize("mode,dtype,tol", CASES)
def test_launcher_losses_match_jax(monkeypatch, mode, dtype, tol):
    _with_dtype(monkeypatch, dtype)
    _jax_init(monkeypatch)
    want = jtrain.run(_args(**MODES[mode]))
    got = ttrain.run(_args(device="cpu", **MODES[mode]))
    assert len(got) == len(want) == 4
    assert all(abs(a - b) <= tol for a, b in zip(got, want)), (got, want)


def test_ddp_picsou_matches_ata_on_2x2x2():
    kw = dict(mesh="2x2x2", mode="ddp", device="cpu")
    picsou = ttrain.run(_args(sync="picsou", **kw))
    ata = ttrain.run(_args(sync="ata", **kw))
    assert all(abs(a - b) < 1e-4 for a, b in zip(picsou, ata)), (picsou,
                                                                   ata)


def test_checkpoint_restart_continues(tmp_path):
    kw = dict(arch="starcoder2-3b-smoke", mesh="2x2", ckpt_every=4,
              device="cpu")
    ttrain.run(_args(steps=8, ckpt_dir=str(tmp_path), **kw))
    ref = ttrain.run(_args(steps=12, **kw))
    # resumes after the step-7 checkpoint: steps 8..11
    resumed = ttrain.run(_args(steps=4, ckpt_dir=str(tmp_path), restore=True,
                               **kw))
    assert all(abs(a - b) < 2e-3 for a, b in zip(ref[8:12], resumed)), (
        ref[8:12], resumed)


def test_training_loss_decreases():
    losses = ttrain.run(_args(arch="starcoder2-3b-smoke", steps=40, seq=64,
                              mesh="2x2", lr=1e-2, device="cpu"))
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    assert last < first - 0.05, (first, last)


def test_launcher_refusals(monkeypatch):
    with pytest.raises(ValueError, match="does not split"):
        ttrain.run(_args(batch=6, mesh="2x2x2", mode="ddp", device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(["--steps", "1"])
