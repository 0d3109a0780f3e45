"""The port's serving launcher (``repro_torch.launch.serve``) against
``repro.launch.serve``.

``generate`` on the JAX package's weights (``init_model(cfg,
PRNGKey(seed))``, carried by ``params_from_numpy``) and the same prompts
(``SyntheticTokens(seed=3)``, bit for bit in both packages) must give the
greedy tokens of ``repro.launch.serve.run`` exactly: prefill's argmax
and 16 decode steps of a batch of 4 32-token prompts, every config at
``.smoke()`` (f32). Also the
launcher's CLI and prints on the CPU, ``parse_mesh``, and the rule that the
launcher needs a card unless ``--device`` names another.
"""

import argparse

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, list_configs
from repro.launch import serve as jserve
from repro.models import init_model
from repro_torch.configs import get_config as t_get_config
from repro_torch.data import SyntheticTokens
from repro_torch.launch import serve as tserve
from repro_torch.launch.mesh import parse_mesh
from repro_torch.models import params_from_numpy

SERVED = [f"{arch}-smoke" for arch in list_configs()]


def _args(arch, **kw):
    base = dict(arch=arch, batch=4, prompt_len=32, gen=16, mesh="1x1",
                seed=0, device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


def _generate(arch, args):
    cfg = t_get_config(arch)
    params = params_from_numpy(
        jax.device_get(init_model(get_config(arch),
                                  jax.random.PRNGKey(args.seed))), "cpu")
    data = SyntheticTokens(vocab=cfg.vocab, seq_len=args.prompt_len,
                           global_batch=args.batch, seed=3)
    prompts = torch.from_numpy(data.batch_at(0)["tokens"])
    memory = None
    if cfg.family in ("encdec", "vlm"):
        n = cfg.encoder_seq if cfg.family == "encdec" else cfg.vision_seq
        memory = torch.zeros((args.batch, n, cfg.d_model))
    return tserve.generate(params, cfg, prompts, args.gen, memory)


@pytest.mark.parametrize("arch", SERVED)
def test_generate_gives_the_jax_launchers_tokens(arch, capsys):
    args = _args(arch)
    want = np.asarray(jserve.run(args))
    got = _generate(arch, args)
    assert got.tokens.shape == (4, 17)
    np.testing.assert_array_equal(got.tokens, want)
    assert len(got.step_s) == 16 and got.prefill_s > 0
    out = capsys.readouterr().out.splitlines()
    # the JAX launcher's three lines, then the port's
    assert [ln.split(":")[0] for ln in out] == ["prefill", "decode",
                                               "sample"] * 2
    assert out[5] == out[2]                 # the same sample


def test_run_on_the_cpu_prints_and_returns_tokens(capsys):
    tokens = tserve.run(_args("granite-8b-smoke", batch=2, prompt_len=16,
                              gen=3, mesh="2x2"))
    assert tokens.shape == (2, 4) and tokens.dtype == np.int32
    out = capsys.readouterr().out
    assert "prefill:" in out and "ms/step" in out and "tok/s" in out


def test_cli_main(capsys):
    tserve.main(["--arch", "granite-8b-smoke", "--device", "cpu",
                 "--batch", "1", "--prompt-len", "8", "--gen", "2"])
    assert "sample:" in capsys.readouterr().out


def test_launcher_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.run(_args("granite-8b-smoke", device=None))
    assert tserve.parser().parse_args([]).device is None


@pytest.mark.parametrize("spec,shape", [("2x2", {"data": 2, "model": 2}),
                                        ("2x4x8", {"pod": 2, "data": 4,
                                                   "model": 8})])
def test_parse_mesh(spec, shape):
    mesh = parse_mesh(spec, "cpu")
    assert mesh.shape == shape
    assert mesh.axis_names == tuple(shape)
    assert mesh.device == torch.device("cpu")
