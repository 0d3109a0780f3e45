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

``launch.steps.decode``, the decode step ``generate`` takes (one
captured graph a step on the card), on the CPU, where its program set
runs the body eagerly: the caches given are consumed into the set's
buffers, which come back at the same addresses every step; its logits
and caches are ``decode_step``'s bit for bit; a second generation on the
same weights takes the same set, other weights another. Generations
that interleave decode on sets of their own, each its own functional
step bit for bit, and a held set refuses a load.
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


def test_decode_step_keeps_its_caches_in_its_program_set():
    from repro_torch.core import graphs
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.tree_util import tree_leaves, tree_map
    cfg = t_get_config("granite-8b-smoke")
    params = M.init_model(cfg, 0, device="cpu")
    plen = 8
    prompts = torch.from_numpy(SyntheticTokens(
        vocab=cfg.vocab, seq_len=plen, global_batch=2,
        seed=3).batch_at(0)["tokens"])
    graphs.clear_programs()
    first = graphs.first_use_count()
    kept = None
    for _ in range(2):
        _, caches = M.prefill(params, cfg, prompts, cache_len=plen + 3)
        want = tree_map(torch.clone, caches)
        given = [x.data_ptr() for x in tree_leaves(caches)]
        tok = prompts[:, -1:]
        for i in range(3):
            logits, caches = steps.decode(params, cfg, caches, tok, plen + i)
            w_logits, want = M.decode_step(params, cfg, want, tok, plen + i)
            assert torch.equal(logits, w_logits)
            assert all(torch.equal(a, b) for a, b in
                       zip(tree_leaves(caches), tree_leaves(want)))
            now = [x.data_ptr() for x in tree_leaves(caches)]
            assert not set(now) & set(given)      # consumed into the set
            kept = kept or now
            assert now == kept
            tok = logits[:, -1].argmax(dim=-1)[:, None].to(torch.int32)
    assert graphs.first_use_count() == first + 1
    other = tree_map(torch.clone, params)
    _, caches = M.prefill(other, cfg, prompts, cache_len=plen + 3)
    steps.decode(other, cfg, caches, prompts[:, -1:], plen)
    assert graphs.first_use_count() == first + 2
    graphs.clear_programs()


def test_interleaved_generations_decode_on_sets_of_their_own():
    """Three generations of one key decoding in turn: each holds a set of
    its own while its caches live, so each step is its own generation's
    functional step, bit for bit; a set that is held refuses a load; once
    they end, a new generation takes a set it left and captures nothing,
    and ``DECODE_SETS`` idle sets stay cached."""
    from repro_torch.core import graphs
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.tree_util import tree_leaves, tree_map
    cfg = t_get_config("granite-8b-smoke")
    params = M.init_model(cfg, 0, device="cpu")
    plen, n = 8, 3
    rng = np.random.default_rng(5)
    prompts = [torch.from_numpy(rng.integers(0, cfg.vocab, (2, plen))
                                .astype(np.int32)) for _ in range(n)]
    graphs.clear_programs()
    first = graphs.first_use_count()
    caches = [M.prefill(params, cfg, p, cache_len=plen + 3)[1]
              for p in prompts]
    want = [tree_map(torch.clone, c) for c in caches]
    toks = [p[:, -1:] for p in prompts]
    for i in range(3):
        for g in range(n):
            logits, caches[g] = steps.decode(params, cfg, caches[g],
                                             toks[g], plen + i)
            w_logits, want[g] = M.decode_step(params, cfg, want[g],
                                              toks[g], plen + i)
            assert torch.equal(logits, w_logits), (i, g)
            assert all(torch.equal(a, b) for a, b in zip(
                tree_leaves(caches[g]), tree_leaves(want[g]))), (i, g)
            toks[g] = logits[:, -1].argmax(dim=-1)[:, None].to(torch.int32)
    assert graphs.first_use_count() == first + n
    sets = graphs.cached_sets()
    assert len(sets) == n and all(ps.held() for ps in sets)
    with pytest.raises(RuntimeError, match="lent"):
        sets[0].load(tuple(tree_leaves(want[0])))
    del caches, sets
    _, fresh = M.prefill(params, cfg, prompts[0], cache_len=plen + 3)
    logits, fresh = steps.decode(params, cfg, fresh, toks[0], plen)
    assert graphs.first_use_count() == first + n
    held = [ps.held() for ps in graphs.cached_sets()]
    assert sorted(held) == [False] * steps.DECODE_SETS + [True]
    graphs.clear_programs()
