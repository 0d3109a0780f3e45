"""The port's model zoo (``repro_torch.models``) against ``repro.models``.

Every architecture at ``.smoke()`` (f32, two layers) with the JAX
package's weights (``init_model(cfg, PRNGKey(0))``) carried over by
``params_from_numpy``, fed the same numpy tokens (and encoder frames or
vision memory): the forward logits, prefill's last logits and every cache
leaf, and two decode steps after it. Errors are measured as
max |port - JAX| over max |JAX| of the compared tensor (a cache leaf over
its own largest entry) and held to ``TOL`` (1e-4). whisper-small gets
1e-3: its f32 encoder is ill-conditioned at smoke size (f32 rounding
alone, in either package, moves its encoder output by more than the
other configs' limit) and its decoder amplifies that.

Also: the kernel route (``impl="kernel"``, ``ref.mha_reference`` on the
CPU) against the scan within 1e-5 (whisper-small 1e-4, for the reason
above), and its gradient equal to the scan's, scan against triangular,
MoE dense against scatter, the blocked recurrent scans against the
per-step ones,
the port's own prefill / decode consistency, a bf16 case, the init
distribution against the JAX package's (the stacked fan-in quirk
included), and the CPU / CUDA rule of the entry points.

bf16 (granite-8b smoke, ``dtype="bfloat16"``): both packages round to
bf16 at every op, but XLA's CPU backend keeps excess precision across
some explicit bf16 casts (``--xla_allow_excess_precision``, on by
default), and the smoke model's near one-hot softmax turns an ulp of a
score into a large change of a row: both packages sit far from the f32
run, and a few 1e-2 of max |logit| from each other. So the port is
held within 5e-2 of JAX, and its distance to the f32 run to at most
1.25 times JAX's own.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, list_configs
from repro.models import decode_step, forward, init_model, prefill
from repro.models.model import encode
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import attention as tattn
from repro_torch.models import blocks
from repro_torch.models import model as tmodel
from repro_torch.models import params as tparams
from repro_torch.tree_util import tree_flatten_with_path, tree_leaves

ARCHS = list_configs()
TOL = {"whisper-small": 1e-3}
DEFAULT_TOL = 1e-4
KERNEL_TOL = {"whisper-small": 1e-4}
DEFAULT_KERNEL_TOL = 1e-5
B, S = 2, 16


def _cfgs(arch, **kw):
    return (dataclasses.replace(get_config(arch).smoke(), **kw),
            dataclasses.replace(t_get_config(arch).smoke(), **kw))


def _inputs(cfg, seed=0, s=S + 2):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)
    mem = None
    if cfg.family in ("encdec", "vlm"):
        n = cfg.encoder_seq if cfg.family == "encdec" else cfg.vision_seq
        mem = rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)
    return tokens, mem


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _carry(params):
    return tparams.params_from_numpy(jax.device_get(params), "cpu")


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """The JAX side of one arch, computed once: weights, inputs, forward
    logits, prefill (last logits, caches) and two decode steps."""
    arch = request.param
    cfg, tcfg = _cfgs(arch)
    params = init_model(cfg, jax.random.PRNGKey(0))
    tokens, mem = _inputs(cfg)
    jm = None if mem is None else jnp.asarray(mem)
    fwd_mem = encode(params, cfg, jm) if cfg.family == "encdec" else jm
    full, _ = forward(params, cfg, jnp.asarray(tokens), memory=fwd_mem)
    last, caches = prefill(params, cfg, jnp.asarray(tokens[:, :S]),
                           memory=jm, cache_len=S + 2)
    cache_leaves = [np.asarray(c) for c in jax.tree_util.tree_leaves(caches)]
    steps = []
    for i in range(2):
        logits, caches = decode_step(params, cfg, caches,
                                     jnp.asarray(tokens[:, S + i:S + i + 1]),
                                     jnp.int32(S + i))
        steps.append(np.asarray(logits))
    return dict(arch=arch, cfg=tcfg, params=_carry(params), tokens=tokens,
                mem=mem, full=np.asarray(full), last=np.asarray(last),
                caches=cache_leaves, steps=steps,
                tol=TOL.get(arch, DEFAULT_TOL))


def _forward(case, impl=None):
    cfg, p = case["cfg"], case["params"]
    mem = _t(case["mem"])
    if cfg.family == "encdec":
        mem = tmodel.encode(p, cfg, mem, impl=impl)
    logits, _ = tmodel.forward(p, cfg, _t(case["tokens"]), memory=mem,
                               impl=impl)
    return logits


def _prefill(case, impl=None, cache_len=S + 2):
    return tmodel.prefill(case["params"], case["cfg"],
                          _t(case["tokens"][:, :S]), memory=_t(case["mem"]),
                          impl=impl, cache_len=cache_len)


def test_forward_matches_jax(case):
    assert _rel(_forward(case), case["full"]) <= case["tol"]


def test_prefill_and_every_cache_leaf_match_jax(case):
    last, caches = _prefill(case)
    assert _rel(last, case["last"]) <= case["tol"]
    leaves = tree_leaves(caches)
    assert len(leaves) == len(case["caches"])
    for got, want in zip(leaves, case["caches"]):
        assert got.dtype == getattr(torch, str(want.dtype))
        assert _rel(got, want) <= case["tol"]


def test_two_decode_steps_match_jax(case):
    _, caches = _prefill(case)
    for i, want in enumerate(case["steps"]):
        tok = _t(case["tokens"][:, S + i:S + i + 1])
        logits, caches = tmodel.decode_step(case["params"], case["cfg"],
                                            caches, tok, S + i)
        assert _rel(logits, want) <= case["tol"], i


def test_kernel_route_matches_scan_on_cpu(case):
    """``impl="kernel"`` is the op's plain version on the CPU: the
    layout, GQA mapping and scale of the route the card takes."""
    tol = KERNEL_TOL.get(case["arch"], DEFAULT_KERNEL_TOL)
    assert _rel(_forward(case, "kernel"), _forward(case, "scan")) <= tol


def test_prefill_decode_consistency(case):
    """The port's own property (tests/test_models_smoke.py): prefill's last
    logits and two decode steps equal the full forward at those
    positions, at the JAX test's 2e-2.

    A model whose every layer has a sliding window keeps its caches as
    rings of capacity ``window`` (no ``cache_len``). Padded to
    ``cache_len`` when the prompt is exactly one window long, the ring
    is written at pos % cache_len but read as its last ``window`` slots,
    which drops the oldest key in the window and reads an unwritten one:
    the JAX package's behaviour, which the port keeps
    (``test_two_decode_steps_match_jax``; ROADMAP.md section 3)."""
    cfg = case["cfg"]
    if cfg.family == "moe":       # no capacity drops, as the JAX test
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    case = dict(case, cfg=cfg)
    rings = all(blocks.window_for(cfg, seg.kind)
                for seg in tmodel.layer_plan(cfg))
    full = _np(_forward(case))
    last, caches = _prefill(case, cache_len=None if rings else S + 2)
    np.testing.assert_allclose(_np(last[:, 0]), full[:, S - 1], atol=2e-2,
                               rtol=2e-2)
    for i in range(2):
        tok = _t(case["tokens"][:, S + i:S + i + 1])
        logits, caches = tmodel.decode_step(case["params"], cfg, caches, tok,
                                            S + i)
        np.testing.assert_allclose(_np(logits[:, 0]), full[:, S + i],
                                   atol=2e-2, rtol=2e-2)


def test_init_tree_matches_jax(case):
    """Same structure, key paths, shapes and dtypes as the JAX package's
    init; each leaf of >= 4,096 entries with a std within 10 % of the
    JAX leaf's (the stacked leaves' std is scale / sqrt(layers))."""
    arch = case["arch"]
    cfg, tcfg = _cfgs(arch)
    jp = jax.device_get(init_model(cfg, jax.random.PRNGKey(1)))
    tp = tmodel.init_model(tcfg, 1, device="cpu")
    jflat, _ = tree_flatten_with_path(jp)
    tflat, _ = tree_flatten_with_path(tp)
    assert [k for k, _ in jflat] == [k for k, _ in tflat]
    for (key, j), (_, t) in zip(jflat, tflat):
        assert tuple(t.shape) == j.shape, key
        assert t.dtype == getattr(torch, str(j.dtype)), key
        if j.size >= 4096:
            js, ts = float(np.std(j)), float(t.float().std())
            assert abs(ts - js) <= 0.1 * js, (key, ts, js)


def test_scan_matches_triangular():
    cfg, tcfg = _cfgs("granite-8b")
    p = _carry(init_model(cfg, jax.random.PRNGKey(0)))
    tokens = _t(_inputs(cfg, s=32)[0])
    a, _ = tmodel.forward(p, tcfg, tokens, impl="scan")
    b, _ = tmodel.forward(p, tcfg, tokens, impl="triangular")
    assert _rel(b, a) <= 1e-4


def test_moe_dense_matches_scatter():
    """Dense dispatch equals the scatter path at a capacity that drops
    nothing, in the port and against the JAX package's dense path."""
    cfg, tcfg = _cfgs("mixtral-8x22b", capacity_factor=8.0)
    params = init_model(cfg, jax.random.PRNGKey(0))
    p = _carry(params)
    tokens = _inputs(cfg, s=32)[0]
    dense = dataclasses.replace(tcfg, moe_impl="dense")
    a, aux_a = tmodel.forward(p, tcfg, _t(tokens))
    b, aux_b = tmodel.forward(p, dense, _t(tokens))
    assert _rel(b, a) <= 1e-4
    assert abs(float(aux_a) - float(aux_b)) <= 1e-5
    want, _ = forward(params, dataclasses.replace(cfg, moe_impl="dense"),
                      jnp.asarray(tokens))
    assert _rel(b, want) <= DEFAULT_TOL


@pytest.mark.parametrize("arch", ["rwkv6-7b", "hymba-1.5b"])
def test_blocked_scan_matches_per_step(arch):
    """``rwkv_scan_block=8`` runs the same steps in the same order as 1:
    the port equals itself and the JAX package's blocked scan."""
    cfg1, tcfg1 = _cfgs(arch)
    cfg8, tcfg8 = _cfgs(arch, rwkv_scan_block=8)
    params = init_model(cfg1, jax.random.PRNGKey(0))
    p = _carry(params)
    tokens = _inputs(cfg1, s=32)[0]
    a, _ = tmodel.forward(p, tcfg1, _t(tokens))
    b, _ = tmodel.forward(p, tcfg8, _t(tokens))
    assert _rel(b, a) <= 1e-5
    want, _ = forward(params, cfg8, jnp.asarray(tokens))
    assert _rel(b, want) <= DEFAULT_TOL


def test_bf16_granite_matches_jax():
    cfg, tcfg = _cfgs("granite-8b", dtype="bfloat16")
    params = init_model(cfg, jax.random.PRNGKey(0))
    p = _carry(params)
    tokens = _inputs(cfg, s=32)[0]
    got, _ = tmodel.forward(p, tcfg, _t(tokens))
    assert got.dtype == torch.bfloat16
    want, _ = forward(params, cfg, jnp.asarray(tokens))
    f32, _ = forward(params, dataclasses.replace(cfg, dtype="float32"),
                     jnp.asarray(tokens))
    scale = np.abs(_np(want)).max()
    assert np.abs(_np(got) - _np(want)).max() <= 5e-2 * scale
    assert (np.abs(_np(got) - _np(f32)).max()
            <= 1.25 * np.abs(_np(want) - _np(f32)).max())


def test_params_from_numpy_keeps_bf16_bits():
    cfg, _ = _cfgs("granite-8b", param_dtype="bfloat16")
    jp = jax.device_get(init_model(cfg, jax.random.PRNGKey(0)))
    tp = tparams.params_from_numpy(jp, "cpu")
    for j, t in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      np.asarray(j).view(np.int16))


def test_entry_points_need_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _cfgs("granite-8b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmodel.init_model(tcfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tparams.params_from_numpy({"w": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="generator"):
        tmodel.init_model(tcfg, torch.Generator(device="cpu"),
                          device="meta")


def test_kernel_route_refuses_autograd():
    """The kernel route under autograd (the name is from when it refused):
    its gradients are the scan route's, bit for bit, in f32 and bf16 and
    with a sliding window (its backward is ``attention.scan_backward``,
    which recomputes the scan one query block at a time); an unknown
    ``impl`` still raises."""
    rng = np.random.default_rng(0)
    for dtype, window in ((torch.float32, 0), (torch.bfloat16, 0),
                          (torch.float32, 5)):
        q, k, v, do = (torch.from_numpy(rng.standard_normal(
            shape).astype(np.float32)).to(dtype) for shape in
            ((2, 20, 4, 16), (2, 20, 2, 16), (2, 20, 2, 16),
             (2, 20, 4, 16)))
        grads = {}
        for impl in ("kernel", "scan"):
            xs = [x.clone().requires_grad_() for x in (q, k, v)]
            out = tattn.attention(*xs, window=window, impl=impl, block_q=8,
                                  block_kv=8)
            grads[impl] = torch.autograd.grad(out, xs, do)
        for got, want in zip(grads["kernel"], grads["scan"]):
            assert got.dtype == dtype and torch.equal(got, want), (dtype,
                                                                   window)
    with pytest.raises(ValueError, match="impl"):
        tattn.attention(q, k, k, impl="pallas")


def test_kernel_route_refuses_misaligned_masks():
    """The kernel aligns queries to the end of the keys, the scan to the
    start: a causal call with Sq != Skv would differ, so it raises."""
    q = torch.randn(1, 4, 4, 16)
    k = torch.randn(1, 8, 2, 16)
    with pytest.raises(ValueError, match="Sq == Skv"):
        tattn.attention(q, k, k, causal=True, impl="kernel")
    got = tattn.attention(q, k, k, causal=False, impl="kernel")
    want = tattn.attention(q, k, k, causal=False, impl="scan")
    assert _rel(got, want) <= 1e-5
