"""The port's training path (``repro_torch.models.loss_fn``,
``launch.steps``, ``models.sharding``, the spec trees, remat and the
kernel route's backward) against the JAX package's, on the CPU.

Every config at ``.smoke()`` (f32, two layers; MoE at capacity 8 so that
nothing drops, as ``tests/test_models_smoke.py``) from the JAX init
carried across (``params_from_numpy``), on the same numpy tokens: the
loss and its parts, every gradient leaf, and one AdamW step (parameters,
m and v, on the same gradients). Errors are max |port - JAX| over max
|JAX| of the leaf. The gradients' limit is 1e-4, or twice the port's own
f32 gradient's distance from its f64 gradient on the same weights where
that is larger: two f32 runs, each about that far from f64. That widens
it for mixtral-8x22b (~1.3e-3) and whisper-small (~3.3e-3), whose near
one-hot softmaxes and ill-conditioned encoder turn f32 rounding into that
much. A fault of the port's backward shows in its f32 and f64 runs alike,
so it cannot widen the limit.

Also: ``build_train_step`` over three steps on a ``"1x1"`` mesh against
the JAX package's (f32, 1e-4 of each leaf's largest magnitude), the spec
trees at full size (shapes, dtypes, names equal), ``spec_for`` /
``rules_for`` at the production meshes (2, 16, 16) and (16, 16) through a
stand-in with a ``shape`` dict (JAX's planner reads nothing else), remat
on, off and with the "dots" policy (gradients bit for bit), the kernel
route's forward run again by remat's recompute, and AdamW state carried
across.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.steps as jsteps
import repro.models.sharding as jshard
from repro.configs import SHAPES, ShapeSpec, get_config, list_configs
from repro.data import SyntheticTokens
from repro.launch.mesh import make_mesh
from repro.models import init_model, loss_fn
from repro.models import model as jmodel
from repro.optim import AdamWConfig, adamw_init, adamw_update
from repro.optim import opt_state_specs as j_opt_state_specs
from repro_torch import optim as toptim
from repro_torch.configs import get_config as t_get_config
from repro_torch.kernels import ops as tops
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as tmodel
from repro_torch.models import params_from_numpy
from repro_torch.models import sharding as tshard
from repro_torch.tree_util import (tree_flatten, tree_flatten_up_to,
                                   tree_flatten_with_path, tree_leaves,
                                   tree_map)

ARCHS = list_configs()
TOL = 1e-4
B, S = 2, 17


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size tensors: torch's intra-op threads only cost, and under a
    parallel test run they compete with the other workers'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(arch, **kw):
    cfg, tcfg = get_config(arch).smoke(), t_get_config(arch).smoke()
    if cfg.family == "moe":
        kw = dict(capacity_factor=8.0, **kw)
    return (dataclasses.replace(cfg, **kw),
            dataclasses.replace(tcfg, **kw))


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["memory"] = rng.standard_normal(
            (B, cfg.vision_seq, cfg.d_model)).astype(np.float32)
    return batch


def _t(batch, dtype=None):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    if dtype is not None:
        out = {k: v if k == "tokens" else v.to(dtype)
               for k, v in out.items()}
    return out


def _rel(got, want) -> float:
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _leaf_errs(got_tree, want_tree):
    """{key path: error} over the leaves of two trees of one structure."""
    got, _ = tree_flatten_with_path(got_tree)
    want = jax.tree_util.tree_leaves(want_tree)
    assert len(got) == len(want)
    return {k: _rel(g, np.asarray(w)) for (k, g), w in zip(got, want)}


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """One arch, computed once: the JAX value and grad of ``loss_fn`` and
    one AdamW step from its init; the port's on the carried weights, and
    the port's gradient in f64."""
    arch = request.param
    cfg, tcfg = _cfgs(arch)
    params = init_model(cfg, jax.random.PRNGKey(0))
    batch = _batch(cfg)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: loss_fn(p, cfg, b), has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    state = adamw_init(params)
    jp1, js1 = jax.jit(lambda g, p, s: adamw_update(AdamWConfig(), g, p, s))(
        jg, params, state)
    tp = params_from_numpy(jax.device_get(params), "cpu")
    (tl, tm), tg = tsteps.value_and_grad(tp, tcfg, _t(batch))
    c64 = dataclasses.replace(tcfg, dtype="float64")
    _, g64 = tsteps.value_and_grad(tree_map(lambda a: a.double(), tp), c64,
                                   _t(batch, torch.float64))
    return dict(arch=arch, cfg=tcfg, jax=(float(jl), jax.device_get(jm),
                                          jax.device_get(jg)),
                port=(float(tl), tm, tg), g64=g64, tp=tp,
                state=jax.device_get(state), jnext=jax.device_get((jp1, js1)))


def _limit(case) -> float:
    """1e-4, or twice the port's f32 gradient's distance from its f64
    gradient where that is larger (the model's conditioning)."""
    own = max(_rel(a, b.numpy()) for a, b in zip(
        tree_leaves(case["port"][2]), tree_leaves(case["g64"])))
    return max(TOL, 2 * own)


def test_loss_matches_jax(case):
    jl, jm, _ = case["jax"]
    tl, tm, _ = case["port"]
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    assert abs(float(tm["ce"]) - float(jm["ce"])) <= 1e-5 * abs(jl)
    assert abs(float(tm["aux"]) - float(jm["aux"])) <= 1e-5 * max(
        1.0, abs(float(jm["aux"])))


def test_every_gradient_leaf_matches_jax(case):
    errs = _leaf_errs(case["port"][2], case["jax"][2])
    limit = _limit(case)
    assert max(errs.values()) <= limit, (limit, sorted(
        errs.items(), key=lambda kv: -kv[1])[:4])


def test_one_adamw_step_matches_jax(case):
    """One clipped AdamW step (lr 3e-4, no schedule) from the carried zero
    state on the same gradients (JAX's, carried across): parameters, m
    and v. (On each package's own gradients the first step is lr times
    the sign of each entry, and an entry whose true gradient is 0, such
    as a key bias under softmax, has a sign of f32 noise in both.)"""
    state = params_from_numpy(case["state"], "cpu")
    assert isinstance(state, toptim.AdamWState)
    grads = params_from_numpy(case["jax"][2], "cpu")
    p1, s1 = toptim.adamw_update(toptim.AdamWConfig(), grads, case["tp"],
                                 state)
    jp1, js1 = case["jnext"]
    assert int(s1.step) == int(js1.step) == 1
    for got, want in ((p1, jp1), (s1.m, js1.m), (s1.v, js1.v)):
        errs = _leaf_errs(got, want)
        assert max(errs.values()) <= TOL, sorted(
            errs.items(), key=lambda kv: -kv[1])[:4]


def _steps_batches(cfg, n, seq=32, batch=4):
    data = SyntheticTokens(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                           seed=17)
    return [data.batch_at(i) for i in range(n)]


def test_build_train_step_three_steps_match_jax():
    """Three steps of each package's ``build_train_step`` on a 1x1 mesh,
    granite-8b smoke in f32 (warmup 1 so that steps 1 and 2 move the
    weights): the losses, the parameters and the AdamW state."""
    cfg, tcfg = _cfgs("granite-8b")
    shape = ShapeSpec("train", 32, 4, "train")
    params = init_model(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.device_get(params), "cpu")
    bundle = jsteps.build_train_step(cfg, make_mesh((1, 1),
                                                    ("data", "model")),
                                     shape, warmup=1, total_steps=10)
    tbundle = tsteps.build_train_step(tcfg, tmesh.parse_mesh("1x1", "cpu"),
                                      shape, warmup=1, total_steps=10)
    jopt, topt = adamw_init(params), toptim.adamw_init(tp)
    for b in _steps_batches(cfg, 3):
        params, jopt, jm = bundle(params, jopt,
                                  {"tokens": jnp.asarray(b["tokens"])})
        tp, topt, tm = tbundle(tp, topt, _t(b))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * abs(
            float(jm["loss"]))
    assert int(topt.step) == int(jopt.step) == 3
    for got, want in ((tp, params), (topt.m, jopt.m), (topt.v, jopt.v)):
        assert max(_leaf_errs(got, jax.device_get(want)).values()) <= TOL


# ------------------------------------------------------------ spec trees
def _same_specs(got_shapes, got_names, want_shapes, want_names):
    got, treedef = tree_flatten(got_shapes)
    want = jax.tree_util.tree_leaves(want_shapes)
    names = tree_flatten_up_to(treedef, got_names)
    want_n = jax.tree_util.tree_structure(want_shapes).flatten_up_to(
        want_names)
    assert len(got) == len(want) == len(names) == len(want_n)
    for g, w, gn, wn in zip(got, want, names, want_n):
        assert g.device.type == "meta"
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
        assert tuple(gn) == tuple(wn)


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_match_jax_at_full_size(arch):
    """param_specs, opt_state_specs, cache_specs and input_specs of every
    shape in SHAPES: shapes, dtypes, logical names and key paths."""
    cfg, tcfg = get_config(arch), t_get_config(arch)
    js, jn = jmodel.param_specs(cfg)
    ts, tn = tmodel.param_specs(tcfg)
    assert ([k for k, _ in tree_flatten_with_path(ts)[0]]
            == [jax.tree_util.keystr(k, simple=True, separator="/")
                for k, _ in jax.tree_util.tree_flatten_with_path(js)[0]])
    _same_specs(ts, tn, js, jn)
    _same_specs(*toptim.opt_state_specs(ts, tn), *j_opt_state_specs(js, jn))
    _same_specs(*tmodel.cache_specs(tcfg, 128, 32_768),
                *jmodel.cache_specs(cfg, 128, 32_768))
    for shape in SHAPES.values():
        _same_specs(*tmodel.input_specs(tcfg, shape),
                    *jmodel.input_specs(cfg, shape))


MESHES = {"multi-pod": {"pod": 2, "data": 16, "model": 16},
          "pod": {"data": 16, "model": 16}}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_spec_for_and_rules_for_match_jax_at_production_meshes(mesh):
    """Every leaf of every config's parameters, optimizer state and train
    / decode inputs gets the same PartitionSpec from both planners (with
    each package's ``rules_for``, and each package's ``SP_RULES``); the
    port's ``param_shardings`` and ``tree_shardings`` give those specs."""
    stand_in = types.SimpleNamespace(shape=dict(MESHES[mesh]))
    for arch in ARCHS:
        cfg, tcfg = get_config(arch), t_get_config(arch)
        rules = jsteps.rules_for(cfg, stand_in)
        assert tsteps.rules_for(tcfg, stand_in) == rules
        ts, tn = tmodel.param_specs(tcfg)
        js, jn = jmodel.param_specs(cfg)
        trees = [((ts, tn), (js, jn)),
                 (toptim.opt_state_specs(ts, tn), j_opt_state_specs(js, jn))]
        for shape in (SHAPES["train_4k"], SHAPES["decode_32k"]):
            trees.append((tmodel.input_specs(tcfg, shape),
                          jmodel.input_specs(cfg, shape)))
        for (t_sh, t_nm), (j_sh, j_nm) in trees:
            for r, jr in ((rules, rules), (tshard.SP_RULES,
                                           jshard.SP_RULES)):
                leaves, treedef = tree_flatten(t_sh)
                got = [tshard.spec_for(stand_in, n, s.shape, r) for s, n in
                       zip(leaves, tree_flatten_up_to(treedef, t_nm))]
                want = [jshard.spec_for(stand_in, n, s.shape, jr)
                        for s, n in zip(
                            jax.tree_util.tree_leaves(j_sh),
                            jax.tree_util.tree_structure(j_sh)
                            .flatten_up_to(j_nm))]
                assert [tuple(g) for g in got] == [tuple(w) for w in want]
        shardings, _ = tsteps.param_shardings(tcfg, stand_in)
        want = [jshard.spec_for(stand_in, n, s.shape, rules) for s, n in
                zip(jax.tree_util.tree_leaves(js),
                    jax.tree_util.tree_structure(js).flatten_up_to(jn))]
        assert [tuple(s.spec) for s in tree_leaves(shardings)] == [
            tuple(w) for w in want]
        assert [tuple(s.spec) for s in tree_leaves(tshard.tree_shardings(
            stand_in, ts, tn, rules))] == [tuple(w) for w in want]


def test_spec_for_divisibility_cases():
    """``tests/test_sharding.py``'s cases, with no devices."""
    m = types.SimpleNamespace(shape={"data": 2, "model": 4})
    assert tshard.spec_for(m, ("batch", "seq", "heads", "head_dim"),
                           (8, 16, 8, 64)) == tshard.P("data", None, "model",
                                                       None)
    assert tshard.spec_for(m, ("batch", "seq", "kv_heads", "head_dim"),
                           (8, 16, 2, 64)) == tshard.P("data", None, None,
                                                       None)
    rules = dict(tshard.DEFAULT_RULES, cache_seq="model")
    assert tshard.spec_for(m, ("batch", "cache_seq", "kv_heads", "head_dim"),
                           (8, 64, 2, 64), rules) == tshard.P(
                               "data", "model", None, None)
    m3 = types.SimpleNamespace(shape={"pod": 2, "data": 2, "model": 2})
    assert tshard.spec_for(m3, ("batch", "seq", "embed"),
                           (8, 16, 32)) == tshard.P(("pod", "data"), None,
                                                    None)
    x = torch.zeros(3)
    assert tshard.constrain(x, "batch") is x


# ------------------------------------------------------- remat, kernel route
def _grads(tcfg, params, batch, impl=None):
    return tree_leaves(tsteps.value_and_grad(params, tcfg, batch,
                                             impl=impl)[1])


@pytest.mark.parametrize("arch", ["granite-8b", "whisper-small",
                                  "rwkv6-7b"])
def test_remat_on_off_and_dots_give_the_same_gradients(arch):
    """Bit for bit: checkpointing recomputes the same ops on the same
    inputs."""
    _, tcfg = _cfgs(arch)
    params = tmodel.init_model(tcfg, 0, device="cpu")
    batch = _t(_batch(tcfg))
    off = _grads(dataclasses.replace(tcfg, remat=False), params, batch)
    for kw in (dict(remat=True), dict(remat=True, remat_policy="dots")):
        on = _grads(dataclasses.replace(tcfg, **kw), params, batch)
        assert all(torch.equal(a, b) for a, b in zip(on, off)), kw


def test_remat_runs_the_kernel_route_forward_again(monkeypatch):
    """With remat on, each layer of a stacked segment runs its attention
    forward twice a training step (the forward, then the recompute in the
    backward); with remat off, once. Gradients equal the scan route's."""
    calls = []
    real = tops.flash_attention

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tops, "flash_attention", counted)
    _, tcfg = _cfgs("granite-8b")
    params = tmodel.init_model(tcfg, 0, device="cpu")
    batch = _t(_batch(tcfg))
    scan = _grads(tcfg, params, batch, impl="scan")
    assert not calls
    for remat, launches in ((False, tcfg.n_layers), (True,
                                                     2 * tcfg.n_layers)):
        calls.clear()
        got = _grads(dataclasses.replace(tcfg, remat=remat), params, batch,
                     impl="kernel")
        assert len(calls) == launches, remat
        # the forward differs (mha_reference against the scan), the
        # backward is the scan's
        assert max(_rel(g, s.numpy()) for g, s in zip(got, scan)) <= TOL


@pytest.mark.parametrize("arch", ["granite-8b", "whisper-small"])
def test_build_step_dispatches_on_the_shape_kind(arch):
    """``build_step``: a train shape gives the train step, a prefill shape
    ``prefill`` (its caches included) and a decode shape ``decode_step``,
    each with the shardings the planner gives its declared inputs."""
    _, tcfg = _cfgs(arch)
    params = tmodel.init_model(tcfg, 0, device="cpu")
    mesh = tmesh.parse_mesh("1x1", "cpu")
    batch = _t(_batch(tcfg))
    memory = batch.get("frames", batch.get("memory"))
    pre = tsteps.build_step(tcfg, mesh, ShapeSpec("p", S - 1, B, "prefill"))
    last, caches = pre(params, {k: v[:, :S - 1] if k == "tokens" else v
                                for k, v in batch.items()})
    want_last, want_caches = tmodel.prefill(params, tcfg,
                                            batch["tokens"][:, :S - 1],
                                            memory=memory)
    assert torch.equal(last, want_last)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(caches),
                                                  tree_leaves(want_caches)))
    dec = tsteps.build_step(tcfg, mesh, ShapeSpec("d", S - 1, B, "decode"))
    assert len(dec.in_shapes) == 4 and len(dec.in_shardings) == 4
    tok = batch["tokens"][:, S - 1:]
    got, _ = dec(params, caches, tok, torch.tensor(S - 1, dtype=torch.int32))
    want, _ = tmodel.decode_step(params, tcfg, want_caches, tok, S - 1)
    assert torch.equal(got, want)
    train = tsteps.build_step(tcfg, mesh, ShapeSpec("t", S, B, "train"))
    assert [tuple(s.shape) for s in tree_leaves(train.in_shapes[2])] == [
        tuple(v.shape) for v in tree_leaves(batch)]
    _, _, metrics = train(params, toptim.adamw_init(params), batch)
    assert set(metrics) == {"loss", "ce", "aux"}
