"""The port's optimizer, data stream and configs against the JAX package's.

* AdamW (``adamw_update`` over 20 steps, with and without clipping, f32
  and bf16 leaves, with ``cosine_schedule``'s scale), ``global_norm`` and
  ``cosine_schedule``: f32 results within 1e-6 relative, ``step`` exact.
  The two sum the norm's squares in their own order and their
  ``pow``/``cos`` may differ in the last bit, so a clipped step's scale
  differs by an ulp, and a moment that cancels to near zero keeps that
  absolute error: a leaf is held to 1e-6 of its largest magnitude
  (``_close``). A bf16 parameter is the f32
  update cast to bf16: where the two packages' f32 values straddle a
  bf16 rounding boundary they differ by one bf16 unit, so bf16 leaves are
  held within one unit of the last place, and the f32 moments behind
  them within 1e-6.
* ``SyntheticTokens``: bit for bit (numpy in both).
* Every config: ``dataclasses.asdict``, ``n_params``,
  ``n_active_params``, ``smoke()`` and ``SHAPES`` equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
import repro.data as jdata
import repro.optim as jopt
import repro_torch.configs as tcfg
import repro_torch.data as tdata
import repro_torch.optim as topt

RTOL = 1e-6


def _params(rng, bf16: bool):
    f32 = np.float32
    p = {"w": rng.standard_normal((16, 24)).astype(f32),
         "blocks": [{"a": rng.standard_normal(40).astype(f32)},
                    {"a": rng.standard_normal(40).astype(f32)}],
         "b": rng.standard_normal(7).astype(f32)}
    dtypes = {"b": "bf16"} if bf16 else {}
    return p, dtypes


def _to(tree, dtypes, lib):
    def conv(path, x):
        if lib == "jax":
            a = jnp.asarray(x)
            return a.astype(jnp.bfloat16) if dtypes.get(path) else a
        t = torch.from_numpy(np.array(x))
        return t.to(torch.bfloat16) if dtypes.get(path) else t
    return {"w": conv("w", tree["w"]),
            "blocks": [{"a": conv("a", blk["a"])} for blk in tree["blocks"]],
            "b": conv("b", tree["b"])}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


def _leaves(tree, lib):
    if lib == "jax":
        return jax.tree_util.tree_leaves(tree)
    from repro_torch.tree_util import tree_leaves
    return tree_leaves(tree)


def _close(got: np.ndarray, want: np.ndarray, what: str = "") -> None:
    """Within ``RTOL`` of the leaf's largest magnitude, elementwise."""
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= RTOL * scale, (what, err, scale)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return np.exp2(e - 7)


@pytest.mark.parametrize("clip", [1.0, 1e3])
@pytest.mark.parametrize("bf16", [False, True])
def test_adamw_20_steps_matches_repro(bf16, clip):
    rng = np.random.default_rng(7)
    p0, dtypes = _params(rng, bf16)
    cfg_kw = dict(lr=1e-2, weight_decay=0.1, grad_clip=clip)
    jcfg_, tcfg_ = jopt.AdamWConfig(**cfg_kw), topt.AdamWConfig(**cfg_kw)
    jp, tp = _to(p0, dtypes, "jax"), _to(p0, dtypes, "torch")
    js, ts = jopt.adamw_init(jp), topt.adamw_init(tp)
    assert ts.step.dtype == torch.int32 and int(ts.step) == 0
    for step in range(20):
        g, _ = _params(rng, False)
        jg, tg = _to(g, dtypes, "jax"), _to(g, dtypes, "torch")
        scale_j = jopt.cosine_schedule(js.step, warmup=5, total=20)
        scale_t = topt.cosine_schedule(ts.step, warmup=5, total=20)
        np.testing.assert_allclose(scale_t.numpy(), np.asarray(scale_j),
                                   rtol=RTOL)
        jp, js = jopt.adamw_update(jcfg_, jg, jp, js, scale_j)
        tp, ts = topt.adamw_update(tcfg_, tg, tp, ts, scale_t)
        assert int(ts.step) == int(js.step) == step + 1
        for what in ("m", "v"):
            for a, b in zip(_leaves(getattr(ts, what), "torch"),
                            _leaves(getattr(js, what), "jax")):
                assert a.dtype == torch.float32
                _close(a.numpy(), np.asarray(b), what)
        for a, b in zip(_leaves(tp, "torch"), _leaves(jp, "jax")):
            assert str(a.dtype).split(".")[1] == str(b.dtype), \
                (a.dtype, b.dtype)
            got, want = _np(a), _np(b)
            if a.dtype == torch.bfloat16:
                assert (np.abs(got - want) <= _bf16_ulp(want)).all()
            else:
                _close(got, want, "params")


def test_adamw_rejects_mismatched_trees():
    p = {"w": torch.zeros(3)}
    state = topt.adamw_init(p)
    with pytest.raises(ValueError, match="structure"):
        topt.adamw_update(topt.AdamWConfig(), {"w": torch.zeros(3)},
                          {"w": torch.zeros(3), "x": torch.zeros(1)}, state)


def test_global_norm_matches_repro():
    rng = np.random.default_rng(2)
    tree = [rng.standard_normal((33, 17)).astype(np.float32),
            (rng.standard_normal(5).astype(np.float32),),
            {"z": rng.standard_normal(1000).astype(np.float32)}]
    want = float(jopt.global_norm(jax.tree_util.tree_map(jnp.asarray,
                                                         tree)))
    got = topt.global_norm([torch.from_numpy(tree[0]),
                            (torch.from_numpy(tree[1][0]),),
                            {"z": torch.from_numpy(tree[2]["z"])}])
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=RTOL)
    t = {"a": torch.ones(4), "b": torch.ones(9) * 2.0}
    assert float(topt.global_norm(t)) == pytest.approx(np.sqrt(4 + 36))


@pytest.mark.parametrize("warmup,total,floor", [(100, 10_000, 0.1),
                                                (0, 50, 0.0), (10, 10, 0.2)])
def test_cosine_schedule_matches_repro(warmup, total, floor):
    steps = np.array([0, 1, 5, 10, 50, 100, 101, 5000, 9999, 10_000,
                      20_000], np.int32)
    want = np.asarray(jopt.cosine_schedule(jnp.asarray(steps), warmup,
                                           total, floor))
    got = topt.cosine_schedule(torch.from_numpy(steps), warmup, total,
                               floor).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)


def test_adamw_minimizes_quadratic():
    """``tests/test_optim.py``'s check on the port, gradients by
    autograd."""
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = topt.adamw_init(params)
    cfg = topt.AdamWConfig(lr=0.1, weight_decay=0.0)
    for _ in range(200):
        w = params["w"].clone().requires_grad_(True)
        torch.sum(torch.square(w)).backward()
        params, opt = topt.adamw_update(cfg, {"w": w.grad}, params, opt)
    assert float(torch.sum(torch.square(params["w"]))) < 1e-3


def test_grad_clipping():
    params = {"w": torch.zeros(4)}
    opt = topt.adamw_init(params)
    cfg = topt.AdamWConfig(lr=1.0, grad_clip=1.0, weight_decay=0.0)
    p2, opt = topt.adamw_update(cfg, {"w": torch.full((4,), 100.0)},
                                params, opt)
    assert float(p2["w"].abs().max()) < 1.1


def test_adamw_state_is_a_namedtuple_of_step_m_v():
    s = topt.adamw_init({"w": torch.zeros(2, dtype=torch.bfloat16)})
    assert s._fields == jopt.adamw.AdamWState._fields == ("step", "m", "v")
    assert s.m["w"].dtype == s.v["w"].dtype == torch.float32
    assert s.m["w"].data_ptr() != s.v["w"].data_ptr()


# ----------------------------------------------------------- data
@pytest.mark.parametrize("kw", [dict(vocab=1000, seq_len=32, global_batch=8,
                                     seed=5),
                                dict(vocab=49152, seq_len=128,
                                     global_batch=16, seed=0, zipf_a=1.1),
                                dict(vocab=500, seq_len=256,
                                     global_batch=4, seed=2**40 + 3)])
def test_synthetic_tokens_bit_for_bit(kw):
    j, t = jdata.SyntheticTokens(**kw), tdata.SyntheticTokens(**kw)
    for step in (0, 1, 11, 2**33 + 7):
        for n in (1, 2, 4):
            for shard in range(n):
                a = t.batch_at(step, shard, n)["tokens"]
                b = j.batch_at(step, shard, n)["tokens"]
                assert a.dtype == b.dtype == np.int32
                np.testing.assert_array_equal(a, b)
    it_t = tdata.make_batch_iterator(t, start_step=3, shard=1, n_shards=2)
    it_j = jdata.make_batch_iterator(j, start_step=3, shard=1, n_shards=2)
    for _ in range(3):
        np.testing.assert_array_equal(next(it_t)["tokens"],
                                      next(it_j)["tokens"])


# -------------------------------------------------------- configs
def test_config_registry_matches_repro():
    assert tcfg.list_configs() == jcfg.list_configs()
    assert {k: dataclasses.asdict(v) for k, v in tcfg.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jcfg.SHAPES.items()}
    with pytest.raises(KeyError):
        tcfg.get_config("no-such-arch")


@pytest.mark.parametrize("name", jcfg.list_configs())
def test_config_matches_repro(name):
    for n in (name, name + "-smoke"):
        t, j = tcfg.get_config(n), jcfg.get_config(n)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.n_params() == j.n_params()
        assert t.n_active_params() == j.n_active_params()
        assert t.resolved_head_dim == j.resolved_head_dim
        assert t.is_subquadratic == j.is_subquadratic
        for shape in jcfg.SHAPES:
            assert tcfg.shape_applicable(t, tcfg.SHAPES[shape]) == \
                jcfg.shape_applicable(j, jcfg.SHAPES[shape])
    assert dataclasses.asdict(tcfg.get_config(name).smoke()) == \
        dataclasses.asdict(jcfg.get_config(name).smoke())
