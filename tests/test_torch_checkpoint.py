"""The port's checkpoints against the JAX package's.

``tests/test_checkpoint.py``'s four tests on the port; the same files
and keys as ``repro`` (``step_%08d/shard_%04d.npz``, ``manifest.json``,
round-robin over sorted keys); checkpoints written by either package
restore in the other bit for bit (tolerance 0; bf16 is widened to f32
in the file, exactly, and narrowed on restore); and the two repairs of
the port's ``CheckpointManager``: ``wait()`` returns only when every save
is on disk, and a writer's exception is raised at ``wait()`` and at
``close()``.
"""

import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as jck
import repro_torch.checkpoint as tck
from repro.optim import adamw_init as j_adamw_init
from repro_torch.checkpoint import checkpoint as tck_mod
from repro_torch.optim import adamw_init as t_adamw_init
from repro_torch.tree_util import tree_leaves


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"layer": {"w": torch.randn(8, 16, generator=g),
                      "b": torch.zeros(16, dtype=torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _assert_same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    tck.save_tree(t, str(tmp_path), step=3, n_shards=3)
    out, step = tck.restore_tree(t, str(tmp_path))
    assert step == 3
    _assert_same(t, out)


def test_checksum_verification(tmp_path):
    t = _tree()
    tck.save_tree(t, str(tmp_path), step=1, n_shards=2)
    victim = os.path.join(str(tmp_path), "step_00000001", "shard_0000.npz")
    with open(victim, "r+b") as f:
        f.seek(30)
        f.write(b"\x00\x01\x02")
    with pytest.raises(IOError):
        tck.restore_tree(t, str(tmp_path))


def test_latest_step_and_gc(tmp_path):
    t = _tree()
    mgr = tck.CheckpointManager(str(tmp_path), n_shards=2, keep=2)
    for s in (1, 5, 9):
        mgr.save_async(s, t)
    mgr.wait()
    mgr.close()
    assert tck.latest_step(str(tmp_path)) == 9
    kept = sorted(os.listdir(str(tmp_path)))
    assert len([k for k in kept if k.startswith("step_")]) == 2


def test_async_replication_summary(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path), n_shards=4, peer_hosts=4,
                                u=1)
    mgr.save_async(2, _tree())
    mgr.wait()
    res = mgr.result(2)
    mgr.close()
    assert res is not None
    assert res["replication"]["durable_frac"] == 1.0


def test_no_checkpoint_raises(tmp_path):
    assert tck.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        tck.restore_tree(_tree(), str(tmp_path))


# ------------------------------------------- across the two packages
def _pair(seed=1):
    """The same tree in both packages: params (f32, bf16), an AdamW state
    (a NamedTuple), a nested list/tuple, int and bool leaves."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((6, 10)).astype(np.float32)
    b = rng.standard_normal(10).astype(np.float32)
    x = rng.standard_normal(3).astype(np.float32)
    ids = rng.integers(-5, 5, 4).astype(np.int64)
    mask = rng.random(5) < 0.5
    j = {"params": {"w": jnp.asarray(w), "b": jnp.asarray(b, jnp.bfloat16)},
         "l": [jnp.asarray(x), (jnp.asarray(ids, jnp.int32),
                                jnp.asarray(mask))]}
    j["opt"] = j_adamw_init(j["params"])
    t = {"params": {"w": torch.from_numpy(w),
                    "b": torch.from_numpy(b).to(torch.bfloat16)},
         "l": [torch.from_numpy(x), (torch.from_numpy(ids).to(torch.int32),
                                     torch.from_numpy(mask))]}
    t["opt"] = t_adamw_init(t["params"])
    return j, t


def _same_across(t_tree, j_tree):
    lt, lj = tree_leaves(t_tree), jax.tree_util.tree_leaves(j_tree)
    assert len(lt) == len(lj)
    for a, b in zip(lt, lj):
        assert a.shape == b.shape
        assert str(a.dtype).split(".")[1] == str(b.dtype), (a.dtype, b.dtype)
        want = np.asarray(b.astype(jnp.float32) if b.dtype == jnp.bfloat16
                          else b)
        got = (a.to(torch.float32) if a.dtype == torch.bfloat16 else a)
        np.testing.assert_array_equal(got.numpy(), want)


def test_same_files_and_keys_as_repro(tmp_path):
    j, t = _pair()
    jm = jck.save_tree(j, str(tmp_path / "j"), step=4, n_shards=3)
    tm = tck.save_tree(t, str(tmp_path / "t"), step=4, n_shards=3)
    assert sorted(tm["files"]) == sorted(jm["files"])
    assert {k: v for k, v in tm.items() if k != "files"} == \
        {k: v for k, v in jm.items() if k != "files"}
    for name in jm["files"]:
        with np.load(tmp_path / "j" / "step_00000004" / name) as zj, \
                np.load(tmp_path / "t" / "step_00000004" / name) as zt:
            assert sorted(zt.files) == sorted(zj.files)
            for k in zj.files:
                assert zt[k].dtype == zj[k].dtype, k
                np.testing.assert_array_equal(zt[k], zj[k])
    with open(tmp_path / "t" / "step_00000004" / "manifest.json") as f:
        assert json.load(f) == tm
    flat = tck_mod._flatten_with_paths(t)
    assert sorted(flat) == ["l/0", "l/1/0", "l/1/1", "opt/m/b", "opt/m/w",
                            "opt/step", "opt/v/b", "opt/v/w", "params/b",
                            "params/w"]


def test_repro_checkpoint_restores_in_the_port(tmp_path):
    j, t = _pair(2)
    jck.save_tree(j, str(tmp_path), step=11, n_shards=4)
    out, step = tck.restore_tree(_pair(3)[1], str(tmp_path))
    assert step == 11
    _same_across(out, j)


def test_port_checkpoint_restores_in_repro(tmp_path):
    j, t = _pair(4)
    tck.save_tree(t, str(tmp_path), step=12, n_shards=2)
    out, step = jck.restore_tree(_pair(5)[0], str(tmp_path))
    assert step == 12
    _same_across(t, out)


def test_restore_takes_the_templates_dtype_and_shape(tmp_path):
    t = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3) / 7}
    tck.save_tree(t, str(tmp_path), step=0, n_shards=1)
    out, _ = tck.restore_tree({"a": torch.zeros(6, dtype=torch.float64)},
                              str(tmp_path))
    assert out["a"].dtype == torch.float64 and out["a"].shape == (6,)
    assert torch.equal(out["a"], t["a"].reshape(6).double())


# ------------------------------------------- the manager's repairs
def test_save_async_copies_before_returning(tmp_path):
    t = _tree()
    want = {k: v.clone() for k, v in t["layer"].items()}
    mgr = tck.CheckpointManager(str(tmp_path), n_shards=2)
    mgr.save_async(1, t)
    t["layer"]["w"].zero_()                 # the caller moves on at once
    mgr.wait()
    mgr.close()
    out, _ = tck.restore_tree(_tree(5), str(tmp_path))
    assert torch.equal(out["layer"]["w"], want["w"])


def test_wait_outlasts_a_slow_save(tmp_path, monkeypatch):
    real = tck_mod.save_tree
    started = threading.Event()

    def slow(*a, **kw):
        started.set()
        time.sleep(0.4)                     # far past the reference's 0.05 s
        return real(*a, **kw)

    monkeypatch.setattr(tck_mod, "save_tree", slow)
    mgr = tck.CheckpointManager(str(tmp_path), n_shards=2)
    mgr.save_async(3, _tree())
    assert started.wait(5)
    t0 = time.monotonic()
    mgr.wait(timeout=10)
    assert time.monotonic() - t0 > 0.2
    assert mgr.result(3) is not None
    assert tck.latest_step(str(tmp_path)) == 3
    mgr.close()
    assert not mgr._thread.is_alive()


def test_wait_times_out(tmp_path, monkeypatch):
    release = threading.Event()
    real = tck_mod.save_tree
    monkeypatch.setattr(tck_mod, "save_tree",
                        lambda *a, **kw: (release.wait(10), real(*a, **kw)))
    mgr = tck.CheckpointManager(str(tmp_path), n_shards=1)
    mgr.save_async(1, _tree())
    with pytest.raises(TimeoutError):
        mgr.wait(timeout=0.2)
    release.set()
    mgr.wait(timeout=10)
    mgr.close()


def test_writer_exception_raised_at_wait_and_close(tmp_path, monkeypatch):
    def broken(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(tck_mod, "save_tree", broken)
    mgr = tck.CheckpointManager(str(tmp_path), n_shards=2)
    mgr.save_async(1, _tree())
    with pytest.raises(OSError, match="disk full"):
        mgr.wait(timeout=10)
    mgr.wait(timeout=10)                     # raised once, then cleared
    mgr.save_async(2, _tree())
    assert mgr._thread.is_alive()            # the writer goes on
    with pytest.raises(OSError, match="disk full"):
        mgr.close()
    assert mgr.result(1) is None and mgr.result(2) is None
