"""The port's cross-pod runtime against the JAX package's.

* The two gradient syncs on a (2, 2, 2) (pod, data, model) mesh held on
  the CPU (``repro_torch.launch.mesh``) against ``repro``'s ``shard_map``
  versions on 8 host devices (one subprocess, results through npz), for
  ``P()`` and for ``P(("pod", "data"))`` on dim 0 (every position a
  distinct block), on the tree of ``tests/test_crosspod.py`` and a leaf
  whose length is odd (padding). Tolerance 1e-6 absolute: both sum eight
  f32 values of magnitude < 5 in their own order. ``dcn_bytes_analytic``
  is equal.
* EF-int8 compression: q, scales, pad and residual bit for bit over 20
  steps (tolerance 0: the same f32 ops, division by the scale, round
  half to even).
* The replication ledger (the four scenarios of ``tests/test_crosspod.py``
  and a seeded random sequence of calls on both packages, every output
  equal), the elastic plans and the consensus models: equal (host code,
  tolerance 0).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.consensus as jcons
import repro.crosspod as jcp
import repro.launch.elastic as jel
import repro_torch.consensus as tcons
import repro_torch.crosspod as tcp
import repro_torch.launch.elastic as tel
from helpers import run_py
from repro.core.types import RSMConfig as JRSMConfig
from repro_torch.core.types import RSMConfig as TRSMConfig
from repro_torch.launch import mesh as tmesh

SYNC_ATOL = 1e-6
MESH = ((2, 2, 2), ("pod", "data", "model"))
SPECS = {"replicated": (), "split": (("pod", "data"),)}


def _trees():
    rng = np.random.default_rng(0)
    f32 = np.float32
    return {
        # P(): the tree of tests/test_crosspod.py plus a 2-D odd leaf
        "replicated": {"a": rng.standard_normal((16, 12)).astype(f32),
                       "b": rng.standard_normal(7).astype(f32),
                       "c": rng.standard_normal((3, 5)).astype(f32)},
        # P(("pod", "data")): 4 distinct blocks; b's block is 7 long
        "split": {"a": rng.standard_normal((16, 12)).astype(f32),
                  "b": rng.standard_normal(4 * 7).astype(f32),
                  "c": rng.standard_normal((8, 3, 5)).astype(f32)},
    }


_REPRO_SYNC = """
import numpy as np, jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.launch.mesh import make_mesh
from repro.crosspod import picsou_cross_pod_sync, ata_cross_pod_sync
src = np.load({src!r})
mesh = make_mesh((2, 2, 2), ('pod', 'data', 'model'))
out = {{}}
for name, spec in (('replicated', P()), ('split', P(('pod', 'data')))):
    g = {{k[len(name) + 1:]: src[k] for k in src.files
         if k.startswith(name + '/')}}
    gsh = jax.device_put(g, NamedSharding(mesh, spec))
    for sched, fn in (('picsou', picsou_cross_pod_sync),
                      ('ata', ata_cross_pod_sync)):
        res = fn(gsh, mesh, spec)
        for k in g:
            out[sched + '/' + name + '/' + k] = np.asarray(res[k])
np.savez({dst!r}, **out)
print('DONE')
"""


@pytest.fixture(scope="module")
def repro_sync(tmp_path_factory):
    d = tmp_path_factory.mktemp("sync")
    src, dst = str(d / "in.npz"), str(d / "out.npz")
    np.savez(src, **{f"{name}/{k}": v for name, tree in _trees().items()
                     for k, v in tree.items()})
    assert "DONE" in run_py(_REPRO_SYNC.format(src=src, dst=dst), devices=8)
    with np.load(dst) as z:
        return {k: z[k] for k in z.files}


def _port_sync(sched, name):
    mesh = tmesh.make_mesh(*MESH, device="cpu")
    tree = {k: torch.from_numpy(v) for k, v in _trees()[name].items()}
    fn = {"picsou": tcp.picsou_cross_pod_sync,
          "ata": tcp.ata_cross_pod_sync}[sched]
    return tree, fn(tree, mesh, tmesh.P(*SPECS[name]))


@pytest.mark.parametrize("name", sorted(SPECS))
@pytest.mark.parametrize("sched", ["picsou", "ata"])
def test_sync_matches_repro(repro_sync, sched, name):
    tree, out = _port_sync(sched, name)
    assert sorted(out) == sorted(tree)
    for k, x in tree.items():
        want = repro_sync[f"{sched}/{name}/{k}"]
        got = out[k].numpy()
        assert got.shape == want.shape == tuple(x.shape), k
        assert got.dtype == want.dtype, k
        np.testing.assert_allclose(got, want, rtol=0, atol=SYNC_ATOL,
                                   err_msg=f"{sched} {name} {k}")


@pytest.mark.parametrize("name", sorted(SPECS))
def test_port_schedules_return_the_blocks_mean(name):
    tree, pic = _port_sync("picsou", name)
    _, ata = _port_sync("ata", name)
    n = 4 if name == "split" else 1
    for k, x in tree.items():
        blocks = x.numpy().astype(np.float64).reshape(n, -1,
                                                      *x.shape[1:])
        mean = np.broadcast_to(blocks.mean(0), blocks.shape).reshape(x.shape)
        np.testing.assert_allclose(pic[k].numpy(), mean, rtol=0,
                                   atol=SYNC_ATOL)
        np.testing.assert_allclose(ata[k].numpy(), mean, rtol=0,
                                   atol=SYNC_ATOL)
        np.testing.assert_allclose(pic[k].numpy(), ata[k].numpy(), rtol=0,
                                   atol=SYNC_ATOL)


@pytest.mark.parametrize("schedule", ["ata", "picsou"])
@pytest.mark.parametrize("shape", [{"pod": 2, "data": 16, "model": 16},
                                   {"data": 16, "model": 16},
                                   {"pod": 4, "data": 8}, {"pod": 1}])
def test_dcn_bytes_equal(shape, schedule):
    n = 534.8e6
    assert tcp.dcn_bytes_analytic(n, shape, schedule) == \
        jcp.dcn_bytes_analytic(n, shape, schedule)


def test_dcn_unknown_schedule_raises():
    with pytest.raises(ValueError):
        tcp.dcn_bytes_analytic(1.0, {"pod": 2, "data": 2}, "ring")


# --------------------------------------------------------- the mesh
def test_mesh_needs_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tmesh.make_mesh((2, 2), ("data", "model")),
                 lambda: tmesh.small_mesh(pod=2),
                 lambda: tmesh.make_production_mesh(multi_pod=True)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    mesh = tmesh.make_production_mesh(multi_pod=True, device="cpu")
    assert mesh.shape == {"pod": 2, "data": 16, "model": 16}
    assert mesh.size == 512 and mesh.device == torch.device("cpu")
    assert tmesh.small_mesh(device="cpu").shape == {"data": 2, "model": 2}


def test_blocks_are_views_and_round_trip():
    mesh = tmesh.make_mesh((2, 4, 2), ("pod", "data", "model"),
                           device="cpu")
    x = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8 * 6, 4)
    for spec, lead in ((tmesh.P(), (1, 1, 1)),
                       (tmesh.P(("pod", "data")), (2, 4, 1)),
                       (tmesh.P("data", "model"), (1, 4, 2)),
                       (tmesh.P(None, "pod"), (2, 1, 1))):
        b = tmesh.to_blocks(x, mesh, spec)
        assert tuple(b.shape[:3]) == lead
        assert b.data_ptr() == x.data_ptr()           # a view, no copy
        assert torch.equal(tmesh.from_blocks(b, mesh, spec), x)
    b = tmesh.to_blocks(x, mesh, tmesh.P(("pod", "data")))
    assert torch.equal(b[1, 2, 0], x[6 * 6:7 * 6])    # block 1 * 4 + 2


def test_collectives_on_blocks():
    mesh = tmesh.make_mesh((2, 4, 1), ("pod", "data", "model"),
                           device="cpu")
    x = torch.randn(8 * 12, generator=torch.Generator().manual_seed(1))
    b = tmesh.to_blocks(x, mesh, tmesh.P(("pod", "data")))
    blocks = x.reshape(2, 4, 12)
    s = tmesh.psum_scatter(b, mesh, "data")            # (2, 4, 1, 3)
    assert tuple(s.shape) == (2, 4, 1, 3)
    for j in range(4):
        assert torch.allclose(s[:, j, 0], blocks.sum(1)[:, 3 * j:3 * j + 3])
    r = tmesh.psum(s, mesh, "pod")                     # step (2): shards
    assert tuple(r.shape) == (1, 4, 1, 3)
    g = tmesh.all_gather(r, mesh, "data")
    assert tuple(g.shape) == (1, 1, 1, 12)
    assert torch.allclose(g[0, 0, 0], blocks.sum((0, 1)), atol=1e-6)
    # a block held once counts once per position it stands for
    one = tmesh.to_blocks(x, mesh, tmesh.P())
    assert torch.equal(tmesh.psum(one, mesh, ("pod", "data"))[0, 0, 0],
                       x * 8)


def test_mesh_refuses_bad_input():
    mesh = tmesh.make_mesh((2, 2), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="does not split"):
        tmesh.to_blocks(torch.zeros(3), mesh, tmesh.P("data"))
    with pytest.raises(ValueError, match="no mesh axis"):
        tmesh.to_blocks(torch.zeros(4), mesh, tmesh.P("pod"))
    with pytest.raises(ValueError, match="twice"):
        tmesh.to_blocks(torch.zeros(4, 4), mesh, tmesh.P("data", "data"))
    meta = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="given to a mesh"):
        tmesh.to_blocks(meta, mesh, tmesh.P())


# ------------------------------------------------------ compression
def test_ef_int8_bit_identical_over_20_steps():
    rng = np.random.default_rng(3)
    leaves = {"odd": (rng.standard_normal(1000) * 0.01).astype(np.float32),
              "mat": (rng.standard_normal((12, 512)) * 0.1).astype(
                  np.float32),
              "zero_block": np.concatenate(
                  [np.zeros(256, np.float32),
                   rng.standard_normal(300).astype(np.float32)])}
    for k, g in leaves.items():
        jres = jnp.zeros(g.shape, jnp.float32)
        tres = tcp.make_ef_state({"g": torch.from_numpy(g)})["g"]
        for step in range(20):
            grad = g * np.float32(1 + 0.1 * step)
            (jq, js, jp), jres = jcp.ef_int8_compress(jnp.asarray(grad),
                                                      jres)
            (tq, ts, tp), tres = tcp.ef_int8_compress(
                torch.from_numpy(grad), tres)
            assert tp == jp, (k, step)
            assert tq.dtype == torch.int8 and ts.dtype == torch.float32
            np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
            np.testing.assert_array_equal(tres.numpy(), np.asarray(jres))
            np.testing.assert_array_equal(
                tcp.ef_int8_decompress((tq, ts, tp), grad.shape).numpy(),
                np.asarray(jcp.ef_int8_decompress((jq, js, jp),
                                                  grad.shape)))


def test_ef_int8_error_feedback_accumulates():
    """``tests/test_crosspod.py``'s error-feedback check on the port."""
    g = np.random.RandomState(0).randn(1000).astype(np.float32) * 0.01
    residual = torch.zeros(1000)
    total_sent = np.zeros(1000, np.float32)
    total_true = np.zeros(1000, np.float32)
    for step in range(20):
        grad = torch.from_numpy(g * (1 + 0.1 * step))
        packed, residual = tcp.ef_int8_compress(grad, residual)
        total_sent += tcp.ef_int8_decompress(packed, grad.shape).numpy()
        total_true += grad.numpy()
    assert np.abs(total_sent + residual.numpy() - total_true).max() < 1e-4


# ------------------------------------------------------ the ledger
def test_ledger_quack_durability():
    led = tcp.ReplicationLedger(n_hosts=4, u=1, r=1)
    led.plan_sends(list(range(8)))
    led.record_ack(0, 7)
    assert not led.all_durable()
    led.record_ack(1, 7)
    assert led.all_durable() and led.highest_quacked() == 7


def test_ledger_dup_detection_and_election():
    led = tcp.ReplicationLedger(n_hosts=4, u=1, r=1)
    led.plan_sends(list(range(4)))
    for h in (0, 1, 0):
        led.record_ack(h, 1)
    assert led.lost_shards() == []
    led.record_ack(1, 1)
    assert led.lost_shards() == [2]
    origin = led.shards[2].origin_host
    assert led.elect_retransmitter(2) == (origin + 1) % 4
    for h in (0, 1, 0, 1):
        led.record_ack(h, 1)
    assert led.lost_shards() == [2]
    assert led.elect_retransmitter(2) == (origin + 2) % 4


def test_ledger_hq_attestation_floor():
    led = tcp.ReplicationLedger(n_hosts=4, u=1, r=1)
    led.plan_sends(list(range(4)))
    assert led.record_hq_attestation(0, 2) == 0
    assert led.record_hq_attestation(1, 2) == 3


def test_ledger_straggler_apportionment():
    led = tcp.ReplicationLedger(n_hosts=4, u=1, r=0)
    plan = led.plan_sends(list(range(10)),
                          host_throughput=np.array([5., 3., 1., 1.]))
    counts = np.bincount(list(plan.values()), minlength=4)
    assert counts[0] == 5 and counts[1] == 3


def _ledger_state(led):
    return {
        "shards": {sid: dataclasses.astuple(st)
                   for sid, st in sorted(led.shards.items())},
        "last_ack": dict(led.last_ack),
        "dup": {k: sorted(v) for k, v in led.dup_counts.items()},
        "hq": {k: sorted(v) for k, v in led.hq_attestations.items()},
        "floor": led.ack_floor, "lost": led.lost_shards(),
        "hq_id": led.highest_quacked(), "all": led.all_durable(),
        "summary": led.summary(),
    }


@pytest.mark.parametrize("seed", range(4))
def test_ledger_random_sequence_matches_repro(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3, 7))
    u, r = int(rng.integers(0, 3)), int(rng.integers(0, 2))
    stakes = rng.integers(1, 4, n).astype(np.float64)
    j = jcp.ReplicationLedger(n, u, r, stakes)
    t = tcp.ReplicationLedger(n, u, r, stakes)
    k = int(rng.integers(4, 12))
    tp = rng.random(n) + 0.1
    assert j.plan_sends(list(range(k)), tp) == \
        t.plan_sends(list(range(k)), tp)
    for _ in range(200):
        op = rng.integers(0, 4)
        if op <= 1:
            h = int(rng.integers(0, n))
            cum = (j.last_ack.get(h, -1) if rng.random() < 0.4
                   else int(rng.integers(-1, k)))
            j.record_ack(h, cum)
            t.record_ack(h, cum)
        elif op == 2:
            lost = j.lost_shards()
            assert lost == t.lost_shards()
            if lost:
                sid = lost[int(rng.integers(0, len(lost)))]
                assert j.elect_retransmitter(sid) == \
                    t.elect_retransmitter(sid)
        else:
            h, hq = int(rng.integers(0, n)), int(rng.integers(-1, k))
            assert j.record_hq_attestation(h, hq) == \
                t.record_hq_attestation(h, hq)
        assert _ledger_state(j) == _ledger_state(t)


# ------------------------------------------- elastic plans, consensus
@pytest.mark.parametrize("alive", [[0, 1], [1], [0, 2, 3]])
def test_replan_membership_matches_repro(alive):
    args = (alive, 4, 16, 16, 100)
    assert dataclasses.asdict(tel.replan_membership(*args)) == \
        dataclasses.asdict(jel.replan_membership(*args))
    with pytest.raises(RuntimeError):
        tel.replan_membership([], 4, 16, 16, None)


@pytest.mark.parametrize("tp,quantum,peer", [
    ([4.0, 2.0, 1.0, 1.0], 16, None), ([3.0, 1.0], 8, 12),
    ([2.5, 1.5, 1.0], 7, 9.0), ([1.0] * 5, 13, 0)])
def test_replan_quotas_matches_repro(tp, quantum, peer):
    assert tel.replan_quotas(np.array(tp), quantum, peer) == \
        jel.replan_quotas(np.array(tp), quantum, peer)


def test_elastic_plans_as_test_elastic():
    plan = tel.replan_membership([1], hosts_per_pod=4, data_parallel=16,
                                 model_parallel=16, last_committed_step=100)
    assert plan.mesh_shape == (16, 16) and plan.restore_step == 100
    q = tel.replan_quotas(np.array([3.0, 1.0]), quantum=8,
                          peer_total_stake=12)
    assert sum(q.values()) == 8 and q[0] == 6


@pytest.mark.parametrize("model", ["FileModel", "PBFTModel", "RaftModel",
                                   "AlgorandModel"])
def test_consensus_models_match_repro(model):
    tm, jm = getattr(tcons, model)(), getattr(jcons, model)()
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    for f in (1, 2, 6):
        assert tm.cert_bytes(TRSMConfig.bft(f)) == \
            jm.cert_bytes(JRSMConfig.bft(f))
    for n in (1, 4, 7, 19):
        assert tm.rate_at(n) == jm.rate_at(n)
    for c3b in (100.0, 39_000.0, float("inf")):
        for over in (0.0, 0.02, 0.15):
            assert tcons.coupled_throughput(tm.commit_rate, c3b, over) == \
                jcons.coupled_throughput(jm.commit_rate, c3b, over)


def test_consensus_imports_the_ports_types():
    import repro_torch.consensus.streams as streams
    assert streams.RSMConfig is TRSMConfig
    assert os.path.dirname(streams.__file__).endswith(
        os.path.join("repro_torch", "consensus"))
