"""The torch port's windowed engine vs the JAX package, bit for bit.

One plan (``SimSpec``) is built by the JAX package and carried into the
port with ``spec_from_arrays``. The port runs it windowed on the CPU
(``device="cpu"``); the JAX package runs it windowed and densely, and
the numpy oracle ``repro.core.refsim.run_reference`` replays the window.
Every comparison has tolerance 0 with dtypes compared: the state is
int32/bool and the float32 stake sums are exact for the integer stakes
used. ``test_torch_gpu.py`` runs the same specs on the card against the
port's own CPU runs.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.gc as jgc
import repro.core.snapshot as jsnap
import repro_torch.core as tcore
import repro_torch.core.gc as tgc
import repro_torch.core.snapshot as tsnap
from repro.core import FailureScenario as JFailureScenario
from repro.core import RSMConfig as JRSMConfig
from repro.core import SimConfig as JSimConfig
from repro.core import protocols as jprot
from repro.core import simulator as jsim
from repro.core.refsim import run_reference
from repro_torch.core import protocols as tprot
from repro_torch.core import simulator as tsim
from repro_torch.kernels import ops
from repro_torch.kernels.ref import quack_reference
from test_windowed import FIXTURES, GC_STALL, IDS, METRICS, OUTPUTS


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: torch's intra-op threads only cost, and under a
    parallel test run they compete with the other workers'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


BFT1 = JRSMConfig.bft(1)
CPU = torch.device("cpu")


def _port_spec(jspec):
    return tsim.spec_from_arrays(tsim.spec_to_arrays(jspec))


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.array_equal(a, b), what


def _events(res):
    return [dataclasses.asdict(e) for e in res.window_growth_events]


def _assert_outputs_equal(tr, jr):
    for f in OUTPUTS + ("send_step", "delivery_latency"):
        _same(getattr(tr, f), getattr(jr, f), f)
    for f in METRICS:
        _same(getattr(tr.metrics, f), getattr(jr.metrics, f), f)


def _assert_windowed_equal(tr, jr):
    """Every output, metric and window field, the growth events too."""
    _assert_outputs_equal(tr, jr)
    _same(tr.gc_frontiers, jr.gc_frontiers, "gc_frontiers")
    assert tr.final_window_slots == jr.final_window_slots
    assert _events(tr) == _events(jr)
    assert tr.completion_step() == jr.completion_step()
    assert tr.delivery_step() == jr.delivery_step()


def _run_port(jspec):
    return tsim.run_simulation(_port_spec(jspec), device="cpu")


# ------------------------------------------------ the 12 windowed fixtures
@pytest.mark.parametrize("name,snd,rcv,simkw,fails", FIXTURES, ids=IDS)
def test_windowed_matches_jax_windowed_and_dense(name, snd, rcv, simkw,
                                                  fails):
    jspec = jsim.build_spec(snd, rcv, JSimConfig(**simkw), fails)
    assert jspec.window_slots > 0
    tr = _run_port(jspec)
    _assert_windowed_equal(tr, jsim.run_simulation(jspec))
    jd = jsim.run_simulation(dataclasses.replace(jspec, window_slots=0,
                                                 chunk_steps=0))
    _assert_outputs_equal(tr, jd)
    assert (np.diff(tr.gc_frontiers) >= 0).all()
    assert tr.gc_frontiers[-1] <= jspec.m


@pytest.mark.parametrize("name,snd,rcv,simkw,fails", FIXTURES[:6],
                         ids=IDS[:6])
def test_frontiers_match_refsim(name, snd, rcv, simkw, fails):
    """The numpy oracle replays the same frontier trajectory (and proves
    each retirement safe inside ``run_reference``)."""
    jspec = jsim.build_spec(snd, rcv, JSimConfig(**simkw), fails)
    tr = _run_port(jspec)
    rr = run_reference(jspec)
    _same(tr.gc_frontiers, rr.gc_frontiers, "gc_frontiers")
    for f in OUTPUTS:
        assert np.array_equal(getattr(tr, f), getattr(rr, f)), f


def test_rotation_actually_happens():
    jspec = jsim.build_spec(BFT1, BFT1, JSimConfig(
        n_msgs=24, steps=30, window=1, phi=6, window_slots=16,
        chunk_steps=4))
    tr = _run_port(jspec)
    assert tr.gc_frontiers.max() > 0
    assert len(tr.gc_frontiers) == 30 // 4 + 1   # start + 7 rotating chunks
    assert (tr.deliver_time >= 0).all()
    assert tr.final_window_slots == 16


def test_window_overflow_raises_in_strict_mode():
    spec = tsim.build_spec(tcore.RSMConfig.bft(1), tcore.RSMConfig.bft(1),
                           tcore.SimConfig(n_msgs=64, steps=40, window=4,
                                           phi=6, window_slots=8,
                                           chunk_steps=4,
                                           adaptive_window=False))
    with pytest.raises(ValueError, match="window overflow"):
        tsim.run_simulation(spec, device="cpu")


# ------------------------------------------------ growth and dense fallback
GROWTH = [
    ("failure_free_lag",
     dict(n_msgs=128, steps=128 // 4 + 80, window=1, phi=6,
          window_slots=16, chunk_steps=8), JFailureScenario.none(), False),
    ("gc_stall_adversary",
     dict(n_msgs=128, steps=128 // 4 + 80, window=1, phi=6,
          window_slots=16, chunk_steps=8), GC_STALL, False),
    ("dense_fallback",
     dict(n_msgs=64, steps=200, window=1, phi=6, window_slots=16,
          chunk_steps=8),
     JFailureScenario(byz_bcast_partial=(True, False, False, False),
                      bcast_limit=2, crash_r=(-1, 8, -1, -1)), True),
]


@pytest.mark.parametrize("name,simkw,fails,migrates", GROWTH,
                         ids=[g[0] for g in GROWTH])
def test_adaptive_window_matches_jax(name, simkw, fails, migrates):
    """An undersized window grows 2x (or migrates to the dense layout) as
    the JAX package's does: same outputs, frontiers, final width and
    growth events, and the outputs of a dense run from round 0."""
    jspec = jsim.build_spec(BFT1, BFT1, JSimConfig(**simkw), fails)
    tr = _run_port(jspec)
    _assert_windowed_equal(tr, jsim.run_simulation(jspec))
    _assert_outputs_equal(tr, jsim.run_simulation(dataclasses.replace(
        jspec, window_slots=0, chunk_steps=0)))
    assert tr.window_growth_events
    assert tr.window_growth_events[-1].dense_migration == migrates
    if migrates:
        assert tr.final_window_slots == jspec.m
    else:
        assert jspec.window_slots < tr.final_window_slots < jspec.m
        assert (tr.deliver_time >= 0).all()
    assert tr.gc_frontiers.max() > 0


def test_debug_checks_pass_on_a_migrating_run():
    """The drain's base-mirror and GC-safety checks hold through growth
    and the dense migration, and do not change the result."""
    name, simkw, fails, _ = GROWTH[2]
    jspec = jsim.build_spec(BFT1, BFT1, JSimConfig(**simkw), fails)
    tr = _run_port(dataclasses.replace(jspec, debug_checks=True))
    _assert_windowed_equal(tr, _run_port(jspec))


def test_long_stream_constant_state():
    """Long stream: the state is O(W), not O(M), and the stream
    completes with one cross copy per message."""
    m = 20_000
    sim = tcore.SimConfig(n_msgs=m, steps=m // 16 + 60, window=4, phi=32,
                          window_slots="auto", chunk_steps=32)
    cfg = tcore.RSMConfig.bft(1)
    spec = tsim.build_spec(cfg, cfg, sim)
    assert 0 < spec.window_slots < m // 4
    small = tsim.build_spec(cfg, cfg, dataclasses.replace(
        sim, n_msgs=m // 10, steps=m // 160 + 60))
    assert spec.scan_state_nbytes() == small.scan_state_nbytes()
    r = tsim.run_simulation(spec, device="cpu")
    assert (r.deliver_time >= 0).all() and (r.quack_time >= 0).all()
    assert r.total_cross_msgs() == m
    assert r.gc_frontiers[-1] == m
    assert r.final_window_slots == spec.window_slots
    assert not r.window_growth_events


def test_superchunk_setting_does_not_change_the_run():
    """The port's K = 8 fuses chunks and gives its K = 1 run's result,
    and the JAX package's K = 8 run's."""
    name, snd, rcv, simkw, fails = FIXTURES[3]          # byzantine_recv
    j8 = jsim.build_spec(snd, rcv, JSimConfig(**simkw, superchunk=8), fails)
    j1 = dataclasses.replace(j8, superchunk=1)
    t8, t1 = _run_port(j8), _run_port(j1)
    _assert_windowed_equal(t8, t1)
    _assert_windowed_equal(t8, jsim.run_simulation(j8))


def test_run_picsou_windowed_matches_jax():
    cfg = JRSMConfig.bft(2)
    sim = dict(n_msgs=512, steps=240, window_slots=192, chunk_steps=16)
    fails = JFailureScenario.crash_fraction(7, 7, 0.25)
    jrun = jprot.run_picsou(cfg, cfg, JSimConfig(**sim), fails)
    tcfg = tcore.RSMConfig.bft(2)
    trun = tprot.run_picsou(tcfg, tcfg, tcore.SimConfig(**sim),
                            tcore.FailureScenario.crash_fraction(7, 7, 0.25),
                            device="cpu")
    assert trun.spec == _port_spec(jrun.spec)
    assert 0 < trun.spec.window_slots < 512
    _assert_windowed_equal(trun.result, jrun.result)
    for stat in ("cross_copies_per_msg", "resends_per_msg", "all_quacked",
                 "all_delivered"):
        assert getattr(trun, stat) == getattr(jrun, stat), stat


def test_windowed_run_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = tsim.build_spec(tcore.RSMConfig.bft(1), tcore.RSMConfig.bft(1),
                           tcore.SimConfig(n_msgs=64, steps=8,
                                           window_slots=16, chunk_steps=4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsim.run_simulation(spec)


# ---------------------------------------------------- the GC frontier
def _frontier_lanes(seed, n_b=3, n_s=4, n_r=5, w=48):
    """Seeded lane states whose leading columns are mostly retirable, so
    that frontiers land inside the window."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 200, n_b).astype(np.int32)
    k = rng.integers(w // 4, w, n_b)
    lead = np.arange(w)[None, :] < k[:, None]                 # (B, W)
    known = rng.random((n_b, n_s, n_r, w)) < 0.3
    known |= lead[:, None, None, :] & (rng.random(known.shape) < 0.9)
    bcast_q = rng.random((n_b, n_r, w)) < 0.01
    recv_has = rng.random((n_b, n_r, w)) < 0.8
    recv_has |= lead[:, None, :] & (rng.random(recv_has.shape) < 0.97)
    ack_floor = (base[:, None]
                 + rng.integers(0, 6, (n_b, n_r))).astype(np.int32)
    orig_sent = np.arange(w)[None, :] < rng.integers(w // 2, w + 1,
                                                    (n_b, 1))
    t_next = 30
    crash_r = rng.choice([-1, -1, -1, t_next - 1, t_next, t_next + 1],
                         (n_b, n_r)).astype(np.int32)
    byz_ack_low = rng.random((n_b, n_r)) < 0.15
    stakes_r = rng.integers(1, 4, (n_b, n_r)).astype(np.float32)
    quack_thresh = np.floor(stakes_r.sum(1) * 0.6).astype(np.float32)
    m = int(base.max()) + w - 3
    return dict(base=base, t_next=t_next, m=m, known=known,
                bcast_q=bcast_q, recv_has=recv_has, ack_floor=ack_floor,
                stakes_r=stakes_r, quack_thresh=quack_thresh,
                orig_sent=orig_sent, crash_r=crash_r,
                byz_ack_low=byz_ack_low)


@pytest.mark.parametrize("seed", range(4))
def test_gc_frontier_device_matches_jax_and_numpy(seed):
    lanes = _frontier_lanes(seed)
    scalars = ("t_next", "m")
    port = tgc.gc_frontier_device(**{
        k: v if k in scalars else torch.as_tensor(v)
        for k, v in lanes.items()})
    assert port.dtype == torch.int32 and port.shape == (3,)
    got = port.numpy()
    for b in range(3):
        lane = {k: v if k in scalars else v[b] for k, v in lanes.items()}
        want_np = jgc.gc_frontier(**lane)
        want_jax = jgc.gc_frontier_device(**{
            k: v if k in scalars else jnp.asarray(v)
            for k, v in lane.items()})
        assert int(want_jax) == want_np == int(got[b])
        assert tgc.gc_frontier(**lane) == want_np
    assert got.max() > 0                    # not a run of empty prefixes


def test_grow_window_and_boundaries_match_jax():
    for w, base, need, m in [(16, 0, 31, 128), (16, 8, 200, 128),
                             (64, 100, 163, 1000), (5, 0, 4, 64)]:
        assert tgc.grow_window(w, base, need, m) == jgc.grow_window(
            w, base, need, m)
    for steps, c in [(0, 4), (30, 4), (64, 32), (7, 0)]:
        _same(tgc.chunk_boundaries(steps, c), jgc.chunk_boundaries(steps, c),
              "chunk_boundaries")
    assert [tgc.snap_to_boundary(t, 8) for t in (-3, 0, 7, 8, 23)] == \
        [jgc.snap_to_boundary(t, 8) for t in (-3, 0, 7, 8, 23)]
    prefix = np.array([0, 3, 7], dtype=np.int32)
    _same(tgc.collectable(torch.as_tensor(prefix), 9).numpy(),
          jgc.collectable(jnp.asarray(prefix), 9), "collectable")
    rng = np.random.default_rng(3)
    reports = rng.integers(0, 50, (5, 4)).astype(np.int32)
    stakes = np.array([1.0, 2.0, 1.0, 3.0], dtype=np.float32)
    _same(tgc.ack_floor_from_reports(torch.as_tensor(reports),
                                     torch.as_tensor(stakes), 3.0).numpy(),
          jgc.ack_floor_from_reports(jnp.asarray(reports),
                                     jnp.asarray(stakes), 3.0),
          "ack_floor_from_reports")


# ------------------------------------------ the lane-aware quorum kernel
@pytest.mark.parametrize("compute_lost", [True, False],
                         ids=["lost", "no_lost"])
def test_lane_quack_reference_equals_one_lane_calls(compute_lost):
    """B = 2 lanes with their own real stakes and thresholds in one call
    equal two calls in the reference's one-lane form."""
    rng = np.random.default_rng(21)
    claims = torch.as_tensor(rng.random((2, 3, 7, 100)) < 0.6)
    comps = torch.as_tensor(rng.random((2, 3, 7, 100)) < 0.3)
    claims[:, :, :4, :40] = True
    stakes = torch.as_tensor((rng.random((2, 7)) + 0.5).astype(np.float32))
    qthr = stakes.sum(1) * torch.tensor([0.6, 0.45])
    dthr = stakes.sum(1) * torch.tensor([0.3, 0.2])
    both = quack_reference(claims, comps, stakes, qthr, dthr,
                           compute_lost=compute_lost)
    assert both[0].shape == (2, 3, 100) and both[2].shape == (2, 3)
    assert both[2].dtype == torch.int32
    for b in range(2):
        one = ops.quack_scan(claims[b], comps[b], stakes[b], qthr[b],
                             dthr[b], compute_lost=compute_lost)
        lane = quack_reference(claims[b:b + 1], comps[b:b + 1],
                               stakes[b:b + 1], qthr[b:b + 1],
                               dthr[b:b + 1], compute_lost=compute_lost)
        for x, y, z in zip(both, one, lane):
            if y is None:
                assert x is None and z is None
                continue
            assert torch.equal(x[b], y) and torch.equal(z[0], y)
    assert not torch.equal(both[0][0], both[0][1])   # lanes differ


# ------------------------------------- window moves vs the reference
def _lane_state(seed, n_b=2, n_s=4, n_r=4, w=24):
    """A seeded lane-batched SimState of numpy arrays."""
    rng = np.random.default_rng(seed)
    shapes = tsnap.window_shapes(n_s, n_r, w)
    window = {}
    for name, fill in tsnap.WINDOW_FILLS.items():
        shape = (n_b,) + shapes[name]
        window[name] = (rng.random(shape) < 0.5 if isinstance(fill, bool)
                        else rng.integers(-1, 40, shape).astype(np.int32))
    return tsim.SimState(
        **window,
        last_cum=rng.integers(-1, 30, (n_b, n_s, n_r)).astype(np.int32),
        hq_reports=rng.integers(0, 30, (n_b, n_r, n_s)).astype(np.int32),
        ack_floor=rng.integers(0, 30, (n_b, n_r)).astype(np.int32),
        base=rng.integers(0, 50, n_b).astype(np.int32),
        retired_delivered=rng.integers(0, 9, n_b).astype(np.int32))


@pytest.mark.parametrize("new_w", [24, 40])
def test_pad_window_matches_jax(new_w):
    state = _lane_state(5)
    want = jsnap.pad_window(state, new_w)
    on_host = tsnap.pad_window(state, new_w)
    on_device = tsnap.pad_window(tsnap.device_state(state, CPU), new_w)
    for f in tsim.SimState._fields:
        _same(getattr(on_host, f), getattr(want, f), f)
        _same(getattr(on_device, f).numpy(), getattr(want, f), f)
    back = tsnap.host_state(on_device)
    for f in tsim.SimState._fields:
        _same(getattr(back, f), getattr(want, f), f)


@pytest.mark.parametrize("seed", range(3))
def test_rotate_device_matches_jax(seed):
    w = 24
    state = _lane_state(seed, w=w)
    f = np.array([0, w], dtype=np.int32) if seed == 0 else \
        np.random.default_rng(seed).integers(0, w + 1, 2).astype(np.int32)
    got = tsim._rotate_device(tsnap.device_state(state, CPU),
                              torch.as_tensor(f), w)
    for name in tsnap.WINDOW_FILLS:
        assert getattr(got, name).is_contiguous(), name
    for b in range(2):
        lane = jsim.SimState(*(jnp.asarray(getattr(state, name)[b])
                               for name in jsim.SimState._fields))
        want = jsim._rotate_device(lane, jnp.int32(f[b]), w)
        for name in tsim.SimState._fields:
            _same(getattr(got, name)[b].numpy(), getattr(want, name), name)
