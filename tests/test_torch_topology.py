"""The torch port's topology engine vs the JAX package, bit for bit.

Every fixture of ``tests/test_topology.py`` is carried into the port's
types and runs through the port's ``run_topology`` on the CPU
(``device="cpu"``) and its numpy mirror ``run_topology_reference``; the
JAX package runs the same topologies. Every link's outputs, round
metrics, GC-frontier and commit-floor trajectories, ``send_step`` and
``delivery_latency`` must be equal with dtypes compared: the state is
int32/bool and the float32 stake sums are exact for the integer stakes
used. The port's own numpy oracle (``repro_torch.core.refsim``) is held
to the JAX package's on the windowed fixtures. ``test_torch_gpu.py`` and
``chip_smoke.py`` run topologies on the card against these CPU runs.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import repro.core.refsim as jrefsim
import repro.topology as jtopo
import repro.topology.engine as jengine
import repro_torch.core as tcore
import repro_torch.core.graphs as tgraphs
import repro_torch.core.refsim as trefsim
import repro_torch.topology as ttopo
import repro_torch.topology.engine as tengine
from repro.core import RSMConfig as JRSMConfig
from repro.core import SimConfig as JSimConfig
from repro.core import simulator as jsim
from repro_torch.core import simulator as tsim
from repro_torch.obs.metrics import latency_histogram_np
from repro_torch.obs.report import run_reported_topology
from repro_torch.obs.tracer import SpanTracer, tracing
from test_topology import FIXTURES, GC_STALL, IDS, OUTPUTS, RECV_CRASH
from test_windowed import FIXTURES as WINDOWED
from test_windowed import IDS as WINDOWED_IDS
from test_windowed import METRICS


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: torch's intra-op threads only cost, and under a
    parallel test run they compete with the other workers'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


BFT1 = JRSMConfig.bft(1)
LATENCY = ("send_step", "delivery_latency")
OBS_FIELDS = ("latency_hist", "occupancy_hwm", "gc_lag_hwm",
              "quack_events", "loss_events", "resend_total", "uncounted",
              "per_chunk_hist")
BY_NAME = dict(FIXTURES)

# the chained topology of tests/test_pipeline.py (K = 1 vs K = 8)
PIPE_SIM = dict(n_msgs=96, steps=160, window=1, phi=6, window_slots=24,
                chunk_steps=8, debug_checks=True)

# chained topologies that grow the window and then migrate to the dense
# layout with the metrics fabric on, after the chained link retired
# messages its floor held back (dispatched later than their schedule
# round): a GC-stalling receiver that loses a replica at round 16, on the
# upstream link (which forces the migration) or on the chained one. The
# last field says whether the numpy mirror agrees: on the second the JAX
# package's own engine and mirror disagree (message 0 of "b->c" and the
# frontiers after the migration; ROADMAP queue 3), and the port follows
# the JAX engine.
_STALL_CRASH = dataclasses.replace(GC_STALL, crash_r=(-1, 16, -1, -1))
MIGRATING = [
    ("upstream_stalls", 128, {"a->b": _STALL_CRASH}, True),
    ("downstream_stalls", 96, {"b->c": _STALL_CRASH}, False),
]


# ------------------------------------------------------------ helpers
def _port_cfg(cls, obj):
    return cls(**dataclasses.asdict(obj))


def _port_topo(topo):
    """A JAX package ``Topology`` in the port's types."""
    return ttopo.Topology(
        clusters={n: _port_cfg(tcore.RSMConfig, c)
                  for n, c in topo.clusters.items()},
        links=tuple(ttopo.LinkSpec(
            l.name, l.src, l.dst,
            _port_cfg(tcore.FailureScenario, l.failures), l.upstream)
            for l in topo.links),
        sim=_port_cfg(tcore.SimConfig, topo.sim))


def _same(a, b, what, dtype=True):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype or not dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.array_equal(a, b), what


def _events(res):
    return [dataclasses.asdict(e) for e in res.window_growth_events]


def _assert_link_equal(t, j, what, engine=True):
    """One link of two topology runs: every output, the latency mirrors,
    the frontier and commit-floor trajectories; for two engine runs also
    the round metrics, the final width, the growth events and the dtypes
    (the numpy oracle keeps its outputs in int64)."""
    for f in OUTPUTS + LATENCY:
        _same(getattr(t.result, f), getattr(j.result, f), (what, f),
              dtype=engine)
    _same(t.result.gc_frontiers, j.result.gc_frontiers,
          (what, "gc_frontiers"))
    _same(t.commit_floors, j.commit_floors, (what, "commit_floors"))
    if engine:
        for f in METRICS:
            _same(getattr(t.result.metrics, f),
                  getattr(j.result.metrics, f), (what, f))
        assert t.result.final_window_slots == j.result.final_window_slots
        assert _events(t.result) == _events(j.result), what


def _assert_topology_equal(tres, jres, engine=True):
    assert list(tres.links) == list(jres.links)
    for name in tres.links:
        _assert_link_equal(tres[name], jres[name], name, engine)


def _assert_obs_equal(tobs, jobs, what):
    for f in OBS_FIELDS:
        a, b = getattr(tobs, f), getattr(jobs, f)
        if a is None or b is None:
            assert a is None and b is None, (what, f)
            continue
        assert np.array_equal(np.asarray(a), np.asarray(b)), (what, f)


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    return jtopo.run_topology(BY_NAME[name])


@functools.lru_cache(maxsize=None)
def _port_run(name):
    return ttopo.run_topology(_port_topo(BY_NAME[name]), device="cpu")


# ------------------------------------------ the 8 topology fixtures
@pytest.mark.parametrize("name,topo", FIXTURES, ids=IDS)
def test_engine_matches_jax(name, topo):
    """Every link of the port's run == the JAX package's, bit for bit."""
    _assert_topology_equal(_port_run(name), _jax_run(name))


@pytest.mark.parametrize("name,topo", FIXTURES, ids=IDS)
def test_reference_mirror_matches_jax_and_the_engine(name, topo):
    """The port's numpy mirror == the JAX package's mirror (its retired-
    slot margins too) and == the port's engine."""
    tref = ttopo.run_topology_reference(_port_topo(topo))
    jref = jtopo.run_topology_reference(topo)
    _assert_topology_equal(tref, jref, engine=False)
    for lname in topo.link_names:
        a, b = tref[lname].result, jref[lname].result
        assert a.retired_quack_margin == b.retired_quack_margin, lname
        assert a.retired_undelivered == b.retired_undelivered, lname
        for f in ("cross_msgs", "intra_msgs", "resends"):
            _same(getattr(a, f), getattr(b, f), (lname, f))
    _assert_topology_equal(_port_run(name), tref, engine=False)


@pytest.mark.parametrize("name,topo", [f for f in FIXTURES
                                       if "chain" in f[0]],
                         ids=[i for i in IDS if "chain" in i])
def test_chained_delivery_prefix_consistency(name, topo):
    """A chained link never commits past its upstream's delivered prefix,
    never delivers what its upstream has not, and its delivered prefix is
    inside the upstream's; a floor is never above the retired prefix it
    was read from."""
    res = _port_run(name)
    for l in topo.links:
        if l.upstream is None:
            continue
        dn, up = res[l.name], res[l.upstream]
        assert dn.commit_floors.max() <= up.delivered_prefix(), l.name
        assert not (dn.delivered_mask() & ~up.delivered_mask()).any()
        assert dn.delivered_prefix() <= up.delivered_prefix(), l.name
        _same(dn.commit_floors, up.result.gc_frontiers[:len(
            dn.commit_floors)], (l.name, "floors = upstream frontiers"))
        # nothing is dispatched below the chunk its floor opened at
        starts = np.arange(len(dn.commit_floors)) * topo.sim.chunk_steps
        opened = np.searchsorted(dn.commit_floors, np.arange(
            topo.sim.n_msgs), side="right")
        sent = dn.result.send_step >= 0
        assert (dn.result.send_step[sent]
                >= starts[opened[sent]]).all(), l.name


def test_chain_end_to_end_delivery():
    """The whole chain drains, though every hop is commit-gated, and the
    downstream floor starts at 0 and rises to M."""
    res = _port_run("chain_3c")
    m = BY_NAME["chain_3c"].sim.n_msgs
    assert res["b->c"].delivered_prefix() == m
    floors = res["b->c"].commit_floors
    assert floors[0] == 0 and floors[-1] == m


# ----------------------------------------------- the port's own oracle
@pytest.mark.parametrize("name,snd,rcv,simkw,fails", WINDOWED,
                         ids=WINDOWED_IDS)
def test_refsim_matches_jax_refsim(name, snd, rcv, simkw, fails):
    """``repro_torch.core.refsim`` == ``repro.core.refsim`` on the
    windowed fixtures: every output, round count, frontier and margin."""
    jspec = jsim.build_spec(snd, rcv, JSimConfig(**simkw), fails)
    tspec = tsim.spec_from_arrays(tsim.spec_to_arrays(jspec))
    a, b = trefsim.run_reference(tspec), jrefsim.run_reference(jspec)
    for f in OUTPUTS + LATENCY + ("cross_msgs", "intra_msgs", "resends",
                                  "gc_frontiers"):
        _same(getattr(a, f), getattr(b, f), f)
    assert a.retired_quack_margin == b.retired_quack_margin
    assert a.retired_undelivered == b.retired_undelivered


def test_refsim_fail_schedule_matches_jax():
    """A mid-stream failure swap in the port's oracle == the JAX one's."""
    name, snd, rcv, simkw, _ = WINDOWED[2]
    jspec = jsim.build_spec(snd, rcv, JSimConfig(**simkw))
    tspec = tsim.spec_from_arrays(tsim.spec_to_arrays(jspec))
    tswap = _port_cfg(tcore.FailureScenario, RECV_CRASH)
    a = trefsim.run_reference(
        tspec, fail_schedule=lambda t: tswap if t == 16 else None)
    b = jrefsim.run_reference(
        jspec, fail_schedule=lambda t: RECV_CRASH if t == 16 else None)
    for f in OUTPUTS + LATENCY + ("gc_frontiers",):
        _same(getattr(a, f), getattr(b, f), f)


# ---------------------------------------------- the loop's contract
def _pipe_topo(k):
    j = jtopo.Topology(
        clusters={"a": BFT1, "b": BFT1, "c": BFT1},
        links=(jtopo.LinkSpec("a->b", "a", "b"),
               jtopo.LinkSpec("b->c", "b", "c", upstream="a->b")),
        sim=JSimConfig(superchunk=k, **PIPE_SIM))
    return j


def test_commit_floor_boundaries_stay_synchronous():
    """A chained topology runs chunk at a time: K = 8 == K = 1 == the JAX
    package, floor histories included."""
    t1 = ttopo.run_topology(_port_topo(_pipe_topo(1)), device="cpu")
    t8 = ttopo.run_topology(_port_topo(_pipe_topo(8)), device="cpu")
    _assert_topology_equal(t8, t1)
    _assert_topology_equal(t8, jtopo.run_topology(_pipe_topo(8)))


def test_one_dispatch_per_chunk_covering_every_link(monkeypatch):
    """Each chunk costs exactly one dispatch, whose program runs every
    link as a lane, one host sync (its drain) and one ``plan_floors``
    span; two programs (the rotating chunk and the last one) on a cold
    program cache, and none when the same topology runs again."""
    lanes = []
    real = tsim._superchunk

    def counting(spec, fail, plan, state, *args, **kwargs):
        lanes.append(int(fail.crash_s.shape[0]))
        return real(spec, fail, plan, state, *args, **kwargs)

    monkeypatch.setattr(tsim, "_superchunk", counting)
    topo = _port_topo(jtopo.Topology.fanout(
        "p", ["b0", "b1", "b2"], BFT1, FIXTURES[0][1].sim))
    tgraphs.clear_programs()
    n_chunks = -(-topo.sim.steps // topo.sim.chunk_steps)
    for cold in (True, False):
        lanes.clear()
        before = (tsim.chunk_dispatch_count(), tsim.host_sync_count(),
                  tsim.chunk_trace_count())
        tr = SpanTracer()
        with tracing(tr):
            ttopo.run_topology(topo, device="cpu")
        dispatches, syncs, traces = (a - b for a, b in zip(
            (tsim.chunk_dispatch_count(), tsim.host_sync_count(),
             tsim.chunk_trace_count()), before))
        assert dispatches == n_chunks == len(lanes)
        assert set(lanes) == {len(topo.links)}
        assert syncs == n_chunks + 1               # the drains, the flush
        assert traces == (2 if cold else 0)
        assert tr.count("plan_floors") == n_chunks
        assert tr.count("run_topology") == tr.count("run") == 1


def test_topology_validation():
    with pytest.raises(ValueError, match="unknown cluster"):
        ttopo.Topology(clusters={"a": tcore.RSMConfig.bft(1)},
                       links=(ttopo.LinkSpec("x", "a", "b"),))
    with pytest.raises(ValueError, match="self-loop"):
        ttopo.Topology(clusters={"a": tcore.RSMConfig.bft(1)},
                       links=(ttopo.LinkSpec("x", "a", "a"),))
    two = {"a": tcore.RSMConfig.bft(1), "b": tcore.RSMConfig.bft(1)}
    with pytest.raises(ValueError, match="cycle"):
        ttopo.Topology(clusters=two,
                       links=(ttopo.LinkSpec("x", "a", "b", upstream="y"),
                              ttopo.LinkSpec("y", "b", "a",
                                             upstream="x")))
    with pytest.raises(ValueError, match="share"):
        ttopo.Topology(clusters=dict(two, c=tcore.RSMConfig.cft(1)),
                       links=(ttopo.LinkSpec("x", "a", "b"),
                              ttopo.LinkSpec("y", "a", "c")))
    with pytest.raises(ValueError, match="duplicate"):
        ttopo.Topology(clusters=two, links=(ttopo.LinkSpec("x", "a", "b"),
                                            ttopo.LinkSpec("x", "b", "a")))
    with pytest.raises(ValueError, match="unknown upstream"):
        ttopo.Topology(clusters=two,
                       links=(ttopo.LinkSpec("x", "a", "b", upstream="z"),))
    with pytest.raises(ValueError, match="no links"):
        ttopo.Topology(clusters=two, links=())
    with pytest.raises(ValueError, match="at least one backup"):
        ttopo.Topology.fanout("p", [], tcore.RSMConfig.bft(1))
    with pytest.raises(ValueError, match="at least two"):
        ttopo.Topology.chain(["a"], tcore.RSMConfig.bft(1))


@pytest.mark.parametrize("name,topo", FIXTURES, ids=IDS)
def test_constructors_and_link_specs_match_jax(name, topo):
    """The port's graph and per-link specs == the JAX package's."""
    t = _port_topo(topo)
    assert t.link_names == topo.link_names
    assert [(l.src, l.dst, l.upstream) for l in t.links] == \
        [(l.src, l.dst, l.upstream) for l in topo.links]
    assert tengine._floor_plan(t) == jengine._floor_plan(topo)
    for ts, js in zip(ttopo.link_specs(t), jtopo.link_specs(topo)):
        assert ts == tsim.spec_from_arrays(tsim.spec_to_arrays(js))


def test_auto_window_forces_chunked_execution():
    """``window_slots="auto"`` clamps a small stream to dense for a
    single run, but a topology keeps chunk boundaries at W = M, with the
    JAX package's results."""
    j = jtopo.Topology.chain(
        ["a", "b", "c"], BFT1,
        dataclasses.replace(BY_NAME["chain_3c"].sim, window_slots="auto"))
    t = _port_topo(j)
    single = tsim.build_spec(t.clusters["a"], t.clusters["b"], t.sim)
    assert single.window_slots == 0
    specs = ttopo.link_specs(t)
    assert all(s.window_slots == s.m for s in specs)
    assert all(s.chunk_steps == t.sim.chunk_steps for s in specs)
    res = ttopo.run_topology(t, device="cpu")
    assert res["b->c"].delivered_prefix() == t.sim.n_msgs
    _assert_topology_equal(res, jtopo.run_topology(j))


def test_floor_planner_matches_jax():
    """``plan_floors`` / ``FloorPlanner`` (chain, history, seeded history)
    == the JAX package's on random retired prefixes."""
    rng = np.random.default_rng(3)
    rows = np.cumsum(rng.integers(0, 9, size=(6, 4)), axis=0)
    tp, jp = (mod.FloorPlanner.chain(4, 50) for mod in (tengine, jengine))
    for t, row in enumerate(rows):
        _same(tp(t, row), jp(t, row), t)
    _same(tp.stacked(), jp.stacked(), "history")
    assert tp.calls == jp.calls == len(rows)
    tp.seed_history(rows[:3])
    jp.seed_history(rows[:3])
    _same(tp.stacked(), jp.stacked(), "seeded")
    plan = {0: 2, 3: 1}
    _same(tengine.plan_floors(plan, 4, 50, rows[-1]),
          jengine.plan_floors(plan, 4, 50, rows[-1]), "plan")


# --------------------------------------------------- the metrics fabric
def test_topology_chain_metrics_exact():
    """Chained topology with metrics: each link's histogram == the numpy
    histogram of its latency array, on == off, and the latency arrays ==
    the port's mirror's and the JAX package's; every ``ObsMetrics`` field
    == the JAX package's."""
    sim = JSimConfig(n_msgs=96, steps=96 // 4 + 60, window=1, phi=6,
                     window_slots=24, chunk_steps=8)
    on = dataclasses.replace(sim, collect_metrics=True)
    j_on, j_off = (jtopo.Topology.chain(["a", "b", "c"], BFT1, s)
                   for s in (on, sim))
    jon = jtopo.run_topology(j_on)
    r_on = ttopo.run_topology(_port_topo(j_on), device="cpu")
    r_off = ttopo.run_topology(_port_topo(j_off), device="cpu")
    ref = ttopo.run_topology_reference(_port_topo(j_off))
    _assert_topology_equal(r_on, r_off)
    _assert_topology_equal(r_on, jon)
    _assert_topology_equal(r_on, ref, engine=False)
    for name in ("a->b", "b->c"):
        a = r_on[name].result
        _same(a.obs.latency_hist, latency_histogram_np(a.delivery_latency),
              name)
        assert a.obs.uncounted == 0
        _assert_obs_equal(a.obs, jon[name].result.obs, name)


@pytest.mark.parametrize("name,m,fails,mirror", MIGRATING,
                         ids=[m[0] for m in MIGRATING])
def test_chained_growth_and_dense_migration_with_metrics(name, m, fails,
                                                         mirror,
                                                         monkeypatch):
    """A chained topology that grows and migrates to the dense layout with
    metrics on == the JAX package in every output, ``send_step``,
    ``delivery_latency`` and ``ObsMetrics`` field, and the migrated
    metrics carry == the JAX package's: its retired send rounds come from
    the per-lane, floor-aware dispatch mirror, not the schedule."""
    migrated = {}

    def capture(module, key):
        real = module.migrate_dense_metrics

        def wrapped(*args, **kwargs):
            out = real(*args, **kwargs)
            migrated[key] = np.asarray(out.send_time)
            return out
        monkeypatch.setattr(module, "migrate_dense_metrics", wrapped)

    capture(jsim, "jax")
    capture(tsim, "port")
    sim = JSimConfig(n_msgs=m, steps=240, window=1, phi=6,
                     window_slots=32, chunk_steps=8, collect_metrics=True)
    j = jtopo.Topology.chain(["a", "b", "c"], BFT1, sim, failures=fails)
    jres = jtopo.run_topology(j)
    tres = ttopo.run_topology(_port_topo(j), device="cpu")
    chained = tres["b->c"].result
    migration = [e for e in chained.window_growth_events
                 if e.dense_migration]
    assert len(migration) == 1
    # the chained link had retired messages whose floor delayed them
    base = int(chained.gc_frontiers[(migration[0].step + 1) // 8 - 1])
    ostep = np.asarray(ttopo.link_specs(_port_topo(j))[1].orig_step)
    assert (chained.send_step[:base] > ostep[:base]).any()
    _same(migrated["port"], migrated["jax"], "migrated send_time")
    _assert_topology_equal(tres, jres)
    for lname in j.link_names:
        t, jr = tres[lname].result, jres[lname].result
        _assert_obs_equal(t.obs, jr.obs, lname)
        _same(t.obs.latency_hist, latency_histogram_np(t.delivery_latency),
              lname)
    if mirror:
        ref = ttopo.run_topology_reference(_port_topo(j))
        _assert_topology_equal(tres, ref, engine=False)


def test_reported_topology_spans_and_report():
    """``run_reported_topology``: one report lane per link named by link,
    the topology, floor and run spans, and a report that validates."""
    j = jtopo.Topology.chain(["a", "b", "c"], BFT1, JSimConfig(
        n_msgs=64, steps=120, window=1, phi=6, window_slots=16,
        chunk_steps=8))
    tres, report = run_reported_topology(_port_topo(j), device="cpu")
    names = {e["name"] for e in report.chrome_trace["traceEvents"]}
    assert {"run_topology", "plan_floors", "run"} <= names
    assert report.lane_names == ["a->b", "b->c"]
    assert report.meta["links"] == ["a->b", "b->c"]
    assert report.meta["chunk_dispatches"] == -(-120 // 8)
    assert report.meta["device"] == "cpu"
    assert report.validate() == []
    jres = jtopo.run_topology(dataclasses.replace(
        j, sim=dataclasses.replace(j.sim, collect_metrics=True)))
    _assert_topology_equal(tres, jres)
    for lname in ("a->b", "b->c"):
        _assert_obs_equal(report.obs[lname], jres[lname].result.obs, lname)


# --------------------------------------------- what the port refuses
@pytest.mark.parametrize("arg", ["recorder", "resume", "fail_schedule"])
def test_unported_arguments_raise(arg):
    """``recorder`` / ``resume`` / ``fail_schedule`` are ported with
    ``repro_torch.replay``: they no longer raise ``NotImplementedError``
    but reach the windowed loop, which raises on an object that is not
    one, and with a real one the topology run == the JAX package's."""
    import repro.replay as jrep
    import repro_torch.replay as trep
    jtopology = BY_NAME["pair_clean"]
    topo = _port_topo(jtopology)
    with pytest.raises((AttributeError, TypeError)):
        ttopo.run_topology(topo, device="cpu", **{arg: object()})
    if arg == "recorder":
        rec = trep.TraceRecorder(topo.sim.chunk_steps)
        jrec = jrep.TraceRecorder(jtopology.sim.chunk_steps)
        got = ttopo.run_topology(topo, device="cpu", recorder=rec)
        want = jtopo.run_topology(jtopology, recorder=jrec)
        assert [c.t for c in rec.checkpoints] == \
            [c.t for c in jrec.checkpoints]
        for c, jc in zip(rec.checkpoints, jrec.checkpoints):
            for f in c.state._fields:
                _same(getattr(c.state, f), getattr(jc.state, f), f)
    elif arg == "resume":
        _, trace = trep.record_topology(topo, device="cpu")
        _, jtrace = jrep.record_topology(jtopology)
        ckpt = trace.checkpoints[2]
        got = ttopo.run_topology(topo, device="cpu", resume=ckpt)
        want = jtopo.run_topology(jtopology,
                                  resume=jtrace.checkpoints[2])
    else:
        cut = ttopo.link_specs(_port_topo(dataclasses.replace(
            jtopology, links=tuple(dataclasses.replace(
                l, failures=dataclasses.replace(
                    l.failures, crash_s=(16,) * 4))
                for l in jtopology.links))))
        jcut = jtopo.link_specs(dataclasses.replace(
            jtopology, links=tuple(dataclasses.replace(
                l, failures=dataclasses.replace(
                    l.failures, crash_s=(16,) * 4))
                for l in jtopology.links)))
        got = ttopo.run_topology(topo, device="cpu",
                                 fail_schedule=lambda t: cut if t == 16
                                 else None)
        want = jtopo.run_topology(jtopology,
                                  fail_schedule=lambda t: jcut if t == 16
                                  else None)
    _assert_topology_equal(got, want)


def test_topology_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    topo = _port_topo(BY_NAME["pair_clean"])
    with pytest.raises(RuntimeError, match="CUDA"):
        ttopo.run_topology(topo)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_reported_topology(topo)
    # the numpy mirror takes no device
    assert ttopo.run_topology_reference(topo)["a->b"].delivered_prefix() \
        == topo.sim.n_msgs
