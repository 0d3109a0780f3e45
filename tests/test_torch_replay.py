"""The torch port's replay subsystem vs the JAX package, bit for bit.

Every test of ``tests/test_replay.py`` runs here on the port
(``repro_torch.replay``, ``device="cpu"``) and on ``repro.replay`` with
the same specs (one plan, built by the JAX package and carried into the
port with ``spec_from_arrays``). Outputs, round metrics, frontiers,
final widths, growth events, every ``RunTrace`` checkpoint field (dtypes
compared: the state is int32/bool, the stakes and thresholds float32
bit for bit) and ``WhatIfReport.rows()`` must be equal, and the port's
own contract holds besides: an unchanged replay equals the original, an
injected one the merged schedule's from-scratch run and the port's numpy
oracle. Also here: the two replay tests of ``tests/test_pipeline.py``;
traces written by one package resuming in the other; the program cache's
warm contract (three identical runs move the trace and first-use
counters +N, +0, +0, as ``repro``'s do); and the cache key, which must
keep apart two specs that differ only in a value a program reads as a
Python number. ``tests/test_torch_gpu.py`` runs replays on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.apps as japps
import repro.core.simulator as jsim
import repro.replay as jrep
import repro_torch.apps as tapps
import repro_torch.core as tcore
import repro_torch.core.graphs as tgraphs
import repro_torch.core.simulator as tsim
import repro_torch.replay as trep
from repro.core import FailureScenario as JFailureScenario
from repro.core import RSMConfig as JRSMConfig
from repro.core import SimConfig as JSimConfig
from repro.topology import Topology as JTopology
from repro_torch.replay.whatif import _reattribute_events
from test_replay import (CRASH_S0, DROP_R0, GC_STALL, METRICS, OUTPUTS, SIM,
                         TOPO_SIM)
from test_torch_topology import _port_topo
from test_torch_windowed import _port_spec


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: torch's intra-op threads only cost, and under a
    parallel test run they compete with the other workers'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


BFT1 = JRSMConfig.bft(1)
TBFT1 = tcore.RSMConfig.bft(1)
CPU = dict(device="cpu")
CHECKPOINT_ARRAYS = ("bases", "floors", "bases_hist", "out_quack",
                     "out_deliver", "out_retry", "out_recv", "send_step")


# ------------------------------------------------------------ helpers
def _port(cls, obj):
    return None if obj is None else cls(**dataclasses.asdict(obj))


def _tinj(inj):
    """A JAX package ``Injection`` in the port's types."""
    return trep.Injection(
        at_step=inj.at_step,
        failures=_port(tcore.FailureScenario, inj.failures),
        stakes_s=inj.stakes_s, stakes_r=inj.stakes_r,
        quack_thresh=inj.quack_thresh, dup_thresh=inj.dup_thresh,
        hq_thresh=inj.hq_thresh)


def _tinjs(injs):
    """An injection set (a sequence, or a mapping of lanes) in the port's
    types."""
    if injs is None:
        return None
    if isinstance(injs, dict):
        return {k: [_tinj(e) for e in v] for k, v in injs.items()}
    return [_tinj(e) for e in injs]


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.array_equal(a, b), what


def _events(res):
    return [dataclasses.asdict(e) for e in res.window_growth_events]


def _assert_results_equal(a, b, frontiers=True, metrics=True):
    """``tests/test_replay.py``'s comparison, within one package."""
    for out in OUTPUTS:
        assert np.array_equal(getattr(a, out), getattr(b, out)), out
    if frontiers:
        assert np.array_equal(a.gc_frontiers, b.gc_frontiers)
    if metrics:
        for name in METRICS:
            assert np.array_equal(np.asarray(getattr(a.metrics, name)),
                                  np.asarray(getattr(b.metrics, name))), name


def _assert_matches_oracle(res, ref, frontiers=True):
    for out in OUTPUTS:
        assert np.array_equal(getattr(res, out), getattr(ref, out)), out
    if frontiers:
        assert np.array_equal(res.gc_frontiers, ref.gc_frontiers)
    assert np.array_equal(np.asarray(res.metrics.resends), ref.resends)
    assert np.array_equal(np.asarray(res.metrics.cross_msgs),
                          ref.cross_msgs)


def _assert_port_equals_jax(tr, jr, frontiers=True):
    """The port's result == the JAX package's: outputs, latency arrays
    and round metrics with dtypes, and (``frontiers``) the window."""
    for f in OUTPUTS + ("send_step", "delivery_latency"):
        _same(getattr(tr, f), getattr(jr, f), f)
    for f in METRICS:
        _same(getattr(tr.metrics, f), getattr(jr.metrics, f), f)
    if frontiers:
        _same(tr.gc_frontiers, jr.gc_frontiers, "gc_frontiers")
        assert tr.final_window_slots == jr.final_window_slots
        assert _events(tr) == _events(jr)


def _assert_checkpoints_equal(ct, cj):
    """One checkpoint of each package, field by field."""
    assert (ct.t, ct.window_slots) == (cj.t, cj.window_slots)
    for name in CHECKPOINT_ARRAYS:
        _same(getattr(ct, name), getattr(cj, name), name)
    for f in ct.state._fields:
        _same(getattr(ct.state, f), getattr(cj.state, f), f"state.{f}")
    for f in ct.fails._fields:
        _same(getattr(ct.fails, f), getattr(cj.fails, f), f"fails.{f}")
    mt, mj = ct.metrics(), cj.metrics()
    for f in METRICS:
        _same(getattr(mt, f), getattr(mj, f), f"metrics.{f}")
    assert ([dataclasses.asdict(e) for e in ct.growth_events]
            == [dataclasses.asdict(e) for e in cj.growth_events])


def _assert_traces_equal(tt, jt):
    assert tt.kind == jt.kind and tt.lane_names == jt.lane_names
    assert tt.floor_plan == jt.floor_plan
    assert [dataclasses.asdict(s) for s in tt.specs] == \
        [dataclasses.asdict(s) for s in jt.specs]
    assert len(tt.checkpoints) == len(jt.checkpoints)
    for ct, cj in zip(tt.checkpoints, jt.checkpoints):
        _assert_checkpoints_equal(ct, cj)


def _record(jspec, every=1):
    """Record one spec in both packages: (port, JAX) pairs of (result,
    trace)."""
    tres, ttrace = trep.record_simulation(_port_spec(jspec), every=every,
                                          **CPU)
    jres, jtrace = jrep.record_simulation(jspec, every=every)
    _assert_port_equals_jax(tres, jres)
    _assert_traces_equal(ttrace, jtrace)
    return (tres, ttrace), (jres, jtrace)


def _replay_both(ttrace, jtrace, t, injections=None, frontiers=True):
    """Replay both packages' traces from ``t``; the port's lanes, each
    held to the JAX package's."""
    tr = trep.replay(ttrace, t, _tinjs(injections), **CPU)
    jr = jrep.replay(jtrace, t, injections)
    for a, b in zip(tr, jr):
        _assert_port_equals_jax(a, b, frontiers)
    return tr


def _spec(sim=SIM, fails=JFailureScenario.none()):
    return jsim.build_spec(BFT1, BFT1, sim, fails)


# --- checkpointing + unchanged replay ------------------------------------
def test_unchanged_replay_bit_identical_from_every_checkpoint():
    jspec = _spec(fails=CRASH_S0)
    (res, trace), (_, jtrace) = _record(jspec)
    _assert_results_equal(res, tsim.run_simulation(_port_spec(jspec),
                                                   **CPU))
    assert len(trace.checkpoints) == (SIM.steps - 1) // SIM.chunk_steps + 1
    for t in trace.boundaries().tolist():
        rr = _replay_both(trace, jtrace, t)[0]
        _assert_results_equal(rr, res)
        assert rr.final_window_slots == res.final_window_slots
    ref = trep.replay_oracle(trace)
    _assert_matches_oracle(res, ref)
    jref = jrep.replay_oracle(jtrace)
    for out in OUTPUTS:
        _same(getattr(ref, out), getattr(jref, out), out)


def test_thinned_recording_and_missing_checkpoint():
    (res, trace), (_, jtrace) = _record(_spec(), every=2)
    bounds = trace.boundaries()
    assert np.array_equal(bounds % (2 * SIM.chunk_steps),
                          np.zeros_like(bounds))
    _assert_results_equal(_replay_both(trace, jtrace, int(bounds[-1]))[0],
                          res)
    with pytest.raises(KeyError, match="no checkpoint at round 8"):
        trace.checkpoint_at(8)
    assert trace.last_checkpoint_before(23).t == 16


def test_trace_save_load_roundtrip(tmp_path):
    (res, trace), (_, jtrace) = _record(_spec(fails=DROP_R0))
    path = str(tmp_path / "trace.npz")
    trace.save(path)
    loaded = trep.RunTrace.load(path)
    assert loaded.specs == trace.specs
    assert loaded.lane_names == trace.lane_names
    assert np.array_equal(loaded.boundaries(), trace.boundaries())
    for c0, c1 in zip(trace.checkpoints, loaded.checkpoints):
        _assert_checkpoints_equal(c1, c0)
    _assert_traces_equal(loaded, jtrace)
    _assert_results_equal(trep.replay(loaded, 16, **CPU)[0], res)


# --- injection ------------------------------------------------------------
@pytest.mark.parametrize("at_step,edit", [
    (16, CRASH_S0),
    (16, JFailureScenario(crash_r=(16, -1, -1, -1))),
    (16, JFailureScenario(byz_recv_drop=(True, False, False, False))),
], ids=["crash_sender", "crash_receiver", "open_partition"])
def test_injected_replay_equals_merged_schedule(at_step, edit):
    (res, trace), (_, jtrace) = _record(_spec())
    inj = [jrep.Injection(at_step, edit)]
    ri = _replay_both(trace, jtrace, at_step, inj)[0]
    scratch = _replay_both(trace, jtrace, 0, inj)[0]
    _assert_results_equal(ri, scratch)
    _assert_matches_oracle(ri, trep.replay_oracle(trace, _tinjs(inj)))
    assert any(not np.array_equal(getattr(ri, out), getattr(res, out))
               for out in OUTPUTS)


def test_heal_injection():
    sim = dataclasses.replace(SIM, steps=200)
    (res, trace), (_, jtrace) = _record(_spec(sim, DROP_R0))
    heal = [jrep.Injection(16, JFailureScenario.none())]
    ri = _replay_both(trace, jtrace, 16, heal)[0]
    _assert_matches_oracle(ri, trep.replay_oracle(trace, _tinjs(heal)))
    assert not np.array_equal(ri.deliver_time, res.deliver_time)
    assert np.sum(ri.metrics.resends) < np.sum(res.metrics.resends)


def test_injection_validation():
    (_, trace), _ = _record(_spec())
    crash = _port(tcore.FailureScenario, CRASH_S0)
    with pytest.raises(ValueError, match="not a chunk boundary"):
        trep.replay(trace, 16, [trep.Injection(19, crash)], **CPU)
    with pytest.raises(ValueError, match="outside the replayed range"):
        trep.replay(trace, 16, [trep.Injection(8, crash)], **CPU)
    with pytest.raises(ValueError, match="replicas"):
        trep.replay(trace, 16, [trep.Injection(
            16, tcore.FailureScenario(crash_s=(1, -1)))], **CPU)
    with pytest.raises(KeyError, match="unknown lane"):
        trep.replay(trace, 16, {"nope": [trep.Injection(16, crash)]},
                    **CPU)
    with pytest.raises(KeyError, match="no checkpoint"):
        trep.replay(trace, 13, **CPU)
    # a schedule whose specs differ outside the per-lane inputs is
    # another program: the loop refuses it
    other = dataclasses.replace(trace.specs[0], phi=trace.specs[0].phi + 1)
    with pytest.raises(ValueError, match="fail_schedule must return"):
        tsim._run_windowed_batch(trace.specs, torch.device("cpu"),
                                 fail_schedule=lambda t: [other])


def test_scenario_batch_replay():
    jspecs = [_spec(fails=f) for f in (JFailureScenario.none(), DROP_R0)]
    results, trace = trep.record_batch([_port_spec(s) for s in jspecs],
                                       **CPU)
    jresults, jtrace = jrep.record_batch(jspecs)
    _assert_traces_equal(trace, jtrace)
    for a, b in zip(results, jresults):
        _assert_port_equals_jax(a, b)
    for t in (0, 16, 48):
        for r0, r1 in zip(results, _replay_both(trace, jtrace, t)):
            _assert_results_equal(r0, r1)
    ri = _replay_both(trace, jtrace, 16,
                      {1: [jrep.Injection(16, JFailureScenario.none())]})
    _assert_results_equal(ri[0], results[0])
    assert not np.array_equal(ri[1].deliver_time, results[1].deliver_time)


# --- adaptive growth / dense fallback across the replay boundary ----------
def test_replay_across_dense_fallback_boundary():
    sim = JSimConfig(n_msgs=64, steps=200, window=1, phi=6,
                     window_slots=16, chunk_steps=8)
    jspec = _spec(sim, GC_STALL)
    (res, trace), (_, jtrace) = _record(jspec)
    assert res.final_window_slots == jspec.m
    migration = [e for e in res.window_growth_events if e.dense_migration]
    assert migration
    mig_chunk = (migration[0].step // sim.chunk_steps) * sim.chunk_steps
    windowed_bounds = [int(c.t) for c in trace.checkpoints
                       if c.window_slots < jspec.m]
    assert windowed_bounds and windowed_bounds[-1] <= mig_chunk
    for t in windowed_bounds:
        rr = _replay_both(trace, jtrace, t)[0]
        _assert_results_equal(rr, res)
        assert rr.final_window_slots == jspec.m
        assert [e for e in rr.window_growth_events if e.dense_migration]
    dense_bounds = [int(c.t) for c in trace.checkpoints
                    if c.window_slots == jspec.m]
    assert dense_bounds
    _assert_results_equal(_replay_both(trace, jtrace, dense_bounds[0])[0],
                          res)
    _assert_matches_oracle(res, trep.replay_oracle(trace))


def test_replay_across_adaptive_growth_boundary():
    sim = JSimConfig(n_msgs=128, steps=128 // 4 + 80, window=1, phi=6,
                     window_slots=16, chunk_steps=8)
    stall = JFailureScenario(byz_bcast_partial=(True, False, False, False),
                             bcast_limit=2)
    jspec = _spec(sim, stall)
    (res, trace), (_, jtrace) = _record(jspec)
    assert jspec.window_slots < res.final_window_slots < jspec.m
    assert res.window_growth_events
    assert all(not e.dense_migration for e in res.window_growth_events)
    first_grow = res.window_growth_events[0]
    assert first_grow.scenario == 0 and first_grow.old_w == 16
    narrow = [int(c.t) for c in trace.checkpoints
              if c.window_slots == jspec.window_slots]
    for t in (narrow[0], narrow[-1]):
        rr = _replay_both(trace, jtrace, t)[0]
        _assert_results_equal(rr, res)
        assert rr.final_window_slots == res.final_window_slots
        assert rr.window_growth_events == res.window_growth_events


# --- topology replay ------------------------------------------------------
def _chain_topos():
    jtopo = JTopology.chain(["a", "b", "c"], BFT1, TOPO_SIM)
    return _port_topo(jtopo), jtopo


def _record_topology():
    topo, jtopo = _chain_topos()
    r0, trace = trep.record_topology(topo, **CPU)
    j0, jtrace = jrep.record_topology(jtopo)
    _assert_traces_equal(trace, jtrace)
    for name in trace.lane_names:
        _assert_port_equals_jax(r0[name].result, j0[name].result)
        _same(r0[name].commit_floors, j0[name].commit_floors, name)
    return (r0, trace), (j0, jtrace)


def _assert_topologies_equal(tres, jres, names):
    for name in names:
        _assert_port_equals_jax(tres[name].result, jres[name].result)
        _same(tres[name].commit_floors, jres[name].commit_floors, name)


def test_topology_unchanged_replay_bit_identical():
    (r0, trace), (_, jtrace) = _record_topology()
    assert trace.floor_plan == {1: 0}
    for t in (0, 24, 64):
        rr = trep.replay_topology(trace, t, **CPU)
        _assert_topologies_equal(rr, jrep.replay_topology(jtrace, t),
                                 trace.lane_names)
        for name in trace.lane_names:
            _assert_results_equal(rr[name].result, r0[name].result)
            assert np.array_equal(rr[name].commit_floors,
                                  r0[name].commit_floors)
    ref = trep.replay_topology_oracle(trace)
    for name in trace.lane_names:
        _assert_matches_oracle(r0[name].result, ref[name].result)
        assert np.array_equal(r0[name].commit_floors,
                              ref[name].commit_floors)


def test_topology_injected_replay_matches_oracle():
    (r0, trace), (_, jtrace) = _record_topology()
    inj = {"a->b": [jrep.Injection(16, JFailureScenario(crash_s=(16,) * 4))]}
    ri = trep.replay_topology(trace, 16, _tinjs(inj), **CPU)
    _assert_topologies_equal(ri, jrep.replay_topology(jtrace, 16, inj),
                             trace.lane_names)
    ref = trep.replay_topology_oracle(trace, _tinjs(inj))
    for name in trace.lane_names:
        _assert_matches_oracle(ri[name].result, ref[name].result)
        assert np.array_equal(ri[name].commit_floors,
                              ref[name].commit_floors)
    assert ri["b->c"].delivered_prefix() < r0["b->c"].delivered_prefix()


def test_topology_trace_save_load(tmp_path):
    (r0, trace), _ = _record_topology()
    path = str(tmp_path / "topo.npz")
    trace.save(path)
    loaded = trep.RunTrace.load(path)
    assert loaded.kind == "topology"
    assert loaded.topology == trace.topology
    rr = trep.replay_topology(loaded, 24, **CPU)
    for name in trace.lane_names:
        _assert_results_equal(rr[name].result, r0[name].result)


# --- forked what-if -------------------------------------------------------
def _assert_reports_equal(trpt, jrpt):
    assert trpt.rows() == jrpt.rows()
    assert trpt.baseline == jrpt.baseline
    assert trpt.lane_names == jrpt.lane_names
    for tf, jf in zip(trpt.forks, jrpt.forks):
        assert tf.name == jf.name and tf.divergence == jf.divergence
        for a, b in zip(tf.results, jf.results):
            _assert_port_equals_jax(a, b, frontiers=False)
            assert _events(a) == _events(b)


def _fork_both(trace, jtrace, at, jforks):
    tforks = [trep.ForkSpec(f.name, _tinjs(f.injections) or ())
              for f in jforks]
    report = trep.fork_whatif(trace, at, tforks, **CPU)
    _assert_reports_equal(report, jrep.fork_whatif(jtrace, at, jforks))
    return report


def test_fork_whatif_matches_individual_replays():
    (res, trace), (_, jtrace) = _record(_spec())
    variants = [
        jrep.ForkSpec("baseline"),
        jrep.ForkSpec("crash-16", [jrep.Injection(16, CRASH_S0)]),
        jrep.ForkSpec("crash-32", [jrep.Injection(
            32, JFailureScenario(crash_s=(32, -1, -1, -1)))]),
        jrep.ForkSpec("partition", [jrep.Injection(16, DROP_R0)]),
    ]
    report = _fork_both(trace, jtrace, 16, variants)
    assert report.lane_names == ["lane0"]
    for fs in variants:
        solo = trep.replay(trace, 16, _tinjs(fs.injections), **CPU)[0]
        _assert_results_equal(report[fs.name].results[0], solo,
                              frontiers=False)
    _assert_results_equal(report["baseline"].results[0], res,
                          frontiers=False)
    assert report["baseline"].divergence["lane0"]["delivered"] == 0
    base_stats = report["baseline"].stats["lane0"]
    crash = report["crash-16"].stats["lane0"]
    assert crash["resends"] > base_stats["resends"]
    assert crash["delivery_step"] > base_stats["delivery_step"]
    assert report["crash-16"].divergence["lane0"]["resends"] > 0
    assert (report["partition"].stats["lane0"]["resends"]
            > base_stats["resends"])
    rows = report.rows()
    assert len(rows) == 4 and {r["fork"] for r in rows} == {
        "baseline", "crash-16", "crash-32", "partition"}


def test_fork_whatif_reuses_compiled_chunk():
    """A cold fork batch captures at most the rotating and the final
    chunk program of its lane count; a second fork set of the same shape
    and a replay capture nothing, here as in ``repro``."""
    (_, trace), (_, jtrace) = _record(_spec())
    variants = [jrep.ForkSpec("a"),
                jrep.ForkSpec("b", [jrep.Injection(16, CRASH_S0)]),
                jrep.ForkSpec("c", [jrep.Injection(24, DROP_R0)])]
    first = _fork_both(trace, jtrace, 16, variants)
    assert first.chunk_traces <= 2
    again = _fork_both(trace, jtrace, 24, [
        jrep.ForkSpec("x", [jrep.Injection(24, CRASH_S0)]),
        jrep.ForkSpec("y"),
        jrep.ForkSpec("z", [jrep.Injection(32, DROP_R0)])])
    assert again.chunk_traces == 0
    before = tsim.chunk_trace_count()
    trep.replay(trace, 16, _tinjs([jrep.Injection(16, CRASH_S0)]), **CPU)
    assert tsim.chunk_trace_count() == before


def test_fork_whatif_topology():
    (r0, trace), (_, jtrace) = _record_topology()
    inj = {"a->b": [jrep.Injection(16, JFailureScenario(crash_s=(16,) * 4))]}
    report = _fork_both(trace, jtrace, 16, [
        jrep.ForkSpec("baseline"), jrep.ForkSpec("upstream-crash", inj)])
    for name in trace.lane_names:
        _assert_results_equal(report["baseline"][name], r0[name].result,
                              frontiers=False)
    solo = trep.replay_topology(trace, 16, _tinjs(inj), **CPU)
    for name in trace.lane_names:
        _assert_results_equal(report["upstream-crash"][name],
                              solo[name].result, frontiers=False)
    assert report["upstream-crash"].divergence["b->c"]["delivered"] < 0


def test_fork_whatif_on_loaded_trace_has_baseline(tmp_path):
    (_, trace), (_, jtrace) = _record(_spec())
    path = str(tmp_path / "t.npz")
    trace.save(path)
    loaded = trep.RunTrace.load(path)
    assert loaded.results is None
    jforks = [jrep.ForkSpec("baseline"),
              jrep.ForkSpec("crash", [jrep.Injection(16, CRASH_S0)])]
    report = _fork_both(loaded, jtrace, 16, jforks)
    assert report.baseline == {"lane0": dict(
        report["baseline"].stats["lane0"])}
    assert report["crash"].divergence["lane0"]["resends"] > 0
    in_memory = _fork_both(trace, jtrace, 16, jforks)
    assert report.baseline == in_memory.baseline
    assert (report["crash"].divergence["lane0"]
            == in_memory["crash"].divergence["lane0"])


def test_fork_growth_event_reattribution():
    pre = tsim.WindowGrowthEvent(step=7, scenario=1, need=31, old_w=16,
                                 new_w=32)
    post = tsim.WindowGrowthEvent(step=40, scenario=5, need=90, old_w=32,
                                  new_w=64)
    out = _reattribute_events((pre, post), n_b=2, from_step=16)
    assert out[0] == pre and out[0].fork is None
    assert out[1].fork == 2 and out[1].scenario == 1
    assert (out[1].step, out[1].old_w, out[1].new_w) == (40, 32, 64)


def test_fork_rejects_duplicates_and_empty():
    (_, trace), _ = _record(_spec())
    with pytest.raises(ValueError, match="at least one"):
        trep.fork_whatif(trace, 16, [], **CPU)
    with pytest.raises(ValueError, match="duplicate fork names"):
        trep.fork_whatif(trace, 16, [trep.ForkSpec("a"),
                                     trep.ForkSpec("a")], **CPU)


# --- disaster recovery as an injected event -------------------------------
def test_disaster_recovery_injected_equals_static():
    jsim_cfg = JSimConfig(n_msgs=96, steps=60, window=1, phi=6,
                          window_slots=24, chunk_steps=8)
    sim = _port(tcore.SimConfig, jsim_cfg)
    jkw = dict(crash_at=12, backup_failures={
        "backup-1": JFailureScenario(byz_recv_drop=(True, True, False,
                                                    False))})
    kw = dict(crash_at=12, backup_failures={
        k: _port(tcore.FailureScenario, v)
        for k, v in jkw["backup_failures"].items()})
    static = tapps.run_disaster_recovery(TBFT1, TBFT1, sim, **kw, **CPU)
    injected = tapps.run_disaster_recovery(TBFT1, TBFT1, sim, **kw,
                                           inject_via_replay=True, **CPU)
    oracle = tapps.run_disaster_recovery(TBFT1, TBFT1, sim, **kw,
                                         inject_via_replay=True,
                                         use_reference=True)
    jinjected = japps.run_disaster_recovery(BFT1, BFT1, jsim_cfg, **jkw,
                                            inject_via_replay=True)
    for r in (injected, oracle, jinjected):
        assert r.elected == static.elected
        assert r.phase1_prefixes == static.phase1_prefixes
        assert r.final_prefixes == static.final_prefixes
        assert r.converged == static.converged
        assert np.array_equal(r.recovered_log, static.recovered_log)
    assert injected.injected_at == jinjected.injected_at == 8
    assert injected.phase1_trace is not None and oracle.phase1_trace is None
    _assert_traces_equal(injected.phase1_trace, jinjected.phase1_trace)
    _assert_topologies_equal(injected.phase1, jinjected.phase1,
                             list(injected.phase1.links))
    assert static.phase1_prefixes[static.elected] < sim.n_msgs


def test_growth_event_observability_in_batch():
    sim = JSimConfig(n_msgs=128, steps=128 // 4 + 80, window=1, phi=6,
                     window_slots=16, chunk_steps=8)
    stall = JFailureScenario(byz_bcast_partial=(True, False, False, False),
                             bcast_limit=2)
    jspecs = [_spec(sim, f) for f in (JFailureScenario.none(), stall)]
    batched = tsim.run_simulation_batch([_port_spec(s) for s in jspecs],
                                        **CPU)
    for a, b in zip(batched, jsim.run_simulation_batch(jspecs)):
        _assert_port_equals_jax(a, b)
    events = batched[0].window_growth_events
    assert events and events == batched[1].window_growth_events
    assert len(events) >= 2
    assert all(e.scenario == 1 for e in events[1:])
    assert all(e.new_w == 2 * e.old_w for e in events)
    assert [e.old_w for e in events] == [16 * 2 ** i
                                         for i in range(len(events))]
    assert all(0 <= e.step < sim.steps for e in events)
    assert all(not e.dense_migration for e in events)
    roomy = dataclasses.replace(sim, n_msgs=256, steps=256 // 4 + 80,
                                window_slots=160)
    clean = tsim.run_simulation(_port_spec(_spec(roomy)), **CPU)
    assert clean.window_growth_events == ()
    assert clean.gc_frontiers[-1] == 256


# --- the two replay tests of tests/test_pipeline.py -----------------------
PIPE_SIM = dict(n_msgs=96, steps=120, window=1, phi=6, window_slots=24,
                chunk_steps=8)


def _pipe_spec(k, fails=JFailureScenario.none()):
    return jsim.build_spec(BFT1, BFT1, JSimConfig(debug_checks=True,
                                                  superchunk=k, **PIPE_SIM),
                           fails)


def test_recorder_boundaries_flush_pipeline():
    """A trace recorded at K = 8 with sparse checkpoints == the K = 1
    trace (and == the JAX package's); its replay reproduces the run and
    captures nothing: the recording ran every program the tail uses."""
    (r1, tr1), _ = _record(_pipe_spec(1), every=2)
    (r8, tr8), _ = _record(_pipe_spec(8), every=2)
    _assert_port_equals_jax(r1, r8)
    assert [c.t for c in tr1.checkpoints] == [c.t for c in tr8.checkpoints]
    for c1, c8 in zip(tr1.checkpoints, tr8.checkpoints):
        _assert_checkpoints_equal(c1, c8)
    mid = tr8.boundaries()[len(tr8.boundaries()) // 2]
    before = (tsim.chunk_trace_count(), tgraphs.first_use_count())
    replayed = trep.replay(tr8, int(mid), **CPU)[0]
    assert (tsim.chunk_trace_count(), tgraphs.first_use_count()) == before
    for out in OUTPUTS:
        assert np.array_equal(getattr(replayed, out), getattr(r8, out)), out


def test_fail_schedule_swap_breaks_fusion_exactly():
    """A mid-stream edit of a K = 8 trace == the from-scratch run of the
    merged schedule, in the port as in ``repro``."""
    crash = JFailureScenario(crash_s=(16, -1, -1, -1))
    jspec = _pipe_spec(8)
    (_, trace), (_, jtrace) = _record(jspec)
    edited = _replay_both(trace, jtrace, 16,
                          [jrep.Injection(at_step=16, failures=crash)])[0]
    scratch = tsim.run_simulation(tsim.spec_with_failures(
        _port_spec(jspec), _port(tcore.FailureScenario, crash)), **CPU)
    for out in OUTPUTS:
        assert np.array_equal(getattr(edited, out),
                              getattr(scratch, out)), out


def test_replay_with_metrics_matches_jax():
    """With ``collect_metrics`` a resume seeds the metrics carry from the
    checkpoint's dispatch mirror: the replayed tail's ``ObsMetrics``
    equal the JAX package's replay's, field by field, across a growth."""
    sim = JSimConfig(n_msgs=64, steps=200, window=1, phi=6,
                     window_slots=16, chunk_steps=8, collect_metrics=True)
    (_, trace), (_, jtrace) = _record(_spec(sim, GC_STALL))
    for t in (16, 64):
        tr = trep.replay(trace, t, **CPU)[0]
        jr = jrep.replay(jtrace, t)[0]
        _assert_port_equals_jax(tr, jr)
        for f in ("latency_hist", "occupancy_hwm", "gc_lag_hwm",
                  "quack_events", "loss_events", "resend_total",
                  "uncounted", "per_chunk_hist"):
            _same(getattr(tr.obs, f), getattr(jr.obs, f), f)


# --- traces across the packages ------------------------------------------
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_trace_resumes_in_the_other_package(writer, tmp_path):
    """A trace saved by one package loads and resumes in the other, bit
    for bit, the stakes (float32, re-weighted to non-integers) too."""
    jspec = jsim.spec_with_quorum(_spec(fails=DROP_R0),
                                  stakes_r=(1.5, 1.0, 1.0, 0.75),
                                  quack_thresh=2.25)
    (res, trace), (jres, jtrace) = _record(jspec)
    path = str(tmp_path / "trace.npz")
    (jtrace if writer == "jax" else trace).save(path)
    tload, jload = trep.RunTrace.load(path), jrep.RunTrace.load(path)
    _assert_traces_equal(tload, jload)
    _assert_traces_equal(tload, jtrace)
    assert tload.checkpoints[2].fails.stakes_r.dtype == np.float32
    for t in (16, 48):
        _assert_port_equals_jax(trep.replay(tload, t, **CPU)[0], jres)
        _assert_port_equals_jax(res, jrep.replay(jload, t)[0])


# --- the program cache ----------------------------------------------------
def _counters():
    return (tsim.chunk_trace_count(), tgraphs.first_use_count(),
            jsim.chunk_trace_count(),
            jsim._compiled_sim.cache_info().misses
            + jsim._compiled_batch.cache_info().misses)


@pytest.mark.parametrize("windowed", [True, False],
                         ids=["windowed", "dense"])
def test_three_identical_runs_capture_once(windowed):
    """Three identical runs move the port's trace and first-use counters
    +N, +0, +0, as ``repro``'s trace count (windowed) and compile cache
    (dense) move, and the runs stay equal to ``repro``'s."""
    sim = dict(n_msgs=80, steps=90, window=1, phi=5, seed=11)
    if windowed:
        sim.update(window_slots=24, chunk_steps=8, superchunk=4)
    jspec = _spec(JSimConfig(**sim), CRASH_S0)
    tgraphs.clear_programs()
    moved = []
    for _ in range(3):
        before = _counters()
        tr = tsim.run_simulation(_port_spec(jspec), **CPU)
        jr = jsim.run_simulation(jspec)
        moved.append(tuple(a - b for a, b in zip(_counters(), before)))
        _assert_port_equals_jax(tr, jr, frontiers=windowed)
    port_traces, port_uses, jax_traces, jax_compiles = zip(*moved)
    assert port_uses[0] > 0 and port_uses[1:] == (0, 0)
    if windowed:
        assert port_traces[0] == port_uses[0] > 0
        assert port_traces[1:] == (0, 0) and jax_traces[1:] == (0, 0)
    else:
        assert port_traces == (0, 0, 0) and jax_compiles[1:] == (0, 0)


@pytest.mark.parametrize("field,value", [("phi", 3), ("window", 2)])
def test_cache_key_keeps_apart_what_programs_read(field, value):
    """Two specs of equal shapes that differ only in a value the
    programs read as a Python number (``phi``), or only in the schedule
    (``window``: the dispatch rounds), run in one process one after the
    other: neither may replay the other's programs, and each equals
    ``repro``."""
    base = dict(n_msgs=96, steps=120, window=1, phi=6, window_slots=24,
                chunk_steps=8)
    specs = [_spec(JSimConfig(**base)),
             _spec(JSimConfig(**dict(base, **{field: value})))]
    tspecs = [_port_spec(s) for s in specs]
    assert tspecs[0].window_slots == tspecs[1].window_slots
    assert tsim._LayoutKey(tspecs[0]) != tsim._LayoutKey(tspecs[1])
    for spec, jspec in zip(tspecs, specs):
        before = tsim.chunk_trace_count()
        tr = tsim.run_simulation(spec, **CPU)
        _assert_port_equals_jax(tr, jsim.run_simulation(jspec))
    # the second spec is a layout of its own: it used programs of its own
    assert tsim.chunk_trace_count() > before
    # and running the first again is warm, and still equal
    before = tsim.chunk_trace_count()
    _assert_port_equals_jax(tsim.run_simulation(tspecs[0], **CPU),
                            jsim.run_simulation(specs[0]))
    assert tsim.chunk_trace_count() == before


def test_cache_is_bounded_and_clears():
    """The cache holds ``CACHE_SETS`` sets, evicting by count, and
    ``clear_programs`` empties it."""
    tgraphs.clear_programs()
    base = dict(n_msgs=64, window=1, phi=6, window_slots=16, chunk_steps=8)
    n = tgraphs.CACHE_SETS + 2
    for steps in range(40, 40 + n):
        tsim.run_simulation(_port_spec(_spec(JSimConfig(steps=steps,
                                                        **base))), **CPU)
    assert len(tgraphs._SETS) == tgraphs.CACHE_SETS
    tgraphs.clear_programs()
    assert not tgraphs._SETS
