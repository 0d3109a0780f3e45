"""The torch port's adversary palette vs the JAX package, bit for bit.

Every test of ``tests/test_adversary.py`` but the benchmark smoke runs
here: the
palette constructors build the same ``FailureScenario``s in both
packages; every adversary kind runs on the port's dense, windowed and
superchunk engines (``device="cpu"``) and must equal ``repro``'s engine
and the port's own numpy oracle (``core/refsim.py``) in every output,
round metric and frontier, and never retire an undelivered message
where the stake budget makes that provable (``adversary.safety``).
Mid-stream reconfigurations (remove / join a receiver, re-weight stakes,
switch an adversary on) replay bit-exactly against a from-scratch run,
the oracle and ``repro``'s replay, and capture no program once warm.
Each palette attack switched on mid-stream in a streaming session
(``repro_torch.stream``) breaches an SLO watchdog and recovers after the
heal, with ``repro``'s SLO events.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import repro.adversary as jadv
import repro.core as jcore
import repro.core.simulator as jsim
import repro.replay as jrep
import repro.stream as jstream
import repro.topology as jtopo
import repro_torch.adversary as tadv
import repro_torch.core as tcore
import repro_torch.core.refsim as trefsim
import repro_torch.core.simulator as tsim
import repro_torch.replay as trep
import repro_torch.stream as tstream
import repro_torch.topology as ttopo
from repro.core import FailureScenario as JFailureScenario
from repro.core import RSMConfig as JRSMConfig
from repro.core import SimConfig as JSimConfig
from test_adversary import ENGINE_PATHS, REPLAY_SIM, _sim
from test_torch_replay import _tinjs
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


BFT1 = JRSMConfig(n=4, u=1, r=1)
OUTPUTS = ("quack_time", "deliver_time", "retry", "recv_has")
METRICS = ("cross_msgs", "intra_msgs", "resends")
ALL_METRICS = METRICS + ("acks", "delivered", "min_quack_prefix")
CPU = dict(device="cpu")


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.array_equal(a, b), what


def _scenario(jsc):
    """A JAX package ``FailureScenario`` in the port's type."""
    return tcore.FailureScenario(**dataclasses.asdict(jsc))


def _same_scenario(tsc, jsc):
    assert dataclasses.asdict(tsc) == dataclasses.asdict(jsc)


def _assert_engine_matches_oracle(jspec, ctx: str):
    """The port's engine == the port's oracle (``test_adversary``'s
    check) and == the JAX package's engine, every output and metric."""
    spec = _port_spec(jspec)
    res = tsim.run_simulation(spec, **CPU)
    ref = trefsim.run_reference(spec)
    for f in OUTPUTS:
        assert np.array_equal(np.asarray(getattr(res, f)),
                              getattr(ref, f)), (ctx, f)
    for f in METRICS:
        assert np.array_equal(np.asarray(getattr(res.metrics, f)),
                              getattr(ref, f)), (ctx, f)
    if res.gc_frontiers is not None and ref.gc_frontiers is not None:
        assert np.array_equal(np.asarray(res.gc_frontiers),
                              ref.gc_frontiers), ctx
    jres = jsim.run_simulation(jspec)
    for f in OUTPUTS + ("send_step", "delivery_latency", "gc_frontiers"):
        _same(getattr(res, f), getattr(jres, f), (ctx, f))
    for f in ALL_METRICS:
        _same(getattr(res.metrics, f), getattr(jres.metrics, f), (ctx, f))
    assert res.final_window_slots == jres.final_window_slots, ctx
    return spec, res, ref


# --------------------------------------------------------------- palette
def test_palette_mask_validation():
    with pytest.raises(ValueError, match="out of range"):
        tadv.equivocators(4, (4,))
    with pytest.raises(ValueError, match="out of range"):
        tadv.stale_ackers(4, (-1,))
    with pytest.raises(ValueError, match="advance"):
        tadv.hq_liars(4, (0,), advance=0)
    with pytest.raises(ValueError, match="out of range"):
        tadv.selective_drops(4, 4, [(0, 5)])
    with pytest.raises(ValueError, match="side"):
        tadv.stake_attack((1.0,) * 4, 2.0, side="auditor")
    with pytest.raises(ValueError, match="unknown adversary kind"):
        tadv.adversary_scenario("bribery", 4, 4)
    with pytest.raises(ValueError, match="unknown adversary kind"):
        tadv.streaming_attack("bribery", 4, 4)
    with pytest.raises(ValueError, match="out of range"):
        tadv.remove_receiver(4, 4, 16, (1.0,) * 4, 2.0, 2.0)


def test_palette_scenarios_validate():
    """Every generated scenario validates for its RSM pair and equals the
    JAX package's constructor's, field by field."""
    assert tadv.ADVERSARY_KINDS == jadv.ADVERSARY_KINDS
    for kind in tadv.ADVERSARY_KINDS:
        for seed in range(3):
            sc = tadv.adversary_scenario(kind, 4, 4, seed=seed)
            sc.validate(4, 4, 64)
            _same_scenario(sc, jadv.adversary_scenario(kind, 4, 4,
                                                       seed=seed))
        sc = tadv.streaming_attack(kind, 4, 4)
        sc.validate(4, 4, 64)
        _same_scenario(sc, jadv.streaming_attack(kind, 4, 4))
    for make in ("remove_receiver", "join_receiver"):
        t = getattr(tadv, make)(4, 2, 16, (1.0, 2.0, 1.0, 1.0), 3.0, 2.0)
        j = getattr(jadv, make)(4, 2, 16, (1.0, 2.0, 1.0, 1.0), 3.0, 2.0)
        assert isinstance(t, trep.Injection)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_stake_attack_respects_budget():
    sc = tadv.stake_attack((3.0, 2.0, 1.0, 1.0), 4.0, side="receiver")
    adv = np.asarray(sc.byz_ack_advance) > 0
    st = np.asarray((3.0, 2.0, 1.0, 1.0))
    assert 0 < st[adv].sum() < 4.0
    assert adv[0] and not adv[1]
    jspec = jsim.build_spec(BFT1, BFT1, _sim(True),
                            failures=JFailureScenario(
                                **dataclasses.asdict(sc)))
    spec = tsim.spec_with_quorum(_port_spec(jspec),
                                 stakes_r=(3.0, 2.0, 1.0, 1.0),
                                 quack_thresh=4.0)
    budget = tadv.quorum_budget(spec)
    assert budget.provable and budget.receiver_margin > 0
    jbudget = jadv.quorum_budget(jsim.spec_with_quorum(
        jspec, stakes_r=(3.0, 2.0, 1.0, 1.0), quack_thresh=4.0))
    assert dataclasses.asdict(budget) == dataclasses.asdict(jbudget)


def test_quorum_budget_detects_owned_quorum():
    sc = JFailureScenario(byz_ack_advance=(4, 4, 0, 0))
    spec = _port_spec(jsim.build_spec(BFT1, BFT1, _sim(True), failures=sc))
    assert not tadv.quorum_budget(spec).provable
    with pytest.raises(ValueError, match="not provable"):
        tadv.assert_safe_retirement(spec, trefsim.run_reference(spec))


# ----------------------------------------------- oracle equivalence sweep
@pytest.mark.parametrize("kind", jadv.ADVERSARY_KINDS)
@pytest.mark.parametrize("path,windowed,k", ENGINE_PATHS,
                         ids=[p[0] for p in ENGINE_PATHS])
def test_adversary_matches_oracle(kind, path, windowed, k):
    for seed in (0, 1):
        sc = jadv.adversary_scenario(kind, 4, 4, seed=seed)
        jspec = jsim.build_spec(BFT1, BFT1, _sim(windowed, k), failures=sc)
        spec, res, ref = _assert_engine_matches_oracle(
            jspec, f"{kind}/{path}/seed{seed}")
        if windowed:
            assert ref.retired_undelivered == 0, (kind, seed)
            if tadv.quorum_budget(spec).provable:
                tadv.assert_safe_retirement(spec, ref)
                tadv.assert_safe_retirement(spec, res)


@pytest.mark.parametrize("kind", jadv.ADVERSARY_KINDS)
def test_adversary_pallas_quack_matches(kind):
    """With ``use_pallas_quack`` (the JAX package's Pallas quorum kernel,
    in interpret mode off the TPU) the JAX engine, the port (whose
    quorum is its own ``quack_scan``, the plain version on the CPU) and
    the port's oracle agree under every adversary kind."""
    sc = jadv.adversary_scenario(kind, 4, 4, seed=0)
    jspec = jsim.build_spec(BFT1, BFT1, _sim(True, use_pallas_quack=True),
                            failures=sc)
    assert jspec.use_pallas_quack
    _assert_engine_matches_oracle(jspec, f"{kind}/pallas")


def test_adversary_combo_with_quorum_reweight():
    dp = tuple(tuple(i == 0 and j in (0, 2) for j in range(4))
               for i in range(4))
    sc = JFailureScenario(byz_equiv_send=(True, False, False, False),
                          byz_hq_advance=(0, 2, 0, 0),
                          byz_ack_stale=(False, True, False, False),
                          drop_pair=dp, crash_r=(-1, -1, -1, 30))
    for windowed in (False, True):
        jspec = jsim.build_spec(BFT1, BFT1, _sim(windowed), failures=sc)
        jspec = jsim.spec_with_quorum(jspec, stakes_r=(2.0, 1.0, 1.0, 1.0),
                                      quack_thresh=3.0)
        _assert_engine_matches_oracle(jspec, f"combo/windowed={windowed}")


def test_adversary_chain_matches_oracle():
    sim = dict(n_msgs=24, steps=80, window=1, phi=6, window_slots=16,
               chunk_steps=4)
    jt = jtopo.Topology.chain(
        ["a", "b", "c"], BFT1, JSimConfig(**sim),
        failures={"a->b": jadv.adversary_scenario("stale_ack", 4, 4,
                                                  seed=1),
                  "b->c": jadv.selective_drops(4, 4, [(0, 0), (1, 2)])})
    topo = _port_topo(jt)
    er = ttopo.run_topology(topo, **CPU)
    rr = ttopo.run_topology_reference(topo)
    jr = jtopo.run_topology(jt)
    for lname in topo.link_names:
        for out in OUTPUTS:
            assert np.array_equal(
                np.asarray(getattr(er[lname].result, out)),
                np.asarray(getattr(rr[lname].result, out))), (lname, out)
            _same(getattr(er[lname].result, out),
                  getattr(jr[lname].result, out), (lname, out))
        assert np.array_equal(er[lname].result.gc_frontiers,
                              rr[lname].result.gc_frontiers), lname
        _same(er[lname].commit_floors, jr[lname].commit_floors, lname)


# ------------------------------------------------- hypothesis widening
try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:          # pragma: no cover - CI installs hypothesis
    HAVE_HYPOTHESIS = False

if HAVE_HYPOTHESIS:

    @st.composite
    def adversary_specs(draw):
        """A random palette scenario, engine path and stake re-weight
        (``test_adversary``'s strategy), as a JAX package spec."""
        kind = draw(st.sampled_from(jadv.ADVERSARY_KINDS))
        seed = draw(st.integers(0, 63))
        sc = jadv.adversary_scenario(kind, 4, 4, seed=seed)
        windowed = draw(st.booleans())
        k = draw(st.sampled_from([1, 8])) if windowed else 1
        spec = jsim.build_spec(BFT1, BFT1,
                               _sim(windowed, k,
                                    seed=draw(st.integers(0, 7))),
                               failures=sc)
        if draw(st.booleans()):
            boosted = draw(st.integers(2, 3))
            stakes = tuple(2.0 if i == boosted else 1.0 for i in range(4))
            spec = jsim.spec_with_quorum(spec, stakes_r=stakes,
                                         quack_thresh=3.0, dup_thresh=2.0)
        return spec, f"{kind}/seed{seed}/windowed={windowed}/K={k}"

    @settings(max_examples=20, deadline=None)
    @given(adversary_specs())
    def test_property_adversary_oracle_and_gc_safety(drawn):
        jspec, ctx = drawn
        spec, res, ref = _assert_engine_matches_oracle(jspec, ctx)
        if ref.retired_undelivered is not None:
            assert ref.retired_undelivered == 0, ctx
            if tadv.quorum_budget(spec).provable:
                tadv.assert_safe_retirement(spec, ref)
                tadv.assert_safe_retirement(spec, res)


# --------------------------------------------- mid-stream reconfiguration
def _record(jspec):
    _, trace = trep.record_simulation(_port_spec(jspec), **CPU)
    _, jtrace = jrep.record_simulation(jspec)
    return trace, jtrace


def _assert_replay_consistent(trace, jtrace, jinj, resume_t):
    """Replay from the checkpoint == from-scratch engine == the port's
    oracle == the JAX package's replay."""
    inj = _tinjs(jinj)
    ri = trep.replay(trace, resume_t, inj, **CPU)[0]
    scratch = trep.replay(trace, 0, inj, **CPU)[0]
    ref = trep.replay_oracle(trace, inj)
    jri = jrep.replay(jtrace, resume_t, jinj)[0]
    for f in OUTPUTS:
        a = np.asarray(getattr(ri, f))
        assert np.array_equal(a, np.asarray(getattr(scratch, f))), f
        assert np.array_equal(a, getattr(ref, f)), f
        _same(a, getattr(jri, f), f)
    for f in ALL_METRICS:
        _same(getattr(ri.metrics, f), getattr(jri.metrics, f), f)
    return ri


def _replay_spec(fails=JFailureScenario()):
    return jsim.build_spec(BFT1, BFT1, REPLAY_SIM, failures=fails)


def test_remove_receiver_reconfig_replays_bitexact():
    trace, jtrace = _record(_replay_spec())
    jinj = [jadv.remove_receiver(4, 3, 16, stakes_r=(1.0, 1.0, 1.0, 1.0),
                                 quack_thresh=2.0, dup_thresh=2.0)]
    tinj = [tadv.remove_receiver(4, 3, 16, stakes_r=(1.0, 1.0, 1.0, 1.0),
                                 quack_thresh=2.0, dup_thresh=2.0)]
    assert tinj[0].reconfigures and tinj[0].failures.crash_r[3] == 16
    assert _tinjs(jinj) == tinj
    ri = _assert_replay_consistent(trace, jtrace, jinj, 16)
    assert (np.asarray(ri.deliver_time) >= 0).all()


def test_join_receiver_reconfig_replays_bitexact():
    jspec = jsim.spec_with_quorum(
        _replay_spec(JFailureScenario(crash_r=(-1, -1, -1, 0))),
        stakes_r=(1.0, 1.0, 1.0, 0.0))
    trace, jtrace = _record(jspec)
    jinj = [jadv.join_receiver(4, 3, 32, stakes_r=(1.0, 1.0, 1.0, 1.0),
                               quack_thresh=2.0, dup_thresh=2.0)]
    ri = _assert_replay_consistent(trace, jtrace, jinj, 32)
    assert (np.asarray(ri.deliver_time) >= 0).all()


def test_adversary_injection_replays_bitexact():
    trace, jtrace = _record(_replay_spec())
    dp = tuple(tuple(i == 1 and j == 2 for j in range(4)) for i in range(4))
    jinj = [jrep.Injection(32, failures=JFailureScenario(
        byz_ack_stale=(False, True, False, False), drop_pair=dp))]
    _assert_replay_consistent(trace, jtrace, jinj, 32)


def test_stake_reweight_injection_replays_bitexact():
    trace, jtrace = _record(_replay_spec())
    jinj = [jrep.Injection(16, stakes_r=(2.0, 1.0, 1.0, 1.0),
                           quack_thresh=3.0)]
    _assert_replay_consistent(trace, jtrace, jinj, 16)


def test_empty_injection_rejected():
    trace, _ = _record(_replay_spec())
    with pytest.raises(ValueError, match="edits nothing"):
        trep.replay(trace, 16, [trep.Injection(16)], **CPU)


def test_reconfig_zero_warm_recompiles():
    """After one warm-up replay, arbitrarily different membership, stake
    and adversary swaps capture no chunk program (``chunk_trace_count``
    and ``graphs.first_use_count`` stand still), as in ``repro``."""
    from repro_torch.core import graphs
    trace, jtrace = _record(_replay_spec())
    warmup = [tadv.remove_receiver(4, 3, 16, stakes_r=(1.0,) * 4,
                                   quack_thresh=2.0, dup_thresh=2.0)]
    trep.replay(trace, 16, warmup, **CPU)
    jrep.replay(jtrace, 16, [jadv.remove_receiver(
        4, 3, 16, stakes_r=(1.0,) * 4, quack_thresh=2.0, dup_thresh=2.0)])
    before = (tsim.chunk_trace_count(), graphs.first_use_count(),
              jsim.chunk_trace_count())
    variants = [
        [jadv.remove_receiver(4, 2, 32, stakes_r=(1.0,) * 4,
                              quack_thresh=2.0, dup_thresh=2.0)],
        [jrep.Injection(16, stakes_r=(2.0, 1.0, 1.0, 1.0),
                        quack_thresh=3.0)],
        [jrep.Injection(32, failures=jadv.streaming_attack(
            "selective_drop", 4, 4))],
        [jrep.Injection(16, failures=jadv.adversary_scenario(
            "equivocate", 4, 4)),
         jrep.Injection(48, stakes_r=(1.0, 2.0, 1.0, 1.0),
                        quack_thresh=3.0)],
    ]
    for jinj in variants:
        ri = trep.replay(trace, 16, _tinjs(jinj), **CPU)[0]
        jri = jrep.replay(jtrace, 16, jinj)[0]
        for f in OUTPUTS:
            _same(getattr(ri, f), getattr(jri, f), f)
    assert (tsim.chunk_trace_count(), graphs.first_use_count(),
            jsim.chunk_trace_count()) == before, \
        "reconfiguration forced a chunk program capture"


def test_trace_roundtrip_preserves_adversary_state(tmp_path):
    jsc = jadv.adversary_scenario("selective_drop", 4, 4, seed=2)
    jspec = jsim.spec_with_quorum(_replay_spec(jsc),
                                  stakes_r=(2.0, 1.0, 1.0, 1.0),
                                  quack_thresh=3.0)
    trace, jtrace = _record(jspec)
    sc = _scenario(jsc)
    inj = [trep.Injection(32, failures=tadv.stale_ackers(4, (1,), base=sc))]
    ri = trep.replay(trace, 32, inj, **CPU)[0]
    path = os.path.join(str(tmp_path), "trace.npz")
    trace.save(path)
    t2 = trep.RunTrace.load(path)
    r2 = trep.replay(t2, 32, inj, **CPU)[0]
    jri = jrep.replay(jrep.RunTrace.load(path), 32, [jrep.Injection(
        32, failures=jadv.stale_ackers(4, (1,), base=jsc))])[0]
    for f in OUTPUTS:
        assert np.array_equal(np.asarray(getattr(ri, f)),
                              np.asarray(getattr(r2, f))), f
        _same(getattr(ri, f), getattr(jri, f), f)


# ----------------------------------------------- streaming SLO degradation

@pytest.mark.parametrize("kind", jadv.ADVERSARY_KINDS)
def test_streaming_attack_breaches_and_recovers(kind):
    """Graceful degradation, not just survival: each palette attack
    switched on mid-stream trips an SLO watchdog breach, and healing it
    produces the matching recovery event — while the stream still
    delivers its whole horizon; the port's session (on the CPU) gives
    ``repro``'s SLO events, report and every live row."""
    runs = []
    for stream, core, adv, extra in (
            (tstream, tcore, tadv, CPU),
            (jstream, jcore, jadv, {})):
        b = core.RSMConfig.bft(1)
        sim = core.SimConfig(window=2, phi=3, chunk_steps=16,
                             window_slots="auto")
        slo_mod = stream.session
        cfg = stream.StreamConfig(
            horizon=1024, utilization=0.5,
            slo=slo_mod.SLOConfig(p99_latency_rounds=24, resend_rate=0.25,
                                  frontier_stall_chunks=2),
            report_every=2)
        sess = stream.StreamSession(b, b, sim, cfg, **extra)
        chunk = max(sess.spec.chunk_steps, 1)
        res = sess.run(fail_schedule={
            4 * chunk: adv.streaming_attack(kind, 4, 4),
            16 * chunk: core.FailureScenario.none()})
        runs.append((res, chunk))
    (res, chunk), (jres, _) = runs
    assert not res.problems, (kind, res.problems)
    breach = [e for e in res.slo_events if not e.recovered]
    recov = [e for e in res.slo_events if e.recovered]
    assert breach, f"{kind}: attack caused no SLO breach"
    assert recov, f"{kind}: no SLO recovery after the heal"
    assert all(e.t >= 4 * chunk for e in breach), kind
    assert res.delivered == 1024
    assert [e.to_dict() for e in res.slo_events] == \
        [e.to_dict() for e in jres.slo_events]
    assert list(res.live.rows) == list(jres.live.rows)
    td, jd = res.to_json_dict(), jres.to_json_dict()
    for d in (td, jd):
        d["counters"] = {k: v for k, v in d["counters"].items()
                         if k != "traces"}
    assert td == jd
