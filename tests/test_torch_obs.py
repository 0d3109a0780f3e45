"""The torch port's observability stack (``repro_torch.obs``) vs the JAX
package's (``repro.obs``), on the CPU.

One plan is built by the JAX package and carried into the port with
``spec_from_arrays``; both run it with ``collect_metrics`` on. The
fixtures are ``tests/test_obs.py``'s: the four fusion-break classes at
K in {1, 8}, the dense path and the batched sweep. Tolerance 0
everywhere: the fabric is int32 on both sides. The layer's contract:

* **Exactness** — the port with metrics on equals the port with metrics
  off bit for bit, its ``ObsMetrics`` equal the JAX package's field by
  field (the per-chunk histograms too), and each lane's histogram equals
  the numpy histogram of its ``delivery_latency``. The device half's
  functions (``update_metrics``, ``rotate_metrics``, ``pad_metrics``,
  ``migrate_dense_metrics``, ``resume_metrics_carry``, ``latency_bucket``)
  equal the JAX package's on the same numpy inputs, and so does the host
  half (block algebra, percentiles, the live aggregator).
* **No new dispatch** — metrics on adds no dispatch, host sync, program
  or graph replay (``chunk_dispatch_count``, ``host_sync_count``,
  ``chunk_trace_count``, ``graphs.replay_count``); on the card
  ``tests/test_torch_gpu.py`` adds the kernel launch counters.
* **Reporting** — the engine emits the canonical spans, as many of each
  as the JAX engine; the Chrome trace validates; RunReports round-trip;
  the CLI selftest passes with ``--device cpu``.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs.live as jlive
import repro.obs.metrics as jmet
import repro_torch.core as tcore
import repro_torch.core.graphs as tgraphs
import repro_torch.core.simulator as tsim
import repro_torch.obs.live as tlive
import repro_torch.obs.metrics as tmet
from repro.core import FailureScenario as JFailureScenario
from repro.core import RSMConfig as JRSMConfig
from repro.core import SimConfig as JSimConfig
from repro.core import protocols as jprot
from repro.core import simulator as jsim
from repro.obs.report import validate_chrome_trace as jvalidate
from repro.obs.tracer import SpanTracer as JSpanTracer
from repro.obs.tracer import tracing as jtracing
from repro_torch.obs.report import (RunReport, report_from_results,
                                    run_reported, validate_chrome_trace)
from repro_torch.obs.tracer import (SpanTracer, obs_begin, obs_span,
                                    tracing)
from test_obs import FIXTURES, GC_STALL, IDS
from test_torch_windowed import _assert_windowed_equal, _port_spec


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
OBS_FIELDS = ("latency_hist", "occupancy_hwm", "gc_lag_hwm",
              "quack_events", "loss_events", "resend_total", "uncounted",
              "per_chunk_hist")
SCENARIOS = [JFailureScenario.none(), GC_STALL,
             JFailureScenario(crash_s=(1, -1, -1, -1)),
             JFailureScenario.crash_fraction(4, 4, 0.33, seed=1)]


def _jspec(simkw, fails, k=8, collect=True, **extra):
    sim = JSimConfig(debug_checks=True, superchunk=k,
                     collect_metrics=collect, **simkw, **extra)
    return jsim.build_spec(BFT1, BFT1, sim, fails)


def _port(spec, **change):
    return tsim.run_simulation(dataclasses.replace(spec, **change),
                               device="cpu")


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and np.array_equal(a, b), (what, a, b)


def _assert_obs_equal(tobs, jobs):
    """The port's ``ObsMetrics`` == the JAX package's, field by field."""
    assert tobs is not None and jobs is not None
    for f in OBS_FIELDS:
        a, b = getattr(tobs, f), getattr(jobs, f)
        if f == "per_chunk_hist" and (a is None or b is None):
            assert a is None and b is None, f
            continue
        _same(a, b, f)
    assert tobs.to_dict() == jobs.to_dict()


def _assert_exact(res):
    """The lane's histogram == the numpy oracle of its latency array."""
    _same(res.obs.latency_hist,
          tmet.latency_histogram_np(res.delivery_latency), "oracle")
    delivered = int((np.asarray(res.deliver_time) >= 0).sum())
    assert res.obs.total_counted() + res.obs.uncounted == delivered
    assert res.obs.uncounted == 0
    assert res.obs.resend_total == int(np.sum(res.metrics.resends))


def _counts():
    return (tsim.chunk_dispatch_count(), tsim.host_sync_count(),
            tsim.chunk_trace_count(), tgraphs.replay_count())


# --- exactness: the engine's metrics ------------------------------------

@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("name,simkw,fails", FIXTURES, ids=IDS)
def test_metrics_exact_and_nonperturbing(name, simkw, fails, k):
    """Port on == port off bit for bit, and == the JAX package on; the
    port's ObsMetrics == the JAX package's (per-chunk histograms of the
    chunks a guard discarded dropped on both sides) and == the oracle."""
    jspec = _jspec(simkw, fails, k)
    spec = _port_spec(jspec)
    on = _port(spec)
    off = _port(spec, collect_metrics=False)
    _assert_windowed_equal(on, off)
    assert off.obs is None
    jr = jsim.run_simulation(jspec)
    _assert_windowed_equal(on, jr)
    _assert_obs_equal(on.obs, jr.obs)
    _assert_exact(on)
    assert len(on.obs.per_chunk_hist) == len(jr.obs.per_chunk_hist)


def test_dense_path_metrics_exact():
    """The dense engine fills ``obs`` by the same rule, == the JAX
    package's dense run; the windowed run at full width agrees."""
    simkw = dict(n_msgs=64, steps=120, window=1, phi=6)
    fails = JFailureScenario(crash_s=(5, -1, -1, -1))
    jspec = jsim.build_spec(BFT1, BFT1, JSimConfig(collect_metrics=True,
                                                   **simkw), fails)
    r = _port(_port_spec(jspec))
    _assert_obs_equal(r.obs, jsim.run_simulation(jspec).obs)
    assert r.obs.per_chunk_hist is None
    _assert_exact(r)
    off = _port(_port_spec(jspec), collect_metrics=False)
    _assert_windowed_equal(r, off)
    rw = _port(_port_spec(_jspec(dict(window_slots=64, chunk_steps=8,
                                      **simkw), fails, 8)))
    _same(r.delivery_latency, rw.delivery_latency, "delivery_latency")
    _same(r.obs.latency_hist, rw.obs.latency_hist, "latency_hist")


BATCH_SIM = dict(n_msgs=128, steps=128 // 4 + 60, window=1, phi=6,
                 window_slots=32, chunk_steps=8)


@pytest.mark.parametrize("k", [1, 8])
def test_batched_sweep_metrics_exact(k):
    """Four scenarios as the lanes of one windowed run: each lane's
    ObsMetrics == the JAX batch lane's, and == its oracle."""
    jspecs = [_jspec(BATCH_SIM, f, k) for f in SCENARIOS]
    got = tsim.run_simulation_batch([_port_spec(s) for s in jspecs],
                                    device="cpu")
    off = tsim.run_simulation_batch(
        [dataclasses.replace(_port_spec(s), collect_metrics=False)
         for s in jspecs], device="cpu")
    for tr, tr_off, jr in zip(got, off, jsim.run_simulation_batch(jspecs)):
        _assert_windowed_equal(tr, tr_off)
        _assert_obs_equal(tr.obs, jr.obs)
        _assert_exact(tr)


def test_dense_batch_metrics_exact():
    jspecs = [jsim.build_spec(BFT1, BFT1, JSimConfig(
        n_msgs=64, steps=70, window=1, phi=6, collect_metrics=True), f)
        for f in SCENARIOS]
    got = tsim.run_simulation_batch([_port_spec(s) for s in jspecs],
                                    device="cpu")
    for tr, jr in zip(got, jsim.run_simulation_batch(jspecs)):
        _assert_obs_equal(tr.obs, jr.obs)
        _assert_exact(tr)


@pytest.mark.parametrize("window_slots", [None, 192],
                         ids=["dense", "windowed"])
def test_run_picsou_batch_metrics_match_jax(window_slots):
    """Through the entry points: ``SimConfig(collect_metrics=True)`` to
    ``run_picsou`` / ``run_picsou_batch``, each lane == the JAX
    package's."""
    cfg = JRSMConfig.bft(2)
    sim = dict(n_msgs=256, steps=140, window_slots=window_slots,
               chunk_steps=8, collect_metrics=True)
    jscen = [JFailureScenario.none(),
             JFailureScenario(byz_ack_low=(True,) + (False,) * 6)]
    tscen = [tcore.FailureScenario.none(),
             tcore.FailureScenario(byz_ack_low=(True,) + (False,) * 6)]
    tcfg = tcore.RSMConfig.bft(2)
    truns = tcore.run_picsou_batch(tcfg, tcfg, tcore.SimConfig(**sim),
                                   tscen, device="cpu")
    jruns = jprot.run_picsou_batch(cfg, cfg, JSimConfig(**sim), jscen)
    for trun, jrun in zip(truns, jruns):
        _assert_obs_equal(trun.result.obs, jrun.result.obs)
    single = tcore.run_picsou(tcfg, tcfg, tcore.SimConfig(**sim),
                              tscen[1], device="cpu")
    _assert_obs_equal(single.result.obs, truns[1].result.obs)


# --- the device half's functions vs the JAX package's -------------------

class _State:
    """The four ``SimState`` fields ``update_metrics`` reads."""

    def __init__(self, orig_sent, deliver_time, quack_time, retry):
        self.orig_sent, self.deliver_time = orig_sent, deliver_time
        self.quack_time, self.retry = quack_time, retry


def _rand_states(rng, b, s, w, t):
    def one():
        return dict(orig_sent=rng.random((b, w)) < 0.5,
                    deliver_time=rng.integers(-1, t + 1, (b, w)),
                    quack_time=rng.integers(-1, t + 1, (b, s, w)),
                    retry=rng.integers(0, 4, (b, s, w)))
    return one(), one()


def _carry_np(rng, b, w, t):
    return tmet.MetricsCarry(
        send_time=rng.integers(-1, t + 1, (b, w)),
        latency_hist=rng.integers(0, 50, (b, tmet.NUM_LATENCY_BUCKETS)),
        **{f: rng.integers(0, 50, (b,))
           for f in tmet.MetricsCarry._fields[2:]})


def _torch(tree):
    return type(tree)(*(torch.tensor(np.asarray(x, dtype=np.int32))
                        for x in tree))


def _jax_lane(tree, b):
    return type(tree)(*(jnp.asarray(np.asarray(x[b], dtype=np.int32))
                        for x in tree))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_update_metrics_matches_jax(seed):
    """One round's fold on random old/new states, B = 3 lanes at W = 70,
    latencies crossing several buckets: == the JAX package per lane."""
    rng = np.random.default_rng(seed)
    b, s, w, t = 3, 4, 70, 300
    old, new = _rand_states(rng, b, s, w, t)
    mc = _carry_np(rng, b, w, t)
    resends = rng.integers(0, 9, (b,))
    metrics = np.zeros((b, 6), dtype=np.int32)
    metrics[:, 2] = resends

    def port_state(d):
        return _State(**{k: torch.tensor(v) if v.dtype == bool else
                         torch.tensor(v, dtype=torch.int32)
                         for k, v in d.items()})

    got = tmet.update_metrics(_torch(mc), port_state(old), port_state(new),
                              torch.tensor(metrics),
                              torch.tensor(t, dtype=torch.int32))
    for lane in range(b):
        def jstate(d):
            return _State(**{k: jnp.asarray(v[lane]) if v.dtype == bool
                             else jnp.asarray(v[lane], dtype=jnp.int32)
                             for k, v in d.items()})
        ms = type("Ms", (), {"resends": jnp.int32(resends[lane])})
        want = jmet.update_metrics(
            jmet.MetricsCarry(*_jax_lane(mc, lane)), jstate(old),
            jstate(new), ms, jnp.int32(t))
        for f, a, x in zip(tmet.MetricsCarry._fields, got, want):
            assert a.dtype == torch.int32, f
            _same(a[lane].numpy(), x, f)


def test_latency_bucket_matches_np():
    lat = np.array([0, 1, 2, 3, 7, 8, 1023, 1024, 65535, 65536, 10 ** 6])
    got = tmet.latency_bucket(torch.tensor(lat, dtype=torch.int32))
    assert got.dtype == torch.int32
    _same(got.numpy(), tmet.latency_bucket_np(lat), "bucket")
    _same(got.numpy(), jmet.latency_bucket_np(lat), "bucket")
    _same(got.numpy(), jmet.latency_bucket(jnp.asarray(lat)), "bucket")


@pytest.mark.parametrize("seed", [0, 1])
def test_rotate_metrics_matches_jax(seed):
    """Per-lane frontiers from 0 to W: == the JAX rotation lane by lane."""
    rng = np.random.default_rng(seed)
    b, w = 4, 40
    mc = _carry_np(rng, b, w, 99)
    f = np.array([0, 1, rng.integers(2, w), w], dtype=np.int32)
    got = tmet.rotate_metrics(_torch(mc), torch.tensor(f), w)
    for lane in range(b):
        want = jmet.rotate_metrics(jmet.MetricsCarry(*_jax_lane(mc, lane)),
                                   jnp.int32(f[lane]), w)
        for name, a, x in zip(tmet.MetricsCarry._fields, got, want):
            _same(a[lane].numpy(), x, name)


def test_pad_metrics_matches_jax():
    rng = np.random.default_rng(3)
    mc = _carry_np(rng, 2, 24, 50)
    got = tmet.pad_metrics(_torch(mc), 56)
    want = jmet.pad_metrics(jmet.MetricsCarry(*(jnp.asarray(
        np.asarray(x, dtype=np.int32)) for x in mc)), 56)
    for name, a, x in zip(tmet.MetricsCarry._fields, got, want):
        _same(a.numpy(), x, name)


@pytest.mark.parametrize("seed", [0, 1])
def test_migrate_dense_metrics_matches_jax(seed):
    """Bases at 0, inside the stream and near its end (live columns cut
    by M): == the JAX package's migration on the same numpy carry."""
    rng = np.random.default_rng(seed)
    b, w, m = 3, 16, 60
    mc = _carry_np(rng, b, w, 80)
    mc = mc._replace(**{f: np.asarray(x, dtype=np.int32)
                        for f, x in mc._asdict().items()})
    bases = [0, int(rng.integers(1, m - w)), m - 5]
    send_step = rng.integers(-1, 80, (b, m))
    got = tmet.migrate_dense_metrics(mc, bases, send_step, m, CPU)
    want = jmet.migrate_dense_metrics(jmet.MetricsCarry(*mc), bases,
                                      send_step, m)
    for name, a, x in zip(tmet.MetricsCarry._fields, got, want):
        assert a.dtype == torch.int32, name
        _same(a.numpy(), x, name)


@pytest.mark.parametrize("seed", [0, 1])
def test_resume_metrics_carry_matches_jax(seed):
    rng = np.random.default_rng(seed)
    w, m = 16, 60
    bases = [0, int(rng.integers(1, m - w)), m - 5, m]
    send_step = rng.integers(-1, 80, (len(bases), m))
    got = tmet.resume_metrics_carry(w, bases, send_step, m, CPU)
    want = jmet.resume_metrics_carry(w, bases, send_step, m)
    for name, a, x in zip(tmet.MetricsCarry._fields, got, want):
        assert a.dtype == torch.int32, name
        _same(a.numpy(), x, name)


@pytest.mark.parametrize("lane", [0, 2])
def test_obs_from_carry_and_final_match_jax(lane):
    """A fetched carry (numpy leaves) and per-chunk blocks into one
    lane's ObsMetrics: == the JAX package's summaries."""
    rng = np.random.default_rng(lane)
    mc = _carry_np(rng, 3, 8, 30)
    blocks = _cumulative_blocks(rng, 4, 3)
    got = tmet.obs_from_final(mc, blocks, lane)
    _assert_obs_equal(got, jmet.obs_from_final(
        jmet.MetricsCarry(*mc), [jmet.MetricsBlock(*b) for b in blocks],
        lane))
    one = type(mc)(*(x[lane] for x in mc))
    _assert_obs_equal(tmet.obs_from_carry(one), jmet.obs_from_carry(one))


# --- the host half vs the JAX package's ---------------------------------

def test_bucket_edges_and_percentiles():
    assert tmet.LATENCY_BUCKET_EDGES == jmet.LATENCY_BUCKET_EDGES
    assert tmet.NUM_LATENCY_BUCKETS == jmet.NUM_LATENCY_BUCKETS
    lat = np.array([0, 0, 1, 2, 3, 4, 65535, 65536, 70000, -1])
    hist = tmet.latency_histogram_np(lat)
    _same(hist, jmet.latency_histogram_np(lat), "hist")
    assert int(hist.sum()) == 9 and hist[0] == 2 and hist[2] == 2
    assert hist[tmet.NUM_LATENCY_BUCKETS - 1] == 2
    for i in range(tmet.NUM_LATENCY_BUCKETS):
        assert tmet.bucket_label(i) == jmet.bucket_label(i)
    assert tmet.bucket_label(2) == "2-3"
    assert tmet.percentile_from_hist(np.zeros(18), 50) == -1
    one = np.zeros(18, dtype=int)
    one[0], one[3] = 100, 1
    assert tmet.percentile_from_hist(one, 50) == 0
    assert tmet.percentile_from_hist(one, 100) == 8
    rng = np.random.default_rng(7)
    for _ in range(20):
        h = rng.integers(0, 5, 18)
        for q in (0, 1, 50, 95, 99, 100):
            assert tmet.percentile_from_hist(h, q) == \
                jmet.percentile_from_hist(h, q)


def _cumulative_blocks(rng, n, lanes):
    """``n`` cumulative snapshots with full-width (18-bucket) histograms:
    counters non-decreasing, HWMs monotone."""
    blocks, cur = [], tmet.zero_metrics_block(lanes)
    for _ in range(n):
        cur = tmet.MetricsBlock(*(
            x + rng.integers(0, 7, x.shape) for x in cur))
        blocks.append(cur)
    return blocks


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_delta_merge_fold_matches_jax(seed):
    """The block algebra on full-width histograms: each delta and merge ==
    the JAX package's; folding the deltas in any grouping gives the last
    snapshot back exactly."""
    rng = np.random.default_rng(seed)
    blocks = _cumulative_blocks(rng, 9, 3)
    prev, deltas = None, []
    for blk in blocks:
        d = tmet.delta_metrics_block(prev, blk)
        jd = jmet.delta_metrics_block(
            None if prev is None else jmet.MetricsBlock(*prev),
            jmet.MetricsBlock(*blk))
        for name, a, x in zip(tmet.MetricsBlock._fields, d, jd):
            _same(a, x, name)
        deltas.append(d)
        prev = blk
    cut = int(rng.integers(1, len(deltas)))
    left, right = tmet.zero_metrics_block(3), tmet.zero_metrics_block(3)
    for d in deltas[:cut]:
        left = tmet.merge_metrics_blocks(left, d)
    for d in deltas[cut:]:
        right = tmet.merge_metrics_blocks(right, d)
    folded = tmet.merge_metrics_blocks(left, right)
    jfolded = jmet.merge_metrics_blocks(jmet.MetricsBlock(*left),
                                        jmet.MetricsBlock(*right))
    for name, a, x, last in zip(tmet.MetricsBlock._fields, folded, jfolded,
                                blocks[-1]):
        _same(a, x, name)
        _same(a, last, name)


class _Drained:
    """The round metrics ``LiveAggregator.observe`` reads of a chunk."""

    def __init__(self, rng, lanes, c, delivered):
        self.delivered = np.full((lanes, c), delivered)
        self.cross_msgs = rng.integers(0, 5, (lanes, c))
        self.intra_msgs = rng.integers(0, 9, (lanes, c))


def test_live_aggregator_matches_jax():
    """The same per-chunk feed through both aggregators, watchdogs and
    reports: every sample, SLO event and dashboard row equal."""
    rng = np.random.default_rng(11)
    lanes, chunks, c = 2, 14, 8
    arrivals = np.minimum(np.arange(chunks * c + 1) * 3, 200)
    blocks = _cumulative_blocks(rng, chunks, lanes)
    slo = dict(p99_latency_rounds=4, resend_rate=0.2,
               frontier_stall_chunks=2)
    aggs = (tlive.LiveAggregator(lanes, arrivals, window_chunks=4),
            jlive.LiveAggregator(lanes, arrivals, window_chunks=4))
    dogs = (tlive.SLOWatchdog(tlive.SLOConfig(**slo)),
            jlive.SLOWatchdog(jlive.SLOConfig(**slo)))
    reps = (tlive.LiveReport(maxlen=5), jlive.LiveReport(maxlen=5))
    bases = np.zeros(lanes, dtype=np.int64)
    events = 0
    for i, blk in enumerate(blocks):
        if i % 3:
            bases = bases + rng.integers(0, 20, lanes)
        t_end = (i + 1) * c
        drained = _Drained(rng, lanes, c, 10 * i)
        samples = [agg.observe(t_end, drained, bases.copy(),
                               None if i == 5 else block)
                   for agg, block in zip(aggs, (blk,
                                                jmet.MetricsBlock(*blk)))]
        assert samples[0].to_row() == samples[1].to_row()
        evs = [dog.check(sm) for dog, sm in zip(dogs, samples)]
        assert [e.to_dict() for e in evs[0]] == \
            [e.to_dict() for e in evs[1]]
        events += len(evs[0])
        rows = [rep.add(sm, ev) for rep, sm, ev in zip(reps, samples, evs)]
        assert rows[0] == rows[1]
    assert events > 0
    assert reps[0].dashboard() == reps[1].dashboard()
    _same(aggs[0].sketch().hist, aggs[1].sketch().hist, "sketch")
    assert aggs[0].gc_lag_trend.slope_per_round() == \
        aggs[1].gc_lag_trend.slope_per_round()


# --- no new dispatch -----------------------------------------------------

@pytest.mark.parametrize("k", [1, 8])
def test_metrics_overhead_contract(k):
    """collect_metrics=True adds no dispatch, host sync, program or graph
    replay against metrics off, and changes no output."""
    simkw = dict(n_msgs=136, steps=136 // 4 + 40, window=1, phi=6,
                 window_slots=34, chunk_steps=4)
    spec = _port_spec(_jspec(simkw, JFailureScenario.none(), k))
    deltas = {}
    for collect in (False, True):
        before = _counts()
        deltas[collect] = (_port(spec, collect_metrics=collect),
                           tuple(a - b for a, b in zip(_counts(), before)))
    (r_off, c_off), (r_on, c_on) = deltas[False], deltas[True]
    _assert_windowed_equal(r_on, r_off)
    assert c_on == c_off and c_on[0] > 0
    n_chunks = -(-spec.steps // spec.chunk_steps)
    assert c_on[0] <= -(-n_chunks // k) + 2 and c_on[1] <= c_on[0] + 2


# --- tracer + report ---------------------------------------------------

def test_tracer_spans_and_chrome_schema():
    tr = SpanTracer()
    with tracing(tr):
        with obs_span("outer", cat="test", k=1):
            with obs_span("inner", cat="test"):
                pass
        tr.counter("rate", msgs=3)
        tr.instant("breach", cat="slo", kind="p99")
    assert tr.count("outer") == tr.count("inner") == 1
    assert tr.total_ns("outer") >= tr.total_ns("inner")
    doc = tr.to_chrome_trace()
    assert validate_chrome_trace(doc) == [] == jvalidate(doc)
    assert {e["name"] for e in doc["traceEvents"]} == {
        "outer", "inner", "rate", "breach"}
    assert "outer" in tr.summary() and "n/a (no_drains)" in tr.summary()
    assert obs_begin() is None        # disabled: no clock sample


@pytest.mark.parametrize("doc", [
    [], {}, {"traceEvents": 3},
    {"traceEvents": [{"name": "x", "cat": "c", "ph": "B", "ts": 0,
                      "dur": -1, "pid": 0, "tid": 0, "args": {}}]},
    {"traceEvents": [{"name": "c", "cat": "c", "ph": "C", "ts": 1,
                      "pid": 0, "tid": 0, "args": {"v": "x"}},
                     {"name": "i", "cat": "c", "ph": "i", "s": "q",
                      "ts": 0, "pid": 0, "tid": 0, "args": {}}]},
], ids=["list", "empty", "events_not_list", "bad_phase", "bad_counter"])
def test_validate_chrome_trace_matches_jax(doc):
    assert validate_chrome_trace(doc) == jvalidate(doc) != []


def _span_counts(names):
    return {n: names.count(n) for n in (
        "run", "drain_wait", "final_flush", "window_growth",
        "dense_migration")} | {
        "compile+dispatch": names.count("compile") + names.count(
            "dispatch")}


@pytest.mark.parametrize("name,simkw,fails", FIXTURES, ids=IDS)
def test_engine_emits_canonical_spans(name, simkw, fails):
    """A windowed run at K = 8 records as many run, compile-or-dispatch,
    drain_wait, window_growth, dense_migration and final_flush spans as
    the JAX engine on the same spec; every drain_wait says whether it
    overlapped."""
    jspec = _jspec(simkw, fails, 8, collect=False)
    tr, jtr = SpanTracer(), JSpanTracer()
    with tracing(tr):
        _port(_port_spec(jspec))
    with jtracing(jtr):
        jsim.run_simulation(jspec)
    assert _span_counts(tr.names()) == _span_counts(jtr.names())
    assert {"run", "drain_wait", "final_flush"} <= set(tr.names())
    assert 0.0 <= tr.drain_overlap_ratio() <= 1.0
    for s in tr.spans:
        if s.name == "drain_wait":
            assert isinstance(s.args["overlapped"], bool)
    assert validate_chrome_trace(tr.to_chrome_trace()) == []


def test_run_report_roundtrip(tmp_path):
    simkw = dict(n_msgs=96, steps=96 // 4 + 40, window=1, phi=6,
                 window_slots=24, chunk_steps=8)
    spec = _port_spec(_jspec(simkw, GC_STALL, 8, collect=False))
    result, report = run_reported(spec, device="cpu")
    assert report.validate() == []
    assert report.meta["device"] == "cpu"
    assert report.meta["chunk_dispatches"] > 0
    assert "link" in report.percentile_table()
    assert "delivery-latency" in report.histogram_table("link")
    prefix = os.path.join(str(tmp_path), "report")
    paths = report.save(prefix)
    assert os.path.exists(paths["json"]) and os.path.exists(paths["npz"])
    back = RunReport.load(prefix)
    assert back.validate() == []
    for f in OBS_FIELDS:
        _same(getattr(back.obs["link"], f), getattr(report.obs["link"], f),
              f)
    _same(back.latency["link"], result.delivery_latency, "latency")
    assert back.spans == report.spans and back.meta == report.meta
    assert back.summary() == report.summary()
    json.dumps(back.to_json_dict())


def test_report_requires_metrics():
    simkw = dict(n_msgs=48, steps=60, window=1, phi=6,
                 window_slots=12, chunk_steps=4)
    r = _port(_port_spec(_jspec(simkw, JFailureScenario.none(), 1,
                                collect=False)))
    with pytest.raises(ValueError, match="collect_metrics"):
        report_from_results([r], SpanTracer())


def test_run_reported_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = _port_spec(_jspec(dict(n_msgs=8, steps=4, window_slots=4,
                                  chunk_steps=2), JFailureScenario.none()))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_reported(spec)


def test_obs_selftest_cli(tmp_path, capsys):
    """``python -m repro_torch.obs --selftest --device cpu`` exits 0 and
    leaves the RunReport + Perfetto trace artifacts."""
    from repro_torch.obs.__main__ import main

    out = os.path.join(str(tmp_path), "obs_out")
    assert main(["--selftest", "--device", "cpu", "--out", out]) == 0
    assert "SELFTEST OK on cpu" in capsys.readouterr().out
    for f in ("report.json", "report.npz"):
        assert os.path.exists(os.path.join(out, f))
    with open(os.path.join(out, "trace.json")) as f:
        assert validate_chrome_trace(json.load(f)) == []
