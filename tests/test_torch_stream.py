"""The torch port's streaming session (``repro_torch.stream``) and the
windowed loop's horizon mode vs the JAX package's, on the CPU.

The legs of ``tests/test_stream.py``, each holding the port
(``device="cpu"``) to ``repro`` on the same inputs, tolerance 0 (the
schedule, the engine and the telemetry are integer on both sides, the
rates the same float64 arithmetic):

* **Workload** — every arrival process gives the same seeded schedule,
  window and ``SimSpec`` field by field; validation rejects the same
  processes.
* **Horizon mode** — the sink contract's errors and the dense-fallback
  refusal (with the same suggested width); a capture sink sees the same
  chunk ends, metrics, queues, cumulative blocks and bases, and the same
  ``on_final`` arguments, on a stream that grows its window at K = 1
  and at K = 8 (where the in-graph guard cuts a span, whose discarded
  chunks reach no sink); it issues the batch run's dispatches and keeps
  no (B, ..., M) host array.
* **Sessions** — ``to_json_dict()``, every ``LiveReport`` row (the
  JSON-lines stream), SLO events, sketches, ``ObsMetrics``, capacity,
  final width and growth events equal, single, chained and growing; the
  CLI selftest passes with ``--device cpu``; without a device named a
  session needs CUDA.
* **Telemetry** — watchdogs, tracer counters and instants, the Chrome
  trace schema, sketches and the history-free floor planner, on the
  same inputs.

The hypothesis fold property of ``tests/test_stream.py`` is not copied:
``tests/test_torch_obs.py`` holds the delta/merge fold on full-width
blocks.
"""

import dataclasses
import json
import re
import tracemalloc
import weakref

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

import repro.core.simulator as jsim
import repro.obs.live as jlive
import repro.stream as jstream
import repro_torch.core as tcore
import repro_torch.core.graphs as tgraphs
import repro_torch.core.simulator as tsim
import repro_torch.obs.live as tlive
import repro_torch.stream as tstream
from repro.core import FailureScenario as JFailureScenario
from repro.core import RSMConfig as JRSMConfig
from repro.core import SimConfig as JSimConfig
from repro.obs.report import validate_chrome_trace as jvalidate
from repro.obs.tracer import SpanTracer as JSpanTracer
from repro.topology.engine import FloorPlanner as JFloorPlanner
from repro_torch.obs.report import validate_chrome_trace
from repro_torch.obs.tracer import SpanTracer
from repro_torch.topology.engine import FloorPlanner


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: torch's intra-op threads only cost, and under a
    parallel test run they compete with the other workers'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


KINDS = ("constant", "diurnal", "bursty", "heavytail")
CPU = torch.device("cpu")
# a stream that outgrows a 32-slot window twice (bursty arrivals); at
# K = 8 the in-graph guard cuts one span
GROWING = dict(kind="bursty", rate=4.0, window_slots=32, horizon=512)


def _pair(name, **kw):
    """The same config object in both packages: (port, JAX)."""
    return (getattr(tcore, name)(**kw), {
        "RSMConfig": JRSMConfig, "SimConfig": JSimConfig,
        "FailureScenario": JFailureScenario}[name](**kw))


def _bft1():
    return tcore.RSMConfig.bft(1), JRSMConfig.bft(1)


def _sims(k=8, window_slots="auto", **kw):
    return _pair("SimConfig", window=1, phi=6, window_slots=window_slots,
                 chunk_steps=8, superchunk=k, **kw)


def _procs(**kw):
    return (tstream.ArrivalProcess(**kw), jstream.ArrivalProcess(**kw))


def _stream_specs(horizon=256, k=8, kind="constant", rate=4.0,
                  window_slots="auto", failures=None):
    """(port spec, JAX spec) of ``build_stream_spec``, each package's."""
    (tb, jb), (ts, js) = _bft1(), _sims(k, window_slots)
    tp, jp = _procs(kind=kind, rate=rate)
    tspec = tstream.build_stream_spec(tb, tb, ts, tp, horizon)
    jspec = jstream.build_stream_spec(jb, jb, js, jp, horizon)
    if failures is not None:
        tf, jf = _pair("FailureScenario", **failures)
        tspec = tsim.spec_with_failures(tspec, tf)
        jspec = jsim.spec_with_failures(jspec, jf)
    return tspec, jspec


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.array_equal(a, b), (what, a, b)


# ---------------------------------------------------------------- workload

@pytest.mark.parametrize("kind", KINDS)
def test_workload_schedule_matches_jax(kind):
    """The same seed gives the same exact-horizon schedule, dispatch
    rounds and load-sized window in both packages."""
    tp, jp = _procs(kind=kind, rate=3.5, seed=7)
    counts = tstream.arrivals_per_round(tp, 777)
    _same(counts, jstream.arrivals_per_round(jp, 777), "counts")
    assert counts.sum() == 777 and (counts >= 0).all()
    _same(tstream.dispatch_rounds(counts),
          jstream.dispatch_rounds(counts), "dispatch rounds")
    for args in ((4, 4, 8, 6), (19, 19, 32, 32)):
        assert tstream.stream_window_slots(counts, *args) == \
            jstream.stream_window_slots(counts, *args), args
    if kind != "constant":   # stochastic kinds move with the seed
        other = tstream.arrivals_per_round(dataclasses.replace(tp, seed=8),
                                           777)
        assert not (len(other) == len(counts)
                    and np.array_equal(other, counts))


@pytest.mark.parametrize("bad", [dict(kind="nope"), dict(rate=0.0),
                                 dict(kind="heavytail", alpha=1.0)])
def test_workload_validation_matches_jax(bad):
    for make in (tstream.ArrivalProcess, jstream.ArrivalProcess):
        with pytest.raises(ValueError):
            make(**bad)
    for mod in (tstream, jstream):
        with pytest.raises(ValueError):
            mod.arrivals_per_round(mod.ArrivalProcess(), 0)


@pytest.mark.parametrize("kind", KINDS)
def test_build_stream_spec_matches_jax(kind):
    """The arrival-driven spec, field by field (the schedule tuples, the
    derived steps and window, metrics forced on), with a failure
    scenario applied and with an explicit drain slack."""
    tspec, jspec = _stream_specs(horizon=300, kind=kind,
                                 failures=dict(crash_s=(1, -1, -1, -1)))
    assert tsim.spec_to_arrays(tspec) == tsim.spec_to_arrays(jspec)
    assert tspec.collect_metrics and tspec.window_slots < tspec.m
    (tb, jb), (ts, js) = _bft1(), _sims(window_slots=96)
    tp, jp = _procs(kind=kind, rate=2.0, seed=3)
    assert tsim.spec_to_arrays(tstream.build_stream_spec(
        tb, tb, ts, tp, 200, drain_slack=17)) == tsim.spec_to_arrays(
        jstream.build_stream_spec(jb, jb, js, jp, 200, drain_slack=17))


# ------------------------------------------------------------ horizon mode

class _CaptureSink:
    """Horizon-mode sink that keeps everything it is handed, as numpy."""

    def __init__(self):
        self.chunks = []
        self.final = None

    def on_chunk(self, t_end, metrics, queue, block, bases):
        self.chunks.append(dict(
            t=int(t_end),
            metrics={f: np.array(getattr(metrics, f))
                     for f in metrics._fields},
            queue={f: np.array(getattr(queue, f)) for f in queue._fields},
            block={f: np.array(getattr(block, f)) for f in block._fields},
            bases=np.array(bases)))

    def on_final(self, state, mc, bases, w, growth_events, t):
        self.final = dict(state=state, mc=mc, bases=np.array(bases),
                          w=int(w), t=int(t),
                          growth=[dataclasses.asdict(e)
                                  for e in growth_events])


def _run_sinks(tspec, jspec):
    ts, js = _CaptureSink(), _CaptureSink()
    assert tsim._run_windowed_batch([tspec], CPU, drain_sink=ts) == []
    assert jsim._run_windowed_batch([jspec], drain_sink=js) == []
    return ts, js


def test_sink_contract_errors_match_jax():
    tspec, jspec = _stream_specs(horizon=128)
    with pytest.raises(ValueError, match="recorder"):
        tsim._run_windowed_batch([tspec], CPU, drain_sink=_CaptureSink(),
                                 recorder=object())
    with pytest.raises(ValueError, match="recorder"):
        jsim._run_windowed_batch([jspec], drain_sink=_CaptureSink(),
                                 recorder=object())
    for run, spec in ((lambda s, **kw: tsim._run_windowed_batch(
            [s], CPU, **kw), tspec),
                      (lambda s, **kw: jsim._run_windowed_batch(
                          [s], **kw), jspec)):
        with pytest.raises(ValueError, match="recorder"):
            run(spec, drain_sink=_CaptureSink(), resume=object())
        bare = dataclasses.replace(spec, collect_metrics=False)
        with pytest.raises(ValueError, match="collect_metrics"):
            run(bare, drain_sink=_CaptureSink())


def test_sink_mode_refuses_dense_fallback_like_jax():
    """A retirement-stalled stream escalates growth until the next
    doubling would reach the horizon: both packages raise, naming the
    same overflow and the same suggested width, and the sink never sees
    the final call."""
    crash = dataclasses.asdict(JFailureScenario.crash_fraction(
        4, 4, 0.25, seed=3, at_step=8))
    tspec, jspec = _stream_specs(horizon=192, failures=crash)
    msgs = []
    for run, spec in ((lambda s, sink: tsim._run_windowed_batch(
            [s], CPU, drain_sink=sink), tspec),
                      (lambda s, sink: jsim._run_windowed_batch(
                          [s], drain_sink=sink), jspec)):
        sink = _CaptureSink()
        with pytest.raises(RuntimeError, match="window overflow") as err:
            run(spec, sink)
        assert sink.final is None
        msgs.append(str(err.value))
    widths = [re.search(r"stream_window_slots >= (\d+)", m).group(1)
              for m in msgs]
    assert widths[0] == widths[1]
    heads = [re.search(r"W=(\d+) -> M=(\d+)\). Lane (\d+)'s dispatch "
                       r"head is (\d+) with GC frontier (\d+)", m).groups()
             for m in msgs]
    assert heads[0] == heads[1]


@pytest.mark.parametrize("k", [1, 8])
def test_capture_sink_matches_jax_on_a_growing_stream(k, monkeypatch):
    """Every on_chunk argument (chunk end, round metrics, queue, block,
    bases) and on_final's (final window, accumulators, bases, width,
    growth events, round) equal the JAX package's, on a stream that
    grows its window twice; at K = 8 a span is cut by the in-graph
    guard, and its discarded chunks reach neither sink."""
    cut = []
    discount = tgraphs.Programs.discount
    monkeypatch.setattr(tgraphs.Programs, "discount",
                        lambda self, key, chunks, of: (
                            cut.append(chunks),
                            discount(self, key, chunks, of))[1])
    g = GROWING
    tspec, jspec = _stream_specs(horizon=g["horizon"], k=k, kind=g["kind"],
                                 rate=g["rate"],
                                 window_slots=g["window_slots"])
    ts, js = _run_sinks(tspec, jspec)
    assert bool(cut) == (k > 1), cut
    assert [c["t"] for c in ts.chunks] == [c["t"] for c in js.chunks]
    assert len(ts.chunks) == -(-tspec.steps // tspec.chunk_steps)
    for tc, jc in zip(ts.chunks, js.chunks):
        for part in ("metrics", "queue", "block"):
            for f, a in tc[part].items():
                _same(a, jc[part][f], (tc["t"], part, f))
        _same(tc["bases"], jc["bases"], (tc["t"], "bases"))
    tf, jf = ts.final, js.final
    assert len(tf["growth"]) == 2 and tf["growth"] == jf["growth"]
    assert (tf["w"], tf["t"]) == (jf["w"], jf["t"]) == (128, tspec.steps)
    _same(tf["bases"], jf["bases"], "final bases")
    for f in ("quack_time", "deliver_time", "retry", "recv_has"):
        _same(getattr(tf["state"], f), getattr(jf["state"], f), f)
    _same(tf["state"].base, np.asarray(jf["state"].base), "final base")
    for f in tf["mc"]._fields:
        _same(getattr(tf["mc"], f), getattr(jf["mc"], f), f)


def test_horizon_mode_equals_batch_mode_and_its_dispatches():
    """The sink's blocks and retired prefixes are batch mode's
    ``ObsMetrics`` per-chunk histograms and frontier trajectory, with
    the same dispatches and syncs; a batch run after a session of the
    spec finds every program (no first use)."""
    g = GROWING
    tspec, _ = _stream_specs(horizon=g["horizon"], k=8, kind=g["kind"],
                             rate=g["rate"], window_slots=g["window_slots"])
    sink = _CaptureSink()
    c0 = (tsim.chunk_dispatch_count(), tsim.host_sync_count())
    tsim._run_windowed_batch([tspec], CPU, drain_sink=sink)
    stream = (tsim.chunk_dispatch_count() - c0[0],
              tsim.host_sync_count() - c0[1])
    f0 = tgraphs.first_use_count()
    c0 = (tsim.chunk_dispatch_count(), tsim.host_sync_count())
    batch = tsim.run_simulation(tspec, device="cpu")
    assert stream == (tsim.chunk_dispatch_count() - c0[0],
                      tsim.host_sync_count() - c0[1])
    assert tgraphs.first_use_count() == f0
    _same(np.stack([c["block"]["latency_hist"][0] for c in sink.chunks]),
          batch.obs.per_chunk_hist, "per-chunk histograms")
    rotating = [c["bases"][0] for c in sink.chunks[:-1]]
    _same([0] + rotating, batch.gc_frontiers, "frontiers")
    _same(sink.final["mc"].latency_hist[0], batch.obs.latency_hist, "hist")


def test_horizon_mode_keeps_no_stream_sized_host_array():
    """tracemalloc: a warm session's host peak is under half of the
    (B, ..., M) mirrors it never allocates, and under a quarter of the
    batch run's peak, on the same spec."""
    (tb, _), (ts, _) = _bft1(), _sims(k=8, window_slots="auto")
    tp, _ = _procs(kind="constant", rate=32.0)
    session = tstream.StreamSession(
        tb, tb, ts, tstream.StreamConfig(horizon=8192, process=tp),
        device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)           # tiny tensors: threads only cost
    peaks = []
    try:
        session.run()                      # captures (first uses)
        for run in (session.run, lambda: tsim.run_simulation(
                session.spec, device="cpu")):
            tracemalloc.start()
            try:
                run()
                peaks.append(tracemalloc.get_traced_memory()[1])
            finally:
                tracemalloc.stop()
    finally:
        torch.set_num_threads(threads)
    spec = session.spec
    mirrors = (2 * spec.n_s * 4 + spec.n_r + 4 + 8) * spec.m
    assert spec.window_slots * 8 < spec.m
    assert peaks[1] > mirrors > 2 * peaks[0], (peaks, mirrors)
    assert peaks[0] * 4 < peaks[1], peaks


class _LiveBytes(TorchDispatchMode):
    """The peak bytes of the distinct storages alive among the tensors
    that the aten ops run under it create or read (each storage counted
    while a tensor seen on it lives: a weakref finalizer on every tensor,
    a count per storage)."""

    def __init__(self):
        super().__init__()
        self.seen, self.refs, self.size = {}, {}, {}
        self.live = self.peak = 0

    def _see(self, t):
        if not isinstance(t, torch.Tensor) or id(t) in self.seen:
            return
        storage = t.untyped_storage()
        if not storage.nbytes():
            return
        key = storage.data_ptr()
        self.seen[id(t)] = weakref.finalize(t, self._gone, id(t), key)
        if key not in self.refs:
            self.refs[key] = 0
            self.size[key] = storage.nbytes()
            self.live += storage.nbytes()
            self.peak = max(self.peak, self.live)
        self.refs[key] += 1

    def _gone(self, tid, key):
        del self.seen[tid]
        self.refs[key] -= 1
        if not self.refs[key]:
            del self.refs[key]
            self.live -= self.size.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in pytree.tree_leaves((args, kwargs, out)):
            self._see(t)
        return out


class _KeepingSink:
    """A sink that keeps the final width and, as the faulty control, one
    ``torch.zeros(keep)`` alive from its first chunk to the run's end."""

    def __init__(self, keep: int = 0):
        self.keep, self.kept, self.w = keep, None, None

    def on_chunk(self, *args):
        if self.keep and self.kept is None:
            self.kept = torch.zeros(self.keep)

    def on_final(self, state, mc, bases, w, growth_events, t):
        self.w = int(w)


@pytest.mark.parametrize("control", [False, True], ids=["flat", "control"])
def test_horizon_mode_device_state_is_independent_of_the_horizon(control):
    """P1 for a resident link: BFT f = 1, ``window_slots="auto"``, 32
    messages a round, at horizons of 2,048 and 16,384 messages. Each
    reading is the peak of the tensor bytes the loop holds (``_LiveBytes``
    over the whole run, the program cache emptied first: the set's state,
    plan and every intermediate) less the padded schedule, 12 bytes a
    message and a window slot at the final width, O(M) by design. The two
    readings agree within W bytes, one byte a window slot, and never a
    bound taken from M: a device tensor of a byte or more a round or
    message over the 14,336 messages between the horizons breaks it (the
    guard's needs, once a 4-byte-a-round table, read 1,792 bytes apart).
    The faulty control keeps ``torch.zeros(m)`` alive through the run
    and must break it."""
    b = tcore.RSMConfig.bft(1)
    sim = tcore.SimConfig(window=1, phi=6, window_slots="auto",
                          chunk_steps=8, superchunk=8)
    reads, widths = [], set()
    for horizon in (2048, 16384):
        spec = tstream.build_stream_spec(
            b, b, sim, tstream.ArrivalProcess(kind="constant", rate=32.0),
            horizon)
        tgraphs.clear_programs()
        sink = _KeepingSink(spec.m if control else 0)
        with _LiveBytes() as mode:
            tsim._run_windowed_batch([spec], CPU, drain_sink=sink)
        reads.append(mode.peak - 12 * (spec.m + sink.w))
        widths.add(sink.w)
    (w,) = widths
    assert w < 2048                  # the window is not the horizon
    assert (abs(reads[1] - reads[0]) > w) == control, (reads, w)


# ---------------------------------------------------------------- sessions

SESSIONS = {
    "single": (dict(horizon=512,
                    process=dict(kind="diurnal", rate=4.0, period=64)),
               {}),
    "chained": (dict(horizon=256, links=3, chained=True), {}),
    "growing": (dict(horizon=GROWING["horizon"],
                     process=dict(kind=GROWING["kind"],
                                  rate=GROWING["rate"]),
                     report_every=2),
                dict(window_slots=GROWING["window_slots"])),
}


def _sessions(name, tmp_path):
    cfg, simkw = SESSIONS[name]
    out = []
    for pkg, mod, b in ((0, tstream, tcore.RSMConfig.bft(1)),
                        (1, jstream, JRSMConfig.bft(1))):
        sim = _sims(**{"window_slots": "auto", **simkw})[pkg]
        kw = dict(cfg)
        if "process" in kw:
            kw["process"] = mod.ArrivalProcess(**kw["process"])
        kw["jsonl_path"] = str(tmp_path / f"live{pkg}.jsonl")
        extra = {"device": "cpu"} if pkg == 0 else {}
        sess = mod.StreamSession(b, b, sim, mod.StreamConfig(**kw), **extra)
        out.append((sess, sess.run()))
    return out


def _assert_sessions_equal(tres, jres, tmp_path):
    td, jd = tres.to_json_dict(), jres.to_json_dict()
    # a trace is a first use in a cached set here, a compilation in the
    # JAX package's process-wide caches: the counts depend on what ran
    # before; dispatches and syncs do not
    for d in (td, jd):
        d["counters"] = {k: v for k, v in d["counters"].items()
                         if k != "traces"}
    assert td == jd
    assert tres.summary().splitlines()[:3] == jres.summary().splitlines()[:3]
    rows = [(tmp_path / f"live{i}.jsonl").read_text().splitlines()
            for i in (0, 1)]
    assert rows[0] == rows[1] and len(rows[0]) == tres.live.total_rows
    assert list(tres.live.rows) == list(jres.live.rows)
    assert tres.live.dashboard() == jres.live.dashboard()
    assert [e.to_dict() for e in tres.slo_events] == \
        [e.to_dict() for e in jres.slo_events]
    _same(tres.sketch.hist, jres.sketch.hist, "sketch")
    for a, b in zip(tres.obs, jres.obs):
        assert a.to_dict() == b.to_dict()
    assert tres.capacity == jres.capacity
    assert tres.final_window_slots == jres.final_window_slots
    assert [dataclasses.asdict(e) for e in tres.growth_events] == \
        [dataclasses.asdict(e) for e in jres.growth_events]
    assert tres.rounds == jres.rounds and tres.problems == [] == \
        jres.problems


@pytest.mark.parametrize("name", list(SESSIONS))
def test_session_matches_jax(name, tmp_path):
    (tsess, tres), (jsess, jres) = _sessions(name, tmp_path)
    assert tsim.spec_to_arrays(tsess.spec) == tsim.spec_to_arrays(jsess.spec)
    _assert_sessions_equal(tres, jres, tmp_path)
    links = tsess.config.links
    assert tres.delivered == tsess.spec.m * links
    if name == "growing":
        assert len(tres.growth_events) == 2


def test_session_dispatches_equal_batch_dispatches():
    """Zero extra dispatches: a session issues exactly the batch run's
    dispatches and host syncs on the identical spec, as in ``repro``."""
    (tb, jb), (ts, js) = _bft1(), _sims()
    counts = []
    for sess, run_batch, counters in (
            (tstream.StreamSession(tb, tb, ts,
                                   tstream.StreamConfig(horizon=512),
                                   device="cpu"),
             lambda s: tsim.run_simulation(s, device="cpu"),
             (tsim.chunk_dispatch_count, tsim.host_sync_count)),
            (jstream.StreamSession(jb, jb, js,
                                   jstream.StreamConfig(horizon=512)),
             jsim.run_simulation,
             (jsim.chunk_dispatch_count, jsim.host_sync_count))):
        c0 = [f() for f in counters]
        res = sess.run()
        stream = [f() - c for f, c in zip(counters, c0)]
        c0 = [f() for f in counters]
        batch = run_batch(sess.spec)
        assert stream == [f() - c for f, c in zip(counters, c0)]
        assert bool((batch.deliver_time >= 0).all())
        assert res.delivered == res.retired == res.sketch.total() == 512
        _same(res.sketch.lane_sum(), batch.obs.latency_hist, "hist")
        counts.append(stream)
    assert counts[0] == counts[1]


def test_sessions_run_on_cuda_unless_told_otherwise(tmp_path):
    """Without a device named, a session, ``run_stream`` and the CLI
    need CUDA: they raise before writing anything."""
    from repro_torch.stream.__main__ import main
    (tb, _), (ts, _) = _bft1(), _sims()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tstream.StreamSession(tb, tb, ts, tstream.StreamConfig(
            horizon=64, jsonl_path=str(tmp_path / "live.jsonl"))).run()
    with pytest.raises(RuntimeError, match="CUDA"):
        tstream.run_stream(tb, tb, ts, tstream.StreamConfig(horizon=64))
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--selftest", "--out", str(tmp_path / "out")])
    assert list(tmp_path.iterdir()) == []


def test_stream_cli_selftest_cpu(tmp_path, capsys):
    from repro_torch.stream.__main__ import main
    assert main(["--selftest", "--device", "cpu",
                 "--out", str(tmp_path)]) == 0
    assert "SELFTEST OK" in capsys.readouterr().out
    for name in ("stream.json", "stream.txt", "live.jsonl", "trace.json"):
        assert (tmp_path / name).exists(), name
    doc = json.loads((tmp_path / "trace.json").read_text())
    assert validate_chrome_trace(doc) == [] == jvalidate(doc)
    assert json.loads((tmp_path / "stream.json").read_text())[
        "delivered"] == 512


def test_stream_cli_session_matches_jax(tmp_path, capsys):
    """A non-selftest CLI session writes the same report as ``repro``'s
    CLI for the same flags."""
    from repro.stream.__main__ import main as jmain
    from repro_torch.stream.__main__ import main as tmain
    flags = ["--horizon", "384", "--kind", "heavytail", "--rate", "3",
             "--links", "2", "--report-every", "2"]
    assert tmain(flags + ["--device", "cpu", "--out",
                          str(tmp_path / "t")]) == 0
    assert jmain(flags + ["--out", str(tmp_path / "j")]) == 0
    docs = [json.loads((tmp_path / p / "stream.json").read_text())
            for p in ("t", "j")]
    for d in docs:
        d["counters"].pop("traces")
    assert docs[0] == docs[1]
    assert (tmp_path / "t" / "live.jsonl").read_text() == \
        (tmp_path / "j" / "live.jsonl").read_text()


# --------------------------------------------------------------- telemetry

def _samples(mod, **kw):
    base = dict(t=0, delivered=0, retired=0, backlog=0, gc_lag=0,
                resends=0, losses=0, throughput=0.0, goodput=0.0,
                resend_rate=0.0, p50=0, p95=0, p99=0, p99_recent=0,
                occupancy_hwm=0, rounds_elapsed=0)
    base.update(kw)
    return mod.LiveSample(**base)


@pytest.mark.parametrize("slo,seq", [
    (dict(p99_latency_rounds=64, resend_rate=None,
          frontier_stall_chunks=None),
     [dict(t=i, p99_recent=p) for i, p in enumerate([10, 100, 120, 90,
                                                     10, 10])]),
    (dict(p99_latency_rounds=None, resend_rate=None,
          frontier_stall_chunks=3),
     [dict(t=i, retired=5, backlog=9) for i in range(6)]
     + [dict(t=6, retired=6, backlog=9)]),
    (dict(p99_latency_rounds=None, resend_rate=0.25,
          frontier_stall_chunks=None),
     [dict(t=i, resend_rate=r) for i, r in enumerate([0.0, 0.5, 0.3,
                                                      0.1, 0.6, 0.2])]),
])
def test_slo_watchdogs_match_jax(slo, seq):
    """Edge-triggered: one event a breach or recovery transition, the
    same events as ``repro``'s watchdog on the same samples."""
    dogs = (tlive.SLOWatchdog(tlive.SLOConfig(**slo)),
            jlive.SLOWatchdog(jlive.SLOConfig(**slo)))
    for kw in seq:
        evs = [d.check(_samples(mod, **kw))
               for d, mod in zip(dogs, (tlive, jlive))]
        assert [e.to_dict() for e in evs[0]] == \
            [e.to_dict() for e in evs[1]]
    assert [e.to_dict() for e in dogs[0].events] == \
        [e.to_dict() for e in dogs[1].events]
    assert dogs[0].events and dogs[0].events[-1].recovered


def test_tracer_no_drains_flag_and_counters_match_jax():
    out = []
    for make in (SpanTracer, JSpanTracer):
        tr = make()
        with tr.span("run", cat="engine"):
            tr.counter("stream/rate", throughput=3.5, goodput=3.0)
            tr.instant("slo:p99_latency", cat="slo", recovered=False)
        first = (tr.no_drains(), tr.to_dict()["no_drains"],
                 tr.to_dict()["counter_samples"],
                 tr.to_dict()["instant_events"], "no_drains" in tr.summary())
        with tr.span("drain_wait", cat="drain"):
            pass
        out.append((first, tr.no_drains(), tr.to_dict()["no_drains"]))
    assert out[0] == out[1] == ((True, True, 1, 1, True), False, False)


def test_chrome_trace_counter_and_instant_schema_matches_jax():
    tr = SpanTracer()
    with tr.span("run", cat="engine"):
        tr.counter("stream/backlog", backlog=12, gc_lag=3)
        tr.instant("slo:resend_rate", cat="slo", value=0.7)
    trace = tr.to_chrome_trace()
    assert validate_chrome_trace(trace) == [] == jvalidate(trace)
    assert {"X", "C", "i"} <= {e["ph"] for e in trace["traceEvents"]}
    bad_counter = {"name": "c", "cat": "counter", "ph": "C", "ts": 0,
                   "pid": 1, "tid": 1, "args": {"v": "high"}}
    bad_instant = {"name": "i", "cat": "slo", "ph": "i", "ts": 0,
                   "pid": 1, "tid": 1, "s": "x", "args": {}}
    for ev in (bad_counter, bad_instant, dict(bad_counter, args={})):
        doc = {"traceEvents": [ev]}
        assert validate_chrome_trace(doc) and \
            validate_chrome_trace(doc) == jvalidate(doc), ev


def test_latency_sketch_merge_and_percentiles_match_jax():
    sketches = []
    for mod in (tlive, jlive):
        a = mod.LatencySketch.empty()
        h = np.zeros_like(np.asarray(a.hist))
        h[0], h[3], h[9] = 90, 10, 3
        b = mod.LatencySketch(hist=h)
        sketches.append(a.merge(b).merge(b))
    t, j = sketches
    assert t.total() == j.total() == 206
    assert t.percentiles((50, 90, 99, 100)) == \
        j.percentiles((50, 90, 99, 100))
    _same(t.hist, j.hist, "merged")


def test_floor_planner_streaming_keeps_no_history_like_jax():
    planners = (FloorPlanner.chain(3, 1000, keep_history=False),
                JFloorPlanner.chain(3, 1000, keep_history=False))
    for bases in ([7, 5, 2], [9, 8, 5]):
        got = [fp(8, np.array(bases)) for fp in planners]
        _same(got[0], got[1], bases)
    for fp in planners:
        assert fp.history == [] and fp.calls == 2
        assert fp.last.tolist() == [1000, 9, 8]
