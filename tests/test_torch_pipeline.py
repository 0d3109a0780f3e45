"""The torch port's batched sweeps and K-fused superchunk pipeline vs the
JAX package, bit for bit, on the CPU.

One plan is built by the JAX package and carried into the port with
``spec_from_arrays``. At every superchunk K the port must equal the JAX
package at the same K and the port at K = 1 in every output, metric,
GC frontier trajectory, final width and growth event (tolerance 0,
dtypes compared: the state is int32/bool). On the CPU the port runs its
chunk and superchunk programs eagerly, the same functions a CUDA card
replays as graphs (``tests/test_torch_gpu.py`` holds the two together).
"""

import dataclasses

import pytest
import torch

import repro.core.protocols as jprot
import repro.core.retransmit as jret
import repro.core.simulator as jsim
import repro_torch.core as tcore
import repro_torch.core.graphs as tgraphs
import repro_torch.core.protocols as tprot
import repro_torch.core.retransmit as tret
import repro_torch.core.simulator as tsim
from repro.core import FailureScenario as JFailureScenario
from repro.core import NetworkModel as JNetworkModel
from repro.core import RSMConfig as JRSMConfig
from repro.core import SimConfig as JSimConfig
from test_pipeline import FIXTURES, GC_STALL, IDS
from test_torch_windowed import (_assert_outputs_equal,
                                 _assert_windowed_equal, _port_spec)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: torch's intra-op threads only cost, and under a
    parallel test run they compete with the other workers'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


BFT1 = JRSMConfig.bft(1)


def _jspec(simkw, fails, k, **extra):
    return jsim.build_spec(BFT1, BFT1, JSimConfig(debug_checks=True,
                                                  superchunk=k, **simkw,
                                                  **extra), fails)


def _port(jspec, **change):
    return tsim.run_simulation(dataclasses.replace(_port_spec(jspec),
                                                   **change), device="cpu")


def _cut_spans(monkeypatch):
    """Record how many chunk bodies each span's overflow guard cut."""
    cut = []
    discount = tgraphs.Programs.discount

    def spy(self, key, chunks, of):
        cut.append(chunks)
        return discount(self, key, chunks, of)

    monkeypatch.setattr(tgraphs.Programs, "discount", spy)
    return cut


# ------------------------------------ the four pipeline fixtures at K
@pytest.mark.parametrize("k", [2, 8])
@pytest.mark.parametrize("name,simkw,fails", FIXTURES, ids=IDS)
def test_superchunk_matches_jax_and_k1(name, simkw, fails, k, monkeypatch):
    """Port at K == JAX at K == port at K = 1; where the window grows
    inside a span, the guard cuts the span and the host rewinds."""
    jspec = _jspec(simkw, fails, k)
    cut = _cut_spans(monkeypatch)
    fused = _port(jspec)
    _assert_windowed_equal(fused, jsim.run_simulation(jspec))
    _assert_windowed_equal(fused, _port(jspec, superchunk=1))
    if name in ("adaptive_growth", "dense_fallback"):
        assert fused.window_growth_events and any(cut)


# ------------------------------------------------------------ batches
SCENARIOS = [JFailureScenario.none(), GC_STALL,
             JFailureScenario(crash_s=(1, -1, -1, -1)),
             JFailureScenario.crash_fraction(4, 4, 0.33, seed=1)]
BATCH_SIM = dict(n_msgs=128, steps=128 // 4 + 60, window=1, phi=6,
                 window_slots=32, chunk_steps=8)


@pytest.mark.parametrize("k", [1, 8])
def test_windowed_batch_matches_jax_batch(k):
    """The four-scenario sweep of ``test_superchunk_batch_bit_identical``
    through ``run_simulation_batch``: each lane == the JAX package's
    batch lane; at K = 8 each lane's outputs also == its own single run
    (the lanes share one width, so a single run may grow differently)."""
    jspecs = [_jspec(BATCH_SIM, f, k) for f in SCENARIOS]
    got = tsim.run_simulation_batch([_port_spec(s) for s in jspecs],
                                    device="cpu")
    want = jsim.run_simulation_batch(jspecs)
    assert len(got) == len(want) == len(SCENARIOS)
    for tr, jr in zip(got, want):
        _assert_windowed_equal(tr, jr)
    if k == 8:
        for tr, jspec in zip(got, jspecs):
            _assert_outputs_equal(tr, _port(jspec))


def test_dense_batch_matches_jax_batch_and_single_runs():
    simkw = dict(n_msgs=64, steps=70, window=1, phi=6)
    jspecs = [jsim.build_spec(BFT1, BFT1, JSimConfig(**simkw), f)
              for f in SCENARIOS]
    got = tsim.run_simulation_batch([_port_spec(s) for s in jspecs],
                                    device="cpu")
    for tr, jr, jspec in zip(got, jsim.run_simulation_batch(jspecs),
                             jspecs):
        _assert_windowed_equal(tr, jr)
        _assert_windowed_equal(tr, _port(jspec))


@pytest.mark.parametrize("change", [
    dict(n_msgs=160), dict(phi=4), dict(window_slots=48),
    dict(chunk_steps=4), dict(superchunk=4), dict(adaptive_window=False),
    dict(debug_checks=True)], ids=lambda d: next(iter(d)))
def test_require_uniform_batch_refuses(change):
    """Specs that differ outside their failure masks are refused, as the
    JAX package refuses them."""
    pair = [jsim.build_spec(BFT1, BFT1, JSimConfig(**{
        **BATCH_SIM, "superchunk": 8, **c})) for c in ({}, change)]
    with pytest.raises(ValueError, match="differ outside"):
        jsim.require_uniform_batch(pair)
    ported = [_port_spec(s) for s in pair]
    with pytest.raises(ValueError, match="differ outside"):
        tsim.require_uniform_batch(ported)
    with pytest.raises(ValueError, match="differ outside"):
        tsim.run_simulation_batch(ported, device="cpu")


def test_require_uniform_batch_accepts_masks_and_stakes():
    specs = [_port_spec(_jspec(BATCH_SIM, f, 8)) for f in SCENARIOS]
    specs.append(tsim.spec_with_quorum(specs[0], stakes_r=(2, 1, 1, 1),
                                       quack_thresh=3.0))
    tsim.require_uniform_batch(specs)
    assert tsim.run_simulation_batch([], device="cpu") == []


def test_run_picsou_batch_matches_jax():
    cfg = JRSMConfig.bft(2)
    sim = dict(n_msgs=256, steps=140, window_slots=192, chunk_steps=8)
    jscen = [JFailureScenario.none(),
             JFailureScenario.crash_fraction(7, 7, 0.25),
             JFailureScenario(byz_ack_low=(True,) + (False,) * 6)]
    tscen = [tcore.FailureScenario.none(),
             tcore.FailureScenario.crash_fraction(7, 7, 0.25),
             tcore.FailureScenario(byz_ack_low=(True,) + (False,) * 6)]
    jruns = jprot.run_picsou_batch(cfg, cfg, JSimConfig(**sim), jscen)
    tcfg = tcore.RSMConfig.bft(2)
    truns = tprot.run_picsou_batch(tcfg, tcfg, tcore.SimConfig(**sim),
                                   tscen, device="cpu")
    for trun, jrun in zip(truns, jruns):
        assert trun.spec == _port_spec(jrun.spec)
        _assert_windowed_equal(trun.result, jrun.result)
        for stat in ("cross_copies_per_msg", "resends_per_msg",
                     "all_quacked", "all_delivered"):
            assert getattr(trun, stat) == getattr(jrun, stat), stat


# --------------------------------------------- counters and contracts
def test_dispatch_and_sync_counts_shrink():
    """The fixture of ``test_dispatch_and_sync_counts_shrink`` on the
    port's counters: K = 1 dispatches once a chunk; K = 8 at most
    ceil(C / 8) + 2 times; host syncs at most dispatches + 2. From a
    cold program cache, K = 1 captures its two programs and K = 8 only
    the 8-chunk span (its one-chunk tail span and final chunk are K =
    1's); run again, neither captures anything (the reference's warm
    contract) and both dispatch and sync as before."""
    simkw = dict(n_msgs=512, steps=512 // 4 + 40, window=1, phi=6,
                 window_slots=256, chunk_steps=4)
    jspec = _jspec(simkw, JFailureScenario.none(), 8)
    n_chunks = -(-jspec.steps // jspec.chunk_steps)
    tgraphs.clear_programs()
    counts = {}
    for k in (1, 8, 1, 8):
        before = (tsim.chunk_dispatch_count(), tsim.host_sync_count(),
                  tsim.chunk_trace_count())
        res = _port(jspec, superchunk=k)
        after = (tsim.chunk_dispatch_count(), tsim.host_sync_count(),
                 tsim.chunk_trace_count())
        counts.setdefault(k, []).append(
            (res,) + tuple(a - b for a, b in zip(after, before)))
    (r1, disp1, sync1, traces1), (r8, disp8, sync8, traces8) = \
        counts[1][0], counts[8][0]
    _assert_windowed_equal(r1, r8)
    assert disp1 == n_chunks
    assert sync1 >= n_chunks and sync1 <= disp1 + 2
    assert disp8 <= -(-n_chunks // 8) + 2
    assert sync8 <= disp8 + 2
    assert traces1 == 2 and traces8 == 1
    for k, ((_, *cold), (warm_res, *warm)) in counts.items():
        _assert_windowed_equal(warm_res, r1)
        assert warm[:2] == cold[:2] and warm[2] == 0, k


@pytest.mark.parametrize("k", [1, 8])
def test_superchunk_respects_strict_overflow(k):
    sim = tcore.SimConfig(n_msgs=64, steps=40, window=4, phi=6,
                          window_slots=8, chunk_steps=4,
                          adaptive_window=False, superchunk=k)
    spec = tsim.build_spec(tcore.RSMConfig.bft(1), tcore.RSMConfig.bft(1),
                           sim)
    with pytest.raises(ValueError, match="window overflow"):
        tsim.run_simulation(spec, device="cpu")


# ------------------------------------------------ host-only helpers
@pytest.mark.parametrize("stakes,nic", [
    ((1, 1, 1, 1), 1.25e9), ((333, 223, 222, 222), 1.25e9),
    ((5, 1, 1, 1, 1, 1, 1), (2.5e9, 1e9, 1e9, 1e9, 1e9, 1e9, 1e9))])
def test_staked_picsou_throughput_matches_jax(stakes, nic):
    net = JNetworkModel()
    assert tprot.staked_picsou_throughput(
        stakes, nic, tcore.NetworkModel()) == \
        jprot.staked_picsou_throughput(stakes, nic, net)


@pytest.mark.parametrize("args", [(4, 1, 4, 1, 3), (7, 2, 7, 2, 8),
                                  (19, 6, 19, 6, 8), (10, 3, 4, 1, 5)])
def test_empirical_delivery_probability_matches_jax(args):
    kw = dict(trials=2000, seed=3)
    assert tret.empirical_delivery_probability(*args, **kw) == \
        jret.empirical_delivery_probability(*args, **kw)
