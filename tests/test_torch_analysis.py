"""The torch port's runtime contracts (``repro_torch.analysis``) vs the
JAX package's sanitizer (``repro.analysis.sanitizer``), on the CPU.

The sanitizer half of ``tests/test_analysis.py``: the K = 8 dispatch
contract, warm replay resume with zero recompiles (captures; first uses
on the CPU), a seeded implicit transfer caught by every interposed route
while the sanctioned routes (``snapshot.to_host``, ``PinnedDrain``) stay
silent, the violation message naming its ceiling, ``engine_guard``
behind ``debug_checks`` (results bit-equal with it on and off, a transfer
seeded inside the loop raising), ``dispatch_bound`` and the ``--check``
CLI. Each engine run is held to the JAX package's counters on the same
spec. The AST and jaxpr passes of ``repro.analysis`` have their
counterparts in ``repro_torch.analysis.astlint`` and ``programlint``,
held in ``tests/test_torch_astlint.py`` and
``tests/test_torch_programlint.py``.
"""

import dataclasses
import json
import threading

import numpy as np
import pytest
import torch

import repro.analysis.sanitizer as jsan
import repro.core.simulator as jsim
import repro.replay as jrep
import repro_torch.analysis as tan
import repro_torch.core.simulator as tsim
import repro_torch.replay as trep
from repro.core import FailureScenario as JFailureScenario
from repro.core import RSMConfig as JRSMConfig
from repro.core import SimConfig as JSimConfig
from repro_torch.analysis.sanitizer import (DispatchContract, SanitizerError,
                                            dispatch_bound,
                                            dispatch_contract, engine_guard,
                                            sanitized)
from repro_torch.core import snapshot
from test_torch_windowed import _port_spec
from test_windowed import GC_STALL


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: torch's intra-op threads only cost, and under a
    parallel test run they compete with the other workers'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


BFT1 = JRSMConfig.bft(1)
NP_ASARRAY = np.asarray
OUTPUTS = ("quack_time", "deliver_time", "retry", "recv_has",
           "gc_frontiers", "send_step", "delivery_latency")


def _jspec(k: int, **over):
    kw = dict(n_msgs=128, steps=128 // 4 + 40, window=1, phi=6,
              window_slots=64, chunk_steps=4, superchunk=k,
              debug_checks=True)
    kw.update(over)
    return jsim.build_spec(BFT1, BFT1, JSimConfig(**kw))


def _port(spec):
    return tsim.run_simulation(spec, device="cpu")


def _deltas(rep):
    return rep.dispatches, rep.host_syncs, rep.recompiles, rep.transfers


def test_sanitizer_dispatch_contract_k8():
    """The acceptance contract: a K = 8 run fits ceil(C/K) + 2
    dispatches with zero implicit transfers and zero recompiles warm,
    under debug_checks (the engine guard nested inside); the same
    counts as the JAX package's sanitizer."""
    jspec = _jspec(8)
    spec = _port_spec(jspec)
    _port(spec)                                  # warm
    with sanitized(dispatch_contract(spec, warm=True)) as rep:
        _port(spec)
    jsim.run_simulation(jspec)
    with jsan.sanitized(jsan.dispatch_contract(jspec, warm=True)) as jrep_:
        jsim.run_simulation(jspec)
    n_chunks = -(-spec.steps // spec.chunk_steps)
    assert rep.dispatches <= -(-n_chunks // 8) + 2
    assert rep.transfers == () and rep.recompiles == 0
    assert rep.host_syncs <= rep.dispatches + 2
    assert _deltas(rep) == _deltas(jrep_)
    assert rep.to_dict()["contract"] == jrep_.to_dict()["contract"]
    assert rep.ok and rep.closed


def test_sanitizer_warm_replay_resume_zero_recompiles():
    """Replay resume under the sanitizer: zero captures (first uses),
    zero implicit transfers — the recorded parent ran every program the
    resumed tail reuses — and the JAX package's counts."""
    jspec = _jspec(8, n_msgs=96, steps=120, window_slots=24,
                   chunk_steps=8)
    spec = _port_spec(jspec)
    contract = DispatchContract(max_recompiles=0, max_transfers=0,
                                sync_slack=2, label="replay resume")
    r0, trace = trep.record_simulation(spec, every=2, device="cpu")
    mid = int(trace.boundaries()[len(trace.boundaries()) // 2])
    with sanitized(contract) as rep:
        replayed = trep.replay(trace, mid, device="cpu")[0]
    j0, jtrace = jrep.record_simulation(jspec, every=2)
    with jsan.sanitized(jsan.DispatchContract(
            max_recompiles=0, max_transfers=0, sync_slack=2)) as jrep_:
        jrep.replay(jtrace, mid)
    assert rep.recompiles == 0 and rep.transfers == ()
    assert np.array_equal(replayed.deliver_time, r0.deliver_time)
    assert _deltas(rep) == _deltas(jrep_)


# every route by which a tensor silently becomes host data
ROUTES = {
    "np.asarray": lambda x: np.asarray(x),
    "np.array": lambda x: np.array(x),
    "Tensor.numpy": lambda x: x.numpy(),
    "Tensor.item": lambda x: x[0].item(),
    "Tensor.tolist": lambda x: x.tolist(),
    "Tensor.cpu": lambda x: x.cpu(),
    "Tensor.__bool__": lambda x: bool(x[0]),
    "Tensor.__int__": lambda x: int(x[0]),
    "Tensor.__float__": lambda x: float(x[0]),
    "Tensor.__index__": lambda x: [0, 1, 2][x[1]],
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_sanitizer_flags_implicit_transfer(route):
    x = torch.arange(8)
    with pytest.raises(SanitizerError, match="implicit device->host"):
        with sanitized(DispatchContract(max_transfers=0)):
            ROUTES[route](x)
    with sanitized(DispatchContract(max_transfers=None)) as rep:
        ROUTES[route](x)
    assert len(rep.transfers) == 1 and rep.transfers[0].startswith(route)
    # outside a region nothing is interposed
    assert "numpy" not in torch.Tensor.__dict__
    assert np.asarray is NP_ASARRAY


def test_sanitized_routes_and_host_data_stay_silent():
    """The sanctioned routes mark their extent explicit; numpy on host
    data is no transfer."""
    x = torch.arange(8, dtype=torch.int32)
    drain = snapshot.PinnedDrain(torch.device("cpu"))
    with sanitized(DispatchContract(max_transfers=0)) as rep:
        got = snapshot.to_host([x, x > 3])
        waited = drain.wait(drain.start([x]))
        np.asarray([1, 2, 3])
        np.array(got[0])
    assert rep.transfers == ()
    assert np.array_equal(got[0], np.arange(8)) and \
        np.array_equal(waited[0], np.arange(8))


def test_sanitizer_collectors_are_nested_and_thread_aware():
    """Both nested collectors see a transfer; an explicit extent in one
    thread hides nothing of another thread's."""
    x = torch.arange(4)
    seen = threading.Event()
    inside = threading.Event()

    def other():
        with snapshot.explicit():
            inside.set()
            seen.wait(5)

    with sanitized(DispatchContract(max_transfers=None)) as outer:
        with sanitized(DispatchContract(max_transfers=None)) as inner:
            th = threading.Thread(target=other)
            th.start()
            inside.wait(5)
            x.tolist()
            seen.set()
            th.join()
        x.numpy()
    assert len(inner.transfers) == 1
    assert len(outer.transfers) == 2


def test_sanitizer_contract_violation_message_names_ceiling():
    jspec = _jspec(1, n_msgs=32, steps=24, window_slots=32)
    spec = _port_spec(jspec)
    _port(spec)
    tight = DispatchContract(max_dispatches=1, label="tight")
    with pytest.raises(SanitizerError,
                       match=r"dispatches > contract 1 \(tight\)"):
        with sanitized(tight):
            _port(spec)
    jsim.run_simulation(jspec)
    msgs = []
    for mod, run, s in ((tan.sanitizer, _port, spec),
                        (jsan, jsim.run_simulation, jspec)):
        with pytest.raises(mod.SanitizerError) as err:
            with mod.sanitized(mod.DispatchContract(
                    max_dispatches=1, label="tight")):
                run(s)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_engine_guard_behind_debug_checks():
    """debug_checks wires the engine guard: every output bit-equal with
    it on and off, the same counters, and the guard composes with an
    outer sanitized() (both see the counters)."""
    spec = _port_spec(_jspec(4, collect_metrics=True))
    off = dataclasses.replace(spec, debug_checks=False)
    a, b = _port(spec), _port(off)
    for f in OUTPUTS:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert a.obs.to_dict() == b.obs.to_dict()
    reps = []
    for s in (spec, off):
        with sanitized(dispatch_contract(s, warm=True)) as rep:
            _port(s)
        reps.append(_deltas(rep))
    assert reps[0] == reps[1] and reps[0][0] > 0 and reps[0][3] == ()


def test_engine_guard_catches_seeded_transfer():
    x = torch.arange(4)
    with pytest.raises(SanitizerError, match="implicit device->host"):
        with engine_guard():
            np.asarray(x)


def test_debug_checks_catch_a_transfer_inside_the_loop():
    """A host read seeded into the windowed loop (a schedule callback
    calling ``.item()``) raises ``SanitizerError`` under debug_checks and
    passes silently without them."""
    spec = _port_spec(_jspec(1))
    probe = torch.tensor([7])

    def schedule(t):
        probe.item()
        return None

    with pytest.raises(SanitizerError, match="Tensor.item"):
        tsim._run_windowed_batch([spec], torch.device("cpu"),
                                 fail_schedule=schedule)
    off = dataclasses.replace(spec, debug_checks=False)
    tsim._run_windowed_batch([off], torch.device("cpu"),
                             fail_schedule=schedule)


# (SimConfig overrides, failures): a window that grows under a
# GC-stalling adversary, and one that migrates to the dense layout
# (``tests/test_windowed.py``'s fixtures)
GROWTH = {
    "grows": (dict(n_msgs=128, steps=128 // 4 + 40, window_slots=16,
                   chunk_steps=8), GC_STALL),
    "migrates": (dict(n_msgs=64, steps=200, window_slots=16,
                      chunk_steps=8),
                 JFailureScenario(byz_bcast_partial=(True, False, False,
                                                     False),
                                  bcast_limit=2, crash_r=(-1, 8, -1, -1))),
}


@pytest.mark.parametrize("name", list(GROWTH))
def test_engine_guard_holds_across_growth_and_dense_migration(name):
    """Growth and the dense migration move state only through the
    sanctioned routes: no transfer under debug_checks, the JAX package's
    counters, and bit-equal to the run without them."""
    over, fails = GROWTH[name]
    jspec = jsim.build_spec(BFT1, BFT1, JSimConfig(
        window=1, phi=6, superchunk=8, debug_checks=True,
        collect_metrics=True, **over), fails)
    spec = _port_spec(jspec)
    with sanitized(DispatchContract(max_transfers=0)) as rep:
        a = _port(spec)
    with jsan.sanitized(jsan.DispatchContract(max_transfers=0)) as jrep_:
        jsim.run_simulation(jspec)
    assert rep.transfers == ()
    assert _deltas(rep)[:2] == _deltas(jrep_)[:2]
    assert a.window_growth_events
    assert any(e.dense_migration for e in a.window_growth_events) == \
        (name == "migrates")
    b = _port(dataclasses.replace(spec, debug_checks=False))
    for f in OUTPUTS:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


def test_dispatch_bound_shapes_match_jax():
    assert dispatch_bound(168, 4, 8) == -(-42 // 8) + 2
    assert dispatch_bound(168, 4, 1) == 44
    assert dispatch_bound(40, 0, 8) == 3        # dense: one dispatch
    assert dispatch_bound(1, 4, 8) == 3
    for steps in (1, 7, 64, 168, 1000):
        for c in (0, 1, 4, 32):
            for k in (0, 1, 2, 8):
                assert dispatch_bound(steps, c, k) == \
                    jsan.dispatch_bound(steps, c, k), (steps, c, k)
    jspec = _jspec(8)
    for warm in (False, True):
        assert dataclasses.asdict(dispatch_contract(
            _port_spec(jspec), warm=warm)) == dataclasses.asdict(
            jsan.dispatch_contract(jspec, warm=warm))


def test_cli_check_passes_on_cpu(tmp_path, capsys):
    """``python -m repro_torch.analysis --check --device cpu``: a cold and
    a warm run of the JAX CLI's spec under the contract, warm with zero
    recompiles; the JAX CLI's sanitizer section counts the same."""
    from repro.analysis.__main__ import _sanitizer_section
    from repro_torch.analysis.__main__ import main
    out = tmp_path / "ANALYSIS.json"
    assert main(["--check", "--device", "cpu", "--json", str(out)]) == 0
    assert "analysis: ok" in capsys.readouterr().out
    sec = json.loads(out.read_text())["sanitizer"]
    assert sec["ok"] and sec["warm"]["recompiles"] == 0
    assert sec["cold"]["transfers"] == [] == sec["warm"]["transfers"]
    jsec = _sanitizer_section()
    assert sec["shape"] == jsec["shape"]
    for run in ("cold", "warm"):
        assert sec[run]["dispatches"] == jsec[run]["dispatches"]
        assert sec[run]["host_syncs"] == jsec[run]["host_syncs"]
        assert sec[run]["contract"] == jsec[run]["contract"]


def test_cli_needs_cuda_unless_told_otherwise():
    from repro_torch.analysis.__main__ import main
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--check"])
