"""The torch port's dense simulator vs the JAX package, bit for bit.

One plan (``SimSpec``) is built by the JAX package and carried into the
port with ``spec_from_arrays``; both run it densely (the port's step on
one lane at W = M) and every output,
round metric and derived field must agree exactly, dtypes included
(tolerance 0: the state is int32/bool and the float32 stake sums are
exact for the integer stakes used). The port runs on the CPU here
(``device="cpu"``); ``test_torch_gpu.py`` runs it on the card against its
own CPU run.
"""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro_torch.core as tcore
from repro.core import FailureScenario as JFailureScenario
from repro.core import RSMConfig as JRSMConfig
from repro.core import SimConfig as JSimConfig
from repro.core import protocols as jprot
from repro.core import simulator as jsim
from repro_torch.core import protocols as tprot
from repro_torch.core import simulator as tsim
from test_windowed import FIXTURES, IDS, METRICS, OUTPUTS


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: torch's intra-op threads only cost, and under a
    parallel test run they compete with the other workers'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REPO = Path(__file__).resolve().parents[1]
BFT1 = JRSMConfig.bft(1)


def _dense_spec(snd, rcv, simkw, fails):
    return jsim.build_spec(snd, rcv, JSimConfig(**dict(simkw,
                                                      window_slots=None)),
                           fails)


def _port_spec(jspec):
    return tsim.spec_from_arrays(tsim.spec_to_arrays(jspec))


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.array_equal(a, b), what


def _assert_results_equal(tr, jr):
    for f in OUTPUTS + ("send_step", "delivery_latency", "gc_frontiers"):
        _same(getattr(tr, f), getattr(jr, f), f)
    for f in METRICS:
        _same(getattr(tr.metrics, f), getattr(jr.metrics, f), f)
    assert tr.final_window_slots == jr.final_window_slots
    assert tr.completion_step() == jr.completion_step()
    assert tr.delivery_step() == jr.delivery_step()
    assert tr.max_resends_per_msg() == jr.max_resends_per_msg()


def _run_both(jspec):
    tr = tsim.run_simulation(_port_spec(jspec), device="cpu")
    jr = jsim.run_simulation(jspec)
    _assert_results_equal(tr, jr)
    return tr, jr


# ---------------------------------------------- (c) the 12 dense fixtures
@pytest.mark.parametrize("name,snd,rcv,simkw,fails", FIXTURES, ids=IDS)
def test_dense_matches_jax(name, snd, rcv, simkw, fails):
    _run_both(_dense_spec(snd, rcv, simkw, fails))


@pytest.mark.parametrize("name,snd,rcv,simkw,fails", FIXTURES, ids=IDS)
def test_build_spec_matches_jax(name, snd, rcv, simkw, fails):
    """The port's own planner gives the JAX package's plan, field by
    field, and the same state footprint — windowed specs included."""
    jspec = jsim.build_spec(snd, rcv, JSimConfig(**simkw), fails)
    tspec = tsim.build_spec(
        tcore.RSMConfig(**dataclasses.asdict(snd)),
        tcore.RSMConfig(**dataclasses.asdict(rcv)),
        tcore.SimConfig(**simkw),
        tcore.FailureScenario(**dataclasses.asdict(fails)))
    assert tsim.spec_to_arrays(tspec) == tsim.spec_to_arrays(jspec)
    assert tspec.scan_state_nbytes() == jspec.scan_state_nbytes()


# ------------------------------ (d) the JAX package on its Pallas kernel
def test_dense_matches_jax_pallas_quack():
    name, snd, rcv, simkw, fails = FIXTURES[2]          # crash_sender
    jspec = _dense_spec(snd, rcv, dict(simkw, use_pallas_quack=True), fails)
    assert jspec.use_pallas_quack
    _run_both(jspec)


# ------------------------------------------- (e) the adversary palette
_DROPS = tuple(tuple(i == 0 and j in (0, 2) for j in range(4))
               for i in range(4))
ADVERSARIES = [
    ("byz_equiv_send", JFailureScenario(
        byz_equiv_send=(True, False, False, False),
        drop_pair=tuple(tuple(j == 1 for j in range(4)) for _ in range(4)))),
    ("byz_ack_stale", JFailureScenario(
        byz_ack_stale=(False, True, False, False), crash_r=(-1, -1, -1, 8))),
    ("byz_hq_advance", JFailureScenario(byz_hq_advance=(0, 2, 0, 0),
                                        crash_s=(-1, -1, 5, -1))),
    ("drop_pair", JFailureScenario(drop_pair=_DROPS)),
]


@pytest.mark.parametrize("kind,fails", ADVERSARIES,
                         ids=[a[0] for a in ADVERSARIES])
def test_adversary_matches_jax(kind, fails):
    jspec = jsim.build_spec(BFT1, BFT1, JSimConfig(n_msgs=48, steps=96,
                                                   window=2, phi=3, seed=7),
                            fails)
    tr, _ = _run_both(jspec)
    assert tr.total_cross_msgs() > 0


# --------------------------------------------- (f) stake re-weighting
def test_quorum_reweight_matches_jax():
    fails = JFailureScenario(crash_r=(-1, -1, -1, 10),
                             byz_ack_stale=(False, True, False, False))
    jspec = jsim.build_spec(BFT1, BFT1, JSimConfig(n_msgs=48, steps=120,
                                                   window=2, phi=3), fails)
    jspec = jsim.spec_with_quorum(jspec, stakes_r=(2.0, 1.0, 1.0, 1.0),
                                  quack_thresh=3.0, dup_thresh=3.0)
    _run_both(jspec)
    # the port's own re-weight gives the same plan
    tspec = tsim.spec_with_quorum(
        _port_spec(jsim.build_spec(BFT1, BFT1, JSimConfig(
            n_msgs=48, steps=120, window=2, phi=3), fails)),
        stakes_r=(2.0, 1.0, 1.0, 1.0), quack_thresh=3.0, dup_thresh=3.0)
    assert tsim.spec_to_arrays(tspec) == tsim.spec_to_arrays(jspec)
    with pytest.raises(ValueError, match="length"):
        tsim.spec_with_quorum(tspec, stakes_r=(1.0, 1.0))


def test_spec_failures_round_trip():
    fails = ADVERSARIES[0][1]
    tspec = _port_spec(jsim.build_spec(BFT1, BFT1, JSimConfig(), fails))
    again = tsim.spec_with_failures(tspec, tsim.spec_failures(tspec))
    assert again == tspec
    assert tsim.retire_safety_stakes_ok(tspec) == \
        jsim.retire_safety_stakes_ok(jsim.build_spec(BFT1, BFT1,
                                                     JSimConfig(), fails))


# ------------------------------------------- one round from a carried state
def test_step_from_carried_jax_state():
    """A state the JAX engine reached mid-run, carried over as one lane of
    the port's lane-batched state with ``state_from_numpy``, steps to the
    same next state in the port (``t`` a device scalar, as in a run)."""
    name, snd, rcv, simkw, fails = FIXTURES[4]          # crash_plus_byz
    k = 40
    jspec = _dense_spec(snd, rcv, dict(simkw, steps=k), fails)
    carry, _ = jsim._compiled_sim(jsim._neutral(jspec))(
        jsim._fail_arrays(jspec))
    state_np = jax.device_get(carry)
    jstep = jsim._protocol_step(jspec, jsim._fail_arrays(jspec),
                                jsim._sched_arrays(jspec), 0, jspec.m)
    jnext, jms = jax.device_get(jax.jit(jstep)(carry, np.int32(k)))

    tspec = _port_spec(jspec)
    dev = torch.device("cpu")
    state = tsim.state_from_numpy([np.asarray(x)[None] for x in state_np],
                                  dev)
    sched_w = tsim._sched_window(tsim._padded_sched(tspec, tspec.m, dev),
                                 state.base, tspec.m)
    tstep = tsim._protocol_step(tspec, tsim._fail_arrays([tspec], dev),
                                tsim._rotation_seqs(tspec, dev), sched_w,
                                state.base, tspec.m)
    tnext, tms = tstep(state, torch.tensor(k, dtype=torch.int32))
    for f in tsim.SimState._fields:
        _same(getattr(tnext, f)[0].numpy(), getattr(jnext, f), f)
    _same(tms[0].numpy(), np.asarray(jms, dtype=np.int32), "metrics")


# -------------------------------------------------- (g) run_picsou
def test_run_picsou_matches_jax():
    cfg = JRSMConfig.bft(2)
    fails = JFailureScenario.crash_fraction(7, 7, 0.25)
    sim = dict(n_msgs=512, steps=240)
    jrun = jprot.run_picsou(cfg, cfg, JSimConfig(**sim), fails)
    tcfg = tcore.RSMConfig.bft(2)
    trun = tprot.run_picsou(tcfg, tcfg, tcore.SimConfig(**sim),
                            tcore.FailureScenario.crash_fraction(7, 7, 0.25),
                            device="cpu")
    assert trun.spec == _port_spec(jrun.spec)
    for stat in ("cross_copies_per_msg", "intra_copies_per_msg",
                 "resends_per_msg", "all_quacked", "all_delivered"):
        assert getattr(trun, stat) == getattr(jrun, stat), stat
    assert trun.quack_throughput_per_step() == \
        jrun.quack_throughput_per_step()
    assert trun.all_delivered and trun.resends_per_msg > 0
    _assert_results_equal(trun.result, jrun.result)


def test_analytic_throughput_matches_jax():
    net_t, net_j = tcore.NetworkModel.geo(), jprot.NetworkModel.geo()
    for proto in ("picsou", "ata", "ost"):
        t = tcore.analytic_throughput(proto, tcore.RSMConfig.bft(3),
                                      tcore.RSMConfig.bft(3), net_t)
        j = jprot.analytic_throughput(proto, JRSMConfig.bft(3),
                                      JRSMConfig.bft(3), net_j)
        assert t == j, proto


# ------------------------------------------- engine limits of this slice
def test_windowed_and_metrics_raise_not_implemented():
    """Neither a windowed spec nor ``collect_metrics`` raises any more:
    both run (``tests/test_torch_windowed.py`` and
    ``tests/test_torch_obs.py`` hold them to ``repro``)."""
    spec = tsim.build_spec(tcore.RSMConfig.bft(1), tcore.RSMConfig.bft(1),
                           tcore.SimConfig(n_msgs=256, window_slots=64))
    res = tsim.run_simulation(spec, device="cpu")
    assert spec.window_slots == 64 and res.final_window_slots >= 64
    assert res.gc_frontiers[-1] > 0 and res.delivery_step() >= 0
    spec = tsim.build_spec(tcore.RSMConfig.bft(1), tcore.RSMConfig.bft(1),
                           tcore.SimConfig(n_msgs=64, steps=4,
                                           collect_metrics=True))
    res = tsim.run_simulation(spec, device="cpu")
    assert res.obs is not None
    assert res.obs.total_counted() == int((res.deliver_time >= 0).sum())


def test_auto_window_clamped_to_dense_runs():
    spec = tsim.build_spec(tcore.RSMConfig.bft(1), tcore.RSMConfig.bft(1),
                           tcore.SimConfig(n_msgs=64, steps=30,
                                           window_slots="auto"))
    assert spec.window_slots == 0
    res = tsim.run_simulation(spec, device="cpu")
    assert res.final_window_slots == 64 and res.delivery_step() >= 0


def test_spec_from_arrays_rejects_unknown_fields():
    d = tsim.spec_to_arrays(_port_spec(jsim.build_spec(BFT1, BFT1)))
    d["not_a_field"] = 1
    with pytest.raises(TypeError, match="not_a_field"):
        tsim.spec_from_arrays(d)


# ------------------------------------------ (i) the device is never guessed
def test_run_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = _port_spec(jsim.build_spec(BFT1, BFT1, JSimConfig(n_msgs=8,
                                                             steps=2)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsim.run_simulation(spec)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tprot.run_picsou(tcore.RSMConfig.bft(1), tcore.RSMConfig.bft(1),
                         tcore.SimConfig(n_msgs=8, steps=2))


# ------------------------------------ (h) the port stands alone from JAX
def _port_sources():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    examples = sorted((REPO / "examples" / "torch").glob("*.py"))
    assert len(examples) == 5, examples
    return files + examples + [REPO / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_port_imports_neither_jax_nor_repro():
    files = _port_sources()
    assert len(files) > 10 and all(f.exists() for f in files)
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                bad += [(f.name, a.name) for a in node.names
                        if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom):
                if node.level == 0 and node.module and \
                        _forbidden(node.module):
                    bad.append((f.name, node.module))
    assert not bad, bad


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = ("import sys, repro_torch, repro_torch.core.protocols, "
            "repro_torch.kernels.ops; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
