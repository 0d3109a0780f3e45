"""The torch port's §6 applications vs the JAX package, field by field.

Every disaster-recovery and reconciliation fixture of
``tests/test_apps.py`` runs through ``repro.apps`` and through
``repro_torch.apps``, on the port's engine on the CPU
(``device="cpu"``) and on its numpy mirror (``use_reference=True``).
Every report field must be equal: the election, both prefix maps, the
convergence verdict and the recovered log; the rounds, the merged stores
and the entries exchanged; and the per-link outputs underneath.
``test_torch_gpu.py`` and ``chip_smoke.py`` run the applications on the
card against these CPU runs.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import repro.apps as japps
import repro_torch.apps as tapps
import repro_torch.core as tcore
from test_apps import BFT1 as JBFT1
from test_apps import DR_FIXTURES, RECON_FIXTURES, RECON_SIM, SIM


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: torch's intra-op threads only cost, and under a
    parallel test run they compete with the other workers'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


OUTPUTS = ("quack_time", "deliver_time", "retry", "recv_has")
BFT1 = tcore.RSMConfig.bft(1)
DR_IDS = [f[0] for f in DR_FIXTURES]
RECON_IDS = [f[0] for f in RECON_FIXTURES]
ENGINES = [False, True]
ENGINE_IDS = ["engine", "reference"]


def _port(cls, obj):
    return cls(**dataclasses.asdict(obj))


def _fails(fails):
    return {k: _port(tcore.FailureScenario, f) for k, f in fails.items()}


def _dr_args(crash_at, fails):
    backups = sorted({"backup-0", "backup-1"} | set(fails))
    return dict(backups=backups, crash_at=crash_at)


@functools.lru_cache(maxsize=None)
def _jax_dr(name):
    _, crash_at, fails = next(f for f in DR_FIXTURES if f[0] == name)
    return japps.run_disaster_recovery(JBFT1, JBFT1, SIM,
                                       backup_failures=fails,
                                       **_dr_args(crash_at, fails))


def _port_dr(name, use_reference, **extra):
    _, crash_at, fails = next(f for f in DR_FIXTURES if f[0] == name)
    device = None if use_reference else "cpu"
    return tapps.run_disaster_recovery(
        BFT1, BFT1, _port(tcore.SimConfig, SIM),
        backup_failures=_fails(fails), use_reference=use_reference,
        device=device, **_dr_args(crash_at, fails), **extra)


def _assert_links_equal(tres, jres):
    assert list(tres.links) == list(jres.links)
    for lname in tres.links:
        for out in OUTPUTS:
            assert np.array_equal(
                np.asarray(getattr(tres[lname].result, out)),
                np.asarray(getattr(jres[lname].result, out))), (lname, out)
        assert np.array_equal(tres[lname].commit_floors,
                              jres[lname].commit_floors), lname


# ------------------------------------------------- disaster recovery
@pytest.mark.parametrize("use_reference", ENGINES, ids=ENGINE_IDS)
@pytest.mark.parametrize("name", DR_IDS)
def test_disaster_recovery_matches_jax(name, use_reference):
    """Every field of the port's report == the JAX package's engine
    report, and every link of both phases underneath."""
    rep, ref = _port_dr(name, use_reference), _jax_dr(name)
    assert rep.elected == ref.elected
    assert rep.phase1_prefixes == ref.phase1_prefixes
    assert rep.final_prefixes == ref.final_prefixes
    assert rep.converged == ref.converged
    assert rep.recovered_log.dtype == ref.recovered_log.dtype
    assert np.array_equal(rep.recovered_log, ref.recovered_log)
    assert rep.recovered_entries == ref.recovered_entries
    assert rep.injected_at is None and rep.phase1_trace is None
    _assert_links_equal(rep.phase1, ref.phase1)
    assert (rep.phase2 is None) == (ref.phase2 is None)
    if rep.phase2 is not None:
        _assert_links_equal(rep.phase2, ref.phase2)


@pytest.mark.parametrize("name", DR_IDS)
def test_disaster_recovery_semantics(name):
    """The election picks a most-caught-up backup and every backup ends
    on the elected log."""
    rep = _port_dr(name, use_reference=False)
    assert rep.phase1_prefixes[rep.elected] == max(
        rep.phase1_prefixes.values())
    assert rep.converged
    for b, p in rep.final_prefixes.items():
        assert p == rep.recovered_entries, b
    assert np.array_equal(rep.recovered_log,
                          np.arange(rep.recovered_entries))


def test_disaster_recovery_carries_payloads():
    """The recovered log holds the payloads, not their indices."""
    payloads = np.arange(SIM.n_msgs, dtype=np.int64) * 7 + 3
    rep = tapps.run_disaster_recovery(
        BFT1, BFT1, _port(tcore.SimConfig, SIM), crash_at=10,
        payloads=payloads, device="cpu")
    assert np.array_equal(rep.recovered_log,
                          payloads[:rep.recovered_entries])
    with pytest.raises(ValueError, match="payloads"):
        tapps.run_disaster_recovery(
            BFT1, BFT1, _port(tcore.SimConfig, SIM),
            payloads=payloads[:-1], device="cpu")
    with pytest.raises(ValueError, match=">= 2 backups"):
        tapps.run_disaster_recovery(
            BFT1, BFT1, _port(tcore.SimConfig, SIM), backups=("only",),
            device="cpu")


@pytest.mark.parametrize("use_reference", ENGINES, ids=ENGINE_IDS)
def test_inject_via_replay_raises(use_reference):
    """``inject_via_replay`` is ported (``repro_torch.replay``): it no
    longer raises ``NotImplementedError``. The injected report == the
    static one and == the JAX package's injected report, field by field;
    what still raises is what raises in the JAX package (one backup)."""
    _, crash_at, fails = next(f for f in DR_FIXTURES
                              if f[0] == "crash_late")
    injected = _port_dr("crash_late", use_reference, inject_via_replay=True)
    static = _port_dr("crash_late", use_reference)
    jinjected = japps.run_disaster_recovery(
        JBFT1, JBFT1, SIM, backup_failures=fails, inject_via_replay=True,
        use_reference=use_reference, **_dr_args(crash_at, fails))
    for other in (static, jinjected):
        assert injected.elected == other.elected
        assert injected.phase1_prefixes == other.phase1_prefixes
        assert injected.final_prefixes == other.final_prefixes
        assert injected.converged == other.converged
        assert np.array_equal(injected.recovered_log, other.recovered_log)
    assert injected.injected_at == jinjected.injected_at
    assert (injected.phase1_trace is None) == use_reference
    _assert_links_equal(injected.phase1, jinjected.phase1)
    with pytest.raises(ValueError, match="2 backups"):
        tapps.run_disaster_recovery(
            BFT1, BFT1, _port(tcore.SimConfig, SIM), backups=("only",),
            crash_at=crash_at, inject_via_replay=True,
            use_reference=use_reference,
            device=None if use_reference else "cpu")


# --------------------------------------------------- reconciliation
@functools.lru_cache(maxsize=None)
def _jax_recon(name):
    _, mk, sim, fails = next(f for f in RECON_FIXTURES if f[0] == name)
    return japps.run_reconciliation(JBFT1, mk(), sim, failures=fails)


def _port_recon(name, use_reference):
    _, mk, sim, fails = next(f for f in RECON_FIXTURES if f[0] == name)
    return tapps.run_reconciliation(
        BFT1, mk(), _port(tcore.SimConfig, sim), failures=_fails(fails),
        use_reference=use_reference,
        device=None if use_reference else "cpu")


@pytest.mark.parametrize("use_reference", ENGINES, ids=ENGINE_IDS)
@pytest.mark.parametrize("name", RECON_IDS)
def test_reconciliation_matches_jax(name, use_reference):
    """Rounds, verdict, merged stores and entries exchanged == the JAX
    package's, and every link of every session underneath."""
    r, ref = _port_recon(name, use_reference), _jax_recon(name)
    assert r.rounds == ref.rounds
    assert r.converged == ref.converged
    assert r.stores == ref.stores
    assert r.exchanged == ref.exchanged
    assert len(r.sessions) == len(ref.sessions)
    for ts, js in zip(r.sessions, ref.sessions):
        _assert_links_equal(ts, js)


@pytest.mark.parametrize("name", RECON_IDS)
def test_reconciliation_converges_to_lww_union(name):
    _, mk, _, _ = next(f for f in RECON_FIXTURES if f[0] == name)
    expect: dict = {}
    for s in mk().values():
        tapps.lww_merge(expect, [(k, v, ver) for k, (v, ver) in s.items()])
    r = _port_recon(name, use_reference=False)
    assert r.converged, r.rounds
    for n, s in r.stores.items():
        assert s == expect, n


def test_reconciliation_already_converged_is_a_noop():
    stores = {"a": {1: (2, 3)}, "b": {1: (2, 3)}}
    r = tapps.run_reconciliation(BFT1, stores,
                                 _port(tcore.SimConfig, RECON_SIM),
                                 device="cpu")
    assert r.rounds == 0 and r.converged and r.exchanged == 0
    with pytest.raises(ValueError, match=">= 2 stores"):
        tapps.run_reconciliation(BFT1, {"a": {}},
                                 _port(tcore.SimConfig, RECON_SIM),
                                 device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lww_merge_matches_jax_and_is_order_free(seed):
    """``lww_merge`` == the JAX package's on random entries (same store,
    same count of changes), and commutative and idempotent: any order of
    the same entries, merged again, gives the same store."""
    rng = np.random.default_rng(seed)
    entries = [tuple(int(x) for x in row) for row in
               rng.integers(0, 6, size=(40, 3))]
    a, b = {}, {}
    assert tapps.lww_merge(a, entries) == japps.lww_merge(b, entries)
    assert a == b
    c: dict = {}
    for i in rng.permutation(len(entries)):
        tapps.lww_merge(c, [entries[i]])
    assert c == a
    assert tapps.lww_merge(c, entries) == 0 and c == a


def test_lww_merge_resolves_by_version_then_value():
    entries = [(1, 5, 2), (1, 9, 1), (2, 3, 3), (1, 5, 2), (2, 4, 3)]
    store: dict = {}
    tapps.lww_merge(store, entries)
    assert store == {1: (5, 2), 2: (4, 3)}


# --------------------------------------------- what the port refuses
def test_app_entry_points_raise_without_cuda(monkeypatch):
    """With no card and no device named the apps raise, even a
    reconciliation with nothing to exchange; the numpy mirror needs no
    device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sim = _port(tcore.SimConfig, SIM)
    with pytest.raises(RuntimeError, match="CUDA"):
        tapps.run_disaster_recovery(BFT1, BFT1, sim)
    with pytest.raises(RuntimeError, match="CUDA"):
        tapps.run_reconciliation(BFT1, {"a": {1: (2, 3)}, "b": {1: (2, 3)}},
                                 _port(tcore.SimConfig, RECON_SIM))
    rep = tapps.run_disaster_recovery(BFT1, BFT1, sim, use_reference=True)
    assert rep.converged
