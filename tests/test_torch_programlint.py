"""The port's captured-program auditor (``repro_torch.analysis.programlint``)
against the JAX package's jaxpr auditor (``repro.analysis.jaxprlint``).

``python -m repro_torch.analysis --check --device cpu`` runs the three
passes once (a module fixture): its program audit must be clean, with
the JAX auditor's program names, shape and dispatch estimates (the JAX
audit runs once, without lowering, in a module fixture). Controls: a
``.item()``, a ``.nonzero()``, a ``.double()`` and an int64 state leaf
are each caught, and an int64 index made by a conversion is not. The
model zoo's decode step (``model_steps``): no host sync, its caches
written in place (0 copy-back bytes); a decode body that reads
``int(pos)`` is flagged by the auditor and the linter.
``estimate_dispatches`` equals the JAX package's over a grid and the
port engine's counted dispatches at K = 1, 2 and 8.
"""

import json

import pytest
import torch

import repro.analysis.jaxprlint as jlint
import repro_torch.core.simulator as tsim
from repro_torch.analysis.__main__ import main
from repro_torch.analysis.programlint import (BANNED_OPS, audit_callable,
                                              decode_control,
                                              estimate_dispatches)
from repro_torch.core import RSMConfig, SimConfig


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: torch's intra-op threads only cost, and under a
    parallel test run they compete with the other workers'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cli(tmp_path_factory, _one_thread):
    """(exit code, report) of ``--check --device cpu --json``."""
    out = tmp_path_factory.mktemp("analysis") / "ANALYSIS.json"
    rc = main(["--check", "--device", "cpu", "--json", str(out)])
    return rc, json.loads(out.read_text())


@pytest.fixture(scope="module")
def jax_audit():
    return jlint.audit_engine(with_lowered=False)


def test_cli_runs_the_three_passes_clean(cli):
    rc, report = cli
    assert rc == 0 and report["ok"]
    assert list(report) == ["astlint", "jaxpr", "sanitizer", "ok"]
    assert report["astlint"]["new"] == [] and report["astlint"]["ok"]
    assert report["jaxpr"]["ok"], report["jaxpr"]["violations"]
    assert report["sanitizer"]["ok"]


def test_audit_matches_the_jax_auditor(cli, jax_audit):
    port = cli[1]["jaxpr"]
    assert [p["name"] for p in port["programs"]] == \
        [p["name"] for p in jax_audit["programs"]]
    keys = ("m", "steps", "window_slots", "chunk_steps", "superchunk")
    assert {k: port["shape"][k] for k in keys} == \
        {k: jax_audit["shape"][k] for k in keys}
    assert port["dispatch_estimates"] == jax_audit["dispatch_estimates"]
    assert jax_audit["ok"]


def test_audit_reports_bytes_and_no_launch_check_on_the_cpu(cli):
    for prog in cli[1]["jaxpr"]["programs"]:
        assert prog["ok"] and prog["device"] == "cpu"
        assert prog["host_syncs"] == [] and prog["widenings"] == []
        assert prog["arg_bytes"][0] > 0 and prog["arg_bytes"][1] == 4
        # the state leaves that come back as new tensors, which the
        # capture copies back on every replay: all of a span's (its guard
        # selects every leaf), all but the unchanged bases of a dense
        # block's
        assert 0 < prog["copy_back_bytes"] <= prog["arg_bytes"][0]
        if prog["name"] != "dense":
            assert prog["copy_back_bytes"] == prog["arg_bytes"][0]
        assert prog["launches"] is None and prog["launches_no_lost"] is None
        assert "gather" in prog["ops"] and "_to_copy" in prog["ops"]


def test_audit_holds_the_decode_step(cli):
    """The decode step beside the engine's programs: clean, its cache
    leaves written in place (copy-back 0 of their bytes), widenings not
    held (reported)."""
    (prog,) = cli[1]["jaxpr"]["model_steps"]
    assert prog["name"] == "decode" and prog["ok"]
    assert prog["host_syncs"] == [] and prog["cpu_operands"] == []
    assert prog["arg_bytes"][0] > 0 and prog["arg_bytes"][1] == 4
    assert prog["copy_back_bytes"] == 0 and prog["max_copy_back"] == 0
    assert not prog["hold_widenings"] and prog["launches"] is None
    assert "index_copy_" in prog["ops"] and "bmm" in prog["ops"]


def test_audit_and_lint_flag_a_decode_body_reading_int_pos():
    rules, audit = decode_control("cpu")
    assert rules == ["host-sync"]
    assert not audit.ok
    assert any("_local_scalar_dense" in v for v in audit.violations()), \
        audit.violations()


def _state():
    return (torch.arange(4, dtype=torch.int32),
            torch.tensor([True, False, True, False]))


def _body(fn):
    def body(carry, t0):
        a, b = carry
        return (fn(a, b, t0), b), [a + 1]
    return body


CONTROLS = {
    "item": (lambda a, b, t: a + int(a.sum().item()), "host sync"),
    "nonzero": (lambda a, b, t: a + b.nonzero().shape[0], "host sync"),
    "double": (lambda a, b, t: (a.double() * 2).to(torch.int32),
               "torch.float64"),
    "int64_leaf": (lambda a, b, t: a.long(), "int64 state leaf"),
    "int64_sum": (lambda a, b, t: a + a.long().sum().to(torch.int32),
                  "int32->int64"),
}


@pytest.mark.parametrize("name", list(CONTROLS))
def test_audit_catches_each_control(name):
    fn, word = CONTROLS[name]
    audit = audit_callable(_body(fn), _state(), name, "cpu")
    assert not audit.ok
    assert any(word in v for v in audit.violations()), audit.violations()


def test_int64_index_made_by_a_conversion_is_allowed():
    """torch requires int64 indices: a converted index that only views,
    integer arithmetic and index operands read is no widening."""
    def fn(a, b, t):
        ix = ((a.long() * 2 + 1) % 4).reshape(1, 4).expand(2, 4)
        return torch.gather(a.expand(2, 4), 1, ix)[0] + a[ix[1]]
    audit = audit_callable(_body(fn), _state(), "index", "cpu")
    assert audit.ok, audit.violations()
    assert "_local_scalar_dense" in BANNED_OPS


def test_estimate_dispatches_matches_the_jax_package():
    for steps in (1, 4, 7, 40, 64, 168, 1000):
        for c in (1, 3, 4, 32):
            for k in (0, 1, 2, 3, 8):
                assert estimate_dispatches(steps, c, k) == \
                    jlint.estimate_dispatches(steps, c, k), (steps, c, k)


@pytest.mark.parametrize("k", [1, 2, 8])
def test_estimate_dispatches_counts_the_engine(k):
    rsm = RSMConfig.bft(1)
    # the sanitizer's spec (M = 512, C = 42 chunks), whose window never
    # grows: the clean-pipeline plan the estimate describes
    spec = tsim.build_spec(rsm, rsm, SimConfig(
        n_msgs=512, steps=168, window=1, phi=6, window_slots=96,
        chunk_steps=4, superchunk=k))
    before = tsim.chunk_dispatch_count()
    res = tsim.run_simulation(spec, device="cpu")
    assert res.final_window_slots == 96 and not res.window_growth_events
    assert tsim.chunk_dispatch_count() - before == \
        estimate_dispatches(spec.steps, spec.chunk_steps, k)
