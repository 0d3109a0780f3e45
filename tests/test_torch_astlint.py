"""The port's capture-discipline linter (``repro_torch.analysis.astlint``)
against the JAX package's (``repro.analysis.astlint``).

Each rule gets the fixtures of ``tests/test_analysis.py`` in torch idiom:
a snippet that triggers exactly one finding, its twin suppressed with
``# analysis: ignore[rule]``, and negatives for the reads that are not
host syncs (metadata, the builder's Python ints, static parameters).
Beside them: ``JAX_RULES`` covers the JAX linter's rules, the baseline
file parses as the JAX package parses it, the port's tree lints clean
modulo its own baseline (from any working directory), and a copy of the
tree with a ``.item()`` seeded in ``_protocol_step`` and another in a
``core/quack.py`` function that only an import reaches is caught, under
both symbols, by the ``--check`` gate. The decode step's body
(``launch.steps.decode_body``, given to ``Programs.run``) is a capture
context: a copy of the tree whose body reads ``int(pos)``, or whose
attention branches on the position, is caught; a string literal's
membership in a parameter dict (``"bq" in p``) reads keys, no value.
"""

import os
import shutil
import textwrap

import pytest
import torch

import repro.analysis.astlint as jlint
from repro_torch.analysis import astlint
from repro_torch.analysis.__main__ import main
from repro_torch.analysis.astlint import (DEFAULT_BASELINE, JAX_RULES, RULES,
                                          lint_source, lint_tree,
                                          load_baseline, partition)

ROOT = os.path.join(os.path.dirname(__file__), "..")
PORT = os.path.join(ROOT, "src", "repro_torch")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: torch's intra-op threads only cost, and under a
    parallel test run they compete with the other workers'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _lint(src: str):
    return lint_source(textwrap.dedent(src), path="fixture.py")


def _one(src: str, rule: str):
    """Lint a fixture and assert exactly one finding of ``rule``."""
    findings = _lint(src)
    assert [f.rule for f in findings] == [rule], findings
    return findings[0]


def _none(src: str):
    findings = _lint(src)
    assert findings == [], findings


# a body given to Programs.run through a builder, as the engine's loop
# gives _span_program(...)
SEEDED_ITEM_IN_BODY = """
    import torch

    def _build(spec, c: int):
        def body(carry, t0):
            v = carry + t0
            bad = v.item(){SUPPRESS}
            return carry, [bad]

        return body

    def loop(progs, spec):
        return progs.run(("k", 4), _build(spec, 4), 0)
"""

# reads of metadata and of the builder's Python values: never host syncs
METADATA_BODY = """
    import torch

    def _build(spec, c: int, rotate: bool):
        def body(carry, t0):
            n = int(carry.shape[-1]) + int(carry.numel()) + len(carry)
            k = float(c) + int(carry.ndim) + bool(rotate)
            if carry.dtype == torch.bool or carry.device.type == "cuda":
                n += 1
            if n > 2 and c > 1 and rotate:
                n += 1
            if carry.dim() == 3 or len(carry) > 1:
                n += 1
            z = 0 if carry.dtype == torch.bool else 1
            return carry + n + k + z, []

        return body

    def loop(progs, spec):
        return progs.run(("k", 4), _build(spec, 4, True), 0)
"""


def test_rule_host_sync_item_in_program_body():
    """The acceptance seed: a ``.item()`` inside a captured body is
    found, named, and carries the fix-it hint."""
    f = _one(SEEDED_ITEM_IN_BODY.format(SUPPRESS=""), "host-sync")
    assert f.symbol == "_build.body"
    assert ".item()" in f.message
    assert "drain" in f.hint
    assert f.fingerprint() == "host-sync::fixture.py::_build.body"


def test_rule_host_sync_suppressed_inline():
    _none(SEEDED_ITEM_IN_BODY.format(
        SUPPRESS="  # analysis: ignore[host-sync]"))


@pytest.mark.parametrize("expr,word", [
    ("np.asarray(x)", "np.asarray"), ("np.array(x)", "np.array"),
    ("x.cpu()", ".cpu()"), ("x.tolist()", ".tolist()"),
    ("x.numpy()", ".numpy()"), ("x.to('cpu')", ".to('cpu')"),
    ("int(x.sum())", "int()"), ("float(x)", "float()"),
    ("bool(x.any())", "bool()"), ("torch.nonzero(x)", "torch.nonzero"),
    ("x.nonzero()", ".nonzero()"), ("torch.unique(x)", "torch.unique"),
    ("torch.masked_select(x, x > 0)", "torch.masked_select"),
    ("torch.equal(x, x)", "torch.equal")])
def test_rule_host_sync_each_host_read(expr, word):
    src = f"""
        import numpy as np
        import torch

        def step(x, t0):
            y = {expr}{{SUPPRESS}}
            return x, [y]

        def loop(progs):
            return progs.run(("k",), step, 0)
    """
    f = _one(src.format(SUPPRESS=""), "host-sync")
    assert word in f.message and f.symbol == "step"
    _none(src.format(SUPPRESS="  # analysis: ignore[host-sync]"))


def test_rule_host_sync_spares_metadata_and_builder_values():
    _none(METADATA_BODY)


def test_rule_host_sync_outside_a_capture_is_no_finding():
    """The host loop reads the device by design: only capture contexts
    are linted."""
    _none("""
        import numpy as np

        def drain(x):
            return np.asarray(x), x.item(), int(x)
    """)


def test_rule_tensor_branch():
    src = """
        import torch

        def _build(spec, c: int):
            def body(carry, t0):
                y = carry.sum()
                {LINE}
                    y = y * 2
                return carry, [y]

            return body

        def loop(progs, spec):
            return progs.run(("k",), _build(spec, 4), 0)
    """
    f = _one(src.format(LINE="if y > 0:"), "tensor-branch")
    assert "torch.where" in f.message and f.symbol == "_build.body"
    _none(src.format(LINE="if y > 0:  # analysis: ignore[tensor-branch]"))
    _one(src.format(LINE="while t0 < 4:"), "tensor-branch")
    for line in ("assert y.all()", "z = y if y.any() else y"):
        _one(src.replace("{LINE}\n                    y = y * 2", line),
             "tensor-branch")
    # config dispatch (a string compare) and the builder's parameters
    # annotated static are static
    _none("""
        import torch

        def _build(kind: str, n: int):
            def body(carry, t0):
                if kind == "rwkv":
                    carry = carry * 2
                if n > 4:
                    carry = carry + 1
                return carry, []

            return body

        def loop(progs):
            return progs.run(("k",), _build("rwkv", 8), 0)
    """)
    _none(METADATA_BODY)
    # a tensor closed over from the builder (the engine's _Plan) is read
    # on the host all the same: branching on it, or int() of it, in the
    # body is a finding
    closed = """
        import torch

        def _build(spec, plan: _Plan, c: int, k: int):
            def body(carry, t0):
                {LINE}
                return carry, []

            return body

        def loop(progs, spec, plan):
            return progs.run(("k",), _build(spec, plan, 4, 1), 0)
    """
    f = _one(closed.format(LINE="if plan.needs[k][0] > 0: carry = carry + 1"),
             "tensor-branch")
    assert "plan" in f.message and f.symbol == "_build.body"
    f = _one(closed.format(LINE="carry = carry + int(plan.needs[k][0])"),
             "host-sync")
    assert "plan" in f.message
    _none(closed.format(LINE="carry = carry + plan.needs[k][0]"))


def test_rule_tensor_branch_spares_a_string_membership():
    """``"bq" in p`` reads a parameter dict's keys (a tensor holds no
    strings); a tensor's membership test is still a read."""
    src = """
        import torch

        def _build(p):
            def body(carry, t0):
                {LINE}
                    carry = carry + p["bq"]
                return carry, []

            return body

        def loop(progs, p):
            return progs.run(("k",), _build(p), 0)
    """
    _none(src.format(LINE='if "bq" in p:'))
    _none(src.format(LINE='if "bq" not in p:'))
    _one(src.format(LINE="if t0 in p:"), "tensor-branch")


def test_rule_tensor_branch_through_the_graph_block():
    """The statements inside ``with torch.cuda.graph(...)`` are a capture
    context; identity tests there are not value reads."""
    src = """
        import torch

        def capture(body, state, graph):
            with torch.cuda.graph(graph):
                new = body(state)
                for dst, src in zip(state, new):
                    if src is not dst:
                        dst.copy_(src)
                {LINE}
    """
    _none(src.format(LINE="pass"))
    f = _one(src.format(LINE="assert new[0].all()"), "tensor-branch")
    assert f.symbol == "capture"


def test_rule_import_time_tensor():
    f = _one("""
        import torch

        BIG = torch.tensor(2 ** 30)
    """, "import-time-tensor")
    assert "import time" in f.message and f.symbol == "<module>:torch.tensor"
    f = _one("""
        import torch

        class K:
            ON = torch.cuda.is_available()
    """, "import-time-tensor")
    assert f.symbol == "K:torch.cuda.is_available"
    _none("""
        import torch

        BIG = torch.tensor(2 ** 30)  # analysis: ignore[import-time-tensor]
    """)
    _none("""
        import torch

        BIG = 2 ** 30
        I32 = torch.int32
        aten = torch.ops.aten

        def big(device):
            return torch.tensor(BIG, dtype=I32, device=device)
    """)


def test_rule_static_in_state():
    f = _one("""
        from typing import NamedTuple

        import torch

        class Carry(NamedTuple):
            base: torch.Tensor
            rounds: int

        def body(carry, t0):
            return Carry(carry.base + 1, 4), []

        def loop(progs):
            return progs.run(("k",), body, 0)
    """, "static-in-state")
    assert f.symbol == "Carry.rounds" and "freezes" in f.message
    f = _one("""
        import dataclasses

        import torch

        @dataclasses.dataclass(frozen=True)
        class LayoutKey:
            steps: int
            masks: torch.Tensor
    """, "static-in-state")
    assert "LayoutKey.masks" in f.symbol
    _none("""
        import dataclasses

        import torch

        @dataclasses.dataclass(frozen=True)
        class LayoutKey:
            steps: int
            masks: torch.Tensor  # analysis: ignore[static-in-state]
    """)
    # tuple fields in a key, and a NamedTuple built only on the host
    _none("""
        import dataclasses
        from typing import NamedTuple

        @dataclasses.dataclass(frozen=True)
        class LayoutKey:
            steps: int
            masks: tuple

        class Event(NamedTuple):
            step: int

        def record(t):
            return Event(int(t))
    """)


def test_jax_rules_cover_the_jax_linter():
    assert set(JAX_RULES) == set(jlint.RULES)
    for jax_rule, (port_rule, why) in JAX_RULES.items():
        assert port_rule is None or port_rule in RULES, jax_rule
        assert why
    assert {r for r, _ in JAX_RULES.values() if r} == set(RULES)
    assert JAX_RULES["missing-donate"][0] is None


def test_baseline_parses_as_the_jax_package_parses_it():
    path = os.path.join(ROOT, "ANALYSIS_BASELINE.txt")
    assert load_baseline(path) == jlint.load_baseline(path)
    assert load_baseline(path)
    assert load_baseline(DEFAULT_BASELINE) == \
        jlint.load_baseline(DEFAULT_BASELINE)


def test_port_tree_is_clean_modulo_its_baseline():
    """The gate invariant: zero unbaselined findings on the port's tree,
    and no stale baseline entries."""
    findings = lint_tree(os.path.relpath(PORT))
    baseline = load_baseline(DEFAULT_BASELINE)
    new, _ = partition(findings, baseline)
    assert new == [], [f.render() for f in new]
    live = {f.fingerprint() for f in findings}
    assert baseline <= live, f"stale baseline entries: {baseline - live}"


def test_cli_check_from_a_foreign_directory(tmp_path, monkeypatch, capsys):
    """``--check --skip-engine`` exits 0 on the tree from any working
    directory, with relative and absolute roots alike."""
    monkeypatch.chdir(tmp_path)
    assert main(["--check", "--skip-engine"]) == 0
    assert main(["--check", "--skip-engine", "--root",
                 os.path.abspath(PORT)]) == 0
    assert "astlint: 0 finding(s)" in capsys.readouterr().out


def _seed(path, anchor: str, line: str) -> None:
    text = path.read_text()
    assert anchor in text, anchor
    indent = anchor[:len(anchor) - len(anchor.lstrip())]
    path.write_text(text.replace(anchor, f"{anchor}\n{indent}{line}", 1))


def test_seeded_copy_is_caught_across_modules(tmp_path, capsys):
    """A ``.item()`` in ``_protocol_step`` and another in
    ``core/quack.py::missing_below_horizon``, which only the simulator's
    import reaches, are both found under their symbols; ``--check`` exits
    1 on the copy."""
    tree = tmp_path / "src" / "repro_torch"
    shutil.copytree(PORT, tree,
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    _seed(tree / "core" / "simulator.py",
          "    sender_ix = orig_sender.long()", "_seeded = base.item()")
    # the first ``w = received.shape[-1]`` of quack.py is in
    # missing_below_horizon
    _seed(tree / "core" / "quack.py", "    w = received.shape[-1]",
          "_seeded = received.sum().item()")
    found = {f.fingerprint() for f in lint_tree(str(tree))}
    assert found == {
        "host-sync::src/repro_torch/core/simulator.py::_protocol_step",
        "host-sync::src/repro_torch/core/quack.py::missing_below_horizon",
    }, found
    # the quack.py function is reached only through the import
    quack = astlint.lint_paths([str(tree / "core" / "quack.py")])
    assert quack == []
    rc = main(["--check", "--skip-engine", "--root", str(tree),
               "--baseline", DEFAULT_BASELINE])
    out = capsys.readouterr().out
    assert rc == 1
    assert "[host-sync]" in out and "hint:" in out
    assert "core/quack.py" in out and "core/simulator.py" in out


@pytest.mark.parametrize("seed", ["int_pos", "branch_on_pos"])
def test_seeded_decode_step_is_caught(seed, tmp_path, capsys):
    """The decode step's body reaches ``models`` through the package's
    imports: ``int(pos)`` in the body and a Python ``if`` on the
    position in ``blocks.attn_decode_fwd`` are each caught."""
    copy = tmp_path / "src" / "repro_torch"
    shutil.copytree(PORT, copy)
    if seed == "int_pos":
        path, old, new = ("launch/steps.py", "    def body(state, t0):\n",
                          "    def body(state, t0):\n        t0 = int(t0)\n")
        want = ("host-sync", "launch/steps.py", "decode_body.body")
    else:
        path, old, new = ("models/blocks.py",
                          "        posv = pos.reshape(1, 1)",
                          "        if pos > 0:\n            x = x + 1\n"
                          "        posv = pos.reshape(1, 1)")
        want = ("tensor-branch", "models/blocks.py", "attn_decode_fwd")
    target = copy / path
    text = target.read_text()
    assert text.count(old) == 1
    target.write_text(text.replace(old, new))
    found = [(f.rule, f.path.split("repro_torch/")[1], f.symbol)
             for f in lint_tree(str(copy))]
    assert found == [want], found
    assert main(["--check", "--skip-engine", "--root", str(copy),
                 "--baseline", DEFAULT_BASELINE]) == 1
    assert want[0] in capsys.readouterr().out
