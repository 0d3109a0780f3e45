"""The port's dry run (``repro_torch.launch.dryrun``) and its pieces.

Held here: every smoke cell's FLOPs (``StepBundle.lower()``) equal the
HLO dot FLOPs of the JAX step exactly, plus the difference
``torch_dryrun_parity.port_minus_jax`` explains op by op (zero for the
train steps of eight configs), and its argument bytes equal
``memory_analysis().argument_size_in_bytes`` plus the arguments that
JAX's jit drops as unused (``torch_dryrun_parity.jax_prunes``; none in
a train step); controls, a dropped layer or a loop counted once without
its trip count, break that equality. A smoke cell's ``run_cell`` allocates nothing off ``meta``
(a dispatch mode raises on any other tensor over 1 MB), its record keeps
the JAX package's keys and states its bases, a resume skips this
backend's cached cells and never the JAX package's, full-size cells on
the production mesh count in seconds, the derived collectives follow the
ring formulas of ``tests/test_roofline.py::test_ring_cost_formulas`` and
a hand-computed sharded leaf, and a (2, 2, 2) smoke cell's argument
bytes a position equal JAX's ``argument_size_in_bytes`` (an 8-device
subprocess, as ``tests/test_sharding.py`` runs its mesh).
"""

import dataclasses
import json

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from helpers import run_py
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.sharding import NamedSharding, P
from repro_torch.roofline import inspect as tinspect
from repro_torch.roofline.collectives import (BASIS, derive_collectives,
                                              ring_wire_bytes)
from repro_torch.configs import list_configs
from repro_torch.roofline import count
from torch_dryrun_parity import (WIRE_CELLS, jax_counts, jax_mesh_cells,
                                 jax_prunes, port_lowered, port_mesh_cell,
                                 port_minus_jax)

ARCHS = list_configs()

# the JAX package's record keys, less compile_s
JAX_KEYS = {"arch", "shape", "mesh", "impl", "tag", "status", "lower_s",
            "hlo_flops_per_chip", "hlo_bytes_per_chip",
            "wire_bytes_per_chip", "model_flops_total", "compute_s",
            "memory_s", "collective_s", "bottleneck", "useful_ratio",
            "collectives", "memory_analysis"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Meta tensors: torch's intra-op threads only cost, and under a
    parallel test run they compete with the other workers'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _NoAllocation(TorchDispatchMode):
    """Raises on any op that makes a tensor off ``meta`` over 1 MB."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.device.type != "meta" \
                    and t.numel() * t.element_size() > 2 ** 20:
                raise AssertionError(f"{func} made {tuple(t.shape)} on "
                                     f"{t.device}")
        return out


@pytest.fixture
def smoke_cells(monkeypatch):
    """The registry's cells at smoke size: every config's ``.smoke()``,
    ``smoke_<kind>`` shapes at S 64 x B 4, and (2, 2, 2) as the
    "multi" mesh."""
    import repro_torch.configs as configs
    import repro_torch.launch.mesh as tmesh

    full = configs.get_config
    monkeypatch.setattr(configs, "get_config",
                        lambda arch: full(arch).smoke())
    for kind in ("train", "prefill", "decode"):
        monkeypatch.setitem(configs.SHAPES, f"smoke_{kind}",
                            ShapeSpec(f"smoke_{kind}", 64, 4, kind))
    monkeypatch.setattr(tmesh, "make_production_mesh",
                        lambda multi_pod, device: make_mesh(
                            (2, 2, 2), ("pod", "data", "model"), device))


def test_the_guard_catches_an_allocation():
    with pytest.raises(AssertionError, match="made"):
        with _NoAllocation():
            torch.zeros((1024, 1024))


@pytest.mark.parametrize("arch,kind", [("granite-8b", "train"),
                                       ("mixtral-8x22b", "prefill"),
                                       ("rwkv6-7b", "decode")])
def test_run_cell_allocates_nothing(arch, kind, tmp_path, smoke_cells):
    out = tmp_path / "r.jsonl"
    with _NoAllocation():
        rec = dryrun.run_cell(arch, f"smoke_{kind}", "multi",
                              out_path=str(out), verbose=False)
    assert rec["status"] == "OK", rec.get("trace")
    assert JAX_KEYS <= set(rec) and "compile_s" not in rec
    assert rec["backend"] == "torch-meta" and rec["hw"] == "H100 SXM5 80GB"
    for key in ("compile_s_absent", "flops_basis", "bytes_basis",
                "per_chip_basis", "collective_basis"):
        assert rec[key]
    assert rec["hlo_flops_per_chip"] > 0 and rec["hlo_bytes_per_chip"] > 0
    assert rec["wire_bytes_per_chip"] > 0
    assert json.loads(out.read_text()) == rec


def test_full_size_cells_on_the_production_mesh(tmp_path):
    """Full width and depth on (16, 16): the counts are the JAX
    package's model figures' size, and a scaled count takes seconds."""
    out = str(tmp_path / "r.jsonl")
    dec = dryrun.run_cell("granite-8b", "decode_32k", "single",
                          out_path=out, verbose=False)
    skip = dryrun.run_cell("granite-8b", "long_500k", "single",
                           out_path=out, verbose=False)
    assert dec["status"] == "OK" and skip["status"] == "SKIP"
    assert skip["reason"] == ("full-attention arch: 500k decode is "
                              "quadratic-cost")
    # the analytic 2 * N_active * B + 4 * L * B * S * d_attn within 10 %
    assert 0.9 < dec["useful_ratio"] < 1.1
    assert dec["lower_s"] < 60


def test_resume_skips_cached_cells_and_never_the_jax_records(tmp_path,
                                                             capsys):
    out = tmp_path / "r.jsonl"
    cached = {"arch": "granite-8b", "shape": "decode_32k", "mesh": "single",
              "impl": "scan", "tag": "", "status": "OK",
              "backend": "torch-meta"}
    jax_rec = {"arch": "granite-8b", "shape": "long_500k", "mesh": "single",
               "impl": "scan", "tag": "", "status": "SKIP", "reason": "x"}
    out.write_text(json.dumps(cached) + "\n" + json.dumps(jax_rec) + "\n")
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "granite-8b", "--shape",
                     "decode_32k,long_500k", "--out", str(out)])
    assert e.value.code == 0
    said = capsys.readouterr().out
    assert "skip (cached): ('granite-8b', 'decode_32k'" in said
    recs = [json.loads(x) for x in out.read_text().splitlines()]
    assert len(recs) == 3
    assert recs[-1]["shape"] == "long_500k"
    assert recs[-1]["backend"] == "torch-meta"
    assert recs[-1]["status"] == "SKIP"
    assert dryrun.DEFAULT_OUT != "dryrun_results.jsonl"


def test_apply_opts_is_the_jax_packages():
    from repro.launch.dryrun import apply_opts as japply
    from repro.configs import get_config as jget
    opts = "moe2d,rwkvblock=16,noremat,rematdots,moedense"
    got = dataclasses.asdict(dryrun.apply_opts(get_config("mixtral-8x22b"),
                                               opts))
    want = dataclasses.asdict(japply(jget("mixtral-8x22b"), opts))
    assert got == want
    with pytest.raises(ValueError, match="unknown opt"):
        dryrun.apply_opts(get_config("granite-8b"), "fast")


# ---------------------------------------------------- the collectives
def test_ring_cost_formulas():
    """``tests/test_roofline.py::test_ring_cost_formulas``' numbers."""
    n = 16 * 16 * 4
    assert ring_wire_bytes("all-reduce", n, 4) == pytest.approx(
        2 * n * 3 / 4)
    assert ring_wire_bytes("all-gather", n, 4) == pytest.approx(n / 4 * 3)
    assert ring_wire_bytes("reduce-scatter", n, 4) == n * 3
    assert ring_wire_bytes("all-to-all", n, 4) == n * 3 / 4
    assert ring_wire_bytes("collective-permute", n, 2) == n


def test_a_hand_computed_sharded_leaf():
    """A (64, 32) f32 leaf split P('data', 'model') on (pod 2, data 2,
    model 4), batch over (pod, data): on a position after the gather it
    is 64 x 8 f32 = 2,048 B; the all-gather over data sends 1,024 B,
    the gradient's reduce-scatter over data 1,024 B, and its all-reduce
    over pod (the shard of 1,024 B) 1,024 B."""
    mesh = make_mesh((2, 2, 4), ("pod", "data", "model"), device="meta")
    leaf = {"w": torch.empty((64, 32), device="meta")}
    shard = {"w": NamedSharding(mesh, P("data", "model"))}
    rules = {"batch": ("pod", "data")}
    got = {c.kind: (c.axes, c.result_bytes, c.wire_bytes_per_chip)
           for c in derive_collectives(leaf, shard, mesh, rules, True)}
    assert got == {"all-gather": (("data",), 2048.0, 1024.0),
                   "reduce-scatter": (("data",), 1024.0, 1024.0),
                   "all-reduce": (("pod",), 1024.0, 1024.0)}
    fwd = derive_collectives(leaf, shard, mesh, rules, False)
    assert [c.kind for c in fwd] == ["all-gather"]
    # replicated over the batch axes: only the gradient's all-reduce
    rep = {"w": NamedSharding(mesh, P(None, "model"))}
    (ar,) = derive_collectives(leaf, rep, mesh, rules, True)
    assert (ar.kind, ar.axes, ar.group_size) == ("all-reduce",
                                                 ("pod", "data"), 4)
    assert ar.wire_bytes_per_chip == 2 * 2048 * 3 / 4


def test_inspect_ranks_the_derived_collectives(smoke_cells):
    header, rows = tinspect.top_collectives("granite-8b", "smoke_train",
                                            "multi", top=5)
    assert BASIS in header[1]
    assert len(rows) == 5
    assert [r[0] for r in rows] == sorted((r[0] for r in rows),
                                          reverse=True)


def test_mesh_cells_match_jax_argument_bytes():
    """(2, 2, 2) smoke cells: the argument bytes a position from the
    recorded PartitionSpecs equal JAX's ``argument_size_in_bytes``; the
    wire bytes are derived (JAX's are the HLO's), so only their
    presence is held here and both stand in PERF.md."""
    jax = jax_mesh_cells(run_py)
    for arch, kind in WIRE_CELLS:
        arg, wire, _ = jax[f"{arch}:{kind}"]
        low = port_mesh_cell(arch, kind)
        assert low.argument_bytes == arg, (arch, kind)
        assert wire > 0 and low.collective_breakdown()["bytes.total"] > 0


# ------------------------------------------- parity with the HLO count
# decode at four configs: no difference, a cross layer's unused k and v
# (llama, whisper), and arguments jit drops (rwkv6, whisper)
HLO_CELLS = ([(a, k) for a in ARCHS for k in ("train", "prefill")]
             + [(a, "decode") for a in ("granite-8b", "llama-3.2-vision-11b",
                                        "rwkv6-7b", "whisper-small")])


@pytest.mark.parametrize("arch,kind", HLO_CELLS)
def test_step_flops_equal_jax_hlo_dots(arch, kind):
    jax_flops, jax_args = jax_counts(arch, kind)
    low = port_lowered(arch, kind)
    assert low.flops == jax_flops + port_minus_jax(arch, kind)
    assert low.argument_bytes == jax_args + jax_prunes(arch, kind)
    if kind == "train" and arch not in ("rwkv6-7b", "hymba-1.5b"):
        assert port_minus_jax(arch, kind) == 0


@pytest.mark.parametrize("arch", ["granite-8b", "rwkv6-7b",
                                  "mixtral-8x22b"])
def test_a_dropped_layer_breaks_the_parity(arch):
    jax_flops, _ = jax_counts(arch, "train")
    want = jax_flops + port_minus_jax(arch, "train")
    assert port_lowered(arch, "train").flops == want
    cut = get_config(arch).smoke().n_layers - 1
    assert port_lowered(arch, "train", n_layers=cut).flops != want


@pytest.mark.parametrize("arch", ["granite-8b", "hymba-1.5b"])
def test_a_loop_counted_once_breaks_the_parity(arch, monkeypatch):
    """The middle iterations counted once instead of n - 2 times: the
    count falls short of the HLO's."""
    jax_flops, _ = jax_counts(arch, "train")
    want = jax_flops + port_minus_jax(arch, "train")
    times = count.Counter.times.__wrapped__

    def once(self, n):
        return times(self, 1)

    monkeypatch.setattr(count.Counter, "times",
                        count.contextlib.contextmanager(once))
    assert port_lowered(arch, "train").flops < want
