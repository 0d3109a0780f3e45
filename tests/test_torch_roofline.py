"""The port's roofline counts vs the JAX package's.

``repro_torch.roofline`` counts a step's aten ops on ``meta`` tensors
(``count``) where ``repro.roofline`` reads XLA's compiled HLO. Held here:

* ``model_flops`` and ``roofline_terms`` equal the JAX package's (pure
  arithmetic on the configs; ``HW()`` is the JAX package's TPU v5e), and
  ``report.table`` renders the same text from one results file;
* the counter's conventions on single ops (a matmul is 2·M·N·K FLOPs and
  reads and writes its operands once), and a scaled loop's count equal
  to the unscaled one, FLOPs and bytes, at every smoke config and step
  kind (with remat at four layers too);
and the counts of whole steps against the JAX package's HLO are
``tests/test_torch_dryrun.py``'s.
"""

import dataclasses
import json

import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.roofline import report as jreport
from repro.roofline.model import HW as J_HW
from repro.roofline.model import model_flops as j_model_flops
from repro.roofline.model import roofline_terms as j_roofline_terms
from repro_torch.configs import SHAPES, ShapeSpec, get_config, list_configs
from repro_torch.launch import steps as TS
from repro_torch.launch.mesh import make_mesh
from repro_torch.roofline import (HW, HW_H100, model_flops, report,
                                  roofline_terms)
from repro_torch.roofline import count
from torch_dryrun_parity import KINDS

ARCHS = list_configs()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Meta tensors and smoke sizes: torch's intra-op threads only cost,
    and under a parallel test run they compete with the other
    workers'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------- the analytic model
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equals_jax(arch, shape):
    assert model_flops(get_config(arch), SHAPES[shape]) == \
        j_model_flops(j_get_config(arch), J_SHAPES[shape])


def test_roofline_terms_equal_jax_at_the_v5e():
    assert HW().peak_flops == J_HW().peak_flops
    for f, b, w in [(197e12, 819e9, 50e9), (1.234e15, 5.6e10, 7.0e8),
                    (0.0, 1.0, 3.0)]:
        assert roofline_terms(f, b, w, HW()) == j_roofline_terms(f, b, w,
                                                                J_HW())
    t = roofline_terms(989e12, 3.35e12, 450e9, HW_H100)
    assert t == {"compute_s": 1.0, "memory_s": 1.0, "collective_s": 1.0}


def test_report_table_equals_jax(tmp_path):
    path = tmp_path / "results.jsonl"
    ok = dict(status="OK", compute_s=0.25, memory_s=1.5, collective_s=0.01,
              bottleneck="memory", useful_ratio=0.765)
    recs = [
        dict(arch="granite-8b", shape="train_4k", mesh="single", **ok),
        dict(arch="granite-8b", shape="long_500k", mesh="single",
             status="SKIP", reason="full-attention arch"),
        dict(arch="rwkv6-7b", shape="decode_32k", mesh="single",
             status="FAIL", error="RuntimeError: " + "x" * 90),
        dict(arch="qwen2-72b", shape="prefill_32k", mesh="multi", **ok),
        dict(arch="hymba-1.5b", shape="train_4k", mesh="single",
             impl="triangular", **ok),
        dict(arch="mixtral-8x22b", shape="train_4k", mesh="single",
             tag="moe2d", **dict(ok, compute_s=0.0, memory_s=0.0,
                                 collective_s=0.0)),
    ]
    path.write_text("\n".join(json.dumps(r) for r in recs) + "\nnot json\n")
    for args in [("single",), ("multi",), ("single", "triangular"),
                 ("single", "scan", "moe2d")]:
        assert report.table(str(path), *args) == \
            jreport.table(str(path), *args)
    assert report.table(str(path), "single").count("\n") == 4


# ------------------------------------------------------- the counter
def test_matmul_flop_and_byte_convention():
    a = torch.empty((512, 256), device="meta")
    b = torch.empty((256, 128), device="meta")
    with count.Counter() as c:
        a @ b
    assert c.flops == 2 * 512 * 256 * 128
    assert c.bytes == (512 * 256 + 256 * 128 + 512 * 128) * 4
    with count.Counter() as c:
        a.reshape(-1).view(256, 512).t()[1:]      # views move nothing
    assert (c.flops, c.bytes) == (0, 0)


@pytest.mark.parametrize("grad", [False, True])
def test_loop_counts_its_trip_count(grad):
    """``count.loop`` of 7 iterations of c @ w: 7 products (and 14 more
    in the backward), whether the counter scales the loop or not."""
    w = torch.empty((64, 64), device="meta", requires_grad=grad)
    x = torch.empty((64, 64), device="meta", requires_grad=grad)

    def body(i, carry, shared):
        return (carry[0] @ shared[0],), carry[0][i]

    got = []
    for scale in (False, True):
        with count.Counter(scale_loops=scale) as c:
            (y,), ys = count.loop(7, body, (x,), (w,))
            assert ys.shape == (7, 64)
            if grad:
                torch.autograd.grad(y.sum() + ys.sum(), (x, w))
        got.append((c.flops, c.bytes))
    assert got[0] == got[1]
    assert got[0][0] == (3 if grad else 1) * 7 * 2 * 64 ** 3


def test_loop_without_a_counter_runs_every_iteration():
    seen = []

    def body(i, carry, shared):
        seen.append(i)
        return (carry[0] + shared[0][i],), carry[0]

    x = torch.zeros(3)
    (y,), ys = count.loop(5, body, (x,), (torch.ones(5, 3),))
    assert seen == [0, 1, 2, 3, 4]
    assert torch.equal(y, torch.full((3,), 5.0))
    assert torch.equal(ys[:, 0], torch.arange(5.0))


def _count(arch, kind, scale, **cfg_changes):
    cfg = dataclasses.replace(get_config(arch).smoke(), **cfg_changes)
    mesh = make_mesh((1, 1), ("data", "model"), device="meta")
    b = TS.build_step(cfg, mesh, ShapeSpec("t", 64, 2, kind))
    args = b.in_shapes if kind != "decode" else b.in_shapes[:3] + (63,)
    with count.Counter(scale_loops=scale) as c:
        b(*args)
    return c.flops, c.bytes


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_scaled_count_equals_unscaled(arch, kind):
    assert _count(arch, kind, True) == _count(arch, kind, False)


@pytest.mark.parametrize("arch,policy", [("granite-8b", "none"),
                                         ("rwkv6-7b", "dots"),
                                         ("whisper-small", "none")])
def test_scaled_count_equals_unscaled_under_remat(arch, policy):
    """Four layers: the layer loop itself is scaled, each layer under
    activation checkpointing (its recompute counted once, as it runs)."""
    kw = dict(remat=True, n_layers=4, remat_policy=policy)
    assert _count(arch, "train", True, **kw) == \
        _count(arch, "train", False, **kw)
