"""The torch port on a CUDA card: kernels vs their plain versions, and
CUDA runs vs CPU runs of the simulator.

This file imports only torch, numpy and the port (no JAX), so that it
runs where the card is:

    PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py

Every test decides inside itself whether a card exists and skips where
there is none. Comparisons are bit-exact: the kernel sums stakes in the
same order as its plain version, and the simulator's state is int32/bool.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import FailureScenario, RSMConfig, SimConfig
from repro_torch.core import simulator as tsim
from repro_torch.kernels import ops
from repro_torch.kernels.quack_scan import quack_scan as cuda_quack_scan
from repro_torch.kernels.ref import quack_reference

pytestmark = pytest.mark.gpu

# (S, R, W): small grids, ragged widths, R = 33, the main path's shape
SHAPES = [(3, 7, 64), (2, 16, 512), (4, 5, 128), (1, 33, 256), (3, 7, 100),
          (2, 19, 777), (19, 19, 65536), (19, 19, 65535)]


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _inputs(s, r, w, seed):
    rng = np.random.default_rng(seed)
    claims = rng.random((s, r, w)) < 0.6
    claims[:, : r // 2 + 1, : w // 3] = True
    comps = rng.random((s, r, w)) < 0.2
    stakes = (rng.random(r) + 0.5).astype(np.float32)      # real stakes
    return [torch.as_tensor(x) for x in (claims, comps, stakes)]


@pytest.mark.parametrize("compute_lost", [True, False],
                         ids=["lost", "no_lost"])
@pytest.mark.parametrize("s,r,w", SHAPES,
                         ids=[f"{s}x{r}x{w}" for s, r, w in SHAPES])
def test_cuda_kernel_matches_plain(s, r, w, compute_lost):
    _need_cuda()
    args = _inputs(s, r, w, seed=w)
    thr = float(args[2].sum()) * 0.6
    want = quack_reference(*args, thr, 1.3, compute_lost=compute_lost)
    before = cuda_quack_scan.launches
    got = ops.quack_scan(*(a.cuda() for a in args), thr, 1.3,
                         compute_lost=compute_lost)
    torch.cuda.synchronize()
    assert cuda_quack_scan.launches == before + 1
    for g, w_ in zip(got, want):
        if w_ is None:
            assert g is None
        else:
            assert g.dtype == w_.dtype and torch.equal(g.cpu(), w_)


def test_cuda_op_never_falls_back(monkeypatch):
    _need_cuda()

    def boom(*_a, **_k):
        raise AssertionError("plain version called on CUDA tensors")

    monkeypatch.setattr(ops, "quack_reference", boom)
    args = _inputs(2, 4, 64, seed=2)
    ops.quack_scan(*(a.cuda() for a in args), 2.0, 1.0)
    torch.cuda.synchronize()


def test_cuda_kernel_rejects_bad_inputs():
    _need_cuda()
    claims, comps, stakes = (a.cuda() for a in _inputs(2, 4, 64, seed=3))
    thr = torch.tensor(2.0, device="cuda")
    with pytest.raises(TypeError, match="dtype"):
        cuda_quack_scan(claims.to(torch.uint8), comps, stakes, thr, thr)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_quack_scan(claims.transpose(0, 1).contiguous().transpose(0, 1),
                        comps, stakes, thr, thr)
    with pytest.raises(ValueError, match="shape"):
        cuda_quack_scan(claims, comps, stakes[:3], thr, thr)


def test_cuda_run_matches_cpu_run():
    _need_cuda()
    cfg = RSMConfig.bft(1)
    spec = tsim.build_spec(
        cfg, cfg, SimConfig(n_msgs=96, steps=160, window=2, phi=6),
        FailureScenario(crash_s=(2, -1, -1, -1),
                        byz_recv_drop=(True, False, False, False),
                        byz_ack_stale=(False, False, True, False)))
    cpu = tsim.run_simulation(spec, device="cpu")
    before = cuda_quack_scan.launches
    gpu = tsim.run_simulation(spec)
    assert cuda_quack_scan.launches - before == 2 * spec.steps
    for f in ("quack_time", "deliver_time", "retry", "recv_has",
              "send_step", "delivery_latency", "gc_frontiers"):
        a, b = getattr(gpu, f), getattr(cpu, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in tsim.StepMetrics._fields:
        a, b = getattr(gpu.metrics, f), getattr(cpu.metrics, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
