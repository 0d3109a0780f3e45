"""The torch port's QUACK primitives and quack_scan kernel vs the JAX package.

Inputs are drawn with numpy from a seed and fed to both packages; every
comparison is bit-exact (tolerance 0): outputs are bool/int32, and the
float32 stake sums are exact for the integer or dyadic stakes used. These
tests run the port's plain torch version of ``quack_scan``; the CUDA
kernel is held against it on the card in ``test_torch_gpu.py``.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.quack as jq
import repro.core.retransmit as jrt
import repro_torch.core.quack as tq
import repro_torch.core.retransmit as trt
from repro.kernels.quack_scan import quack_scan as pallas_quack_scan
from repro.kernels.ref import quack_reference as jax_quack_reference
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import quack_scan as kernels_quack_scan_op
from repro_torch.kernels.quack_scan import quack_scan as cuda_quack_scan

# the module (the package exports the op under the same name)
kq = importlib.import_module("repro_torch.kernels.quack_scan")

# (S, R, W, Pallas block) — the grid of tests/test_kernels.py plus ragged W
SHAPES = [(3, 7, 64, 32), (2, 16, 512, 512), (4, 5, 128, 64),
          (1, 33, 256, 128), (3, 7, 100, None), (2, 19, 777, None)]
SHAPE_IDS = [f"{s}x{r}x{w}" for s, r, w, _ in SHAPES]


def _bitmaps(s, r, w, seed, p_claim=0.6, p_comp=0.2):
    rng = np.random.default_rng(seed)
    claims = rng.random((s, r, w)) < p_claim
    comps = rng.random((s, r, w)) < p_comp
    # a few all-claimed rows so that prefixes are long, not just 0
    claims[:, : max(1, r // 2), : w // 2] = True
    stakes = (rng.integers(1, 9, r) * 0.25).astype(np.float32)   # dyadic
    return claims, comps, stakes


def _cmp(port, ref_arr):
    port = port.cpu().numpy() if isinstance(port, torch.Tensor) else port
    ref_arr = np.asarray(ref_arr)
    assert port.dtype == ref_arr.dtype, (port.dtype, ref_arr.dtype)
    assert port.shape == ref_arr.shape
    assert np.array_equal(port, ref_arr)


def _t(a, device="cpu"):
    return torch.as_tensor(np.asarray(a), device=device)


# ------------------------------------------------- (a) quack_scan, on the CPU
@pytest.mark.parametrize("compute_lost", [True, False],
                         ids=["lost", "no_lost"])
@pytest.mark.parametrize("s,r,w,bw", SHAPES, ids=SHAPE_IDS)
def test_plain_quack_scan_matches_pallas_interpret(s, r, w, bw,
                                                   compute_lost):
    claims, comps, stakes = _bitmaps(s, r, w, seed=s * 100 + r)
    q, d = 3.0, 1.5
    out = ops.quack_scan(_t(claims), _t(comps), _t(stakes), q, d,
                         compute_lost=compute_lost)
    if bw is not None:
        pk = pallas_quack_scan(jnp.asarray(claims), jnp.asarray(comps),
                               jnp.asarray(stakes), q, d, block_w=bw,
                               interpret=True, compute_lost=compute_lost)
    else:
        # ragged W: the Pallas kernel needs W padded to its block, which
        # the JAX package's Pallas route does before the call
        pk = jq.stake_quorum_bitmap(jnp.asarray(claims), jnp.asarray(comps),
                                    jnp.asarray(stakes), q, d,
                                    use_pallas=True, need_lost=compute_lost)
    _cmp(out[0], pk[0])
    _cmp(out[2], pk[2])
    if compute_lost:
        _cmp(out[1], pk[1])
    else:
        assert out[1] is None and pk[1] is None
    qr, lr, pr = jax_quack_reference(jnp.asarray(claims), jnp.asarray(comps),
                                     jnp.asarray(stakes), q, d)
    _cmp(out[0], qr)
    _cmp(out[2], pr)
    if compute_lost:
        _cmp(out[1], lr)


# ------------------------------- (a') the launch plan of the CUDA kernel
# (B, S, R, W, pointers aligned): the windowed engine's shapes (one lane,
# the topology's 3 and the reconciliation's 6), the dense shape, a
# misaligned pointer, ragged and tiny widths, R = 1, 33, 257 and _MAX_R,
# and the wrapper's limits
PLAN_SHAPES = [(1, 19, 19, 6016, True), (3, 19, 19, 6016, True),
               (6, 19, 19, 6016, True), (1, 19, 19, 65536, True),
               (1, 19, 19, 6016, False), (1, 19, 19, 65535, True),
               (1, 5, 33, 4099, True), (2, 3, 7, 100, True),
               (1, 2, 19, 16, True), (1, 2, 1, 1, True),
               (1, 3, 257, 4096, True), (1, 3, 257, 6015, True),
               (2, 3, 7, 8192, True), (2, 3, 7, 8208, True),
               (1, 19, 19, 1 << 20, True), (1, 3, kq._MAX_R, 4096, True),
               (kq._MAX_B, kq._MAX_S, 19, 6016, True),
               (1, 1, 1, 2 ** 31 - 16, True), (1, 1, 1, 2 ** 31 - 1, True)]


def _tiles(plan, w):
    """Every tile of the launch as [start, stop) columns of the row."""
    for k in range(plan.cluster):
        begin = k * plan.cols
        n_cols = max(0, min(w - begin, plan.cols))
        for t in range(0, n_cols, plan.tile):
            yield begin + t, begin + min(n_cols, t + plan.tile)


@pytest.mark.parametrize("compute_lost", [True, False],
                         ids=["lost", "no_lost"])
@pytest.mark.parametrize("b,s,r,w,aligned", PLAN_SHAPES,
                         ids=[f"{b}x{s}x{r}x{w}{'' if a else '-plain'}"
                              for b, s, r, w, a in PLAN_SHAPES])
def test_plan_quack_launch_covers_every_column_once(b, s, r, w, aligned,
                                                    compute_lost):
    plan = kq.plan_quack_launch(b, s, r, w, aligned, compute_lost)
    maps = 2 if compute_lost else 1
    assert plan.cluster in (1, 2, 4, 8)
    assert plan.grid == (plan.cluster, s, b)
    assert plan.grid[0] % plan.cluster == 0
    assert plan.grid[1] <= 65535 and plan.grid[2] <= 65535
    assert 32 <= plan.threads <= 512 and plan.threads % 32 == 0
    per_thread = 16 if plan.path == "vector" else 4
    assert plan.tile <= per_thread * plan.threads < plan.tile + 32 * per_thread
    assert plan.cols % 16 == 0 and plan.tile % 16 == 0
    assert (plan.path == "staged") == (plan.stages > 0)
    assert plan.threads <= (512 if plan.path == "vector" else 256)
    # the columns: each once, in order, and every CTA but the last full
    cover = list(_tiles(plan, w))
    assert cover[0][0] == 0 and cover[-1][1] == w
    assert all(a[1] == b_[0] for a, b_ in zip(cover, cover[1:]))
    assert sum(stop - start for start, stop in cover) == w
    assert (plan.cluster - 1) * plan.cols < w <= plan.cluster * plan.cols
    # shared memory: the barriers, the stakes and the stages, within the
    # card's 227 KB and the kernel's 200 KB; each barrier's bytes < 2**20
    assert plan.smem == (16 * plan.stages + -(-4 * r // 16) * 16
                         + plan.stages * maps * r * plan.tile)
    assert plan.smem <= 200 * 1024 <= 232_448
    assert r * plan.tile < 2 ** 20 or not plan.stages
    assert 0 <= plan.stages <= 4
    if not aligned or w % 16:
        assert plan.path == "bytes"        # no 16-byte access off 16 bytes
    if plan.stages:
        assert plan.stages * maps * r * plan.tile <= 112 * 1024
        assert plan.stages <= -(-plan.cols // plan.tile)
    assert plan.path in kq.PATHS


def test_plan_quack_launch_at_the_main_path_shapes():
    """W = 6,016: 8 CTAs of 752 columns staged in one stage, 152 CTAs for
    S = 19 (38 before the redesign); twice that width, two stages; dense
    with the loss quorum 8 CTAs x 8 tiles of 1,024 columns in two stages,
    without it one vector pass of 8,192 columns a CTA. W % 16 != 0 or a
    misaligned pointer: bytes."""
    for lost in (True, False):
        win = kq.plan_quack_launch(1, 19, 19, 6016, True, lost)
        assert (win.path, win.cluster, win.cols, win.tile, win.stages,
                win.threads) == ("staged", 8, 752, 752, 1, 192)
        assert win.grid[0] * win.grid[1] * win.grid[2] == 152
        grown = kq.plan_quack_launch(1, 19, 19, 12032, True, lost)
        assert (grown.path, grown.tile, grown.stages) == ("staged", 752, 2)
    dense = kq.plan_quack_launch(1, 19, 19, 65536, True)
    assert (dense.path, dense.cluster, dense.cols, dense.tile,
            dense.stages, dense.threads) == ("staged", 8, 8192, 1024, 2, 256)
    dense = kq.plan_quack_launch(1, 19, 19, 65536, True, False)
    assert (dense.path, dense.cluster, dense.cols, dense.tile,
            dense.threads) == ("vector", 8, 8192, 8192, 512)
    for w in range(6000, 6017):
        assert ((kq.plan_quack_launch(1, 19, 19, w, True).path == "staged")
                == (w % 16 == 0))
        assert kq.plan_quack_launch(1, 19, 19, w, False).path == "bytes"
    # R too large to stage a tile of 128 columns: bytes
    assert kq.plan_quack_launch(1, 3, kq._MAX_R, 4096, True).path == "bytes"


def _edges(s, r, w):
    """The first unquacked column at each edge of the kernel's launch."""
    plan = kq.plan_quack_launch(1, s, r, w, True)
    return {"col0": 0, "cta0_last": plan.cols - 1, "cta1_first": plan.cols,
            "tile_last": plan.tile - 1, "tile_next": plan.tile,
            "last": w - 1, "none": w}


@pytest.mark.parametrize("compute_lost", [True, False],
                         ids=["lost", "no_lost"])
@pytest.mark.parametrize("w,bw", [(6016, 128), (16384, 512)])
@pytest.mark.parametrize("where", list(_edges(2, 5, 6016)))
def test_plain_quack_scan_matches_pallas_at_the_launch_edges(where, w, bw,
                                                             compute_lost):
    pos = _edges(2, 5, w)[where]
    claims, comps, stakes = _bitmaps(2, 5, w, seed=pos)
    claims[:, :, :pos] = True
    if pos < w:
        claims[1, :, pos] = False                # sender 1: unquacked at pos
        claims[0, :, min(pos + 17, w - 1)] = False
    q, d = float(stakes.sum()) * 0.6, float(stakes.sum()) * 0.3
    out = ops.quack_scan(_t(claims), _t(comps), _t(stakes), q, d,
                         compute_lost=compute_lost)
    pk = pallas_quack_scan(jnp.asarray(claims), jnp.asarray(comps),
                           jnp.asarray(stakes), q, d, block_w=bw,
                           interpret=True, compute_lost=compute_lost)
    assert int(out[2][1]) == pos
    for got, want in zip(out, pk):
        if want is None:
            assert got is None
        else:
            _cmp(got, want)


def test_plain_quack_scan_takes_tensor_thresholds():
    claims, comps, stakes = _bitmaps(2, 5, 96, seed=3)
    a = ops.quack_scan(_t(claims), _t(comps), _t(stakes), 2.5, 0.75)
    b = ops.quack_scan(_t(claims), _t(comps), _t(stakes),
                       torch.tensor(2.5), torch.tensor(0.75))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_kernel_wrapper_refuses_cpu_tensors():
    """No fallback: the CUDA wrapper never computes on a CPU tensor."""
    claims, comps, stakes = _bitmaps(2, 4, 64, seed=1)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_quack_scan(_t(claims), _t(comps), _t(stakes),
                        torch.tensor(2.0), torch.tensor(1.0))


def test_ops_refuses_devices_without_kernel():
    claims = torch.zeros((1, 2, 8), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.quack_scan(claims, claims, torch.ones(2, device="meta"),
                       1.0, 1.0)


def test_build_raises_without_nvcc(monkeypatch):
    import shutil

    import torch.utils.cpp_extension as cpp
    monkeypatch.setattr(shutil, "which", lambda _name: None)
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()


def test_failed_build_raises(monkeypatch, tmp_path):
    """A compiler that fails makes the build raise and leaves no library."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.build("quack_scan")
    assert not list(tmp_path.glob("*.so"))


def test_kernels_package_exports_the_op():
    assert kernels_quack_scan_op is ops.quack_scan
    assert ref.quack_reference is ops.quack_reference


# ------------------------------------- (b) core/quack.py vs the jnp forms
def _received(n, w, seed, density=0.85):
    rng = np.random.default_rng(seed)
    rec = rng.random((n, w)) < density
    rec[0, :] = True            # a full row
    rec[1, :] = False           # an empty row
    rec[2, : w // 3] = True     # a long prefix
    return rec


@pytest.mark.parametrize("base", [0, 37])
@pytest.mark.parametrize("seed", [0, 1])
def test_cumulative_ack_matches(seed, base):
    rec = _received(6, 90, seed)
    _cmp(tq.cumulative_ack(_t(rec), base),
         jq.cumulative_ack(jnp.asarray(rec), base))
    _cmp(tq.cumulative_ack(_t(rec), torch.tensor(base, dtype=torch.int32)),
         jq.cumulative_ack(jnp.asarray(rec), base))


@pytest.mark.parametrize("phi", [1, 4, 32])
@pytest.mark.parametrize("base", [0, 37])
def test_missing_below_horizon_matches(base, phi):
    rec = _received(6, 90, seed=phi)
    _cmp(tq.missing_below_horizon(_t(rec), phi, base),
         jq.missing_below_horizon(jnp.asarray(rec), phi, base))


@pytest.mark.parametrize("phi", [1, 4, 32])
@pytest.mark.parametrize("base,total", [(0, None), (37, None), (37, 500)])
def test_claim_bitmask_matches(base, total, phi):
    rec = _received(6, 90, seed=phi + 7)
    got = tq.claim_bitmask(_t(rec), phi, base, total)
    want = jq.claim_bitmask(jnp.asarray(rec), phi, base, total)
    for g, w in zip(got, want):
        _cmp(g, w)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_weighted_quorum_prefix_matches(seed):
    rng = np.random.default_rng(seed)
    acks = rng.integers(0, 50, (5, 7)).astype(np.int32)
    acks[0, :] = 9              # all tied
    stakes = rng.integers(1, 5, 7).astype(np.float32)
    for thr in (1.0, 3.0, float(stakes.sum()), float(stakes.sum()) + 1):
        _cmp(tq.weighted_quorum_prefix(_t(acks), _t(stakes), thr),
             jq.weighted_quorum_prefix(jnp.asarray(acks),
                                       jnp.asarray(stakes), thr))


@pytest.mark.parametrize("seed", [0, 1])
def test_selective_quack_matches(seed):
    rng = np.random.default_rng(seed)
    known = rng.random((3, 5, 64)) < 0.5
    stakes = rng.integers(1, 4, 5).astype(np.float32)
    _cmp(tq.selective_quack(_t(known), _t(stakes), 4.0),
         jq.selective_quack(jnp.asarray(known), jnp.asarray(stakes), 4.0))


@pytest.mark.parametrize("need_lost", [True, False])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_stake_quorum_bitmap_matches(use_pallas, need_lost):
    claims, comps, stakes = _bitmaps(4, 7, 200, seed=11)
    got = tq.stake_quorum_bitmap(_t(claims), _t(comps), _t(stakes), 3.0,
                                 2.0, use_pallas=use_pallas,
                                 need_lost=need_lost)
    want = jq.stake_quorum_bitmap(jnp.asarray(claims), jnp.asarray(comps),
                                  jnp.asarray(stakes), 3.0, 2.0,
                                  need_lost=need_lost)
    _cmp(got[0], want[0])
    _cmp(got[2], want[2])
    if need_lost:
        _cmp(got[1], want[1])
    else:
        assert got[1] is None


def test_retransmit_helpers_match():
    rng = np.random.default_rng(5)
    orig = rng.integers(0, 7, 40).astype(np.int32)
    retry = rng.integers(0, 9, 40).astype(np.int32)
    _cmp(trt.elect_retransmitter(_t(orig), _t(retry), 7),
         jrt.elect_retransmitter(jnp.asarray(orig), jnp.asarray(retry), 7))
    rep = rng.random((5, 40)) < 0.4
    stakes = rng.integers(1, 4, 5).astype(np.float32)
    _cmp(trt.declared_lost(_t(rep), _t(stakes), 3.0),
         jrt.declared_lost(jnp.asarray(rep), jnp.asarray(stakes), 3.0))
    assert trt.max_retransmissions(2, 3) == jrt.max_retransmissions(2, 3)
    assert trt.theorem1_resends() == jrt.theorem1_resends()
    assert (trt.faulty_pair_bound(19, 6, 19, 6)
            == jrt.faulty_pair_bound(19, 6, 19, 6))
