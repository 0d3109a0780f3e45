"""The torch port on a CUDA card: kernels vs their plain versions, and
CUDA runs vs CPU runs of the simulator.

This file imports only torch, numpy and the port (no JAX), so that it
runs where the card is:

    PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py

Every test decides inside itself whether a card exists and skips where
there is none. ``quack_scan`` (one-lane and lane forms) and the
simulator (dense and windowed, growth and dense fallback included)
compare bit for bit: the
kernel sums stakes in the same order as its plain version, and the
simulator's state is int32/bool. The attention and RWKV6 kernels sum in
another order than their plain versions, so they are held to tolerances:
attention 2e-6 in f32 (the JAX tests'), in bf16 atol 1e-5 and rtol 1.6e-2
(two bf16 steps, the limit ``chip_smoke.py`` measures against controls),
RWKV6 1e-4. Attention routes by dtype: every bf16 call must count on the
wgmma kernel with P in bf16 halves (``launches_sm90``), every f32 call on
the wgmma kernel in three TF32 passes (``launches_f32``), which is also
held against its split in plain torch (``ref.mha_split_tf32``). With
``collect_metrics`` the metrics fabric rides the captured graphs: its
``ObsMetrics`` on the card equal the CPU run's, the outputs equal the
metrics-off run's, and the engine's counters do not move. Topologies
(``repro_torch.topology``) and the §6 applications (``repro_torch.apps``)
on the card equal their CPU runs and the numpy mirror, and a commit
floor written between two replays of one captured chunk program changes
what that program dispatches. Programs outlive runs: a second run of a
shape captures nothing; a ``fail_schedule`` swap written between two
replays of one captured program changes what it computes; recorded runs
replay, resume and fork on the card as on the CPU (``repro_torch.replay``).
A streaming session (``repro_torch.stream``, the loop's horizon mode)
equals its CPU run, keeps no stream-sized host array, and leaves a
batch run of its spec nothing to capture; ``debug_checks`` arms the
sanitizer's guard (``repro_torch.analysis``), which raises on a seeded
synchronisation and passes a real K = 8 run; the program auditor finds
the eight captured programs clean on the card, with the launch counts
the formula gives.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from repro_torch.core import (FailureScenario, RSMConfig, SimConfig, graphs,
                              run_picsou_batch)
from repro_torch.core import simulator as tsim
from repro_torch.core import snapshot
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import \
    flash_attention as cuda_flash_attention
from repro_torch.kernels.quack_scan import plan_quack_launch
from repro_torch.kernels.quack_scan import quack_scan as cuda_quack_scan
from repro_torch.kernels.ref import (mha_reference, mha_split_tf32,
                                     quack_reference, rwkv6_reference)
from repro_torch.kernels.rwkv6_scan import rwkv6_chunked as cuda_rwkv6_chunked
from repro_torch.obs.metrics import init_metrics_carry

pytestmark = pytest.mark.gpu

# (S, R, W): small grids, ragged widths, R = 33, the main path's shape,
# and R = 1, 19, 33, 257 at the windowed width, aligned and ragged
SHAPES = [(3, 7, 64), (2, 16, 512), (4, 5, 128), (1, 33, 256), (3, 7, 100),
          (2, 19, 777), (19, 19, 65536), (19, 19, 65535), (4, 1, 6016),
          (4, 1, 6015), (4, 19, 6015), (4, 33, 6016), (4, 33, 6015),
          (4, 257, 6016), (4, 257, 6015)]


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


# the lane form: (B, S, R, W) with per-lane real stakes and thresholds, at
# ragged widths and at the windowed full-size shape (W = 6,016) with the
# topology's and the applications' lane counts
LANE_SHAPES = [(2, 3, 7, 100), (3, 2, 16, 512), (2, 19, 19, 777),
               (2, 19, 19, 6016), (1, 19, 19, 6016), (3, 19, 19, 6016),
               (6, 19, 19, 6016)]


@pytest.mark.parametrize("compute_lost", [True, False],
                         ids=["lost", "no_lost"])
@pytest.mark.parametrize("b,s,r,w", LANE_SHAPES,
                         ids=[f"{b}x{s}x{r}x{w}" for b, s, r, w in
                              LANE_SHAPES])
def test_cuda_lane_kernel_matches_plain(b, s, r, w, compute_lost):
    _need_cuda()
    rng = np.random.default_rng(b * 1000 + w)
    claims = rng.random((b, s, r, w)) < 0.6
    claims[:, :, : r // 2 + 1, : w // 3] = True
    comps = rng.random((b, s, r, w)) < 0.2
    stakes = (rng.random((b, r)) + 0.5).astype(np.float32)
    share = np.linspace(0.45, 0.65, b, dtype=np.float32)
    qthr = stakes.sum(1) * share
    dthr = stakes.sum(1) * (share - 0.25)
    args = [torch.as_tensor(x) for x in (claims, comps, stakes, qthr, dthr)]
    want = quack_reference(*args, compute_lost=compute_lost)
    before = cuda_quack_scan.launches
    got = ops.quack_scan(*(a.cuda() for a in args),
                         compute_lost=compute_lost)
    torch.cuda.synchronize()
    assert cuda_quack_scan.launches == before + 1
    for g, w_ in zip(got, want):
        if w_ is None:
            assert g is None
        else:
            assert g.dtype == w_.dtype and torch.equal(g.cpu(), w_)


# the redesigned launch (kernels/quack_scan.py::plan_quack_launch): a
# cluster of CTAs per (b, s) row, each owning ``cols`` columns in tiles of
# ``tile``; the prefix is the cluster's min of its CTAs' first unquacked
# columns. Fixtures put the first unquacked column on the plan's edges.
def _boundaries(w, compute_lost=True):
    plan = plan_quack_launch(1, 1, 19, w, True, compute_lost)
    return {"col0": 0, "cta0_last": plan.cols - 1, "cta1_first": plan.cols,
            "tile_last": plan.tile - 1, "tile_next": plan.tile,
            "last": w - 1, "none": w}


def _check_quack(args, compute_lost):
    want = quack_reference(*args, compute_lost=compute_lost)
    before = cuda_quack_scan.launches
    got = ops.quack_scan(*(a.cuda() for a in args), compute_lost=compute_lost)
    torch.cuda.synchronize()
    assert cuda_quack_scan.launches == before + 1
    for g, w_ in zip(got, want):
        if w_ is None:
            assert g is None
        else:
            assert g.dtype == w_.dtype and torch.equal(g.cpu(), w_)
    return got


def _lane_args(b, s, r, w, seed, p_claim=0.6):
    rng = np.random.default_rng(seed)
    claims = rng.random((b, s, r, w)) < p_claim
    comps = rng.random((b, s, r, w)) < 0.2
    stakes = (rng.random((b, r)) + 0.5).astype(np.float32)
    share = np.linspace(0.45, 0.65, b, dtype=np.float32)
    return claims, comps, stakes, stakes.sum(1) * share, \
        stakes.sum(1) * (share - 0.25)


@pytest.mark.parametrize("compute_lost", [True, False],
                         ids=["lost", "no_lost"])
@pytest.mark.parametrize("w", [6016, 65536, 65531])
@pytest.mark.parametrize("where", list(_boundaries(6016)))
def test_quack_prefix_at_the_launch_edges(where, w, compute_lost):
    _need_cuda()
    pos = _boundaries(w, compute_lost)[where]
    claims, comps, stakes, qthr, dthr = _lane_args(1, 3, 19, w, seed=pos)
    claims[..., :pos] = True          # quacked up to pos
    if pos < w:
        claims[:, 1:, :, pos] = False  # rows 1, 2: unquacked at pos
        claims[:, 0, :, min(pos + 17, w - 1)] = False  # row 0: later
    args = [torch.as_tensor(x) for x in (claims, comps, stakes, qthr, dthr)]
    got = _check_quack(args, compute_lost)
    assert got[2][0, 1].item() == pos and got[2][0, 2].item() == pos


@pytest.mark.parametrize("compute_lost", [True, False],
                         ids=["lost", "no_lost"])
@pytest.mark.parametrize("w", list(range(8184, 8209)) + [1, 5, 16, 100,
                                                         131072, 131088])
def test_quack_every_width_mod_16_around_a_tile_edge(w, compute_lost):
    """Every W % 16, staged and bytes, from 8,184 to 8,208, where a CTA's
    columns pass one tile of 1,024 and split into two; W below one tile;
    and widths whose CTAs take two and three vector passes."""
    _need_cuda()
    claims, comps, stakes, qthr, dthr = _lane_args(2, 3, 7, w, seed=w,
                                                   p_claim=0.8)
    claims[:, :, :4, : w // 2] = True
    _check_quack([torch.as_tensor(x) for x in
                  (claims, comps, stakes, qthr, dthr)], compute_lost)


@pytest.mark.parametrize("compute_lost", [True, False],
                         ids=["lost", "no_lost"])
@pytest.mark.parametrize("w", [65536, 6016])
def test_quack_scan_replays_in_a_graph_on_new_inputs(w, compute_lost):
    _need_cuda()
    make = [[torch.as_tensor(x).cuda() for x in _lane_args(2, 19, 19, w, seed)]
            for seed in (0, 1, 2)]
    static = [t.clone() for t in make[0]]
    ops.quack_scan(*static, compute_lost=compute_lost)        # warm-up
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = ops.quack_scan(*static, compute_lost=compute_lost)
    for fresh in make[1:]:
        for dst, src in zip(static, fresh):
            dst.copy_(src)
        g.replay()
        want = quack_reference(*fresh, compute_lost=compute_lost)
        for a, b in zip(out, want):
            assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("compute_lost", [True, False],
                         ids=["lost", "no_lost"])
@pytest.mark.parametrize("w", [6016, 65536, 65531])
def test_quack_scan_is_one_kernel_a_call(w, compute_lost):
    """No fill kernel beside it: over several profiled calls every kernel
    the profiler records is ``quack_scan``, at least one is recorded, and
    no more than one a call. (The profiler drops a call's event now and
    then, so one profiled call alone cannot hold this; and now and then
    a whole window records no CUDA event at all, which is no evidence
    either way: such a window is profiled again, up to ``windows``
    times. Every window that records an event is held to the claim.)"""
    _need_cuda()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    calls, windows = 8, 4
    args = [torch.as_tensor(x).cuda() for x in _lane_args(1, 19, 19, w, 3)]
    ops.quack_scan(*args, compute_lost=compute_lost)
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                ops.quack_scan(*args, compute_lost=compute_lost)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        assert len(names) <= calls, names
        assert all("quack_scan" in n for n in names), names
        if names:
            break
    assert names, f"no CUDA event recorded in {windows} profiled windows"


# the windowed fixtures of tests/test_windowed.py, restated with the
# port's types (this file imports no JAX), and its growth and
# dense-fallback specs: (name, sender, receiver, SimConfig kwargs,
# failures)
_BFT1, _CFT1 = RSMConfig.bft(1), RSMConfig.cft(1)
_STALL = dict(byz_bcast_partial=(True, False, False, False), bcast_limit=2)
WINDOWED = [
    ("failure_free", _BFT1, _BFT1,
     dict(n_msgs=24, steps=30, window=1, phi=6, window_slots=16,
          chunk_steps=4), FailureScenario.none()),
    ("failure_free_w2", _BFT1, _BFT1,
     dict(n_msgs=24, steps=30, window=2, phi=6, window_slots=24,
          chunk_steps=2), FailureScenario.none()),
    ("crash_sender", _BFT1, _BFT1,
     dict(n_msgs=24, steps=150, window=1, phi=6, window_slots=24,
          chunk_steps=8), FailureScenario(crash_s=(1, -1, -1, -1))),
    ("byzantine_recv", _BFT1, _BFT1,
     dict(n_msgs=24, steps=200, window=1, phi=6, window_slots=24,
          chunk_steps=16),
     FailureScenario(byz_recv_drop=(True, False, False, False),
                     byz_ack_low=(False, True, False, False))),
    ("crash_plus_byz", _BFT1, _BFT1,
     dict(n_msgs=24, steps=240, window=1, phi=6, window_slots=24,
          chunk_steps=32),
     FailureScenario(crash_s=(2, -1, -1, -1),
                     byz_recv_drop=(True, False, False, False))),
    ("liar_low", _BFT1, _BFT1,
     dict(n_msgs=24, steps=150, window=1, phi=6, window_slots=24,
          chunk_steps=8),
     FailureScenario(byz_ack_low=(True, False, False, False))),
    ("cft_dup_resend", _CFT1, _CFT1,
     dict(n_msgs=12, steps=120, window=1, phi=6, window_slots=12,
          chunk_steps=8), FailureScenario(crash_s=(1, -1, -1))),
    ("gc_stall_defence", _BFT1, _BFT1,
     dict(n_msgs=24, steps=300, window=1, phi=6, window_slots=24,
          chunk_steps=16),
     FailureScenario(**_STALL, crash_r=(-1, 8, -1, -1))),
    ("staked_dss", RSMConfig(n=4, u=333, r=333,
                             stakes=(333., 223., 222., 222.)),
     RSMConfig(n=4, u=333, r=333, stakes=(250., 250., 250., 250.)),
     dict(n_msgs=24, steps=80, window=2, phi=6, scheduler="dss",
          quantum=12, window_slots=24, chunk_steps=8),
     FailureScenario.none()),
    ("mixed_cft_to_bft", _CFT1, _BFT1,
     dict(n_msgs=24, steps=60, window=2, phi=6, window_slots=24,
          chunk_steps=4), FailureScenario.none()),
    ("mixed_bft_to_cft", _BFT1, _CFT1,
     dict(n_msgs=24, steps=60, window=2, phi=6, window_slots=24,
          chunk_steps=4), FailureScenario.none()),
    ("ack_advance_liar", _BFT1, _BFT1,
     dict(n_msgs=24, steps=120, window=1, phi=6, window_slots=24,
          chunk_steps=8), FailureScenario(byz_ack_advance=(3, 0, 0, 0))),
    ("gc_stall_adversary", _BFT1, _BFT1,
     dict(n_msgs=128, steps=128 // 4 + 80, window=1, phi=6,
          window_slots=16, chunk_steps=8), FailureScenario(**_STALL)),
    ("dense_fallback", _BFT1, _BFT1,
     dict(n_msgs=64, steps=200, window=1, phi=6, window_slots=16,
          chunk_steps=8),
     FailureScenario(**_STALL, crash_r=(-1, 8, -1, -1))),
]


@pytest.mark.parametrize("name,snd,rcv,simkw,fails", WINDOWED,
                         ids=[f[0] for f in WINDOWED])
def test_windowed_cuda_run_matches_cpu_run(name, snd, rcv, simkw, fails):
    """Windowed on the card == windowed on the CPU, every field; the
    kernel launches twice a round and once more per rotating chunk."""
    _need_cuda()
    spec = tsim.build_spec(snd, rcv, SimConfig(**simkw), fails)
    assert spec.window_slots > 0
    cpu = tsim.run_simulation(spec, device="cpu")
    before = cuda_quack_scan.launches
    gpu = tsim.run_simulation(spec)
    chunks = -(-spec.steps // spec.chunk_steps)
    assert cuda_quack_scan.launches - before == 2 * spec.steps + chunks - 1
    for f in ("quack_time", "deliver_time", "retry", "recv_has",
              "send_step", "delivery_latency", "gc_frontiers"):
        a, b = getattr(gpu, f), getattr(cpu, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in tsim.StepMetrics._fields:
        a, b = getattr(gpu.metrics, f), getattr(cpu.metrics, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert gpu.final_window_slots == cpu.final_window_slots
    assert gpu.window_growth_events == cpu.window_growth_events
    if name in ("gc_stall_adversary", "dense_fallback"):
        assert gpu.window_growth_events
        assert gpu.window_growth_events[-1].dense_migration == (
            name == "dense_fallback")


# ------------------------------------------- CUDA graphs (core/graphs.py)
def _lanes(k=8, **simkw):
    """Two lanes of one windowed link, and the run's inputs on the card."""
    kw = dict(n_msgs=128, steps=60, window=1, phi=6, window_slots=32,
              chunk_steps=4, superchunk=k)
    kw.update(simkw)
    specs = [tsim.build_spec(_BFT1, _BFT1, SimConfig(**kw), f)
             for f in (FailureScenario.none(),
                       FailureScenario(crash_s=(1, -1, -1, -1)))]
    dev = torch.device("cuda")
    w = specs[0].window_slots
    return (specs[0], tsim._fail_arrays(specs, dev),
            tsim._plan(specs[0], w, dev),
            tsim._init_state(specs[0], w, dev, len(specs)), w)


@pytest.mark.parametrize("k,rotate", [(1, True), (1, False), (4, True)],
                         ids=["chunk", "final_chunk", "superchunk"])
def test_graphed_program_equals_eager_on_cuda(k, rotate):
    """Three replays of a captured chunk / superchunk program at B = 2 ==
    the same function called eagerly on the card, bit for bit (state,
    metrics, queue, guard flags), and the replays' launches counted."""
    _need_cuda()
    spec, fail, plan, state, w = _lanes()
    c = 4

    def body(st, t0):
        st, ms, queue, oks = tsim._superchunk(spec, fail, plan, st, t0, w,
                                              c, k, rotate)
        return st, [ms, *queue, oks]

    progs = graphs.Programs(tsim.SimState(*(x.clone() for x in state)),
                            torch.device("cuda"), keep=(fail, plan))
    eager = state
    before = cuda_quack_scan.launches
    needs = tsim._max_msg_by_round(spec)
    for t in (0, k * c, 2 * k * c):
        tsim._load_needs(plan, needs, t, c, k)       # the loop does this
        got = [x.clone() for x in progs.run("p", body, t)]
        eager, want = body(eager, torch.tensor(t, dtype=torch.int32,
                                               device="cuda"))
        for a, b in zip(got + list(progs.state), want + list(eager)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    # eager calls launch 3 x, replays add what the capture recorded
    assert (cuda_quack_scan.launches - before
            == 2 * 3 * k * (2 * c + rotate))
    progs.release()


def test_quack_scan_launches_inside_a_captured_graph():
    _need_cuda()
    claims, comps, stakes = (x.cuda() for x in _inputs(19, 19, 6016, 5))
    thr = torch.tensor(7.0, device="cuda")
    static = [claims.clone(), comps.clone()]
    ops.quack_scan(*static, stakes, thr, thr)              # warm-up
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = ops.quack_scan(*static, stakes, thr, thr)
    for seed in (6, 7):
        c2, x2, _ = (x.cuda() for x in _inputs(19, 19, 6016, seed))
        static[0].copy_(c2)
        static[1].copy_(x2)
        g.replay()
        want = quack_reference(c2, x2, stakes, thr, thr)
        for a, b in zip(out, want):
            assert torch.equal(a, b)


def test_launch_accounting_with_a_cut_span():
    """A K = 8 run whose window grows inside a span: the guard cuts the
    span, the cut chunks' launches count on ``launches_skipped``, and the
    contract stays 2 x rounds + one per rotating chunk; == the CPU run."""
    _need_cuda()
    spec = tsim.build_spec(_BFT1, _BFT1, SimConfig(
        n_msgs=128, steps=128 // 4 + 80, window=1, phi=6, window_slots=16,
        chunk_steps=8, superchunk=8), FailureScenario(**_STALL))
    before = (cuda_quack_scan.launches, cuda_quack_scan.launches_no_lost,
              cuda_quack_scan.launches_skipped)
    gpu = tsim.run_simulation(spec)
    total, no_lost, skipped = (a - b for a, b in zip(
        (cuda_quack_scan.launches, cuda_quack_scan.launches_no_lost,
         cuda_quack_scan.launches_skipped), before))
    rotating = -(-spec.steps // spec.chunk_steps) - 1
    assert gpu.window_growth_events and skipped > 0
    assert total == 2 * spec.steps + rotating
    assert no_lost == spec.steps + rotating
    cpu = tsim.run_simulation(spec, device="cpu")
    for f in ("quack_time", "deliver_time", "retry", "recv_has",
              "gc_frontiers"):
        assert np.array_equal(getattr(gpu, f), getattr(cpu, f)), f
    assert gpu.window_growth_events == cpu.window_growth_events


def test_steady_loop_issues_no_sync(monkeypatch):
    """Under ``set_sync_debug_mode("error")`` a replay of a captured
    program and the start of its drain (what the loop does between two
    drains) issue no synchronisation."""
    _need_cuda()
    steady = [0]
    run, start = graphs.Programs.run, snapshot.PinnedDrain.start

    def strict(fn, when):
        def wrapped(self, *args):
            if not when(self, *args):
                return fn(self, *args)
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(self, *args)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return wrapped

    def replay(self, key, body, t):
        steady[0] += key in self
        return key in self

    monkeypatch.setattr(graphs.Programs, "run", strict(run, replay))
    monkeypatch.setattr(snapshot.PinnedDrain, "start",
                        strict(start, lambda self, tensors: True))
    spec = tsim.build_spec(_BFT1, _BFT1, SimConfig(
        n_msgs=512, steps=512 // 4 + 40, window=1, phi=6, window_slots=256,
        chunk_steps=4, superchunk=2))
    res = tsim.run_simulation(spec)
    assert steady[0] > 10 and res.delivery_step() >= 0


def test_growth_frees_the_old_widths_graphs(monkeypatch):
    """When the window grows (and migrates to dense), the run moves into
    the new width's program set and the old widths' graphs stay cached,
    as the JAX package keeps every width compiled: a second run of the
    spec captures nothing and equals the first. ``clear_programs`` then
    frees every graph."""
    _need_cuda()
    graphs.clear_programs()
    captured = []
    capture = graphs.Programs._capture

    def live():
        gc.collect()
        return [key for key, ref in captured if ref() is not None]

    def spy(self, key, body):
        prog = capture(self, key, body)
        captured.append((key, weakref.ref(prog)))
        return prog

    monkeypatch.setattr(graphs.Programs, "_capture", spy)
    spec = tsim.build_spec(_BFT1, _BFT1, SimConfig(
        n_msgs=64, steps=200, window=1, phi=6, window_slots=16,
        chunk_steps=8), FailureScenario(**_STALL, crash_r=(-1, 8, -1, -1)))
    res = tsim.run_simulation(spec)
    widths = {key[0] for key, _ in captured}
    assert len(widths) >= 2 and res.window_growth_events[-1].dense_migration
    n = len(captured)
    assert len(live()) == n
    again = tsim.run_simulation(spec)
    assert len(captured) == n
    _same_run(again, res)
    graphs.clear_programs()
    assert live() == []


# ------------------------------------- the metrics fabric on the card
_OBS = ("latency_hist", "occupancy_hwm", "gc_lag_hwm", "quack_events",
        "loss_events", "resend_total", "uncounted", "per_chunk_hist")
# chip_smoke.py phase 4's link and scenarios: M = 1,024, 200 rounds
_PATH_FAILS = FailureScenario(crash_s=(2, -1, -1, -1),
                              byz_recv_drop=(False, False, True, False))
_PATH_SCENARIOS = [FailureScenario.none(), _PATH_FAILS,
                   FailureScenario(**_STALL),
                   FailureScenario(**_STALL, crash_r=(-1, 8, -1, -1))]
_PATH_SIMS = {
    "dense": dict(n_msgs=1024, steps=200),
    "windowed_k1": dict(n_msgs=1024, steps=200, window_slots=256,
                        chunk_steps=16, superchunk=1),
    "windowed_k8": dict(n_msgs=1024, steps=200, window_slots=256,
                        chunk_steps=16, superchunk=8)}


def _same_obs(a, b):
    for f in _OBS:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
        else:
            assert np.array_equal(np.asarray(x), np.asarray(y)), f


def _same_run(a, b):
    for f in ("quack_time", "deliver_time", "retry", "recv_has",
              "send_step", "delivery_latency", "gc_frontiers"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    for f in tsim.StepMetrics._fields:
        assert np.array_equal(getattr(a.metrics, f), getattr(b.metrics, f))
    assert a.window_growth_events == b.window_growth_events


def _counters():
    return (tsim.chunk_dispatch_count(), tsim.host_sync_count(),
            graphs.replay_count(), cuda_quack_scan.launches,
            cuda_quack_scan.launches_no_lost,
            cuda_quack_scan.launches_skipped)


@pytest.mark.parametrize("lanes", ["single", "batch"])
@pytest.mark.parametrize("sim", list(_PATH_SIMS))
def test_metrics_cuda_run_matches_cpu_run(sim, lanes):
    """Metrics on: the card == the CPU in every output and every
    ObsMetrics field, on the path phase's specs (dense, windowed at
    K = 1 and 8, the window growing and migrating), single and
    batched; and the card's outputs == its metrics-off run's."""
    _need_cuda()
    scen = _PATH_SCENARIOS if lanes == "batch" else [_PATH_FAILS]
    on = SimConfig(collect_metrics=True, **_PATH_SIMS[sim])
    gpu = run_picsou_batch(_BFT1, _BFT1, on, scen)
    cpu = run_picsou_batch(_BFT1, _BFT1, on, scen, device="cpu")
    off = run_picsou_batch(_BFT1, _BFT1, SimConfig(**_PATH_SIMS[sim]), scen)
    for g, c, o in zip(gpu, cpu, off):
        _same_run(g.result, c.result)
        _same_obs(g.result.obs, c.result.obs)
        _same_run(g.result, o.result)
        assert o.result.obs is None


def test_graphed_program_with_metrics_equals_eager_on_cuda():
    """A captured superchunk carrying ``(SimState, MetricsCarry)``:
    three replays == the same function called eagerly on the card, bit
    for bit (state, carry, outputs and the K-deep block stack)."""
    _need_cuda()
    spec, fail, plan, state, w = _lanes()
    c, k = 4, 4
    mc = init_metrics_carry(w, torch.device("cuda"), state.base.shape[0])

    def body(carry, t0):
        carry, ms, queue, oks, blk = tsim._superchunk(
            spec, fail, plan, carry, t0, w, c, k, True)
        return carry, [ms, *queue, oks, *blk]

    def leaves(carry):
        return list(carry[0]) + list(carry[1])

    progs = graphs.Programs(
        (tsim.SimState(*(x.clone() for x in state)),
         type(mc)(*(x.clone() for x in mc))),
        torch.device("cuda"), keep=(fail, plan))
    eager = (state, mc)
    needs = tsim._max_msg_by_round(spec)
    for t in (0, k * c, 2 * k * c):
        tsim._load_needs(plan, needs, t, c, k)       # the loop does this
        got = [x.clone() for x in progs.run("p", body, t)]
        eager, want = body(eager, torch.tensor(t, dtype=torch.int32,
                                               device="cuda"))
        for a, b in zip(got + leaves(progs.state), want + leaves(eager)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    progs.release()


@pytest.mark.parametrize("sim", ["dense", "windowed_k8", "cut_spans"])
def test_metrics_add_no_dispatch_sync_replay_or_launch(sim):
    """Dispatches, host syncs, graph replays and ``quack_scan``'s launch
    counters (with those of chunk bodies a guard discarded) move the
    same with metrics on as off."""
    _need_cuda()
    kw = (dict(n_msgs=128, steps=128 // 4 + 80, window=1, phi=6,
               window_slots=16, chunk_steps=8, superchunk=8)
          if sim == "cut_spans" else _PATH_SIMS[sim])
    fails = (FailureScenario(**_STALL) if sim == "cut_spans"
             else _PATH_FAILS)
    moved = {}
    for collect in (False, True):
        spec = tsim.build_spec(_BFT1, _BFT1, SimConfig(
            collect_metrics=collect, **kw), fails)
        torch.cuda.synchronize()
        before = _counters()
        res = tsim.run_simulation(spec)
        moved[collect] = (res, tuple(a - b for a, b in
                                     zip(_counters(), before)))
    _same_run(moved[True][0], moved[False][0])
    assert moved[True][1] == moved[False][1]
    assert moved[True][1][2] > 0
    if sim == "cut_spans":
        assert moved[True][1][5] > 0


# (B, H, KV, Sq, Skv, D, causal, window, block): the JAX test grid, the
# window grid with and without the causal mask, an end-aligned prefill
# after a cache (with and without a window), causal Sq > Skv (rows that
# see no key), and ragged tiles (Sq = 96, Skv = 160 are not multiples of
# the kernel's 64)
ATTN_CASES = (
    [(2, 4, 2, 128, 128, 64, True, 0, 64), (1, 4, 4, 256, 256, 32, True, 0, 64),
     (2, 4, 1, 128, 256, 64, True, 0, 64), (1, 8, 2, 64, 64, 128, True, 0, 64)]
    + [(1, 2, 2, 128, 128, 64, c, w, 64) for c in (True, False)
       for w in (32, 64)]
    + [(1, 4, 1, 128, 1024, 128, True, 0, 128),
       (1, 4, 1, 128, 1024, 128, True, 300, 128),
       (1, 4, 2, 192, 64, 64, True, 0, 64),
       (1, 2, 1, 96, 160, 16, True, 48, 32)])
# bf16 only, for the wgmma kernel (128-row blocks, 128-key tiles): the K/V
# ring wrapped several times at D = 128 with GQA, causal and with a window;
# one case per head dim with Skv not a multiple of the tile (and Sq not a
# multiple of the block, so the last block holds rows past Sq)
SM90_CASES = ([(1, 8, 2, 1024, 1024, 128, True, w, 128) for w in (0, 300)]
              + [(1, 4, 2, 192, 300, d, True, 0, 4) for d in (16, 32, 64, 128)])
# (B, H, T, D, chunk): the JAX test grid and D = 128; T that is not a
# multiple of the stage depth the kernel picks (8 to 256 steps, by D, the
# dtype and the heads a SM), so the last stage is short, with fewer stages
# than the kernel's three, at D = 16, 32, 64 and 128 (several heads);
# long T, whose stages are refilled many times; more heads than the card
# has SMs
RWKV_CASES = [(2, 2, 64, 32, 16), (1, 4, 128, 64, 64), (2, 1, 256, 16, 128),
              (1, 2, 64, 64, 64), (1, 2, 96, 128, 32),
              (1, 3, 24, 16, 8), (2, 3, 48, 32, 16), (1, 2, 40, 64, 8),
              (2, 3, 80, 128, 16), (1, 2, 1032, 64, 8), (1, 1, 520, 128, 8),
              (4, 64, 128, 64, 64)]
ATTN_TOL = {torch.float32: (2e-6, 2e-6), torch.bfloat16: (1e-5, 1.6e-2)}


def _attn(b, h, kv, sq, skv, d, dtype, seed):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(s, dtype=np.float32)).to(
        dtype).cuda() for s in ((b, h, sq, d), (b, kv, skv, d),
                                (b, kv, skv, d))]


def _rwkv(b, h, t, d, dtype, seed):
    rng = np.random.default_rng(seed)
    shp = (b, h, t, d)
    r, k, v = (rng.standard_normal(shp, dtype=np.float32) * 0.5
               for _ in range(3))
    w = 1 / (1 + np.exp(-rng.standard_normal(shp, dtype=np.float32)))
    u = rng.standard_normal((h, d), dtype=np.float32) * 0.5
    return [torch.as_tensor(x).to(dtype).cuda()
            for x in (r, k, v, w * 0.5 + 0.45, u)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,kv,sq,skv,d,causal,window,blk", ATTN_CASES,
                         ids=["x".join(map(str, c)) for c in ATTN_CASES])
def test_flash_attention_kernel_matches_plain(b, h, kv, sq, skv, d, causal,
                                              window, blk, dtype):
    _need_cuda()
    _check_attention(b, h, kv, sq, skv, d, causal, window, blk, dtype)


@pytest.mark.parametrize("b,h,kv,sq,skv,d,causal,window,blk", SM90_CASES,
                         ids=["x".join(map(str, c)) for c in SM90_CASES])
def test_flash_attention_sm90_kernel_matches_plain(b, h, kv, sq, skv, d,
                                                   causal, window, blk):
    _need_cuda()
    _check_attention(b, h, kv, sq, skv, d, causal, window, blk,
                     torch.bfloat16)


def _check_attention(b, h, kv, sq, skv, d, causal, window, blk, dtype):
    q, k, v = _attn(b, h, kv, sq, skv, d, dtype, seed=sq + skv + d)
    want = mha_reference(q, k, v, causal=causal, window=window)
    fa = cuda_flash_attention
    before = (fa.launches, fa.launches_sm90, fa.launches_f32)
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              block_q=blk, block_kv=blk)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    assert (fa.launches, fa.launches_sm90, fa.launches_f32) == (
        before[0] + 1, before[1] + bf16, before[2] + (not bf16))
    assert got.dtype == dtype and got.shape == (b, h, sq, d)
    atol, rtol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    return got


# f32 only, for the 3xTF32 kernel (64-row blocks, 64-key tiles, the
# pre-pass's v^T padded to 32 keys): ragged Sq and Skv at every head dim,
# long causal and windowed rows with GQA, ragged and end-aligned with a
# window, 64 heads, all-masked rows
F32_CASES = ([(1, 4, 2, 100, 300, d, True, 0, 4) for d in (16, 32, 64, 128)]
             + [(1, 8, 2, 2048, 2048, 128, True, w, 128) for w in (0, 700)]
             + [(1, 8, 2, 1000, 1100, 128, True, 300, 4),
                (1, 64, 8, 256, 256, 64, True, 0, 64),
                (2, 4, 2, 200, 72, 128, True, 0, 8)])


@pytest.mark.parametrize("b,h,kv,sq,skv,d,causal,window,blk", F32_CASES,
                         ids=["x".join(map(str, c)) for c in F32_CASES])
def test_flash_attention_f32_kernel_matches_split_tf32(b, h, kv, sq, skv, d,
                                                       causal, window, blk):
    """The kernel meets 2e-6 against the f32 reference and against its own
    split in plain torch, three TF32 passes."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    got = _check_attention(b, h, kv, sq, skv, d, causal, window, blk,
                           torch.float32)
    q, k, v = _attn(b, h, kv, sq, skv, d, torch.float32, seed=sq + skv + d)
    torch.testing.assert_close(
        got, mha_split_tf32(q, k, v, causal=causal, window=window),
        atol=2e-6, rtol=2e-6)


def test_flash_attention_f32_kernel_is_run_to_run_exact():
    """No atomics and a fixed order of sums: two calls agree bit for
    bit."""
    _need_cuda()
    q, k, v = _attn(1, 8, 2, 512, 640, 128, torch.float32, seed=7)
    a = cuda_flash_attention(q, k, v, window=200, block_kv=64)
    b = cuda_flash_attention(q, k, v, window=200, block_kv=64)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_flash_attention_f32_inputs_at_the_16_byte_edge():
    """The pre-pass reads k and v in 16-byte units and TMA reads q from a
    16-byte aligned start: inputs that start 16 bytes past a 32-byte
    boundary are read right."""
    _need_cuda()
    q, k, v = _attn(1, 4, 2, 96, 136, 64, torch.float32, seed=3)

    def shifted(t):
        s = torch.empty(t.numel() + 4, device="cuda")[4:].view(t.shape)
        s.copy_(t)
        assert s.data_ptr() % 16 == 0 and s.data_ptr() % 32 != 0
        return s

    got = ops.flash_attention(shifted(q), shifted(k), shifted(v), window=40,
                              block_q=8, block_kv=8)
    torch.testing.assert_close(got, mha_reference(q, k, v, window=40),
                               atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,t,d,chunk", RWKV_CASES,
                         ids=["x".join(map(str, c)) for c in RWKV_CASES])
def test_rwkv6_kernel_matches_plain(b, h, t, d, chunk, dtype):
    _need_cuda()
    args = _rwkv(b, h, t, d, dtype, seed=t + d)
    want, _ = rwkv6_reference(*args)
    before = cuda_rwkv6_chunked.launches
    got = ops.rwkv6_chunked(*args, chunk=chunk)
    again = ops.rwkv6_chunked(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert cuda_rwkv6_chunked.launches == before + 2
    assert got.dtype == torch.float32 and got.shape == (b, h, t, d)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert torch.equal(got, again)          # no atomics: run to run exact


def test_attention_and_rwkv6_ops_never_fall_back(monkeypatch):
    _need_cuda()

    def boom(*_a, **_k):
        raise AssertionError("plain version called on CUDA tensors")

    monkeypatch.setattr(ops, "mha_reference", boom)
    monkeypatch.setattr(ops, "rwkv6_reference", boom)
    ops.flash_attention(*_attn(1, 2, 1, 64, 64, 32, torch.bfloat16, 1))
    ops.rwkv6_chunked(*_rwkv(1, 2, 64, 32, torch.float32, 1), chunk=32)
    torch.cuda.synchronize()


def test_flash_attention_kernel_rejects_bad_inputs():
    _need_cuda()
    q, k, v = _attn(1, 2, 1, 64, 64, 32, torch.float32, 2)
    with pytest.raises(TypeError, match="dtype"):
        cuda_flash_attention(q, k.bfloat16(), v)
    with pytest.raises(TypeError, match="dtype"):
        cuda_flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous"):
        cuda_flash_attention(q, k.transpose(2, 3).contiguous().transpose(2, 3),
                             v)
    with pytest.raises(ValueError, match="head dim"):
        cuda_flash_attention(*_attn(1, 2, 1, 64, 64, 48, torch.float32, 2))
    with pytest.raises(ValueError, match="multiple of KV"):
        cuda_flash_attention(*_attn(1, 3, 2, 64, 64, 32, torch.float32, 2))
    with pytest.raises(ValueError, match="expected cuda"):
        cuda_flash_attention(q, k.cpu(), v)


def test_rwkv6_kernel_rejects_bad_inputs():
    _need_cuda()
    r, k, v, w, u = _rwkv(1, 2, 64, 32, torch.float32, 3)
    with pytest.raises(TypeError, match="dtype"):
        cuda_rwkv6_chunked(r, k, v, w, u.bfloat16(), chunk=32)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_rwkv6_chunked(r, k, v.transpose(2, 3).contiguous().transpose(
            2, 3), w, u, chunk=32)
    with pytest.raises(ValueError, match="multiple of chunk"):
        cuda_rwkv6_chunked(r, k, v, w, u, chunk=48)
    with pytest.raises(ValueError, match="head dim"):
        cuda_rwkv6_chunked(*_rwkv(1, 2, 64, 24, torch.float32, 3), chunk=32)
    shifted = torch.empty(r.numel() + 1, device="cuda")[1:].view(r.shape)
    shifted.copy_(r)                       # contiguous, 4 bytes off 16
    with pytest.raises(ValueError, match="16-byte"):
        cuda_rwkv6_chunked(shifted, k, v, w, u, chunk=32)


# ------------------------------------------- topologies and applications
def _same_topology(a, b, outputs_only=False):
    """Two topology runs link by link: outputs and floors, and (for two
    engine runs) every other field of ``_same_run``."""
    assert list(a.links) == list(b.links)
    for name in a.links:
        x, y = a[name], b[name]
        assert np.array_equal(x.commit_floors, y.commit_floors), name
        if outputs_only:
            for f in ("quack_time", "deliver_time", "retry", "recv_has",
                      "send_step", "delivery_latency", "gc_frontiers"):
                assert np.array_equal(getattr(x.result, f),
                                      getattr(y.result, f)), (name, f)
        else:
            _same_run(x.result, y.result)
            assert (x.result.final_window_slots
                    == y.result.final_window_slots)


def test_floor_written_in_place_reaches_the_captured_program():
    """The captured chunk programs read the commit floor from a tensor
    the loop rewrites in place: a floor held at 0 for three chunks and
    opened to M before the fourth makes the *same* captured program,
    replayed, dispatch the stream from round 24 on (a floor written as
    a new tensor would leave the graph reading 0)."""
    _need_cuda()
    cfg = RSMConfig.bft(1)
    spec = tsim.build_spec(cfg, cfg, SimConfig(
        n_msgs=256, steps=80, window_slots=256, chunk_steps=8))
    opens = 24

    def floors(t, bases):
        return np.full(1, 0 if t < opens else spec.m, dtype=np.int64)

    cpu = tsim._run_windowed_batch([spec], torch.device("cpu"),
                                   commit_floors=floors)[0]
    graphs.clear_programs()
    captures = graphs.capture_count()
    replays = graphs.replay_count()
    gpu = tsim._run_windowed_batch([spec], torch.device("cuda"),
                                   commit_floors=floors)[0]
    # one rotating chunk program and the last chunk's, every chunk a
    # replay
    assert graphs.capture_count() - captures == 2
    assert graphs.replay_count() - replays == spec.steps // 8
    _same_run(gpu, cpu)
    cross = gpu.metrics.cross_msgs
    assert cross[:opens].sum() == 0 and cross[opens:opens + 8].sum() > 0
    ostep = np.asarray(spec.orig_step)
    want = np.where(ostep < spec.steps, np.maximum(ostep, opens), -1)
    assert np.array_equal(gpu.send_step, want)
    assert (gpu.deliver_time >= 0).all()


def _topology_fixtures():
    from repro_torch.topology import Topology
    cfg = RSMConfig.bft(1)
    sim = SimConfig(n_msgs=256, steps=160, window_slots=64, chunk_steps=16)
    return {
        "fanout": Topology.fanout(
            "p", ["b0", "b1", "b2"], cfg, sim,
            failures={"b0": FailureScenario(crash_r=(8, 8, -1, -1)),
                      "b2": FailureScenario(
                          byz_recv_drop=(True, False, False, False))}),
        "chain": Topology.chain(
            ["a", "b", "c", "d"], cfg, sim,
            failures={"b->c": FailureScenario(crash_r=(8, 8, -1, -1))}),
        "chain_gc_stall": Topology.chain(
            ["a", "b", "c"], cfg, SimConfig(
                n_msgs=256, steps=200, window_slots=64, chunk_steps=16,
                collect_metrics=True),
            failures={"a->b": FailureScenario(
                byz_bcast_partial=(True, False, False, False),
                bcast_limit=2)}),
    }


@pytest.mark.parametrize("name", ["fanout", "chain", "chain_gc_stall"])
def test_topology_cuda_run_matches_cpu_run_and_mirror(name):
    """A topology on the card == on the CPU (every output, metric, floor
    and frontier; metrics too where on) == the numpy mirror; one launch
    pair a round covers every link."""
    _need_cuda()
    from repro_torch.topology import run_topology, run_topology_reference
    topo = _topology_fixtures()[name]
    cpu = run_topology(topo, device="cpu")
    before = cuda_quack_scan.launches
    gpu = run_topology(topo)
    chunks = -(-topo.sim.steps // topo.sim.chunk_steps)
    assert (cuda_quack_scan.launches - before
            == 2 * topo.sim.steps + chunks - 1)
    _same_topology(gpu, cpu)
    if topo.sim.collect_metrics:
        for lname in gpu.links:
            _same_obs(gpu[lname].result.obs, cpu[lname].result.obs)
    _same_topology(gpu, run_topology_reference(topo), outputs_only=True)


def test_disaster_recovery_cuda_matches_cpu_and_mirror():
    """A primary crash with a laggy and a Byzantine backup: the card's
    report == the CPU's == the numpy mirror's, field by field."""
    _need_cuda()
    from repro_torch.apps import run_disaster_recovery
    cfg = RSMConfig.bft(1)
    sim = SimConfig(n_msgs=256, steps=120, window_slots=64, chunk_steps=8)
    kw = dict(backups=["backup-0", "backup-1", "backup-2"], crash_at=10,
              backup_failures={
                  "backup-1": FailureScenario(crash_r=(2, 2, -1, -1)),
                  "backup-2": FailureScenario(
                      byz_recv_drop=(True, False, False, False))})
    gpu = run_disaster_recovery(cfg, cfg, sim, **kw)
    cpu = run_disaster_recovery(cfg, cfg, sim, device="cpu", **kw)
    ref = run_disaster_recovery(cfg, cfg, sim, use_reference=True, **kw)
    assert gpu.converged and 0 < gpu.recovered_entries < sim.n_msgs
    for other in (cpu, ref):
        assert gpu.elected == other.elected
        assert gpu.phase1_prefixes == other.phase1_prefixes
        assert gpu.final_prefixes == other.final_prefixes
        assert gpu.converged == other.converged
        assert np.array_equal(gpu.recovered_log, other.recovered_log)
    _same_topology(gpu.phase1, cpu.phase1)
    _same_topology(gpu.phase2, cpu.phase2)
    _same_topology(gpu.phase1, ref.phase1, outputs_only=True)


# ------------------------------------------ programs kept, and replay
def _replay_spec(**kw):
    sim = dict(n_msgs=256, steps=120, window=1, window_slots=64,
               chunk_steps=8)
    return tsim.build_spec(_BFT1, _BFT1, SimConfig(**dict(sim, **kw)))


@pytest.mark.parametrize("windowed", [True, False],
                         ids=["windowed", "dense"])
def test_warm_runs_capture_nothing_on_cuda(windowed):
    """Three identical runs capture +N, +0, +0 graphs and replay the
    same number each time; every run == the CPU run."""
    _need_cuda()
    kw = dict(superchunk=4) if windowed else dict(window_slots=None)
    spec = _replay_spec(**kw)
    cpu = tsim.run_simulation(spec, device="cpu")
    graphs.clear_programs()
    moved = []
    for _ in range(3):
        before = (graphs.capture_count(), graphs.replay_count())
        res = tsim.run_simulation(spec)
        moved.append(tuple(a - b for a, b in zip(
            (graphs.capture_count(), graphs.replay_count()), before)))
        for f in ("quack_time", "deliver_time", "retry", "recv_has"):
            assert np.array_equal(getattr(res, f), getattr(cpu, f)), f
    (c0, r0), (c1, r1), (c2, r2) = moved
    assert c0 > 0 and c1 == c2 == 0 and r0 == r1 == r2


def test_capture_after_another_run_of_the_layout():
    """K is not part of a layout: a K = 1 run leaves the set's round
    tensor at its last chunk, and the K = 8 run after it captures its
    spans there; each capture's warm-up must run at its own round (a
    span from the last round would index past the run's dispatch
    horizons). Both == the CPU run."""
    _need_cuda()
    graphs.clear_programs()
    cpu = tsim.run_simulation(_replay_spec(), device="cpu")
    for k in (1, 8):
        res = tsim.run_simulation(_replay_spec(superchunk=k))
        _same_run(res, cpu)


def test_fail_schedule_swap_reaches_the_captured_program():
    """The captured chunk programs read the per-lane inputs from tensors
    a swap rewrites in place: every sender crashing at round 24, swapped
    in before the fourth chunk, makes the *same* captured rotating-chunk
    program, replayed, stop sending from round 24 on (inputs written as
    new tensors would leave the graph sending)."""
    _need_cuda()
    spec = _replay_spec(window_slots=256)          # W = M: never grows
    crashed = tsim.spec_with_failures(spec, FailureScenario(
        crash_s=(24,) * 4))

    def schedule(t):
        return [crashed] if t == 24 else None

    cpu = tsim._run_windowed_batch([spec], torch.device("cpu"),
                                   fail_schedule=schedule)[0]
    graphs.clear_programs()
    captures = graphs.capture_count()
    gpu = tsim._run_windowed_batch([spec], torch.device("cuda"),
                                   fail_schedule=schedule)[0]
    assert graphs.capture_count() - captures == 2
    _same_run(gpu, cpu)
    cross = gpu.metrics.cross_msgs
    assert cross[16:24].sum() > 0 and cross[24:].sum() == 0
    plain = tsim.run_simulation(spec)
    assert plain.metrics.cross_msgs[24:].sum() > 0
    scratch = tsim.run_simulation(crashed)
    for f in ("quack_time", "deliver_time", "retry", "recv_has"):
        assert np.array_equal(getattr(gpu, f), getattr(scratch, f)), f


def test_replay_equals_original_on_cuda():
    """A run recorded on the card (stakes re-weighted to non-integers,
    which its checkpoints keep bit for bit) replays from every
    checkpoint to the original, capturing nothing; an injected replay ==
    the CPU's and the numpy oracle's; a fork set == its replays."""
    _need_cuda()
    from repro_torch.replay import (ForkSpec, Injection, fork_whatif,
                                    record_simulation, replay,
                                    replay_oracle)
    spec = tsim.spec_with_quorum(_replay_spec(),
                                 stakes_r=(1.5, 1.0, 1.0, 0.75),
                                 quack_thresh=2.25)
    graphs.clear_programs()
    res, trace = record_simulation(spec)
    cres, ctrace = record_simulation(spec, device="cpu")
    _same_run(res, cres)
    for c, cc in zip(trace.checkpoints, ctrace.checkpoints):
        for f in c.state._fields + c.fails._fields:
            x = getattr(c.state if f in c.state._fields else c.fails, f)
            y = getattr(cc.state if f in cc.state._fields else cc.fails, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert trace.checkpoints[1].fails.stakes_r.dtype == np.float32
    assert np.array_equal(trace.checkpoints[1].fails.stakes_r[0],
                          np.asarray(spec.stakes_r, dtype=np.float32))
    captures = graphs.capture_count()
    for t in trace.boundaries().tolist():
        rr = replay(trace, t)[0]
        # == the CPU's replay in every field; == the original in what the
        # replay contract covers (from round 0 the JAX package's resume,
        # and so the port's, reports no send_step: ROADMAP queue 3)
        _same_run(rr, replay(ctrace, t, device="cpu")[0])
        for f in ("quack_time", "deliver_time", "retry", "recv_has",
                  "gc_frontiers"):
            assert np.array_equal(getattr(rr, f), getattr(res, f)), f
        for f in tsim.StepMetrics._fields:
            assert np.array_equal(getattr(rr.metrics, f),
                                  getattr(res.metrics, f)), f
    assert graphs.capture_count() == captures
    inj = [Injection(16, FailureScenario(crash_s=(16, -1, -1, -1)))]
    ri = replay(trace, 16, inj)[0]
    _same_run(ri, replay(ctrace, 16, inj, device="cpu")[0])
    ref = replay_oracle(trace, inj)
    for f in ("quack_time", "deliver_time", "retry", "recv_has"):
        assert np.array_equal(getattr(ri, f), getattr(ref, f)), f
    forks = [ForkSpec("base"), ForkSpec("crash", inj)]
    report = fork_whatif(trace, 16, forks)
    for fs in forks:
        solo = replay(trace, 16, fs.injections)[0]
        for f in ("quack_time", "deliver_time", "retry", "recv_has"):
            assert np.array_equal(getattr(report[fs.name].results[0], f),
                                  getattr(solo, f)), f
    late = [ForkSpec("base"), ForkSpec("crash", [Injection(
        24, FailureScenario(crash_s=(24, -1, -1, -1)))])]
    assert fork_whatif(trace, 24, late).chunk_traces == 0


def test_disaster_recovery_injected_on_cuda():
    """The crash injected into a recorded stream on the card == the
    static schedule's report, and == the CPU's injected run."""
    _need_cuda()
    from repro_torch.apps import run_disaster_recovery
    cfg = RSMConfig.bft(1)
    sim = SimConfig(n_msgs=96, steps=60, window=1, phi=6, window_slots=24,
                    chunk_steps=8)
    kw = dict(crash_at=12, backup_failures={
        "backup-1": FailureScenario(byz_recv_drop=(True, True, False,
                                                   False))})
    static = run_disaster_recovery(cfg, cfg, sim, **kw)
    injected = run_disaster_recovery(cfg, cfg, sim, inject_via_replay=True,
                                     **kw)
    cpu = run_disaster_recovery(cfg, cfg, sim, inject_via_replay=True,
                                device="cpu", **kw)
    assert injected.injected_at == 8 and injected.phase1_trace is not None
    for other in (static, cpu):
        assert injected.elected == other.elected
        assert injected.phase1_prefixes == other.phase1_prefixes
        assert injected.final_prefixes == other.final_prefixes
        assert np.array_equal(injected.recovered_log, other.recovered_log)
    _same_topology(injected.phase1, cpu.phase1)


# ------------------------------------------- streaming and the sanitizer
def _stream_session(device, horizon=512, **cfg):
    from repro_torch.stream import ArrivalProcess, StreamConfig, \
        StreamSession
    b = RSMConfig.bft(1)
    sim = SimConfig(window=4, phi=6, window_slots="auto", chunk_steps=16,
                    superchunk=8)
    cfg.setdefault("process", ArrivalProcess(kind="diurnal", rate=4.0,
                                             period=64))
    return StreamSession(b, b, sim, StreamConfig(horizon=horizon, **cfg),
                         device=device)


def _session_dict(res):
    d = res.to_json_dict()
    d["counters"] = {k: v for k, v in d["counters"].items()
                     if k != "traces"}
    return d


@pytest.mark.parametrize("links,chained", [(1, False), (3, True)],
                         ids=["single", "chained"])
def test_stream_session_cuda_equals_cpu(links, chained, tmp_path):
    """A session on the card == the same session on the CPU: its report,
    every live row (the JSON-lines stream), SLO events, sketch,
    ``ObsMetrics``, width, growth events, dispatches and host syncs."""
    _need_cuda()
    runs = []
    for dev in ("cuda", "cpu"):
        sess = _stream_session(dev, links=links, chained=chained,
                               jsonl_path=str(tmp_path / f"{dev}.jsonl"))
        runs.append(sess.run())
    gpu, cpu = runs
    assert gpu.problems == [] and gpu.delivered == 512 * links
    assert _session_dict(gpu) == _session_dict(cpu)
    assert (tmp_path / "cuda.jsonl").read_text() == \
        (tmp_path / "cpu.jsonl").read_text()
    assert [e.to_dict() for e in gpu.slo_events] == \
        [e.to_dict() for e in cpu.slo_events]
    for a, b in zip(gpu.obs, cpu.obs):
        assert a.to_dict() == b.to_dict()
    assert np.array_equal(gpu.sketch.hist, cpu.sketch.hist)


def test_batch_run_after_a_session_captures_nothing():
    """Horizon mode runs the batch run's programs: after a session, a
    batch run of its spec replays them (0 captures) with the same
    dispatches and host syncs, and its histogram is the live one."""
    _need_cuda()
    graphs.clear_programs()
    sess = _stream_session(None, horizon=2048)
    d0 = (tsim.chunk_dispatch_count(), tsim.host_sync_count())
    res = sess.run()
    stream = (tsim.chunk_dispatch_count() - d0[0],
              tsim.host_sync_count() - d0[1])
    c0 = graphs.capture_count()
    d0 = (tsim.chunk_dispatch_count(), tsim.host_sync_count())
    batch = tsim.run_simulation(sess.spec)
    assert graphs.capture_count() == c0
    assert stream == (tsim.chunk_dispatch_count() - d0[0],
                      tsim.host_sync_count() - d0[1])
    assert res.counters["traces"] > 0
    assert np.array_equal(res.sketch.lane_sum(), batch.obs.latency_hist)
    assert bool((batch.deliver_time >= 0).all())


def test_horizon_mode_allocates_no_stream_sized_host_array():
    """tracemalloc around warm runs on the card: a session's host peak
    is under a tenth of the (B, ..., M) mirrors of the batch run of the
    same spec, and under a tenth of that run's peak."""
    _need_cuda()
    import tracemalloc

    from repro_torch.stream import ArrivalProcess
    sess = _stream_session(None, horizon=131072,
                           process=ArrivalProcess(rate=64.0))
    sess.run()
    tsim.run_simulation(sess.spec)
    peaks = []
    for run in (sess.run, lambda: tsim.run_simulation(sess.spec)):
        tracemalloc.start()
        try:
            run()
            peaks.append(tracemalloc.get_traced_memory()[1])
        finally:
            tracemalloc.stop()
    spec = sess.spec
    mirrors = (2 * spec.n_s * 4 + spec.n_r + 4 + 8) * spec.m
    assert peaks[1] > mirrors > 10 * peaks[0], (peaks, mirrors)
    assert 10 * peaks[0] < peaks[1], peaks


def test_engine_guard_on_cuda():
    """On the card the guard holds the sync debug mode at "error": a
    seeded ``.item()`` raises ``SanitizerError``; a real K = 8 run with
    ``debug_checks`` (captures included, then warm) passes its contract
    with 0 implicit transfers and equals the run without the checks."""
    _need_cuda()
    import dataclasses

    from repro_torch.analysis import (SanitizerError, dispatch_contract,
                                      engine_guard, sanitized)
    x = torch.arange(4, device="cuda")
    with pytest.raises(SanitizerError, match="implicit device->host"):
        with engine_guard():
            x.sum().item()
    with pytest.raises(SanitizerError, match="implicit device->host"):
        with engine_guard():
            x.cpu()
    assert torch.cuda.get_sync_debug_mode() == 0
    graphs.clear_programs()
    spec = tsim.build_spec(RSMConfig.bft(1), RSMConfig.bft(1), SimConfig(
        n_msgs=512, steps=168, window=1, phi=6, window_slots=96,
        chunk_steps=4, superchunk=8, debug_checks=True,
        collect_metrics=True))
    with sanitized(dispatch_contract(spec)) as cold:
        a = tsim.run_simulation(spec)
    with sanitized(dispatch_contract(spec, warm=True)) as warm:
        tsim.run_simulation(spec)
    assert cold.transfers == () == warm.transfers
    assert cold.recompiles > 0 and warm.recompiles == 0
    assert warm.dispatches <= -(-(-(-spec.steps // spec.chunk_steps))
                                // 8) + 2
    b = tsim.run_simulation(dataclasses.replace(spec, debug_checks=False))
    for f in ("quack_time", "deliver_time", "retry", "recv_has",
              "gc_frontiers", "send_step"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert a.obs.to_dict() == b.obs.to_dict()
    assert torch.cuda.get_sync_debug_mode() == 0


def test_program_audit_on_cuda():
    """The eight captured programs, run once each on clones of their
    state on the card under the auditor: no host sync, no widening, no
    CPU operand, and ``quack_scan`` launches 2 x rounds + one a rotating
    chunk. Controls on the card: a ``.item()`` and a CPU operand."""
    _need_cuda()
    from repro_torch.analysis.programlint import audit_callable, audit_engine
    report = audit_engine(device="cuda")
    assert report["ok"], report["violations"]
    assert len(report["programs"]) == 8
    for prog in report["programs"]:
        assert prog["device"].startswith("cuda")
        assert not prog["cpu_operands"] and not prog["host_syncs"]
        assert prog["launches"] == prog["expected_launches"] > 0, prog
        assert 0 < prog["launches_no_lost"] < prog["launches"], prog
    state = (torch.arange(8, dtype=torch.int32, device="cuda"),)
    host = torch.arange(8, dtype=torch.int32)

    def item(carry, t0):
        return (carry[0] + carry[0].sum().item(),), []

    def cpu_operand(carry, t0):
        return (carry[0] + host.to("cuda"),), []

    for body, word in ((item, "host sync"), (cpu_operand, "CPU operand")):
        audit = audit_callable(body, state, body.__name__, "cuda")
        assert not audit.ok
        assert any(word in v for v in audit.violations()), \
            audit.violations()


# ------------------------------------------- the cross-pod runtime
def _tree_on(device, seed, shapes, scale=1.0, lead=1):
    g = torch.Generator().manual_seed(seed)
    return {k: (torch.randn((lead * s[0],) + s[1:], generator=g) * scale)
            .to(device) for k, s in shapes.items()}


XP_SHAPES = {"w": (12, 5, 8), "odd": (7,), "mat": (16, 48)}


@pytest.mark.parametrize("split", [False, True])
def test_crosspod_sync_on_cuda(split):
    """Both schedules on a (2, 4, 2) mesh held on the card against the
    same on the CPU (1e-6: the sums run in another order), outputs on the
    card; with ``P(("pod", "data"))`` every position a distinct block and
    the result their mean."""
    _need_cuda()
    from repro_torch.crosspod import ata_cross_pod_sync, picsou_cross_pod_sync
    from repro_torch.launch.mesh import P, make_mesh
    mesh = make_mesh((2, 4, 2), ("pod", "data", "model"))
    assert mesh.device.type == "cuda"
    cpu = make_mesh((2, 4, 2), ("pod", "data", "model"), device="cpu")
    lead = 8 if split else 1
    spec = P(("pod", "data")) if split else P()
    host = _tree_on("cpu", 3, XP_SHAPES, lead=lead)
    dev = {k: v.cuda() for k, v in host.items()}
    for fn in (picsou_cross_pod_sync, ata_cross_pod_sync):
        got, want = fn(dev, mesh, spec), fn(host, cpu, spec)
        for k, x in host.items():
            assert got[k].is_cuda and got[k].shape == x.shape
            assert torch.allclose(got[k].cpu(), want[k], rtol=0, atol=1e-6)
            mean = x.double().reshape(lead, -1).mean(0)
            assert torch.allclose(got[k].cpu().double().reshape(lead, -1),
                                  mean.expand(lead, -1), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="given to a mesh"):
        picsou_cross_pod_sync(host, mesh, spec)


def test_crosspod_ef_int8_on_cuda_bit_for_bit():
    """EF-int8 over 20 steps on the card: q, scales, pad and residual
    equal the CPU's bit for bit; everything stays on the card."""
    _need_cuda()
    from repro_torch.crosspod import (ef_int8_compress, ef_int8_decompress,
                                      make_ef_state)
    base = _tree_on("cpu", 4, XP_SHAPES, scale=0.01)
    res_h = make_ef_state(base)
    res_d = make_ef_state({k: v.cuda() for k, v in base.items()})
    assert all(r.is_cuda for r in res_d.values())
    for step in range(20):
        for k, g in base.items():
            g = g * (1 + 0.1 * step)
            (qh, sh, ph), res_h[k] = ef_int8_compress(g, res_h[k])
            (qd, sd, pd), res_d[k] = ef_int8_compress(g.cuda(), res_d[k])
            assert qd.is_cuda and sd.is_cuda and res_d[k].is_cuda
            assert ph == pd and torch.equal(qh, qd.cpu())
            assert torch.equal(sh, sd.cpu())
            assert torch.equal(res_h[k], res_d[k].cpu())
            deq = ef_int8_decompress((qd, sd, pd), g.shape)
            assert deq.is_cuda and torch.equal(
                deq.cpu(), ef_int8_decompress((qh, sh, ph), g.shape))


def test_crosspod_adamw_on_cuda():
    """Three clipped AdamW steps with the cosine schedule on the card
    against the CPU: within 1e-6 of each leaf's largest magnitude, step
    exact, f32 and bf16 leaves, state on the card."""
    _need_cuda()
    from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                                   cosine_schedule)
    ph = _tree_on("cpu", 5, XP_SHAPES, scale=0.02)
    ph["odd"] = ph["odd"].to(torch.bfloat16)
    pd = {k: v.cuda() for k, v in ph.items()}
    sh, sd = adamw_init(ph), adamw_init(pd)
    assert sd.step.is_cuda
    cfg = AdamWConfig(lr=1e-2)
    for step in range(3):
        g = _tree_on("cpu", 10 + step, XP_SHAPES)
        ph, sh = adamw_update(cfg, g, ph, sh, cosine_schedule(sh.step, 1, 9))
        pd, sd = adamw_update(cfg, {k: v.cuda() for k, v in g.items()},
                              pd, sd, cosine_schedule(sd.step, 1, 9))
        assert int(sd.step) == int(sh.step) == step + 1
        for th, td in ((ph, pd), (sh.m, sd.m), (sh.v, sd.v)):
            for k in th:
                assert td[k].is_cuda and td[k].dtype == th[k].dtype
                want = th[k].double()
                err = (td[k].cpu().double() - want).abs().max()
                if th[k].dtype == torch.bfloat16:
                    assert err <= want.abs().max() * 2 ** -7
                else:
                    assert err <= 1e-6 * want.abs().max()


def test_crosspod_checkpoint_round_trip_from_cuda(tmp_path):
    """``save_async`` of (params, AdamW state) from the card, ``wait``,
    ``restore_tree`` onto the card: bit for bit, on the card, replicated
    durably; the tensors may change as soon as ``save_async`` returns."""
    _need_cuda()
    from repro_torch.checkpoint import CheckpointManager, restore_tree
    from repro_torch.optim import adamw_init
    from repro_torch.tree_util import tree_leaves, tree_map
    params = {k: v.cuda() for k, v in _tree_on("cpu", 6, XP_SHAPES).items()}
    params["odd"] = params["odd"].to(torch.bfloat16)
    tree = (params, adamw_init(params))
    want = tree_map(torch.clone, tree)
    mgr = CheckpointManager(str(tmp_path), n_shards=3)
    mgr.save_async(5, tree)
    params["w"].zero_()
    mgr.wait(timeout=60)
    assert mgr.result(5)["replication"]["durable_frac"] == 1.0
    mgr.close()
    out, step = restore_tree(tree_map(torch.empty_like, want), str(tmp_path))
    assert step == 5
    for a, b in zip(tree_leaves(out), tree_leaves(want)):
        assert a.is_cuda and a.dtype == b.dtype and torch.equal(a, b)


# the serving path: smoke configs of each family (dense, SWA MoE,
# RWKV6, hybrid, encoder-decoder, VLM)
SERVE_ARCHS = ["granite-8b", "mixtral-8x22b", "rwkv6-7b", "hymba-1.5b",
               "whisper-small", "llama-3.2-vision-11b"]


def _served_model(arch, dtype="float32"):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype=dtype)
    params = M.init_model(cfg, 5, device="cpu")
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 18)).astype(
        np.int32))
    memory = None
    if cfg.family in ("encdec", "vlm"):
        n = cfg.encoder_seq if cfg.family == "encdec" else cfg.vision_seq
        memory = torch.from_numpy(rng.standard_normal(
            (2, n, cfg.d_model)).astype(np.float32))
    return cfg, params, tokens, memory


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_model_prefill_launches_the_kernel_once_a_layer(dtype):
    """The default route on CUDA: the dtype's attention kernel once per
    attention layer of a prefill, never in a decode step."""
    _need_cuda()
    from repro_torch.models import model as M
    from repro_torch.tree_util import tree_map
    cfg, params, tokens, _ = _served_model("granite-8b", dtype)
    params = tree_map(lambda a: a.cuda(), params)
    tokens = tokens.cuda()
    fa = cuda_flash_attention
    fa.launches = fa.launches_sm90 = fa.launches_f32 = 0
    _, caches = M.prefill(params, cfg, tokens[:, :16], cache_len=18)
    torch.cuda.synchronize()
    route = (fa.launches_sm90 if dtype == "bfloat16" else fa.launches_f32)
    assert fa.launches == route == cfg.n_layers
    M.decode_step(params, cfg, caches, tokens[:, 16:17], 16)
    torch.cuda.synchronize()
    assert fa.launches == cfg.n_layers


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_smoke_model_on_cuda_equals_its_cpu_twin(arch):
    """Forward, prefill (last logits, caches) and two decode steps on CUDA
    (prefill attention on the f32 kernel) against the CPU on the same
    weights, within 1e-4 of each output's largest entry (whisper-small
    1e-3: its smoke encoder is ill-conditioned)."""
    _need_cuda()
    from repro_torch.models import model as M
    from repro_torch.tree_util import tree_leaves, tree_map
    cfg, params, tokens, memory = _served_model(arch)
    tol = 1e-3 if arch == "whisper-small" else 1e-4

    def run(p, toks, mem):
        fwd_mem = (M.encode(p, cfg, mem) if cfg.family == "encdec"
                   else mem)
        rings = cfg.family == "moe" and cfg.sliding_window > 0
        out = [M.forward(p, cfg, toks, memory=fwd_mem)[0]]
        last, caches = M.prefill(p, cfg, toks[:, :16], memory=mem,
                                 cache_len=None if rings else 18)
        out += [last] + tree_leaves(caches)
        for i in range(2):
            logits, caches = M.decode_step(p, cfg, caches,
                                           toks[:, 16 + i:17 + i], 16 + i)
            out.append(logits)
        return out

    want = run(params, tokens, memory)
    got = run(tree_map(lambda a: a.cuda(), params), tokens.cuda(),
              None if memory is None else memory.cuda())
    for g, w in zip(got, want):
        assert g.is_cuda and g.dtype == w.dtype and g.shape == w.shape
        err = (g.cpu() - w).abs().max() / w.abs().max().clamp(min=1e-30)
        assert err <= tol


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_captured_decode_step_equals_the_eager_step_on_cuda(arch):
    """``launch.steps.decode`` on CUDA, three steps after a prefill (a
    sliding-window ring wrapping for mixtral-8x22b): one capture then a
    replay a step, nothing captured by a second generation on the same
    weights; logits and every cache leaf equal to ``decode_step`` run
    eagerly on CUDA on a copy of the caches, bit for bit; the caches
    returned views of the set's buffers at fixed addresses."""
    _need_cuda()
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.tree_util import tree_leaves, tree_map
    cfg, params, tokens, memory = _served_model(arch)
    params = tree_map(lambda a: a.cuda(), params)
    tokens = tokens.cuda()
    memory = None if memory is None else memory.cuda()
    rings = cfg.family == "moe" and cfg.sliding_window > 0
    graphs.clear_programs()
    kept = None
    for gen in range(2):
        _, caches = M.prefill(params, cfg, tokens[:, :16], memory=memory,
                              cache_len=None if rings else 19)
        want = tree_map(torch.clone, caches)
        before = (graphs.capture_count(), graphs.replay_count())
        for i in range(3):
            tok = tokens[:, 15:16] if i == 2 else tokens[:, 16 + i:17 + i]
            logits, caches = steps.decode(params, cfg, caches, tok, 16 + i)
            w_logits, want = M.decode_step(params, cfg, want, tok, 16 + i)
            assert logits.is_cuda and torch.equal(logits, w_logits), i
            assert all(torch.equal(g, w) for g, w in
                       zip(tree_leaves(caches), tree_leaves(want))), i
            ptrs = [x.data_ptr() for x in tree_leaves(caches)]
            kept = kept or ptrs
            assert ptrs == kept
        assert (graphs.capture_count() - before[0],
                graphs.replay_count() - before[1]) == (1 - gen, 3)
    graphs.clear_programs()


def test_donated_train_update_on_cuda_is_adamw_update():
    """``launch.steps.train_update`` (``optim.adamw_update_``) on CUDA,
    three steps of granite-8b smoke's leaves with moving gradients:
    parameters, m, v and step bit for bit the functional
    ``adamw_update``'s on the card, every leaf written in place."""
    _need_cuda()
    from repro_torch.launch import steps
    from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                                   cosine_schedule)
    from repro_torch.tree_util import tree_leaves, tree_map
    _, params, _, _ = _served_model("granite-8b")
    params = tree_map(lambda a: a.cuda(), params)
    ref_p, ref_s = tree_map(torch.clone, params), adamw_init(params)
    opt = adamw_init(params)
    ptrs = [x.data_ptr() for x in tree_leaves((params, opt))]
    gen = torch.Generator(device="cuda").manual_seed(3)
    cfg = AdamWConfig()
    for _ in range(3):
        grads = tree_map(lambda a: torch.randn(
            a.shape, generator=gen, device="cuda"), params)
        ref_p, ref_s = adamw_update(cfg, grads, ref_p, ref_s,
                                    cosine_schedule(ref_s.step, 1, 10))
        got = steps.train_update(cfg, grads, params, opt, 1, 10)
        assert got[0] is params and got[1] is opt
        for a, w in zip(tree_leaves((params, opt)),
                        tree_leaves((ref_p, ref_s))):
            assert a.is_cuda and torch.equal(a, w)
    assert [x.data_ptr() for x in tree_leaves((params, opt))] == ptrs


def _route_grads(attn, q, k, v, do, impl, **kw):
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    return torch.autograd.grad(attn(*xs, impl=impl, **kw), xs, do)


def test_model_kernel_route_refuses_autograd_on_cuda():
    """The kernel route under autograd on CUDA (the name is from when it
    refused): its forward launches the dtype's kernel once, counted; its
    dQ, dK, dV are the scan route's within 1e-6 of each one's largest
    magnitude, in bf16 and f32, causal and with a sliding window."""
    _need_cuda()
    from repro_torch.models.attention import attention
    gen = torch.Generator(device="cuda").manual_seed(3)
    fa = cuda_flash_attention
    for dtype, window in ((torch.bfloat16, 0), (torch.float32, 0),
                          (torch.bfloat16, 96)):
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       .to(dtype) for shape in
                       ((2, 256, 8, 64), (2, 256, 2, 64), (2, 256, 2, 64),
                        (2, 256, 8, 64)))
        kw = dict(window=window, block_q=64, block_kv=128)
        fa.launches = fa.launches_sm90 = fa.launches_f32 = 0
        got = _route_grads(attention, q, k, v, do, None, **kw)
        torch.cuda.synchronize()
        route = (fa.launches_sm90 if dtype == torch.bfloat16
                 else fa.launches_f32)
        assert fa.launches == route == 1
        want = _route_grads(attention, q, k, v, do, "scan", **kw)
        assert fa.launches == 1
        for g, w in zip(got, want):
            assert g.is_cuda and g.dtype == dtype
            err = (g.float() - w.float()).abs().max() / w.float().abs().max()
            assert err <= 1e-6, (dtype, window, float(err))


# the training path: one build_train_step step of a smoke config with
# remat on, CUDA (attention on the f32 kernel) against the CPU
TRAIN_ARCHS = ["granite-8b", "mixtral-8x22b", "hymba-1.5b", "whisper-small"]


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_on_cuda_equals_cpu(arch):
    """Loss, every gradient leaf, and AdamW's m and v after two
    ``build_train_step`` steps (warmup 1: the lr scale is 0 at step 0 and
    whole at step 1; m and v carry the steps' gradients), each within
    1e-4 of each leaf's largest magnitude or, where larger, within
    twice the CPU's own f32 distance from an f64 run of the same steps
    (two f32 runs, each that far from f64: the smoke model's
    conditioning, mixtral-8x22b, whisper-small); v, which holds squares,
    within at least twice m's limit. The parameters after the moving
    step are not compared between the two runs: AdamW moves an entry
    whose gradient is f32 noise by up to lr on either device
    (``chip_smoke.py`` 13a logs the distance). The card's update itself
    is held instead: the CPU's moving-step update arguments (its
    gradients, the parameters and AdamW state of the step before),
    carried to the card through the same ``steps.train_update`` call,
    give the CPU step's parameters, m and v within 1e-6 of each leaf's
    largest magnitude (phase 11c's limit), and the same update with
    beta2 0.999 for 0.95 breaks that on the parameters and on v. A step
    launches the f32 kernel twice a layer of a stacked segment (remat)
    and once elsewhere."""
    _need_cuda()
    import dataclasses

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.optim import adamw_init
    from repro_torch.tree_util import tree_leaves, tree_map
    cfg, params, tokens, memory = _served_model(arch)
    cfg = dataclasses.replace(cfg, remat=True)
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    batch = {"tokens": tokens}
    if memory is not None:
        batch["frames" if cfg.family == "encdec" else "memory"] = memory
    shape = ShapeSpec("train", tokens.shape[1], tokens.shape[0], "train")

    def rel(g, w):
        return float((g.cpu().double() - w.double()).abs().max()
                     / w.double().abs().max().clamp(min=1e-30))

    def run(dev, cfg, params, batch, moving=None):
        # a copy: the steps update the parameters they are given in place
        p = tree_map(lambda a: a.to(dev, copy=True), params)
        b = {k: x.to(dev) for k, x in batch.items()}
        (loss, _), grads = steps.value_and_grad(p, cfg, b)
        bundle = steps.build_train_step(cfg, tmesh.parse_mesh("1x1", dev),
                                        shape, warmup=1, total_steps=10)
        fa = cuda_flash_attention
        fa.launches = fa.launches_sm90 = fa.launches_f32 = 0
        p1, s1, _ = bundle(p, adamw_init(p), b)
        before = [x.clone() for x in tree_leaves(p1)]
        real = steps.train_update

        def kept(*args):               # the moving step's update arguments
            moving.extend(tree_map(lambda a: a.clone() if isinstance(
                a, torch.Tensor) else a, args))   # (donated: copied)
            return real(*args)
        if moving is not None:
            steps.train_update = kept
        try:
            p2, s2, _ = bundle(p1, s1, b)
        finally:
            steps.train_update = real
        assert int(s2.step) == 2 and not all(
            torch.equal(a, b) for a, b in zip(before, tree_leaves(p2)))
        return loss, {"grads": tree_leaves(grads), "params": tree_leaves(p2),
                      "m": tree_leaves(s2.m),
                      "v": tree_leaves(s2.v)}, fa.launches_f32

    def card_update(opt_cfg, grads, params, state, warmup, total, **fault):
        p, s = steps.train_update(
            dataclasses.replace(opt_cfg, **fault),
            *(tree_map(lambda a: a.to("cuda", copy=True), t)
              for t in (grads, params, state)),
            warmup, total)
        return {"params": tree_leaves(p), "m": tree_leaves(s.m),
                "v": tree_leaves(s.v)}

    moving = []
    loss_c, want, _ = run("cpu", cfg, params, batch, moving)
    for fault, held in (({}, True), (dict(b2=0.999), False)):
        got = card_update(*moving, **fault)
        errs = {key: max(rel(g, w) for g, w in zip(got[key], want[key]))
                for key in got}
        if held:
            assert all(g.is_cuda for g in got["params"])
            assert max(errs.values()) <= 1e-6, errs
        else:
            assert min(errs["params"], errs["v"]) > 1e-6, errs
    del want["params"]
    loss_g, got, launches = run("cuda", cfg, params, batch)
    _, f64, _ = run("cpu", dataclasses.replace(cfg, dtype="float64"),
                    tree_map(lambda a: a.double(), params),
                    {k: x if k == "tokens" else x.double()
                     for k, x in batch.items()})
    per = {"rwkv": 0, "dec": 2}
    calls = sum(seg.count * per.get(seg.kind, 1) * (2 if seg.count > 1
                                                    else 1)
                for seg in M.layer_plan(cfg) + M.encoder_plan(cfg))
    assert launches == 2 * calls
    assert abs(float(loss_g) - float(loss_c)) <= 1e-5 * abs(float(loss_c))
    tols = {key: max([1e-4] + [2 * rel(w, d) for w, d in zip(want[key],
                                                             f64[key])])
            for key in want}
    tols["v"] = max(tols["v"], 2 * tols["m"])      # v holds squares
    for key, tol in tols.items():
        for g, w in zip(got[key], want[key]):
            assert g.is_cuda and g.dtype == w.dtype
            assert rel(g, w) <= tol, (key, rel(g, w), tol)


def test_train_launcher_on_cuda(tmp_path):
    """``python -m repro_torch.launch.train --device cuda``: ddp with
    PICSOU and EF-int8 on a (2, 2, 2) mesh trains with finite losses on
    the kernel route, and a restart continues an uninterrupted run."""
    _need_cuda()
    import math

    from repro_torch.launch import train
    fa = cuda_flash_attention
    fa.launches = 0
    losses = train.main(["--arch", "granite-8b-smoke", "--steps", "6",
                         "--mesh", "2x2x2", "--mode", "ddp", "--sync",
                         "picsou", "--compress", "--seq", "32",
                         "--device", "cuda"])
    assert len(losses) == 6 and all(math.isfinite(x) for x in losses)
    assert fa.launches > 0
    common = ["--arch", "starcoder2-3b-smoke", "--seq", "32", "--mesh",
              "2x2", "--ckpt-every", "4", "--device", "cuda"]
    train.main(common + ["--steps", "8", "--ckpt-dir", str(tmp_path)])
    ref = train.main(common + ["--steps", "12"])
    resumed = train.main(common + ["--steps", "4", "--ckpt-dir",
                                   str(tmp_path), "--restore"])
    assert all(abs(a - b) < 2e-3 for a, b in zip(ref[8:12], resumed))
