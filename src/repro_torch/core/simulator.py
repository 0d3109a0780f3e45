"""Vectorized PICSOU simulator in torch — dense and windowed engines.

The simulator executes the *full* protocol of §4–§5 — round-robin / DSS
send scheduling, receiver rotation, intra-RSM broadcast, cumulative +
phi-list acknowledgements, QUACK formation, duplicate-complaint loss
detection, communication-free retransmitter election, GC with the
highest-quacked metadata defence, stake weighting and LCM-scaled
retransmission rotation — as tensor state transitions, one step per
synchronous round (one cross-RSM RTT).

Every state tensor carries a leading **lane** axis B: one lane per
simulated link, each with its own failure masks, stakes and window base
(``FailArrays``, ``SimState.base``). The round's stake-weighted QUACK and
loss quorums go through ``kernels.ops.quack_scan`` in its lane form — the
hand-written CUDA kernel on the card. The round number ``t`` and the
bases are device tensors, so nothing in a round or a chunk waits for the
host.

Two engines run the same step, each over one lane per spec
(``run_simulation_batch``; ``run_simulation`` is one lane):

- **dense** (``window_slots == 0``): the window is the whole stream
  ``[0, M)`` and never rotates; the rounds run as 32-round programs, the
  loop never syncs with the host, and the result comes back in one
  device→host copy at the end.
- **windowed** (``window_slots > 0``): per-message state lives in a
  sliding window of W columns covering absolute sequence numbers
  ``[base, base + W)``. The run is split into chunks of
  ``spec.chunk_steps`` rounds; at the end of each chunk the GC frontier
  (``gc.gc_frontier_device`` — the prefix both sides may forget, §4.3) is
  computed on the device and the ring buffers rotate past it
  (``_rotate_device``). The retired columns' outputs leave the device in a
  bounded O(W) ``ChunkQueue``, drained by the host once per chunk in one
  copy together with the chunk's round metrics. Failure-free, device
  state is O(W), independent of M. A window too narrow for the in-flight
  set grows 2x (``adaptive_window``), or the state migrates into the
  dense layout when the width would reach M; ``adaptive_window=False``
  raises ``ValueError`` instead. Up to K = ``spec.superchunk`` chunks
  fuse into one dispatch (``_superchunk``), with an overflow guard on
  the device that stops a span where K = 1 would have grown the window;
  a dispatch's drain overlaps the next dispatch. Every K gives the same
  outputs, as in the reference.

On a CUDA device every chunk, superchunk and dense block is a captured
CUDA graph, replayed once a dispatch (``graphs.Programs``); on the CPU
the same functions run eagerly. The programs of a state layout (lanes,
the spec's shape and schedules, width, metrics) live in a set cached
across runs (``_layout_set``), so a second run of a shape captures
nothing; each run copies its state and per-lane inputs into the set's
tensors in place. The windowed loop also records chunk-boundary
checkpoints (``ChunkCheckpoint``), resumes from one, and swaps per-lane
inputs mid-run: the hooks of ``repro_torch.replay``.

With ``collect_metrics`` a ``obs.metrics.MetricsCarry`` rides beside the
state through every program (``update_metrics`` after each round,
``rotate_metrics`` with each rotation), its accumulators drain with the
queue, and each result carries ``obs``; without it the programs are
exactly those without the fabric. The windowed loop reports its spans to
the ambient ``obs.tracer`` (``run``, ``plan_floors``,
``compile``/``dispatch``, ``drain_wait``, ``window_growth``,
``dense_migration``, ``final_flush``).

Semantics of a round ``t`` (matching Figure 3/4/5/6 of the paper):
  1. intra-RSM broadcasts queued at t-1 land;
  2. retransmissions are declared/elected from knowledge as of t-1 and the
     corresponding resends are put on the wire;
  3. scheduled original sends for round t are put on the wire; direct sends
     land at their receiver (unless dropped) and queue a broadcast;
  4. every alive receiver acks (cumulative counter + phi-list + implicit
     duplicate-cum complaint) to its rotating target sender; senders fold
     the ack into their knowledge; QUACK / GC state advances.

Integer and boolean contractions that the JAX package writes as einsums
run here as batched float32 matrix products over 0/1 operands (exact:
every count is below 2^24, and 0/1 is exact in TF32 too) or as boolean
``any`` reductions. Every state tensor is int32 or bool, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs.metrics import (MetricsBlock, MetricsCarry, init_metrics_carry,
                           metrics_updater, migrate_dense_metrics,
                           obs_from_final, pad_metrics, resume_metrics_carry,
                           rotate_metrics, snapshot_metrics, stack_blocks)
from ..obs.tracer import obs_begin, obs_end
from . import scheduler as sched
from .gc import gc_frontier_device, grow_window, resolve_window_slots
from .graphs import Programs, copy_into, program_set
from .quack import (claim_bitmask, missing_below_horizon,
                    stake_quorum_bitmap, weighted_quorum_prefix)
from .snapshot import WINDOW_FILLS as _WINDOW_FILLS
from .snapshot import PinnedDrain, explicit, pad_window, to_host
from .snapshot import window_shapes as _window_shapes
from .types import (FailureScenario, RSMConfig, SimConfig,
                    lcm_scale_factors)

__all__ = ["SimSpec", "SimResult", "SimState", "StepMetrics", "FailArrays",
           "ChunkQueue", "ChunkCheckpoint", "WindowGrowthEvent",
           "build_spec", "run_simulation", "run_simulation_batch",
           "require_uniform_batch", "spec_failures",
           "spec_with_failures", "spec_with_quorum",
           "retire_safety_stakes_ok", "spec_to_arrays", "spec_from_arrays",
           "state_from_numpy", "chunk_trace_count", "chunk_dispatch_count",
           "host_sync_count"]

_NEVER_STEP = 2 ** 30     # orig_step pad for window slots beyond the stream
_BIG = 2 ** 30
_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class SimSpec:
    """Fully-resolved, static simulation plan."""

    n_s: int
    n_r: int
    m: int
    steps: int
    phi: int
    quack_thresh: float      # u_r + 1 (stake units)
    dup_thresh: float        # r_r + 1 (stake units); 1 in CFT mode
    hq_thresh: float         # r_s + 1 (stake units)
    stakes_s: Tuple[float, ...]
    stakes_r: Tuple[float, ...]
    orig_sender: Tuple[int, ...]      # (M,)
    orig_recv: Tuple[int, ...]        # (M,)
    orig_step: Tuple[int, ...]        # (M,) dispatch round of original send
    rs_seq: Tuple[int, ...]           # retransmit sender rotation sequence
    rr_seq: Tuple[int, ...]           # retransmit receiver rotation sequence
    crash_s: Tuple[int, ...]
    crash_r: Tuple[int, ...]
    byz_send_drop: Tuple[bool, ...]
    byz_recv_drop: Tuple[bool, ...]
    byz_ack_advance: Tuple[int, ...]
    byz_ack_low: Tuple[bool, ...]
    byz_bcast_partial: Tuple[bool, ...]
    bcast_limit: int
    # Byzantine adversary palette; None is the neutral mask everywhere
    byz_equiv_send: Optional[Tuple[bool, ...]] = None    # (n_s,)
    byz_hq_advance: Optional[Tuple[int, ...]] = None     # (n_s,)
    byz_ack_stale: Optional[Tuple[bool, ...]] = None     # (n_r,)
    drop_pair: Optional[Tuple[Tuple[bool, ...], ...]] = None  # (n_s, n_r)
    window_slots: int = 0             # 0 => dense (full-M) state
    chunk_steps: int = 0              # rounds per chunk (windowed)
    adaptive_window: bool = True      # grow W / dense-fallback on overflow
    superchunk: int = 8               # chunks a windowed dispatch fuses
    debug_checks: bool = False        # per-drain checks (windowed)
    use_pallas_quack: bool = False    # carried across; see SimConfig
    collect_metrics: bool = False     # metrics fabric (repro_torch.obs)

    def scan_state_nbytes(self) -> int:
        """Device bytes of one lane's per-round state (the P1 footprint).

        Computed from the shapes and dtypes that ``_init_state`` really
        builds (on the ``meta`` device, so nothing is allocated).
        """
        w = self.window_slots or self.m
        state = _init_state(self, w, torch.device("meta"))
        return sum(t.numel() * t.element_size() for t in state)


class FailArrays(NamedTuple):
    """Per-lane inputs of a run, as device tensors with a leading lane
    axis B.

    Mostly failure masks; ``commit_floor`` is the commit-gated dispatch
    boundary for chained topologies (message ``k`` may only be originated
    once ``k < commit_floor``); a standalone link is fully committed
    (``commit_floor == m``). Stakes and quorum thresholds ride here too,
    as float32 tensors that the quorum kernel reads on the device.
    """

    crash_s: torch.Tensor           # (B, n_s) int32, -1 = never
    crash_r: torch.Tensor           # (B, n_r) int32
    byz_send_drop: torch.Tensor     # (B, n_s) bool
    byz_recv_drop: torch.Tensor     # (B, n_r) bool
    byz_ack_advance: torch.Tensor   # (B, n_r) int32
    byz_ack_low: torch.Tensor       # (B, n_r) bool
    byz_bcast_partial: torch.Tensor  # (B, n_r) bool
    bcast_limit: torch.Tensor       # (B,) int32
    commit_floor: torch.Tensor      # (B,) int32 — dispatch gate (abs seqno)
    byz_equiv_send: torch.Tensor    # (B, n_s) bool — resends equivocate
    byz_hq_advance: torch.Tensor    # (B, n_s) int32 — §4.3 hq-piggyback lie
    byz_ack_stale: torch.Tensor     # (B, n_r) bool — replays previous ack
    drop_pair: torch.Tensor         # (B, n_s, n_r) bool — selective drops
    stakes_s: torch.Tensor          # (B, n_s) float32
    stakes_r: torch.Tensor          # (B, n_r) float32
    quack_thresh: torch.Tensor      # (B,) float32 — u_r + 1 (stake units)
    dup_thresh: torch.Tensor        # (B,) float32 — r_r + 1
    hq_thresh: torch.Tensor         # (B,) float32 — r_s + 1


class SimState(NamedTuple):
    """The carried state of B lanes at window width W."""

    recv_has: torch.Tensor      # (B, n_r, W) bool — receiver holds slot
    bcast_q: torch.Tensor       # (B, n_r, W) bool — queued broadcast for t+1
    bcast_done: torch.Tensor    # (B, n_r, W) bool
    orig_sent: torch.Tensor     # (B, W) bool — original dispatch attempted
    known: torch.Tensor         # (B, n_s, n_r, W) bool — j's claims at l
    complaint: torch.Tensor     # (B, n_s, n_r, W) bool — j's last complaint
    repeat_c: torch.Tensor      # (B, n_s, n_r, W) bool — complained twice
    last_cum: torch.Tensor      # (B, n_s, n_r) int32 (absolute counts)
    retry: torch.Tensor         # (B, n_s, W) int32
    quack_time: torch.Tensor    # (B, n_s, W) int32, -1 = not yet
    deliver_time: torch.Tensor  # (B, W) int32, -1 = not yet
    hq_reports: torch.Tensor    # (B, n_r, n_s) int32 (absolute seqnos)
    ack_floor: torch.Tensor     # (B, n_r) int32 (absolute counts)
    base: torch.Tensor          # (B,) int32 — absolute seqno of window col 0
    retired_delivered: torch.Tensor  # (B,) int32 — delivered among retired


class StepMetrics(NamedTuple):
    cross_msgs: np.ndarray     # direct cross-RSM data copies this round
    intra_msgs: np.ndarray     # broadcast copies this round
    resends: np.ndarray        # retransmissions this round
    acks: np.ndarray           # ack messages this round
    delivered: np.ndarray      # cumulative messages delivered
    min_quack_prefix: np.ndarray  # min honest-sender quacked prefix


class ChunkQueue(NamedTuple):
    """Bounded device-side output queue, drained by the host once per chunk.

    Holds the pre-rotation window outputs plus (base, count): columns
    ``[0, count)`` are the slots this chunk's rotation retired, covering
    absolute sequence numbers ``[base, base + count)``. O(W) regardless
    of stream length — the only per-chunk device->host traffic besides
    the round metrics.
    """

    quack_time: torch.Tensor    # (B, n_s, W) pre-rotation
    deliver_time: torch.Tensor  # (B, W)
    retry: torch.Tensor         # (B, n_s, W)
    recv_has: torch.Tensor      # (B, n_r, W)
    base: torch.Tensor          # (B,) int32 — window base before rotation
    count: torch.Tensor         # (B,) int32 — slots retired by this rotation


class ChunkCheckpoint(NamedTuple):
    """Host-side snapshot of a windowed run at a chunk boundary.

    Captured by ``_run_windowed_batch`` (when given a ``recorder``) right
    before dispatching the chunk that starts at round ``t``, and accepted
    back as its ``resume`` argument: resuming from a checkpoint runs the
    exact remaining chunk stream (the same cached programs, the same
    overflow and growth decisions, the same drains) and is bit-identical
    to the original run when the failure schedule is unchanged. Every
    leaf is host-side numpy (``state`` int32/bool, ``fails`` int32/bool
    and the float32 stakes and thresholds, moved as their bits), so a
    device round trip is exact and the tuple serialises losslessly
    (``repro_torch.replay``). Fields in the JAX package's order.
    """

    t: int                       # next round to execute
    window_slots: int            # window width in force entering the chunk
    bases: np.ndarray            # (B,) per-lane window base
    state: SimState              # (B, ...) state, numpy leaves
    fails: FailArrays            # (B, ...) inputs in force, numpy leaves
    floors: np.ndarray           # (B,) commit floors in force
    out_quack: np.ndarray        # (B, n_s, M) drained retired prefix
    out_deliver: np.ndarray      # (B, M)
    out_retry: np.ndarray        # (B, n_s, M)
    out_recv: np.ndarray         # (B, n_r, M)
    # per-chunk (B, c) metric blocks of the rounds already run, shared by
    # reference with the engine loop; ``metrics()`` concatenates them
    metric_parts: Tuple[StepMetrics, ...]
    bases_hist: np.ndarray       # (n_boundaries_so_far, B)
    growth_events: Tuple["WindowGrowthEvent", ...]
    # (B, M) dispatch-round mirror (-1 = not yet dispatched); None (a
    # trace written before it existed) falls back to the schedule rounds
    send_step: Optional[np.ndarray] = None

    def metrics(self) -> StepMetrics:
        """Concatenated (B, t) per-round metrics up to this checkpoint."""
        return _concat_metrics(len(self.bases), list(self.metric_parts))


@dataclasses.dataclass(frozen=True)
class WindowGrowthEvent:
    """One adaptive-window growth decision, attributed to its cause.

    All lanes share one window width, so a single frontier-stalled lane
    forces growth for every lane: ``scenario`` records *which* lane
    overflowed and ``step`` the round whose dispatch would have outrun
    the window. ``new_w == m`` with ``dense_migration`` set means the run
    migrated into the dense layout rather than doubling again. ``fork``
    is kept for the JAX package's what-if forks; it is None here.
    """

    step: int                # round whose dispatch overflowed the window
    scenario: int            # lane that forced the growth
    need: int                # highest in-flight seqno at that round
    old_w: int
    new_w: int
    dense_migration: bool = False
    fork: Optional[int] = None


@dataclasses.dataclass
class SimResult:
    spec: SimSpec
    metrics: StepMetrics                  # (T,) int32 numpy arrays
    quack_time: np.ndarray                # (n_s, M) int32
    deliver_time: np.ndarray              # (M,) int32
    retry: np.ndarray                     # (n_s, M) int32
    recv_has: np.ndarray                  # (n_r, M) bool
    # window base per chunk boundary; dense runs report the trivial [0]
    gc_frontiers: Optional[np.ndarray] = None
    # window width the run ended with (== m for dense / dense-fallback)
    final_window_slots: Optional[int] = None
    # every growth / dense-migration decision the run took
    window_growth_events: Tuple[WindowGrowthEvent, ...] = ()
    # (M,) round each message's original dispatch happened (-1 = never)
    send_step: Optional[np.ndarray] = None
    # (M,) per-message delivery latency (-1 = not delivered)
    delivery_latency: Optional[np.ndarray] = None
    # the lane's drained metrics (obs.metrics.ObsMetrics), present only
    # when the run's SimConfig.collect_metrics was set
    obs: Optional[object] = None

    # --- derived -------------------------------------------------------
    def completion_step(self) -> int:
        """Round by which every message is QUACKed at every honest sender."""
        honest = _honest_mask(self.spec.crash_s, self.spec.byz_send_drop)
        qt = self.quack_time[honest]
        if qt.size == 0 or (qt < 0).any():
            return -1
        return int(qt.max())

    def delivery_step(self) -> int:
        if (self.deliver_time < 0).any():
            return -1
        return int(self.deliver_time.max())

    def total_cross_msgs(self) -> int:
        return int(np.sum(self.metrics.cross_msgs))

    def total_intra_msgs(self) -> int:
        return int(np.sum(self.metrics.intra_msgs))

    def total_resends(self) -> int:
        return int(np.sum(self.metrics.resends))

    def max_resends_per_msg(self) -> int:
        honest = _honest_mask(self.spec.crash_s, self.spec.byz_send_drop)
        if not honest.any():
            return 0
        return int(self.retry[honest].max())


def _honest_mask(crash, byz_flags) -> np.ndarray:
    crash = np.asarray(crash)
    byz = np.asarray(byz_flags)
    return (crash < 0) & ~byz


def build_spec(sender: RSMConfig, receiver: RSMConfig,
               sim: SimConfig = SimConfig(),
               failures: FailureScenario = FailureScenario.none(),
               use_lcm_scaling: bool = True) -> SimSpec:
    """Resolve schedules + failure masks into a static SimSpec."""
    n_s, n_r, m = sender.n, receiver.n, sim.n_msgs
    st_s = np.asarray(sender.stakes, dtype=np.float64)
    st_r = np.asarray(receiver.stakes, dtype=np.float64)

    orig_sender = sched.sender_assignment(
        sim.scheduler, st_s, m, quantum=sim.quantum, seed=sim.seed)
    orig_recv = sched.receiver_for(
        orig_sender, n_r, recv_stakes=st_r, scheduler=sim.scheduler,
        quantum=sim.quantum, seed=sim.seed + 1)

    # dispatch round of each original send: the i-th message of sender l is
    # sent in round i // window (window sends per sender per round).
    orig_step = np.zeros(m, dtype=np.int64)
    counters = np.zeros(n_s, dtype=np.int64)
    for k in range(m):
        l = orig_sender[k]
        orig_step[k] = counters[l] // max(sim.window, 1)
        counters[l] += 1

    # retransmission rotation sequences (§4.2 unit-stake, §5.3 staked+LCM).
    unit_s = np.allclose(st_s, st_s[0])
    unit_r = np.allclose(st_r, st_r[0])
    if unit_s and unit_r:
        rs_seq = np.arange(n_s, dtype=np.int64)
        rr_seq = np.arange(n_r, dtype=np.int64)
    else:
        psi_s, psi_r = (lcm_scale_factors(st_s.sum(), st_r.sum())
                        if use_lcm_scaling else (1.0, 1.0))
        # quota each replica proportional to (scaled) stake, smoothed.
        q_s = max(n_s, min(4 * n_s, int(np.ceil(
            st_s.sum() * psi_s / max(st_s.min() * psi_s, 1)))))
        q_r = max(n_r, min(4 * n_r, int(np.ceil(
            st_r.sum() * psi_r / max(st_r.min() * psi_r, 1)))))
        rs_seq = sched.dss_sequence(st_s * psi_s, q_s, q_s)
        rr_seq = sched.dss_sequence(st_r * psi_r, q_r, q_r)

    w_slots = resolve_window_slots(
        sim.window_slots, n_s=n_s, n_r=n_r, send_window=sim.window,
        phi=sim.phi, chunk_steps=sim.chunk_steps, m=m)

    return SimSpec(
        n_s=n_s, n_r=n_r, m=m, steps=sim.steps, phi=sim.phi,
        quack_thresh=receiver.quack_threshold,
        dup_thresh=receiver.dup_threshold,
        hq_thresh=max(sender.r + 1, 1),
        stakes_s=tuple(float(x) for x in st_s),
        stakes_r=tuple(float(x) for x in st_r),
        orig_sender=tuple(int(x) for x in orig_sender),
        orig_recv=tuple(int(x) for x in orig_recv),
        orig_step=tuple(int(x) for x in orig_step),
        rs_seq=tuple(int(x) for x in rs_seq),
        rr_seq=tuple(int(x) for x in rr_seq),
        **_failure_fields(failures, n_s, n_r, sim.steps),
        window_slots=w_slots,
        chunk_steps=sim.chunk_steps if w_slots else 0,
        adaptive_window=sim.adaptive_window,
        superchunk=max(sim.superchunk, 1),
        debug_checks=sim.debug_checks,
        use_pallas_quack=sim.use_pallas_quack,
        collect_metrics=sim.collect_metrics,
    )


def _failure_fields(failures: FailureScenario, n_s: int, n_r: int,
                    steps: Optional[int] = None) -> dict:
    """Resolve a FailureScenario into the SimSpec mask fields.

    Validates shapes and ranges up front (``ValueError`` naming the
    field).
    """

    def tup(x, n, default):
        if x is None:
            return tuple([default] * n)
        return tuple(x)

    if failures is None:
        failures = FailureScenario()
    failures.validate(n_s, n_r, steps)
    if failures.drop_pair is None:
        dp = ((False,) * n_r,) * n_s
    else:
        dp = tuple(tuple(bool(x) for x in row)
                   for row in failures.drop_pair)
    return dict(
        crash_s=tup(failures.crash_s, n_s, -1),
        crash_r=tup(failures.crash_r, n_r, -1),
        byz_send_drop=tup(failures.byz_send_drop, n_s, False),
        byz_recv_drop=tup(failures.byz_recv_drop, n_r, False),
        byz_ack_advance=tup(failures.byz_ack_advance, n_r, 0),
        byz_ack_low=tup(failures.byz_ack_low, n_r, False),
        byz_bcast_partial=tup(failures.byz_bcast_partial, n_r, False),
        bcast_limit=failures.bcast_limit,
        byz_equiv_send=tup(failures.byz_equiv_send, n_s, False),
        byz_hq_advance=tup(failures.byz_hq_advance, n_s, 0),
        byz_ack_stale=tup(failures.byz_ack_stale, n_r, False),
        drop_pair=dp,
    )


def spec_with_failures(spec: SimSpec, failures: FailureScenario) -> SimSpec:
    """Overlay a FailureScenario's masks onto an existing spec (schedules,
    thresholds and window config are kept)."""
    return dataclasses.replace(
        spec, **_failure_fields(failures, spec.n_s, spec.n_r, spec.steps))


def spec_failures(spec: SimSpec) -> FailureScenario:
    """Extract the failure masks of a spec as a FailureScenario."""
    return FailureScenario(
        crash_s=spec.crash_s, crash_r=spec.crash_r,
        byz_send_drop=spec.byz_send_drop,
        byz_recv_drop=spec.byz_recv_drop,
        byz_ack_advance=spec.byz_ack_advance,
        byz_ack_low=spec.byz_ack_low,
        byz_bcast_partial=spec.byz_bcast_partial,
        bcast_limit=spec.bcast_limit,
        byz_equiv_send=spec.byz_equiv_send,
        byz_hq_advance=spec.byz_hq_advance,
        byz_ack_stale=spec.byz_ack_stale,
        drop_pair=spec.drop_pair)


def spec_with_quorum(spec: SimSpec, stakes_s=None, stakes_r=None,
                     quack_thresh=None, dup_thresh=None,
                     hq_thresh=None) -> SimSpec:
    """Re-weight stakes / quorum thresholds on an existing spec.

    Stakes and thresholds are run inputs (they ride ``FailArrays``). The
    retransmit rotation schedules (``rs_seq``/``rr_seq``) are committed at
    spec build and intentionally kept, as in the JAX package.
    """
    def pick(new, old, n=None):
        if new is None:
            return old
        new = tuple(float(x) for x in new) if n is not None else float(new)
        if n is not None and len(new) != n:
            raise ValueError(f"stake vector has length {len(new)}, "
                             f"expected {n}")
        return new

    return dataclasses.replace(
        spec,
        stakes_s=pick(stakes_s, spec.stakes_s, spec.n_s),
        stakes_r=pick(stakes_r, spec.stakes_r, spec.n_r),
        quack_thresh=pick(quack_thresh, spec.quack_thresh),
        dup_thresh=pick(dup_thresh, spec.dup_thresh),
        hq_thresh=pick(hq_thresh, spec.hq_thresh))


# ----------------------------------------------- carrying specs and state
def spec_to_arrays(spec) -> dict:
    """A spec's fields as plain Python values (``dataclasses.asdict``).

    Works on this package's ``SimSpec`` and on the JAX package's alike,
    which is how one plan is fed to both.
    """
    return dataclasses.asdict(spec)


def _plain(v):
    """numpy scalars/arrays and nested sequences -> Python values/tuples."""
    if isinstance(v, np.ndarray):
        v = v.tolist()
    if isinstance(v, (list, tuple)):
        return tuple(_plain(x) for x in v)
    if isinstance(v, np.generic):
        return v.item()
    return v


def spec_from_arrays(d: dict) -> SimSpec:
    """Build a ``SimSpec`` from ``spec_to_arrays`` output (either package).

    Unknown keys raise ``TypeError``, so a field that this package does
    not model cannot be dropped silently.
    """
    names = {f.name for f in dataclasses.fields(SimSpec)}
    extra = set(d) - names
    if extra:
        raise TypeError(f"spec_from_arrays: unknown SimSpec fields "
                        f"{sorted(extra)}")
    return SimSpec(**{k: _plain(v) for k, v in d.items()})


def state_from_numpy(state_np, device) -> SimState:
    """A ``SimState`` of numpy arrays (fields in ``SimState`` order, each
    with the lane axis in front) as device tensors, dtypes kept
    (int32 / bool). A JAX package state enters as one lane with
    ``[x[None] for x in state]``."""
    return SimState(*(torch.tensor(np.asarray(x), device=device)
                      for x in state_np))


# ------------------------------------------------------------- the round
def _fail_arrays(specs: Sequence[SimSpec], device) -> FailArrays:
    """The specs' masks, stakes and thresholds, one lane per spec."""

    def tup(x, n, default):
        return [default] * n if x is None else x

    def lanes(get, dtype):
        return torch.tensor(np.asarray([get(s) for s in specs]), dtype=dtype,
                            device=device)

    def drop(s):
        dp = (s.drop_pair if s.drop_pair is not None
              else np.zeros((s.n_s, s.n_r), dtype=bool))
        return np.asarray(dp, dtype=bool).reshape(s.n_s, s.n_r)

    return FailArrays(
        crash_s=lanes(lambda s: s.crash_s, _I32),
        crash_r=lanes(lambda s: s.crash_r, _I32),
        byz_send_drop=lanes(lambda s: s.byz_send_drop, torch.bool),
        byz_recv_drop=lanes(lambda s: s.byz_recv_drop, torch.bool),
        byz_ack_advance=lanes(lambda s: s.byz_ack_advance, _I32),
        byz_ack_low=lanes(lambda s: s.byz_ack_low, torch.bool),
        byz_bcast_partial=lanes(lambda s: s.byz_bcast_partial, torch.bool),
        bcast_limit=lanes(lambda s: max(s.bcast_limit, 0), _I32),
        commit_floor=lanes(lambda s: s.m, _I32),
        byz_equiv_send=lanes(lambda s: tup(s.byz_equiv_send, s.n_s, False),
                             torch.bool),
        byz_hq_advance=lanes(lambda s: tup(s.byz_hq_advance, s.n_s, 0),
                             _I32),
        byz_ack_stale=lanes(lambda s: tup(s.byz_ack_stale, s.n_r, False),
                            torch.bool),
        drop_pair=lanes(drop, torch.bool),
        stakes_s=lanes(lambda s: s.stakes_s, torch.float32),
        stakes_r=lanes(lambda s: s.stakes_r, torch.float32),
        quack_thresh=lanes(lambda s: s.quack_thresh, torch.float32),
        dup_thresh=lanes(lambda s: s.dup_thresh, torch.float32),
        hq_thresh=lanes(lambda s: s.hq_thresh, torch.float32),
    )


def _rotation_seqs(spec: SimSpec, device) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """The retransmit rotation sequences (rs_seq, rr_seq) as int32
    tensors on ``device``."""
    return (torch.tensor(spec.rs_seq, dtype=_I32, device=device),
            torch.tensor(spec.rr_seq, dtype=_I32, device=device))


def _protocol_step(spec: SimSpec, fail: FailArrays, seqs, sched_w, base,
                   w: int):
    """Per-round transition of B lanes over ``w`` window columns.

    ``seqs`` are the rotation sequences (``_rotation_seqs``);
    ``sched_w`` is the (orig_sender, orig_recv, orig_step) schedule of
    each lane's window, (B, w) int32 each; ``base`` the (B,) int32 window
    bases. All sequence-number arithmetic is absolute. Returns
    ``step(state, t)`` with ``t`` a () int32 tensor, giving
    ``(new_state, metrics)`` where ``metrics`` is a (B, 6) int32 tensor in
    ``StepMetrics`` order. Nothing here copies from the host or waits for
    the device, so a chunk of steps can be captured into a CUDA graph.
    """
    n_s, n_r, m = spec.n_s, spec.n_r, spec.m
    phi = spec.phi
    orig_sender, orig_recv, orig_step = sched_w
    dev = orig_sender.device
    sender_ix = orig_sender.long()

    stakes_s = fail.stakes_s
    stakes_r = fail.stakes_r
    rs_seq, rr_seq = seqs
    ls, lr = len(spec.rs_seq), len(spec.rr_seq)

    abs_idx = base[:, None] + torch.arange(w, dtype=_I32, device=dev)
    idx_r = torch.arange(n_r, dtype=_I32, device=dev)
    idx_s = torch.arange(n_s, dtype=_I32, device=dev)
    honest_r = (fail.crash_r < 0) & ~(fail.byz_recv_drop | fail.byz_ack_low
                                      | (fail.byz_ack_advance > 0)
                                      | fail.byz_bcast_partial
                                      | fail.byz_ack_stale)
    honest_s = (fail.crash_s < 0) & ~(fail.byz_send_drop
                                      | fail.byz_equiv_send
                                      | (fail.byz_hq_advance > 0))

    # broadcast reach matrix (B, n_r, n_r): who hears j's intra-RSM
    # broadcast
    partial_reach = idx_r[None, None, :] < fail.bcast_limit[:, None, None]
    reach = torch.where(fail.byz_bcast_partial[:, :, None], partial_reach,
                        True)
    reach = reach & (idx_r[None, :] != idx_r[:, None])
    reach_t = reach.transpose(1, 2).to(torch.float32)        # (B, i, j)
    reach_count = reach.sum(dim=2).to(_I32)                  # (B, n_r)
    # the original sends' fixed (sender, receiver) pairs
    sender_of = orig_sender[:, None, :] == idx_s[None, :, None]  # (B,n_s,W)
    recv_of = orig_recv[:, None, :] == idx_r[None, :, None]      # (B,n_r,W)
    drop_o = torch.gather(fail.drop_pair.reshape(-1, n_s * n_r), 1,
                          sender_ix * n_r + orig_recv.long())    # (B, W)
    send_drop_o = torch.gather(fail.byz_send_drop, 1, sender_ix)  # (B, W)

    def step(state: SimState, t: torch.Tensor):
        alive_s = (fail.crash_s < 0) | (t < fail.crash_s)       # (B, n_s)
        alive_r = (fail.crash_r < 0) | (t < fail.crash_r)       # (B, n_r)

        # (1) broadcasts queued last round land now ------------------------
        bcast_sent = state.bcast_q & alive_r[:, :, None]
        # einsum("jk,ji->ik") over 0/1 operands as an exact f32 product
        recv_from_bcast = torch.bmm(reach_t,
                                    bcast_sent.to(torch.float32)) > 0
        recv_has = state.recv_has | (recv_from_bcast & alive_r[:, :, None])
        bcast_done = state.bcast_done | bcast_sent

        # (2) retransmission declaration + election (knowledge of t-1) -----
        quacked_msg_prev, lost_prev, qprefix_prev = stake_quorum_bitmap(
            state.known, state.repeat_c, stakes_r, fail.quack_thresh,
            fail.dup_thresh, use_pallas=spec.use_pallas_quack)
        # losses can only be declared for messages whose original dispatch
        # already happened
        declared = lost_prev & state.orig_sent[:, None, :]
        retry_new = state.retry + declared.to(_I32)
        # Fig. 6: the a-th retransmission of k is sent by the a-th successor
        # of the original sender: sender_new = (orig + #retransmit) mod n_s.
        elected = (rs_seq[((abs_idx[:, None, :] + retry_new) % ls).long()]
                   == idx_s[None, :, None])
        resend = (declared & elected & alive_s[:, :, None]
                  & ~fail.byz_send_drop[:, :, None])
        # clear complaint trackers where a loss was declared (fresh cycle)
        complaint = state.complaint & ~declared[:, :, None, :]
        repeat_c = state.repeat_c & ~declared[:, :, None, :]
        re_target = rr_seq[((orig_recv[:, None, :] + retry_new) % lr)
                           .long()]                            # (B, n_s, W)
        # an equivocating sender's resends are discarded by receivers;
        # a dropped pair kills the copy in the network
        drop_re = torch.gather(fail.drop_pair, 2, re_target.long())
        resend_land = (resend & ~fail.byz_equiv_send[:, :, None]
                       & ~drop_re)
        # hit[b, l, i, k]: sender l's resend of k lands at receiver i
        hit = (resend_land[:, :, None, :]
               & (re_target[:, :, None, :] == idx_r[None, None, :, None]))

        # (3) original sends + landing --------------------------------------
        due = ((orig_step <= t) & (abs_idx < fail.commit_floor[:, None])
               & ~state.orig_sent)
        orig_ok = due & torch.gather(alive_s, 1, sender_ix) & ~send_drop_o
        orig_sent = state.orig_sent | due
        orig_land = orig_ok & ~drop_o
        s_orig = orig_land[:, None, :] & recv_of               # (B, n_r, W)
        s_re = hit.any(dim=1)                                  # (B, n_r, W)
        wire = s_orig | s_re
        land = (wire & alive_r[:, :, None]
                & ~fail.byz_recv_drop[:, :, None])
        recv_has = recv_has | land
        bcast_q = land & ~bcast_done
        deliver_now = (recv_has & honest_r[:, :, None]).any(dim=1)
        deliver_time = torch.where((state.deliver_time < 0) & deliver_now,
                                   t, state.deliver_time)

        # (3b) highest-quacked metadata rides on every landed data message
        # (constant-size piggyback, §4.3); absolute prefix = base + window
        qp_prev = base[:, None] + qprefix_prev                 # (B, n_s)
        e_lk = sender_of & orig_land[:, None, :]               # (B, n_s, W)
        # einsum("lk,ik->li") as an exact f32 product (counts <= W < 2^24)
        sent_orig_to = torch.bmm(
            e_lk.to(torch.float32),
            s_orig.to(torch.float32).transpose(1, 2)) > 0      # (B,n_s,n_r)
        sent_re_to = hit.any(dim=3)                            # (B,n_s,n_r)
        heard = (sent_orig_to | sent_re_to).transpose(1, 2)    # (B,n_r,n_s)
        # an hq-lying sender inflates its piggybacked prefix per receiver:
        # receiver i hears min(true + adv + i, m)
        hq_lie = fail.byz_hq_advance[:, None, :]               # (B, 1, n_s)
        hq_claim = torch.where(
            hq_lie > 0,
            (qp_prev[:, None, :] + hq_lie + idx_r[None, :, None])
            .clamp(max=m),
            qp_prev[:, None, :])                               # (B,n_r,n_s)
        hq_new = torch.where(heard & alive_r[:, :, None], hq_claim, 0)
        hq_reports = torch.maximum(state.hq_reports, hq_new.to(_I32))

        # (4) acknowledgements ---------------------------------------------
        ack_floor = weighted_quorum_prefix(hq_reports, stakes_s[:, None, :],
                                           fail.hq_thresh[:, None, None])
        ack_floor = torch.maximum(state.ack_floor, ack_floor)  # (B, n_r)
        eff = recv_has | (abs_idx[:, None, :] < ack_floor[:, :, None])
        cum, claim, _known_mask = claim_bitmask(eff, phi, base, m)
        miss = missing_below_horizon(eff, phi, base)
        # Byzantine lies --------------------------------------------------
        advance = fail.byz_ack_advance > 0                     # (B, n_r)
        low = fail.byz_ack_low
        cum = torch.where(low, 0, cum)
        cum = torch.where(advance,
                          (cum + fail.byz_ack_advance).clamp(max=m),
                          cum).to(_I32)
        claim = claim & ~low[:, :, None]
        claim = torch.where(advance[:, :, None],
                            abs_idx[:, None, :] < cum[:, :, None], claim)
        miss = torch.where(low[:, :, None], abs_idx[:, None, :] < phi, miss)
        miss = miss & ~advance[:, :, None]
        # the ack rotation: receiver j acks sender (j + t) mod n_s
        tgt = (idx_r + t) % n_s                                # (n_r,)
        upd = ((tgt[None, :] == idx_s[:, None])[None]
               & alive_r[:, None, :])                          # (B,n_s,n_r)
        # a stale-acking receiver replays its previous ack to this round's
        # target verbatim (applied last, over the other lies)
        stale = fail.byz_ack_stale                             # (B, n_r)
        prev_cum = (torch.where(upd, state.last_cum, 0).sum(dim=1)
                    .clamp(min=0).to(_I32))                    # (B, n_r)
        prev_miss = (upd[..., None] & state.complaint).any(dim=1)
        cum = torch.where(stale, prev_cum, cum)
        claim = torch.where(stale[:, :, None],
                            abs_idx[:, None, :] < prev_cum[:, :, None], claim)
        miss = torch.where(stale[:, :, None], prev_miss, miss)
        # implicit duplicate-cum complaint: cum unchanged since last ack to
        # the same sender => complain about index cum (if it exists).
        dup_cum = state.last_cum == cum[:, None, :]            # (B,n_s,n_r)
        cum4 = cum[:, None, :, None]
        dup_complaint = (dup_cum[..., None]
                         & (abs_idx[:, None, None, :] == cum4) & (cum4 < m))
        new_complaint = miss[:, None] | dup_complaint        # (B,n_s,n_r,W)
        upd4 = upd[..., None]
        known = state.known | (upd4 & claim[:, None])
        repeat_c = torch.where(upd4, repeat_c | (complaint & new_complaint),
                               repeat_c)
        complaint = torch.where(upd4, new_complaint, complaint)
        last_cum = torch.where(upd, cum[:, None, :], state.last_cum)

        # (5) QUACK bookkeeping --------------------------------------------
        # the loss quorum is unused here (declaration works on t-1
        # knowledge, step 2), so the kernel variant without it runs
        quacked_msg, _, qprefix = stake_quorum_bitmap(
            known, repeat_c, stakes_r, fail.quack_thresh,
            fail.dup_thresh, use_pallas=spec.use_pallas_quack,
            need_lost=False)
        quack_time = torch.where((state.quack_time < 0) & quacked_msg,
                                 t, state.quack_time)

        new_state = SimState(
            recv_has=recv_has, bcast_q=bcast_q, bcast_done=bcast_done,
            orig_sent=orig_sent,
            known=known, complaint=complaint, repeat_c=repeat_c,
            last_cum=last_cum, retry=retry_new, quack_time=quack_time,
            deliver_time=deliver_time, hq_reports=hq_reports,
            ack_floor=ack_floor, base=state.base,
            retired_delivered=state.retired_delivered)

        qp = base[:, None] + qprefix
        min_qp = torch.where(honest_s, qp, _BIG).min(dim=1).values
        metrics = torch.stack([
            orig_ok.sum(dim=1) + resend.sum(dim=(1, 2)),
            (bcast_sent.sum(dim=2) * reach_count).sum(dim=1),
            resend.sum(dim=(1, 2)),
            alive_r.sum(dim=1),
            (deliver_time >= 0).sum(dim=1) + state.retired_delivered,
            min_qp,
        ], dim=1).to(_I32)
        return new_state, metrics

    return step


def _init_state(spec: SimSpec, w: int, device, lanes: int = 1) -> SimState:
    n_s, n_r = spec.n_s, spec.n_r
    shapes = _window_shapes(n_s, n_r, w)
    window = {
        name: torch.full((lanes,) + shapes[name], fill, device=device,
                         dtype=(torch.bool if isinstance(fill, bool)
                                else _I32))
        for name, fill in _WINDOW_FILLS.items()}
    return SimState(
        **window,
        last_cum=torch.full((lanes, n_s, n_r), -1, dtype=_I32,
                            device=device),
        hq_reports=torch.zeros((lanes, n_r, n_s), dtype=_I32, device=device),
        ack_floor=torch.zeros((lanes, n_r), dtype=_I32, device=device),
        base=torch.zeros((lanes,), dtype=_I32, device=device),
        retired_delivered=torch.zeros((lanes,), dtype=_I32, device=device),
    )


# messages a host pass over an O(M) schedule tuple converts at a time, so
# that planning a run holds O(block) numpy beside its one int32 copy
_HOST_BLOCK = 1 << 12


def _blocks(seq):
    """``(lo, int64 array)`` over consecutive blocks of a sequence."""
    for lo in range(0, len(seq), _HOST_BLOCK):
        yield lo, np.asarray(seq[lo:lo + _HOST_BLOCK], dtype=np.int64)


def _padded_sched(spec: SimSpec, w: int, device):
    """The schedule padded by ``w`` never-sent slots, so that a window at
    any base <= M reads inside it."""

    def pad(seq, fill, cap=None):
        a = np.full(len(seq) + w, fill, dtype=np.int32)
        for lo, blk in _blocks(seq):
            a[lo:lo + len(blk)] = blk if cap is None else \
                np.minimum(blk, cap)
        return torch.from_numpy(a).to(device)

    return (pad(spec.orig_sender, 0), pad(spec.orig_recv, 0),
            pad(spec.orig_step, _NEVER_STEP, _NEVER_STEP))


def _sched_window(sched_p, base: torch.Tensor, w: int):
    """Each lane's (B, w) schedule window: a gather at ``base + [0, w)``."""
    ix = (base[:, None] + torch.arange(w, dtype=_I32, device=base.device)
          ).long()
    return tuple(a[ix] for a in sched_p)


class _Plan(NamedTuple):
    """A run's constant device tensors at one window width, built before
    any program runs (a captured program cannot copy from the host), and
    the buffers the host writes before each dispatch."""

    sched: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # padded by w
    seqs: Tuple[torch.Tensor, torch.Tensor]        # rs_seq, rr_seq
    # {k: (k,) int32}: a k-chunk span's overflow-guard needs, written by
    # ``_load_needs`` before each dispatch (the JAX package passes them
    # as a traced input), so that nothing on the device grows with the
    # stream's rounds
    needs: Dict[int, torch.Tensor]


def _plan(spec: SimSpec, w: int, device) -> _Plan:
    return _Plan(_padded_sched(spec, w, device), _rotation_seqs(spec, device),
                 {})


def _load_needs(plan: _Plan, dispatched_by: np.ndarray, t: int, c: int,
                k: int) -> None:
    """Write a span's needs into the buffer its ``k``-chunk programs read
    by address: ``needs[i]`` = ``dispatched_by[t + (i + 1) * c - 1]``,
    the highest message dispatched by inner chunk ``i``'s last round.
    ``k`` fills in stream order, after every replay that read the old
    values; no host read."""
    buf = plan.needs.get(k)
    if buf is None:
        buf = plan.needs[k] = torch.empty(k, dtype=_I32,
                                          device=plan.sched[0].device)
    for i in range(k):
        buf[i].fill_(int(dispatched_by[t + (i + 1) * c - 1]))


# ------------------------------------------------------------ dense run
DENSE_BLOCK = 32    # rounds a dense program runs (plus one shorter tail)


def _run_dense_batch(specs: List[SimSpec], device) -> List[SimResult]:
    """Dense full-stream runs, one lane per spec: window = [0, M), no
    rotation.

    The rounds run as programs of ``DENSE_BLOCK`` rounds (and one tail
    program for the rest): a captured CUDA graph replayed once a block on
    a CUDA device, the same block eagerly on the CPU, from the layout's
    cached set (``_layout_set``: a second run of the shape captures
    nothing). This is the port's counterpart of the JAX package's one
    compiled ``lax.scan`` over the run. Each block's round metrics are
    copied into one device tensor; the run never waits for the device
    until the result comes back in one device->host copy at the end, the
    metrics carry's accumulators with it when ``collect_metrics`` is set.
    """
    spec0 = specs[0]
    n_b, m, steps = len(specs), spec0.m, spec0.steps
    collect = spec0.collect_metrics
    progs = _fresh_set(specs, _LayoutKey(spec0), m, device)
    fail, plan = progs.keep
    metrics = torch.zeros((n_b, steps, len(StepMetrics._fields)),
                          dtype=_I32, device=device)

    def block(c):
        def body(carry, t0):
            state, mc = _split(carry)
            state, ms, mc = _rounds(spec0, fail, plan, state, t0, c, m, mc)
            return _carry(state, mc), [ms]
        return body

    for t in range(0, steps, DENSE_BLOCK):
        c = min(DENSE_BLOCK, steps - t)
        (ms,) = progs.run(("dense", c, collect), block(c), t)
        metrics[:, t:t + c].copy_(ms)
    final, mc = _split(progs.state)
    quack_time, deliver_time, retry, recv_has, ms, *acc = to_host(
        [final.quack_time, final.deliver_time, final.retry, final.recv_has,
         metrics] + ([] if mc is None else list(snapshot_metrics(mc))))
    acc = MetricsBlock(*acc) if collect else None
    out = []
    for b, spec in enumerate(specs):
        ss = _dense_send_step(spec)
        out.append(SimResult(
            spec=spec,
            metrics=StepMetrics(*(np.ascontiguousarray(ms[b, :, i])
                                  for i in range(ms.shape[2]))),
            quack_time=quack_time[b], deliver_time=deliver_time[b],
            retry=retry[b], recv_has=recv_has[b],
            gc_frontiers=np.zeros(1, dtype=np.int64),
            final_window_slots=spec.m,
            send_step=ss,
            delivery_latency=_latency_from(ss, deliver_time[b]),
            obs=obs_from_final(acc, [], b) if collect else None,
        ))
    return out


class _LayoutKey:
    """What a program body reads of a run's specs as Python values: the
    spec with its per-lane inputs and window config normalised away
    (``_neutral``; ``steps`` stays, as in the JAX package's program
    keys), hashed once per run rather than once per lookup (the
    schedules are O(M) tuples)."""

    __slots__ = ("spec", "_hash")

    def __init__(self, spec: SimSpec):
        self.spec = _neutral(spec)
        self._hash = hash(self.spec)

    def __hash__(self) -> int:
        return self._hash

    def __eq__(self, other) -> bool:
        return (isinstance(other, _LayoutKey) and self._hash == other._hash
                and self.spec == other.spec)


def _layout_set(layout: _LayoutKey, n_b: int, w: int, device) -> Programs:
    """The cached program set of ``n_b`` lanes of ``layout`` at window
    width ``w`` (``m``: the dense layout) on ``device``
    (``graphs.program_set``). It owns the state buffers, and keeps the
    ``FailArrays`` (each run writes its lanes' values into them in
    place) and the width's ``_Plan``, which the programs read by
    address. Programs within it are keyed ``(w, c, k, rotate,
    collect)`` or ``("dense", c, collect)``."""
    nspec = layout.spec
    collect = nspec.collect_metrics

    @explicit()              # a new set's uploads
    def build() -> Programs:
        state = _carry(_init_state(nspec, w, device, n_b),
                       init_metrics_carry(w, device, n_b)
                       if collect else None)
        keep = (_fail_arrays([nspec] * n_b, device), _plan(nspec, w, device))
        return Programs(state, device, keep=keep)

    return program_set((device, n_b, layout, w, collect), build)


def _fresh_set(specs: List[SimSpec], layout: _LayoutKey, w: int,
               device) -> Programs:
    """The layout's set at width ``w`` for a run from round 0: the
    specs' ``FailArrays`` and a fresh state copied into it."""
    n_b, collect = len(specs), layout.spec.collect_metrics
    progs = _layout_set(layout, n_b, w, device)
    with explicit():         # the run's uploads
        copy_into(progs.keep[0], _fail_arrays(specs, device))
        progs.load(_carry(_init_state(layout.spec, w, device, n_b),
                          init_metrics_carry(w, device, n_b)
                          if collect else None))
    return progs


def _carry(state: SimState, mc: Optional[MetricsCarry]):
    """A program's carried state: the ``SimState``, or ``(SimState,
    MetricsCarry)`` when the run collects metrics."""
    return state if mc is None else (state, mc)


def _split(carry) -> Tuple[SimState, Optional[MetricsCarry]]:
    """``(SimState, MetricsCarry or None)`` of a carried state."""
    return (carry, None) if isinstance(carry, SimState) else carry


def _resolve_device(device) -> torch.device:
    """The device a run uses: CUDA unless the caller names another."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "run_simulation runs on CUDA by default and no CUDA device "
                "is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _dense_send_step(spec: SimSpec) -> np.ndarray:
    """Dispatch rounds of the dense (ungated) path: the schedule round,
    -1 for messages whose round never arrives within ``steps``."""
    ostep = np.asarray(spec.orig_step, dtype=np.int64)
    return np.where(ostep < spec.steps, ostep, -1).astype(np.int32)


def _latency_from(send_step: np.ndarray,
                  deliver_time: np.ndarray) -> np.ndarray:
    """Per-message retire-step - send-step; -1 = not delivered."""
    return np.where(deliver_time >= 0, deliver_time - send_step,
                    -1).astype(np.int32)


# ------------------------------------------------------- windowed chunk
def _rotate_device(s: SimState, f: torch.Tensor, w: int) -> SimState:
    """Shift each lane's ring buffers left by its GC frontier ``f`` (B,).

    Each window-indexed tensor is extended by W fresh-fill columns and the
    W columns at each lane's offset ``f`` are gathered: columns
    ``[f, W)`` move to ``[0, W - f)`` and the tail refills with fresh
    slots. The gather writes new contiguous tensors (the quorum kernel
    takes no strided view). ``base`` and ``retired_delivered`` advance on
    the device.
    """
    col = torch.arange(w, dtype=_I32, device=f.device)
    ix = (f[:, None] + col).long()                             # (B, W)

    def shift(a, fill):
        ext = torch.cat([a, torch.full(a.shape[:-1] + (w,), fill,
                                       dtype=a.dtype, device=a.device)],
                        dim=-1)
        lead = (a.shape[0],) + (1,) * (a.dim() - 2) + (w,)
        return torch.gather(ext, -1, ix.reshape(lead).expand(a.shape))

    retired_deliv = ((s.deliver_time >= 0) & (col < f[:, None])).sum(dim=1)
    return s._replace(
        **{name: shift(getattr(s, name), fill)
           for name, fill in _WINDOW_FILLS.items()},
        base=(s.base + f).to(_I32),
        retired_delivered=(s.retired_delivered + retired_deliv).to(_I32))


def _rounds(spec: SimSpec, fail: FailArrays, plan: _Plan, state: SimState,
            t0: torch.Tensor, c: int, w: int,
            mc: Optional[MetricsCarry] = None):
    """``c`` protocol rounds from round ``t0`` (a () int32 tensor) on each
    lane's window at its base, folding each round into the metrics carry
    ``mc`` when one is given. Returns ``(state, metrics (B, c, 6) int32,
    mc)``."""
    base0 = state.base
    step = _protocol_step(spec, fail, plan.seqs,
                          _sched_window(plan.sched, base0, w), base0, w)
    update = None if mc is None else metrics_updater(base0.device)
    ts = t0 + torch.arange(c, dtype=_I32, device=base0.device)
    per_round = []
    for i in range(c):
        new, ms = step(state, ts[i])
        if update is not None:
            mc = update(mc, state, new, ms, ts[i])
        state = new
        per_round.append(ms)
    return state, torch.stack(per_round, dim=1), mc


def _chunk(spec: SimSpec, fail: FailArrays, plan: _Plan, state: SimState,
           t0: torch.Tensor, c: int, w: int, rotate: bool,
           mc: Optional[MetricsCarry] = None):
    """One windowed chunk: ``c`` rounds from ``t0``, then, when
    ``rotate``, the GC frontier and the ring rotation (of the metrics
    carry ``mc`` too, when one is given).

    Returns ``(state, metrics (B, c, 6) int32, ChunkQueue, mc)``; the
    queue holds the pre-rotation outputs and each lane's retired count (0
    for the final chunk of a run, which does not rotate). Plain tensor
    work with no host sync.
    """
    base0 = state.base
    state, ms, mc = _rounds(spec, fail, plan, state, t0, c, w, mc)
    if not rotate:
        return state, ms, ChunkQueue(
            state.quack_time, state.deliver_time, state.retry,
            state.recv_has, base0, torch.zeros_like(base0)), mc
    f = gc_frontier_device(
        base=base0, t_next=t0 + c, m=spec.m,
        known=state.known, bcast_q=state.bcast_q,
        recv_has=state.recv_has, ack_floor=state.ack_floor,
        stakes_r=fail.stakes_r, quack_thresh=fail.quack_thresh,
        orig_sent=state.orig_sent, crash_r=fail.crash_r,
        byz_ack_low=fail.byz_ack_low)
    queue = ChunkQueue(state.quack_time, state.deliver_time, state.retry,
                       state.recv_has, base0, f)
    if mc is not None:
        mc = rotate_metrics(mc, f, w)
    return _rotate_device(state, f, w), ms, queue, mc


def _or_zero(ok: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x`` where ``ok`` (a () bool tensor), else zeros (False)."""
    return torch.where(ok, x, False if x.dtype == torch.bool else 0)


def _superchunk(spec: SimSpec, fail: FailArrays, plan: _Plan, state,
                t0: torch.Tensor, w: int, c: int, k: int, rotate: bool):
    """``k`` chunk bodies of ``c`` rounds from round ``t0`` in one program:
    the JAX package's ``_compiled_batch_superchunk``, and with ``k = 1``
    its single chunk. ``state`` is the carried state: a ``SimState``, or
    ``(SimState, MetricsCarry)`` when the run collects metrics.

    Before inner chunk ``i`` runs, the overflow guard tests each lane's
    exact device base against ``needs[i]`` = the highest message
    dispatched by the chunk's last round (``plan.needs[k]``, which
    ``_load_needs`` wrote for this span; capped by the lane's commit
    floor): ``min(need_i, floor - 1) - base < w`` on every lane, AND-ed
    with the previous chunk's flag. The reference
    skips a failed chunk with a ``lax.cond``; a CUDA graph cannot branch
    on the device, so here every chunk body runs and its results are
    selected with ``torch.where(ok, new, old)``: the state (every leaf of
    the metrics carry too) stays as it was, and the chunk emits zero
    metrics, a zero queue that carries the lane's base and the carried
    metrics snapshot, as the reference's untaken branch does. That is
    exact, and costs device work only on a span that overflows.

    Returns ``(state, metrics (k, B, c, 6), ChunkQueue with a leading
    k axis, oks (k,) bool)``, and with a metrics carry ``((state, mc),
    ..., oks, MetricsBlock with a leading k axis)``; the host folds the
    chunks whose flag is set, in order, and rewinds to the first one
    that is not.
    """
    state, mc = _split(state)
    dev = state.base.device
    needs = plan.needs[k]                                      # (k,)
    floor = fail.commit_floor - 1                              # (B,)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    ms_k, queues, oks, blocks = [], [], [], []
    for i in range(k):
        over = torch.minimum(needs[i], floor) - state.base
        ok = ok & (over < w).all()
        new, ms, queue, new_mc = _chunk(spec, fail, plan, state, t0 + i * c,
                                        c, w, rotate, mc)
        state = SimState(*(torch.where(ok, a, b)
                           for a, b in zip(new, state)))
        if mc is not None:
            mc = MetricsCarry(*(torch.where(ok, a, b)
                                for a, b in zip(new_mc, mc)))
            blocks.append(snapshot_metrics(mc))
        ms_k.append(_or_zero(ok, ms))
        queues.append(queue._replace(**{
            name: _or_zero(ok, getattr(queue, name))
            for name in ChunkQueue._fields if name != "base"}))
        oks.append(ok)
    out = (torch.stack(ms_k),
           ChunkQueue(*(torch.stack([getattr(q, name) for q in queues])
                        for name in ChunkQueue._fields)),
           torch.stack(oks))
    if mc is None:
        return (state,) + out
    return ((state, mc),) + out + (stack_blocks(blocks),)


# The windowed engine's counters, the JAX package's contract: a *trace*
# is one capture of a chunk or superchunk program (its first use in its
# cached set, on the CPU), so a second run of a shape traces nothing; a
# *dispatch* one graph replay on CUDA, or one call of
# the program on the CPU; a *host sync* one wait for a drain, a final
# flush or a dense migration. A run of C chunks at superchunk K that never
# grows its window issues at most ceil(C / K) + 2 dispatches, and host
# syncs <= dispatches + 2 (+ 1 per dense migration).
_CHUNK_TRACES = [0]
_CHUNK_DISPATCHES = [0]
_HOST_SYNCS = [0]


def chunk_trace_count() -> int:
    """How many windowed chunk programs were captured (CPU: first used)."""
    return _CHUNK_TRACES[0]


def chunk_dispatch_count() -> int:
    """Dispatches issued by the windowed engine so far."""
    return _CHUNK_DISPATCHES[0]


def host_sync_count() -> int:
    """Times the windowed engine's host loop blocked on device results."""
    return _HOST_SYNCS[0]


# ------------------------------------------------ growth and migration
def _widen_on_overflow(spec: SimSpec, w: int, base: int, need: int,
                       t: int) -> Optional[int]:
    """Overflow policy: raise (strict), grow 2x, or None => dense layout.

    ``None`` tells the caller to migrate the windowed state into the
    dense layout (base 0, W = M) and continue — no rerun from scratch.
    """
    if not spec.adaptive_window:
        raise ValueError(
            f"sliding window overflow: round {t} dispatches message "
            f"{need} but the window covers [{base}, {base + w}) — the GC "
            f"frontier is {base}. Increase SimConfig.window_slots (or use "
            f"window_slots='auto'), or leave adaptive_window=True for "
            f"automatic growth / dense-layout migration.")
    return grow_window(w, base, need, spec.m)


def _migrate_dense_batch(spec: SimSpec, state: SimState,
                         bases: np.ndarray, out_quack: np.ndarray,
                         out_deliver: np.ndarray, out_retry: np.ndarray,
                         out_recv: np.ndarray,
                         mc: Optional[MetricsCarry] = None,
                         send_step: Optional[np.ndarray] = None):
    """Embed the windowed state into the dense layout (base 0, W = M).

    Adaptive-growth endpoint: when the next doubling would reach the full
    stream length, the run keeps its partial progress instead of rerunning
    from round 0. Live window columns land at their absolute positions
    ``[base_b, base_b + W)``; columns below each lane's base are rebuilt
    from the already-drained retired outputs plus the retirement
    invariants themselves — a retired slot is QUACKed at *every* sender
    (``known`` may be set all-True without changing any threshold
    decision), effectively received at every receiver that still matters
    (``recv_has`` restored from the drained snapshot; the rest is covered
    by the preserved ack floor), has no broadcast pending and its
    original send dispatched. Per-replica state (``last_cum`` /
    ``hq_reports`` / ``ack_floor``) carries over unchanged, so the
    continued run is bit-identical in every output to a dense run from
    round 0.

    One-off host transform: one device->host copy of the state (and of
    the metrics carry ``mc``, when one is given, in the same copy) and
    numpy. Returns ``(state, mc)``: the dense state as numpy (the caller
    copies it into the dense layout's buffers) and the carry migrated by
    ``migrate_dense_metrics`` from the loop's per-lane dispatch mirror
    ``send_step`` (B, M), on the state's device (None without a carry).
    """
    n_b = len(bases)
    n_s, n_r, m = spec.n_s, spec.n_r, spec.m
    device = state.base.device
    host = to_host(list(state) + ([] if mc is None else list(mc)))
    state = SimState(*host[:len(SimState._fields)])
    if mc is not None:
        with explicit():     # an upload
            mc = migrate_dense_metrics(
                MetricsCarry(*host[len(SimState._fields):]), bases,
                send_step, m, device)
    w = state.deliver_time.shape[-1]
    shapes = _window_shapes(n_s, n_r, m)
    dense = {
        name: np.full((n_b,) + shapes[name], fill,
                      dtype=(bool if isinstance(fill, bool) else np.int32))
        for name, fill in _WINDOW_FILLS.items()}
    for b in range(n_b):
        lo = int(bases[b])
        live = min(w, m - lo)
        if live > 0:
            for name in _WINDOW_FILLS:
                dense[name][b][..., lo:lo + live] = \
                    getattr(state, name)[b][..., :live]
        if lo > 0:
            dense["recv_has"][b][..., :lo] = out_recv[b][..., :lo]
            dense["retry"][b][..., :lo] = out_retry[b][..., :lo]
            dense["quack_time"][b][..., :lo] = out_quack[b][..., :lo]
            dense["deliver_time"][b][:lo] = out_deliver[b][:lo]
            dense["known"][b][..., :lo] = True
            dense["bcast_done"][b][..., :lo] = True
            dense["orig_sent"][b][:lo] = True
    return SimState(
        **dense,
        last_cum=state.last_cum, hq_reports=state.hq_reports,
        ack_floor=state.ack_floor,
        base=np.zeros(n_b, dtype=np.int32),
        retired_delivered=np.zeros(n_b, dtype=np.int32)), mc


# -------------------------------------------------- host-side helpers
def _max_msg_by_round(spec: SimSpec) -> np.ndarray:
    """r[t] = highest message index dispatched at or before round t (the
    schedule read a block at a time: O(steps) host memory)."""
    r = np.full(max(spec.steps, 1), -1, dtype=np.int64)
    for lo, ostep in _blocks(spec.orig_step):
        valid = ostep < spec.steps
        np.maximum.at(r, ostep[valid], lo + np.nonzero(valid)[0])
    return np.maximum.accumulate(r)


def _scatter_retired(bases: np.ndarray, counts: np.ndarray, srcs,
                     outs) -> np.ndarray:
    """Fold one drained queue block into the (B, ..., M) output mirrors.

    Writes each lane's leading ``counts[b]`` window columns to absolute
    slots ``[bases[b], bases[b] + counts[b])`` — one vectorized
    advanced-indexing write per output array. ``srcs``/``outs`` are the
    (quack_time, deliver_time, retry, recv_has) quadruples. Returns the
    advanced per-lane bases (the inputs are never mutated).
    """
    qq, qd, qr, qh = srcs
    out_quack, out_deliver, out_retry, out_recv = outs
    counts = np.asarray(counts, dtype=np.int64)
    if counts.any():
        w = qd.shape[-1]
        mask = np.arange(w, dtype=np.int64)[None, :] < counts[:, None]
        rows, cols = np.nonzero(mask)
        abs_cols = bases[rows] + cols
        out_quack[rows, :, abs_cols] = qq[rows, :, cols]
        out_deliver[rows, abs_cols] = qd[rows, cols]
        out_retry[rows, :, abs_cols] = qr[rows, :, cols]
        out_recv[rows, :, abs_cols] = qh[rows, :, cols]
    return bases + counts


def _concat_metrics(n_b: int, metric_parts) -> StepMetrics:
    """Concatenate per-chunk (B, c) metric parts into (B, t) arrays."""
    if not metric_parts:
        return StepMetrics(*(np.zeros((n_b, 0), dtype=np.int32)
                             for _ in StepMetrics._fields))
    return StepMetrics(*(
        np.concatenate([np.asarray(getattr(p, name)) for p in metric_parts],
                       axis=-1)
        for name in StepMetrics._fields))


# ------------------------------------------------------- windowed loop
def _run_windowed_batch(specs: List[SimSpec], device, commit_floors=None,
                        *, fail_schedule=None, recorder=None,
                        resume: Optional[ChunkCheckpoint] = None,
                        drain_sink=None) -> List[SimResult]:
    """The pipelined windowed loop, in the ambient tracer's ``run`` span
    (see ``_run_windowed_batch_impl``).

    With ``SimConfig.debug_checks`` the whole run executes under
    ``repro_torch.analysis.sanitizer.engine_guard``: a tensor read on the
    host outside the sanctioned routes (``snapshot.to_host``,
    ``snapshot.PinnedDrain``) raises ``SanitizerError`` instead of
    silently serialising the pipeline."""
    _tr = obs_begin()
    try:
        if specs and specs[0].debug_checks:
            from ..analysis.sanitizer import engine_guard
            with engine_guard():
                return _run_windowed_batch_impl(
                    specs, device, commit_floors,
                    fail_schedule=fail_schedule, recorder=recorder,
                    resume=resume, drain_sink=drain_sink)
        return _run_windowed_batch_impl(
            specs, device, commit_floors, fail_schedule=fail_schedule,
            recorder=recorder, resume=resume, drain_sink=drain_sink)
    finally:
        obs_end(_tr, "run", cat="engine", lanes=len(specs),
                steps=specs[0].steps if specs else 0)


def _run_windowed_batch_impl(specs: List[SimSpec], device,
                             commit_floors=None, *, fail_schedule=None,
                             recorder=None,
                             resume: Optional[ChunkCheckpoint] = None,
                             drain_sink=None) -> List[SimResult]:
    """The pipelined windowed loop over lanes that share a shape (one per
    spec): the JAX package's ``_run_windowed_batch_impl``.

    Up to K = ``superchunk`` full rotating chunks fuse into one program
    (``_superchunk``: ``chunk_steps`` rounds, each lane's GC frontier and
    ring rotation, K times, with a K-deep ``ChunkQueue`` and K-deep round
    metrics). Programs come from the layout's cached set
    (``_layout_set``), which outlives the run: on a CUDA device a program
    is captured at its first use in the set, per (width, rounds a chunk,
    chunks, rotation, metrics), and replayed by this and every later run
    of the layout; on the CPU the same function runs eagerly. The run
    copies its initial state and its lanes' ``FailArrays`` into the
    set's buffers in place. A span is ``k = min(K, (steps - t - 1) //
    chunk_steps)`` chunks; the final chunk runs alone and does not
    rotate. After a dispatch the host starts its drain
    (``snapshot.PinnedDrain``: queue, metrics, guard flags and, with
    ``collect_metrics``, the K-deep ``MetricsBlock`` stack into pinned
    buffers), then folds the *previous* dispatch's drain while this one
    computes: at most one dispatch stays undrained. The drain folds the
    K inner chunks in order into the (B, ..., M) output mirrors and
    rewinds ``t`` to the first chunk whose in-graph overflow guard
    failed; the blocks of chunks it discarded are dropped with them.

    Before each span the host checks, per lane against its own base,
    that the window holds every message dispatched by the first chunk's
    last round; on overflow the window grows 2x for all lanes, or the
    state migrates to the dense layout (``_migrate_dense_batch``), after
    a full drain, with each decision recorded as a
    ``WindowGrowthEvent``: the state moves into the new layout's set
    (the old width's set stays cached), and the ``FailArrays`` in force
    with it. The next dispatch is launched ahead of the drain only when a
    conservative bound (no frontier advance over the whole span, from
    the host's possibly pre-drain bases) proves the guard cannot fire.
    So every K gives the K = 1 loop's outputs, metrics, frontier
    trajectories and growth events bit for bit.

    Each chunk boundary, in order:

    (a) ``fail_schedule``, when given, is called as ``fail_schedule(t)``;
        a list of specs (one per lane, differing from the run's only in
        failure masks, stakes or quorum thresholds; ``ValueError``
        otherwise) swaps the inputs in force from round ``t`` on: their
        ``FailArrays`` are copied into the tensors the programs read, in
        place, the commit floors kept. ``None`` keeps them.
    (b) ``recorder`` (``wants(t) -> bool``, ``capture(ChunkCheckpoint)``)
        captures a checkpoint after a full drain, in a ``checkpoint``
        span (``cat="snapshot"``, its host bytes in ``nbytes``).
    (c) ``commit_floors``, when given, is called as ``commit_floors(t,
        bases)`` after a full drain (``bases``: each lane's retired
        prefix), inside a ``plan_floors`` span, and returns each lane's
        commit floor for that chunk: a lane dispatches no message at or
        past its floor (the topology engine routes an upstream link's
        retired prefix into a chained link's floor). A new floor is
        written into ``fail.commit_floor`` in place, on the stream that
        replays. Without one every floor is M (a standalone link). A
        lane's overflow need is capped by its floor, and ``send_step``
        records when each message was dispatched: at its schedule round,
        or at the round its floor opened past it if that is later.
    (d) the overflow check above, and (e) the dispatch.

    ``resume`` restarts the loop from a ``ChunkCheckpoint``: its state,
    inputs, mirrors, floors and history are copied into the run (the
    metrics carry restarts, seeded with ``resume_metrics_carry``), and
    the run continues from ``resume.t``. Recorded, replayed and
    scheduled runs dispatch one chunk at a time (K = 1 programs), so a
    replay finds every program its recording captured; a floor callback
    does the same. With ``debug_checks`` each drained chunk checks that
    the host's base mirror tracks the device rotation and, for lanes
    whose adversary stakes keep ``retire_safety_stakes_ok``, that every
    retired slot is held by at least one receiver replica (GC safety).

    ``drain_sink`` switches the loop into **horizon mode** (the
    ``repro_torch.stream`` session): M is a message horizon rather than
    an allocation. No (B, ..., M) output mirror, ``send_step`` mirror,
    round-metric or block history is kept: each drained inner chunk goes
    to ``drain_sink.on_chunk(t_end, metrics, queue, block, bases)``
    (``StepMetrics`` of (B, c) arrays, the chunk's ``ChunkQueue`` of
    numpy arrays, its cumulative ``MetricsBlock``, the lanes' retired
    prefixes after it), the final unrotated chunk included, and after
    the final flush ``drain_sink.on_final(state, mc, bases, w,
    growth_events, t)``, where ``state`` is the final window's outputs
    as a ``ChunkQueue`` (the columns the batch flush fetches; ``count``
    the live columns) and ``mc`` the ``MetricsBlock`` of the final
    accumulators that ``obs_from_final`` reads; the call returns ``[]``.
    The arrays are the sink's to keep. Host memory stays O(B * W) a
    dispatch, and the programs, spans and launch-ahead decisions are
    those of batch mode, so a session issues the batch run's dispatches
    and replays its graphs. It requires ``collect_metrics`` and refuses
    ``recorder`` / ``resume`` (``ValueError``: checkpoints hold the O(M)
    mirrors); a window may grow, but a dense migration (O(M) state)
    raises ``RuntimeError`` before it allocates anything.
    """
    spec0 = specs[0]
    if drain_sink is not None:
        if recorder is not None or resume is not None:
            raise ValueError("drain_sink (horizon mode) is incompatible "
                             "with recorder/resume: checkpoints capture "
                             "the O(M) output mirrors horizon mode "
                             "exists to avoid")
        if not spec0.collect_metrics:
            raise ValueError("drain_sink requires collect_metrics=True: "
                             "the MetricsBlock snapshots riding the "
                             "drain are the live telemetry feed")
    retain = drain_sink is None       # batch mode: the O(M) host mirrors
    n_b = len(specs)
    n_s, n_r, m = spec0.n_s, spec0.n_r, spec0.m
    steps = spec0.steps
    c_full = max(spec0.chunk_steps, 1)
    K = max(spec0.superchunk, 1)
    collect = spec0.collect_metrics
    layout = _LayoutKey(spec0)
    drains = PinnedDrain(device)
    dispatched_by = _max_msg_by_round(spec0)
    ostep = np.asarray(spec0.orig_step, dtype=np.int64) if retain else None

    if resume is None:
        w = spec0.window_slots
        progs = _fresh_set(specs, layout, w, device)
        if retain:
            out_quack = np.full((n_b, n_s, m), -1, dtype=np.int32)
            out_deliver = np.full((n_b, m), -1, dtype=np.int32)
            out_retry = np.zeros((n_b, n_s, m), dtype=np.int32)
            out_recv = np.zeros((n_b, n_r, m), dtype=bool)
            # each lane's dispatch round of every message (-1: not yet),
            # filled as its floor opens
            send_step = np.full((n_b, m), -1, dtype=np.int64)
        else:
            out_quack = out_deliver = out_retry = out_recv = None
            send_step = None
        bases = np.zeros(n_b, dtype=np.int64)
        bases_hist = [bases.copy()]
        floors = np.full(n_b, m, dtype=np.int64)
        t = 0
        metric_parts: List[StepMetrics] = []
        growth_events: List[WindowGrowthEvent] = []
        open_floor = np.zeros(n_b, dtype=np.int64)
    else:
        if len(resume.bases) != n_b:
            raise ValueError(
                f"resume checkpoint has {len(resume.bases)} lanes, specs "
                f"describe {n_b}")
        w = int(resume.window_slots)
        progs = _layout_set(layout, n_b, w, device)
        copy_into(progs.keep[0], resume.fails)
        out_quack = np.array(resume.out_quack, dtype=np.int32)
        out_deliver = np.array(resume.out_deliver, dtype=np.int32)
        out_retry = np.array(resume.out_retry, dtype=np.int32)
        out_recv = np.array(resume.out_recv, dtype=bool)
        bases = np.array(resume.bases, dtype=np.int64)
        bases_hist = [np.array(r, dtype=np.int64)
                      for r in resume.bases_hist]
        floors = np.array(resume.floors, dtype=np.int64)
        t = int(resume.t)
        metric_parts = [p for p in resume.metric_parts
                        if np.asarray(p.acks).shape[-1]]
        growth_events = list(resume.growth_events)
        if resume.send_step is not None:
            send_step = np.array(resume.send_step, dtype=np.int64)
        else:
            # a trace without the mirror: every message below the
            # checkpoint's floor dispatched at its schedule round (exact
            # for standalone links, whose floor opened at round 0)
            send_step = np.where(
                np.arange(m, dtype=np.int64)[None, :] < floors[:, None],
                ostep[None, :], -1)
        open_floor = floors.copy()
        with explicit():     # the resume's uploads
            progs.load(_carry(resume.state,
                              resume_metrics_carry(w, bases, send_step, m,
                                                   device)
                              if collect else None))
    fail, plan = progs.keep
    outs = (out_quack, out_deliver, out_retry, out_recv)
    obs_parts: List[MetricsBlock] = []   # drained per-chunk snapshots
    debug = spec0.debug_checks
    retire_check = np.array([retire_safety_stakes_ok(s) for s in specs])
    pending: List[dict] = []      # dispatched, not yet drained (<= 1)

    def drain_one(ent: dict) -> None:
        nonlocal bases, t
        _tw = obs_begin()
        ms, qq, qd, qr, qh, qbase, qcount, oks, *blk = drains.wait(
            ent["handle"])

        def _queue(i: int) -> ChunkQueue:
            return ChunkQueue(*(x[i].copy() for x in
                                (qq, qd, qr, qh, qbase, qcount)))
        # a successor dispatch still in flight means this wait ran while
        # the device computed
        obs_end(_tw, "drain_wait", cat="drain", k=ent["k"],
                overlapped=bool(pending))
        _HOST_SYNCS[0] += 1
        k, c = ent["k"], ent["c"]
        executed = int(oks.sum())
        if executed < k:
            t = ent["t0"] + executed * c
            ent["progs"].discount(ent["key"], k - executed, k)
        # the chunks a failed guard discarded (i >= executed) reach no
        # mirror and no sink
        for i in range(executed):
            msp = StepMetrics(*(ms[i, :, :, j].copy()
                                for j in range(ms.shape[3])))
            bp = MetricsBlock(*(x[i].copy() for x in blk)) if blk else None
            if retain:
                metric_parts.append(msp)
                if bp is not None:
                    obs_parts.append(bp)
            if not ent["rotate"]:
                if not retain:
                    drain_sink.on_chunk(ent["t0"] + (i + 1) * c, msp,
                                        _queue(i), bp, bases.copy())
                continue               # final chunk: nothing retired
            if debug and not (qbase[i] == bases).all():
                raise RuntimeError(
                    "window base mirror diverged from device rotation")
            if debug and retire_check.any():
                held = qh[i].any(axis=1)                        # (B, W)
                ret = (np.arange(held.shape[-1])[None, :]
                       < qcount[i][:, None])
                bad = ret & ~held & retire_check[:, None]
                if bad.any():
                    b, kk = np.argwhere(bad)[0]
                    raise RuntimeError(
                        f"GC safety violation: lane {b} retired window "
                        f"slot {kk} (abs seqno {int(bases[b]) + int(kk)})"
                        f" that no replica has received — the frontier "
                        f"outran an undelivered message under an "
                        f"adversary whose stake budget should make that "
                        f"impossible")
            if retain:
                bases = _scatter_retired(bases, qcount[i],
                                         (qq[i], qd[i], qr[i], qh[i]), outs)
                bases_hist.append(bases.copy())
            else:
                # horizon mode: the chunk retires into the sink, O(B * W)
                # a drain however far the stream has run
                bases = bases + qcount[i].astype(np.int64)
                drain_sink.on_chunk(ent["t0"] + (i + 1) * c, msp,
                                    _queue(i), bp, bases.copy())

    def drain_all() -> None:
        while pending:
            drain_one(pending.pop(0))

    def program(c: int, k: int, rotate: bool, w: int, fail, plan):
        def body(carry, t0):
            carry, ms, queue, oks, *blk = _superchunk(
                spec0, fail, plan, carry, t0, w, c, k, rotate)
            return carry, [ms, *queue, oks, *(blk[0] if blk else ())]
        return body

    while t < steps:
        c = min(c_full, steps - t)
        # (a) a schedule swap writes the new inputs into the tensors the
        # programs read; a replay still in flight read the old ones first
        new_specs = None if fail_schedule is None else fail_schedule(t)
        if new_specs is not None:
            new_specs = list(new_specs)
            if (len(new_specs) != n_b
                    or any(_LayoutKey(s) != layout for s in new_specs)):
                raise ValueError(
                    "fail_schedule must return one spec per lane, "
                    "differing from the originals only in failure "
                    "masks, stakes or quorum thresholds (inputs the "
                    "programs read; anything else is another program)")
            with explicit():      # an upload
                copy_into(fail, _fail_arrays(new_specs, device)._replace(
                    commit_floor=fail.commit_floor))
            retire_check = np.array([retire_safety_stakes_ok(s)
                                     for s in new_specs])
        # (b) a checkpoint is the boundary's exact state: the pipeline
        # drains first
        if recorder is not None and recorder.wants(t):
            drain_all()
            _HOST_SYNCS[0] += 1
            _tc = obs_begin()
            # the state and the inputs in force, in one device->host copy
            got = to_host(list(_split(progs.state)[0]) + list(fail))
            n_state = len(SimState._fields)
            ckpt = ChunkCheckpoint(
                t=t, window_slots=w, bases=bases.copy(),
                state=SimState(*got[:n_state]),
                fails=FailArrays(*got[n_state:]), floors=floors.copy(),
                out_quack=out_quack.copy(), out_deliver=out_deliver.copy(),
                out_retry=out_retry.copy(), out_recv=out_recv.copy(),
                metric_parts=tuple(metric_parts),
                bases_hist=np.stack(bases_hist),
                growth_events=tuple(growth_events),
                send_step=send_step.copy())
            recorder.capture(ckpt)
            obs_end(_tc, "checkpoint", cat="snapshot", t=t,
                    nbytes=_checkpoint_nbytes(ckpt))
        # (c) the floors follow this boundary's retired prefixes, so the
        # pipeline drains before asking; no replay reads the floors while
        # they are written
        if commit_floors is not None:
            drain_all()
            _tp = obs_begin()
            new_floors = np.asarray(commit_floors(t, bases.copy()),
                                    dtype=np.int64)
            obs_end(_tp, "plan_floors", cat="plan", t=t)
            if not np.array_equal(new_floors, floors):
                floors = new_floors
                copy_into(fail.commit_floor,
                          torch.from_numpy(floors.astype(np.int32)))
        # a floor that opened dispatches its newly committed messages at
        # max(schedule round, now); horizon mode keeps no such mirror
        for b in (np.nonzero(floors > open_floor)[0] if retain else ()):
            ks = np.arange(open_floor[b], floors[b])
            send_step[b, ks] = np.maximum(ostep[ks], t)
            open_floor[b] = floors[b]
        # (d) per-lane overflow check: a lane's window must hold every
        # message it may dispatch by the chunk's last round (nothing at
        # or past its floor), measured against its own base; only a
        # potential overflow waits for the drain
        need_b = np.minimum(int(dispatched_by[t + c - 1]), floors - 1)
        if pending and (need_b - bases >= w).any():
            drain_all()
        over = need_b - bases
        b_worst = int(over.argmax())
        if over[b_worst] >= w:
            drain_all()
            need = int(need_b[b_worst])
            new_w = _widen_on_overflow(spec0, w, int(bases[b_worst]), need,
                                       t + c - 1)
            growth_events.append(WindowGrowthEvent(
                step=t + c - 1, scenario=b_worst, need=need, old_w=w,
                new_w=m if new_w is None else new_w,
                dense_migration=new_w is None))
            if new_w is None and not retain:
                # the width that would have held this overflow: enough
                # slots above the stalled lane's frontier to cover its
                # dispatch head, rounded to stream_window_slots' 64
                span = need + 1 - int(bases[b_worst])
                suggest = int(-(-span // 64) * 64)
                raise RuntimeError(
                    "stream session window overflow: the dense "
                    "fallback would allocate the full horizon "
                    f"(W={w} -> M={m}). Lane {b_worst}'s dispatch "
                    f"head is {need} with GC frontier "
                    f"{int(bases[b_worst])}, so stream_window_slots >= "
                    f"{suggest} would have sufficed — pass "
                    f"SimConfig(window_slots={suggest}) (or raise the "
                    "slack in repro_torch.stream.workload."
                    "stream_window_slots), or lower the arrival rate")
            state, mc = _split(progs.state)
            _tg = obs_begin()
            if new_w is None:
                state, mc = _migrate_dense_batch(spec0, state, bases, *outs,
                                                 mc=mc, send_step=send_step)
                _HOST_SYNCS[0] += 1
                bases[:] = 0
                w = m
            else:
                state = pad_window(state, new_w)
                if mc is not None:
                    mc = pad_metrics(mc, new_w)
                w = new_w
            # the new layout's set takes the state and the inputs in
            # force; the old width's set stays cached
            old_fail = fail
            progs = _layout_set(layout, n_b, w, device)
            fail, plan = progs.keep
            copy_into(fail, old_fail)
            progs.load(_carry(state, mc))
            obs_end(_tg, "dense_migration" if new_w is None
                    else "window_growth", cat="window", t=t, new_w=w)
        # the schedule gather reads [base, base + w) of a schedule padded
        # by w: it stays in range while every base is at most M
        if (bases > m).any():
            raise RuntimeError(f"window bases {bases} past the stream end "
                               f"{m}")
        # (e) a span fuses up to K chunks, only where nothing needs the
        # host between them: recorded, resumed and scheduled runs stay on
        # K = 1 programs, which a recording captures for every replay
        fusible = (resume is None and fail_schedule is None
                   and recorder is None and commit_floors is None)
        last = t + c >= steps
        k = 1
        if not last and c == c_full and fusible:
            k = min(K, (steps - t - 1) // c_full)
        # launch ahead only when the guard provably cannot fire: no
        # frontier advance over the whole span, from the host's bases
        span_need = np.minimum(int(dispatched_by[t + k * c - 1]),
                               floors - 1)
        async_ok = K > 1 and bool((span_need - bases < w).all())
        key = (w, c, k, not last, collect)
        _td = obs_begin()
        _load_needs(plan, dispatched_by, t, c, k)
        captured = key not in progs
        if captured:
            _CHUNK_TRACES[0] += 1
        result = progs.run(key, program(c, k, not last, w, fail, plan), t)
        _CHUNK_DISPATCHES[0] += 1
        pending.append(dict(t0=t, k=k, c=c, rotate=not last, key=key,
                            progs=progs, handle=drains.start(result)))
        obs_end(_td, "compile" if captured else "dispatch", cat="dispatch",
                t=t, k=k)
        t += k * c
        while len(pending) > 1:
            drain_one(pending.pop(0))
        if not async_ok:
            drain_all()

    drain_all()
    # final flush: the live window, and the metrics carry's accumulators,
    # in one copy
    _tf = obs_begin()
    final, mc = _split(progs.state)
    live = [final.quack_time, final.deliver_time, final.retry,
            final.recv_has]
    got = to_host(live + ([] if mc is None else list(snapshot_metrics(mc))))
    n_live = np.minimum(w, m - bases).clip(min=0)
    if retain:
        _scatter_retired(bases, n_live, got[:len(live)], outs)
    final_acc = MetricsBlock(*got[len(live):]) if collect else None
    _HOST_SYNCS[0] += 1
    obs_end(_tf, "final_flush", cat="drain")

    if not retain:
        drain_sink.on_final(
            ChunkQueue(*got[:len(live)], bases.astype(np.int32),
                       n_live.astype(np.int32)),
            final_acc, bases.copy(), w, tuple(growth_events), t)
        return []

    # a round past the run's end never came
    ss = np.where((send_step >= 0) & (send_step < steps), send_step,
                  -1).astype(np.int32)
    traj = np.stack(bases_hist)                     # (n_boundaries, n_b)
    all_metrics = _concat_metrics(n_b, metric_parts)
    events = tuple(growth_events)
    return [SimResult(
        spec=spec,
        metrics=StepMetrics(*(np.ascontiguousarray(getattr(all_metrics,
                                                           name)[b])
                              for name in StepMetrics._fields)),
        quack_time=out_quack[b], deliver_time=out_deliver[b],
        retry=out_retry[b], recv_has=out_recv[b],
        gc_frontiers=traj[:, b].astype(np.int64),
        final_window_slots=w,
        window_growth_events=events,
        send_step=ss[b],
        delivery_latency=_latency_from(ss[b], out_deliver[b]),
        obs=(obs_from_final(final_acc, obs_parts, b) if collect
             else None),
    ) for b, spec in enumerate(specs)]


def _checkpoint_nbytes(ckpt: ChunkCheckpoint) -> int:
    """Host bytes a checkpoint holds of its own (its metric blocks are
    shared with the loop)."""
    leaves = ([ckpt.bases, ckpt.floors, ckpt.out_quack, ckpt.out_deliver,
               ckpt.out_retry, ckpt.out_recv, ckpt.bases_hist,
               ckpt.send_step] + list(ckpt.state) + list(ckpt.fails))
    return int(sum(np.asarray(x).nbytes for x in leaves))


# ------------------------------------------------------------------ runs
def _neutral(spec: SimSpec) -> SimSpec:
    """``spec`` with its per-lane inputs (failure masks, stakes, quorum
    thresholds) and window config normalised away: what the specs of one
    batch must share."""
    n_s, n_r = spec.n_s, spec.n_r
    return dataclasses.replace(
        spec,
        crash_s=(-1,) * n_s, crash_r=(-1,) * n_r,
        byz_send_drop=(False,) * n_s, byz_recv_drop=(False,) * n_r,
        byz_ack_advance=(0,) * n_r, byz_ack_low=(False,) * n_r,
        byz_bcast_partial=(False,) * n_r, bcast_limit=0,
        byz_equiv_send=(False,) * n_s, byz_hq_advance=(0,) * n_s,
        byz_ack_stale=(False,) * n_r,
        drop_pair=((False,) * n_r,) * n_s,
        stakes_s=(1.0,) * n_s, stakes_r=(1.0,) * n_r,
        quack_thresh=1.0, dup_thresh=1.0, hq_thresh=1.0,
        window_slots=0, chunk_steps=0, adaptive_window=True,
        superchunk=1, debug_checks=False)


def require_uniform_batch(specs: Sequence[SimSpec]) -> None:
    """Raise unless the specs differ only in their failure masks (and
    stakes and quorum thresholds): the lanes of one run share shapes,
    schedules and window config."""
    nspec = _neutral(specs[0])
    win_key = (specs[0].window_slots, specs[0].chunk_steps,
               specs[0].adaptive_window, specs[0].superchunk,
               specs[0].debug_checks)
    for s in specs[1:]:
        if (_neutral(s) != nspec
                or (s.window_slots, s.chunk_steps, s.adaptive_window,
                    s.superchunk, s.debug_checks)
                != win_key):
            raise ValueError("run_simulation_batch: specs differ outside "
                             "their failure masks; batch members must share "
                             "shapes, schedules, thresholds and window "
                             "config (window_slots / chunk_steps / "
                             "adaptive_window)")


def run_simulation(spec: SimSpec, device=None) -> SimResult:
    """Run one spec on ``device`` (default: CUDA; raises if it is absent):
    windowed when ``spec.window_slots > 0``, else dense. A run is one
    lane of ``run_simulation_batch``. With ``collect_metrics`` the
    result's ``obs`` holds the lane's ``obs.metrics.ObsMetrics``.
    """
    return run_simulation_batch([spec], device)[0]


def run_simulation_batch(specs: Sequence[SimSpec],
                         device=None) -> List[SimResult]:
    """Run many failure scenarios of one shape as the lanes of one run on
    ``device`` (default: CUDA; raises if it is absent).

    All specs must share every field but their failure masks, stakes and
    quorum thresholds (``require_uniform_batch``): e.g. ``build_spec``
    with one ``FailureScenario`` each. Windowed specs run the
    windowed loop with a window base per lane (O(B * W) device state),
    dense specs the dense engine; each lane is bit-identical to its own
    run.
    """
    specs = list(specs)
    if not specs:
        return []
    require_uniform_batch(specs)
    dev = _resolve_device(device)
    if specs[0].window_slots:
        return _run_windowed_batch(specs, dev)
    return _run_dense_batch(specs, dev)


def retire_safety_stakes_ok(spec: SimSpec) -> bool:
    """Whether the GC retire-implies-delivered invariant is provable.

    A retired slot is QUACKed at every sender, and a QUACK quorum
    (``quack_thresh`` = u_r+1 stake) intersects at least one *honest*
    receiver's truthful claim — unless receivers that can fabricate
    claims (``byz_ack_advance``) control a whole quorum by themselves,
    or senders lying in the §4.3 hq piggyback (``byz_hq_advance``)
    control a whole attestation quorum (``hq_thresh`` = r_s+1). Every
    other adversary kind only ever *suppresses* claims.
    """
    st_r = np.asarray(spec.stakes_r, dtype=np.float64)
    adv = np.asarray(spec.byz_ack_advance, dtype=np.int64)
    fabricating = float(st_r[adv > 0].sum())
    if fabricating >= float(spec.quack_thresh):
        return False
    if spec.byz_hq_advance is not None:
        st_s = np.asarray(spec.stakes_s, dtype=np.float64)
        hq = np.asarray(spec.byz_hq_advance, dtype=np.int64)
        if float(st_s[hq > 0].sum()) >= float(spec.hq_thresh):
            return False
    return True
