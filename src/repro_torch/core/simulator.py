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

Two engines run the same step:

- **dense** (``window_slots == 0``): one lane, the window is the whole
  stream ``[0, M)`` and never rotates; the loop never syncs with the
  host, and the result comes back in one device→host copy at the end.
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
  raises ``ValueError`` instead. This engine runs one chunk per dispatch
  (superchunk K = 1) whatever ``spec.superchunk`` says: the reference
  gives identical outputs for every K.

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
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import scheduler as sched
from .gc import gc_frontier_device, grow_window, resolve_window_slots
from .quack import (claim_bitmask, missing_below_horizon,
                    stake_quorum_bitmap, weighted_quorum_prefix)
from .snapshot import WINDOW_FILLS as _WINDOW_FILLS
from .snapshot import device_state, host_state, pad_window, to_host
from .snapshot import window_shapes as _window_shapes
from .types import (FailureScenario, RSMConfig, SimConfig,
                    lcm_scale_factors)

__all__ = ["SimSpec", "SimResult", "SimState", "StepMetrics", "FailArrays",
           "ChunkQueue", "WindowGrowthEvent",
           "build_spec", "run_simulation", "spec_failures",
           "spec_with_failures", "spec_with_quorum",
           "retire_safety_stakes_ok", "spec_to_arrays", "spec_from_arrays",
           "state_from_numpy"]

_NEVER_STEP = 2 ** 30     # orig_step pad for window slots beyond the stream
_BIG = 2 ** 30
_I32 = torch.int32

_METRICS_TODO = ("collect_metrics is not ported yet (ROADMAP queue 1, "
                 "item 4: obs/metrics device half)")


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
    superchunk: int = 8               # carried; the port runs K = 1
    debug_checks: bool = False        # per-drain checks (windowed)
    use_pallas_quack: bool = False    # carried across; see SimConfig
    collect_metrics: bool = False     # metrics fabric (not ported yet)

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


def _protocol_step(spec: SimSpec, fail: FailArrays, sched_w, base, w: int):
    """Per-round transition of B lanes over ``w`` window columns.

    ``sched_w`` is the (orig_sender, orig_recv, orig_step) schedule of
    each lane's window, (B, w) int32 each; ``base`` the (B,) int32 window
    bases. All sequence-number arithmetic is absolute. Returns
    ``step(state, t)`` with ``t`` a () int32 tensor, giving
    ``(new_state, metrics)`` where ``metrics`` is a (B, 6) int32 tensor in
    ``StepMetrics`` order. Nothing in a step waits for the device.
    """
    n_s, n_r, m = spec.n_s, spec.n_r, spec.m
    phi = spec.phi
    orig_sender, orig_recv, orig_step = sched_w
    dev = orig_sender.device
    sender_ix = orig_sender.long()

    stakes_s = fail.stakes_s
    stakes_r = fail.stakes_r
    rs_seq = torch.tensor(spec.rs_seq, dtype=_I32, device=dev)
    rr_seq = torch.tensor(spec.rr_seq, dtype=_I32, device=dev)
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


def _sched_arrays(spec: SimSpec, device):
    def t(x):
        return torch.tensor(x, dtype=_I32, device=device)

    return t(spec.orig_sender), t(spec.orig_recv), t(spec.orig_step)


def _padded_sched(spec: SimSpec, w: int, device):
    """The schedule padded by ``w`` never-sent slots, so that a window at
    any base <= M reads inside it."""
    osend, orecv, ostep = (np.asarray(a, dtype=np.int64) for a in
                           (spec.orig_sender, spec.orig_recv,
                            spec.orig_step))

    def pad(a, fill):
        return torch.tensor(np.concatenate([a, np.full(w, fill)]),
                            dtype=_I32, device=device)

    return (pad(osend, 0), pad(orecv, 0),
            pad(np.minimum(ostep, _NEVER_STEP), _NEVER_STEP))


def _sched_window(sched_p, base: torch.Tensor, w: int):
    """Each lane's (B, w) schedule window: a gather at ``base + [0, w)``."""
    ix = (base[:, None] + torch.arange(w, dtype=_I32, device=base.device)
          ).long()
    return tuple(a[ix] for a in sched_p)


# ------------------------------------------------------------ dense run
def _run_dense(spec: SimSpec, device) -> Tuple[SimState, torch.Tensor]:
    """Dense full-stream run: one lane, window = [0, M), no rotation.

    Returns the final state and the (1, steps, 6) int32 metrics, both on
    ``device``; the loop never waits for the device.
    """
    fail = _fail_arrays([spec], device)
    state = _init_state(spec, spec.m, device)
    sched_w = tuple(a[None] for a in _sched_arrays(spec, device))
    step = _protocol_step(spec, fail, sched_w, state.base, spec.m)
    ts = torch.arange(spec.steps, dtype=_I32, device=device)
    per_round: List[torch.Tensor] = []
    for i in range(spec.steps):
        state, ms = step(state, ts[i])
        per_round.append(ms)
    if per_round:
        metrics = torch.stack(per_round, dim=1)
    else:
        metrics = torch.zeros((1, 0, len(StepMetrics._fields)), dtype=_I32,
                              device=device)
    return state, metrics


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


def _chunk(spec: SimSpec, fail: FailArrays, sched_p, state: SimState,
           ts: torch.Tensor, w: int, rotate: bool):
    """One windowed chunk: the rounds ``ts`` ((c,) int32 on the device),
    then, when ``rotate``, the GC frontier and the ring rotation.

    Returns ``(state, metrics (B, c, 6) int32, ChunkQueue)``; the queue
    holds the pre-rotation outputs and each lane's retired count (0 for
    the final chunk of a run, which does not rotate). Plain tensor work
    with no host sync.
    """
    base0 = state.base
    step = _protocol_step(spec, fail, _sched_window(sched_p, base0, w),
                          base0, w)
    per_round = []
    for i in range(ts.shape[0]):
        state, ms = step(state, ts[i])
        per_round.append(ms)
    ms = torch.stack(per_round, dim=1)
    if not rotate:
        return state, ms, ChunkQueue(
            state.quack_time, state.deliver_time, state.retry,
            state.recv_has, base0, torch.zeros_like(base0))
    f = gc_frontier_device(
        base=base0, t_next=ts[-1] + 1, m=spec.m,
        known=state.known, bcast_q=state.bcast_q,
        recv_has=state.recv_has, ack_floor=state.ack_floor,
        stakes_r=fail.stakes_r, quack_thresh=fail.quack_thresh,
        orig_sent=state.orig_sent, crash_r=fail.crash_r,
        byz_ack_low=fail.byz_ack_low)
    queue = ChunkQueue(state.quack_time, state.deliver_time, state.retry,
                       state.recv_has, base0, f)
    return _rotate_device(state, f, w), ms, queue


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
                         out_recv: np.ndarray) -> SimState:
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

    One-off host transform: one device->host copy of the state, numpy,
    and back to the state's device.
    """
    n_b = len(bases)
    n_s, n_r, m = spec.n_s, spec.n_r, spec.m
    device = state.base.device
    state = host_state(state)
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
    return device_state(SimState(
        **dense,
        last_cum=state.last_cum, hq_reports=state.hq_reports,
        ack_floor=state.ack_floor,
        base=np.zeros(n_b, dtype=np.int32),
        retired_delivered=np.zeros(n_b, dtype=np.int32)), device)


# -------------------------------------------------- host-side helpers
def _max_msg_by_round(spec: SimSpec) -> np.ndarray:
    """r[t] = highest message index dispatched at or before round t."""
    ostep = np.asarray(spec.orig_step, dtype=np.int64)
    r = np.full(max(spec.steps, 1), -1, dtype=np.int64)
    valid = ostep < spec.steps
    np.maximum.at(r, ostep[valid], np.nonzero(valid)[0])
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
def _run_windowed(spec: SimSpec, device) -> SimResult:
    """Single windowed run == one lane of the windowed loop."""
    return _run_windowed_batch([spec], device)[0]


def _run_windowed_batch(specs: List[SimSpec], device) -> List[SimResult]:
    """The windowed loop over lanes that share a shape (one per spec).

    One dispatch per chunk: ``chunk_steps`` rounds, then each lane's GC
    frontier and ring rotation on the device (``_chunk``). The host then
    drains the chunk's ``ChunkQueue`` and round metrics in one
    device->host copy and folds the retired columns into the (B, ..., M)
    output mirrors. Before each chunk the host checks, per lane against
    its own base, that the window holds every message dispatched by the
    chunk's last round; on overflow the window grows 2x for all lanes, or
    the state migrates to the dense layout (``_migrate_dense_batch``),
    and each decision is recorded as a ``WindowGrowthEvent``. The final
    chunk does not rotate; a last copy flushes the live window.

    Superchunk K = 1 whatever ``spec.superchunk`` says: the reference
    guarantees outputs, metrics, frontier trajectories and growth events
    identical for every K, so K only changes how many chunks a dispatch
    fuses. Commit floors are held at M (a standalone link); the
    dispatch-round mirror ``send_step`` follows them as the reference's
    does.

    With ``debug_checks`` each drain checks that the host's base mirror
    tracks the device rotation and, for lanes whose adversary stakes keep
    ``retire_safety_stakes_ok``, that every retired slot is held by at
    least one receiver replica (GC safety).
    """
    spec0 = specs[0]
    n_b = len(specs)
    n_s, n_r, m = spec0.n_s, spec0.n_r, spec0.m
    c_full = max(spec0.chunk_steps, 1)
    w = spec0.window_slots
    fail = _fail_arrays(specs, device)
    state = _init_state(spec0, w, device, n_b)
    sched_p = _padded_sched(spec0, w, device)

    out_quack = np.full((n_b, n_s, m), -1, dtype=np.int32)
    out_deliver = np.full((n_b, m), -1, dtype=np.int32)
    out_retry = np.zeros((n_b, n_s, m), dtype=np.int32)
    out_recv = np.zeros((n_b, n_r, m), dtype=bool)
    outs = (out_quack, out_deliver, out_retry, out_recv)
    bases = np.zeros(n_b, dtype=np.int64)
    bases_hist = [bases.copy()]
    floors = np.full(n_b, m, dtype=np.int64)
    # per-message dispatch-round mirror: filled as floors open, feeds
    # SimResult.send_step / delivery_latency
    send_step = np.full((n_b, m), -1, dtype=np.int64)
    open_floor = np.zeros(n_b, dtype=np.int64)
    ostep = np.asarray(spec0.orig_step, dtype=np.int64)
    dispatched_by = _max_msg_by_round(spec0)
    metric_parts: List[StepMetrics] = []
    growth_events: List[WindowGrowthEvent] = []
    debug = spec0.debug_checks
    retire_check = np.array([retire_safety_stakes_ok(s) for s in specs])

    t = 0
    while t < spec0.steps:
        c = min(c_full, spec0.steps - t)
        # dispatch-round mirror: floors that opened since the last
        # boundary dispatch their messages at max(schedule round, now)
        for b in np.nonzero(floors > open_floor)[0]:
            ks = np.arange(open_floor[b], floors[b])
            send_step[b, ks] = np.maximum(ostep[ks], t)
            open_floor[b] = floors[b]
        # per-lane overflow check: a lane's window must hold every
        # message dispatched by the chunk's last round (capped by its
        # commit floor), measured against its own base
        need_b = np.minimum(int(dispatched_by[t + c - 1]), floors - 1)
        over = need_b - bases
        b_worst = int(over.argmax())
        if over[b_worst] >= w:
            new_w = _widen_on_overflow(spec0, w, int(bases[b_worst]),
                                       int(need_b[b_worst]), t + c - 1)
            growth_events.append(WindowGrowthEvent(
                step=t + c - 1, scenario=b_worst,
                need=int(need_b[b_worst]), old_w=w,
                new_w=m if new_w is None else new_w,
                dense_migration=new_w is None))
            if new_w is None:
                state = _migrate_dense_batch(spec0, state, bases, *outs)
                bases[:] = 0
                w = m
            else:
                state = pad_window(state, new_w)
                w = new_w
            sched_p = _padded_sched(spec0, w, device)
        # the schedule gather reads [base, base + w) of a schedule padded
        # by w: it stays in range while every base is at most M
        if (bases > m).any():
            raise RuntimeError(f"window bases {bases} past the stream end "
                               f"{m}")
        last = t + c >= spec0.steps
        ts = torch.arange(t, t + c, dtype=_I32, device=device)
        state, ms, queue = _chunk(spec0, fail, sched_p, state, ts, w,
                                  rotate=not last)
        # the drain: one device->host copy for the queue and the metrics
        qq, qd, qr, qh, qbase, qcount, msh = to_host(
            [queue.quack_time, queue.deliver_time, queue.retry,
             queue.recv_has, queue.base, queue.count, ms])
        metric_parts.append(StepMetrics(*(msh[:, :, i] for i in
                                          range(msh.shape[2]))))
        t += c
        if last:
            break                  # final chunk: nothing retired
        if debug and not (qbase == bases).all():
            raise RuntimeError(
                "window base mirror diverged from device rotation")
        if debug and retire_check.any():
            held = qh.any(axis=1)                               # (B, W)
            ret = np.arange(held.shape[-1])[None, :] < qcount[:, None]
            bad = ret & ~held & retire_check[:, None]
            if bad.any():
                b, kk = np.argwhere(bad)[0]
                raise RuntimeError(
                    f"GC safety violation: lane {b} retired window "
                    f"slot {kk} (abs seqno {int(bases[b]) + int(kk)}) "
                    f"that no replica has received — the frontier "
                    f"outran an undelivered message under an adversary "
                    f"whose stake budget should make that impossible")
        bases = _scatter_retired(bases, qcount, (qq, qd, qr, qh), outs)
        bases_hist.append(bases.copy())

    # final flush: the live window, in one copy
    _scatter_retired(bases, np.minimum(w, m - bases).clip(min=0),
                     to_host([state.quack_time, state.deliver_time,
                              state.retry, state.recv_has]), outs)

    # a dispatch round beyond the run never fired
    ss_all = np.where((send_step >= 0) & (send_step < spec0.steps),
                      send_step, -1).astype(np.int32)
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
        send_step=ss_all[b],
        delivery_latency=_latency_from(ss_all[b], out_deliver[b]),
    ) for b, spec in enumerate(specs)]


# ------------------------------------------------------------------ runs
def run_simulation(spec: SimSpec, device=None) -> SimResult:
    """Run one spec on ``device`` (default: CUDA; raises if it is absent):
    windowed when ``spec.window_slots > 0``, else dense.

    ``collect_metrics`` raises ``NotImplementedError`` (not ported yet).
    """
    if spec.collect_metrics:
        raise NotImplementedError(_METRICS_TODO)
    dev = _resolve_device(device)
    if spec.window_slots:
        return _run_windowed(spec, dev)
    final, metrics = _run_dense(spec, dev)
    quack_time, deliver_time, retry, recv_has, ms = to_host(
        [final.quack_time[0], final.deliver_time[0], final.retry[0],
         final.recv_has[0], metrics[0]])
    ss = _dense_send_step(spec)
    return SimResult(
        spec=spec,
        metrics=StepMetrics(*(np.ascontiguousarray(ms[:, i])
                              for i in range(ms.shape[1]))),
        quack_time=quack_time,
        deliver_time=deliver_time,
        retry=retry,
        recv_has=recv_has,
        gc_frontiers=np.zeros(1, dtype=np.int64),
        final_window_slots=spec.m,
        send_step=ss,
        delivery_latency=_latency_from(ss, deliver_time),
    )


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
