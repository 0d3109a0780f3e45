"""Vectorized PICSOU simulator in torch — the dense engine.

The simulator executes the *full* protocol of §4–§5 — round-robin / DSS
send scheduling, receiver rotation, intra-RSM broadcast, cumulative +
phi-list acknowledgements, QUACK formation, duplicate-complaint loss
detection, communication-free retransmitter election, GC with the
highest-quacked metadata defence, stake weighting and LCM-scaled
retransmission rotation — as tensor state transitions, one step per
synchronous round (one cross-RSM RTT).

This module holds the dense engine: per-message state covers the whole
stream (window ``[0, M)``, no rotation) and a Python loop runs
``spec.steps`` rounds on one device. The stake-weighted QUACK and loss
quorums of every round go through ``kernels.ops.quack_scan`` — the
hand-written CUDA kernel on the card. The round loop never syncs with
the host: round metrics stay on the device, and the whole result comes
back in one device→host copy at the end. The windowed engine (chunks,
GC rotation, superchunks), batched sweeps and the metrics fabric are not
ported yet (ROADMAP queue 1).

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
run here as float32 matrix products over 0/1 operands (exact: every count
is below 2^24, and 0/1 is exact in TF32 too) or as boolean ``any``
reductions. Every state tensor is int32 or bool, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import scheduler as sched
from .gc import resolve_window_slots
from .quack import (claim_bitmask, missing_below_horizon,
                    stake_quorum_bitmap, weighted_quorum_prefix)
from .snapshot import WINDOW_FILLS as _WINDOW_FILLS
from .snapshot import window_shapes as _window_shapes
from .types import (FailureScenario, RSMConfig, SimConfig,
                    lcm_scale_factors)

__all__ = ["SimSpec", "SimResult", "SimState", "StepMetrics", "FailArrays",
           "build_spec", "run_simulation", "spec_failures",
           "spec_with_failures", "spec_with_quorum",
           "retire_safety_stakes_ok", "spec_to_arrays", "spec_from_arrays",
           "state_from_numpy"]

_BIG = 2 ** 30
_I32 = torch.int32

# ROADMAP queue 1 items that a dense-only engine cannot run yet
_WINDOWED_TODO = ("the windowed engine is not ported yet (ROADMAP queue 1, "
                  "item 1: windowed core with gc_frontier_device and "
                  "_rotate_device); use window_slots=None")
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
    superchunk: int = 8               # fused chunks per dispatch (windowed)
    debug_checks: bool = False        # per-drain checks (windowed)
    use_pallas_quack: bool = False    # carried across; see SimConfig
    collect_metrics: bool = False     # metrics fabric (not ported yet)

    def scan_state_nbytes(self) -> int:
        """Device bytes of the per-round state (the P1 footprint).

        Computed from the shapes and dtypes that ``_init_state`` really
        builds (on the ``meta`` device, so nothing is allocated).
        """
        w = self.window_slots or self.m
        state = _init_state(self, w, torch.device("meta"))
        return sum(t.numel() * t.element_size() for t in state)


class FailArrays(NamedTuple):
    """Per-scenario inputs of a run, as device tensors.

    Mostly failure masks; ``commit_floor`` is the commit-gated dispatch
    boundary for chained topologies (message ``k`` may only be originated
    once ``k < commit_floor``); a standalone link is fully committed
    (``commit_floor == m``). Stakes and quorum thresholds ride here too,
    as () / (n,) float32 tensors that the quorum kernel reads on the
    device.
    """

    crash_s: torch.Tensor           # (n_s,) int32, -1 = never
    crash_r: torch.Tensor           # (n_r,) int32
    byz_send_drop: torch.Tensor     # (n_s,) bool
    byz_recv_drop: torch.Tensor     # (n_r,) bool
    byz_ack_advance: torch.Tensor   # (n_r,) int32
    byz_ack_low: torch.Tensor       # (n_r,) bool
    byz_bcast_partial: torch.Tensor  # (n_r,) bool
    bcast_limit: torch.Tensor       # () int32
    commit_floor: torch.Tensor      # () int32 — dispatch gate (abs seqno)
    byz_equiv_send: torch.Tensor    # (n_s,) bool — resends equivocate
    byz_hq_advance: torch.Tensor    # (n_s,) int32 — §4.3 hq-piggyback lie
    byz_ack_stale: torch.Tensor     # (n_r,) bool — replays previous ack
    drop_pair: torch.Tensor         # (n_s, n_r) bool — selective drops
    stakes_s: torch.Tensor          # (n_s,) float32
    stakes_r: torch.Tensor          # (n_r,) float32
    quack_thresh: torch.Tensor      # () float32 — u_r + 1 (stake units)
    dup_thresh: torch.Tensor        # () float32 — r_r + 1
    hq_thresh: torch.Tensor         # () float32 — r_s + 1


class SimState(NamedTuple):
    recv_has: torch.Tensor      # (n_r, W) bool — receiver truly holds slot
    bcast_q: torch.Tensor       # (n_r, W) bool — queued broadcast for t+1
    bcast_done: torch.Tensor    # (n_r, W) bool
    orig_sent: torch.Tensor     # (W,) bool — original dispatch attempted
    known: torch.Tensor         # (n_s, n_r, W) bool — j's claims known to l
    complaint: torch.Tensor     # (n_s, n_r, W) bool — j's last complaint
    repeat_c: torch.Tensor      # (n_s, n_r, W) bool — complained twice to l
    last_cum: torch.Tensor      # (n_s, n_r) int32 (absolute counts)
    retry: torch.Tensor         # (n_s, W) int32
    quack_time: torch.Tensor    # (n_s, W) int32, -1 = not yet
    deliver_time: torch.Tensor  # (W,) int32, -1 = not yet
    hq_reports: torch.Tensor    # (n_r, n_s) int32 (absolute seqnos)
    ack_floor: torch.Tensor     # (n_r,) int32 (absolute counts)
    base: torch.Tensor          # () int32 — absolute seqno of window col 0
    retired_delivered: torch.Tensor  # () int32 — delivered among retired


class StepMetrics(NamedTuple):
    cross_msgs: np.ndarray     # direct cross-RSM data copies this round
    intra_msgs: np.ndarray     # broadcast copies this round
    resends: np.ndarray        # retransmissions this round
    acks: np.ndarray           # ack messages this round
    delivered: np.ndarray      # cumulative messages delivered
    min_quack_prefix: np.ndarray  # min honest-sender quacked prefix


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
    # window width the run ended with (== m for dense runs)
    final_window_slots: Optional[int] = None
    window_growth_events: Tuple = ()
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
    """A ``SimState`` of numpy arrays (fields in ``SimState`` order, e.g.
    the JAX package's state after ``jax.device_get``) as device tensors,
    with dtypes kept (int32 / bool)."""
    return SimState(*(torch.tensor(np.asarray(x), device=device)
                      for x in state_np))


# ------------------------------------------------------------- the round
def _fail_arrays(spec: SimSpec, device) -> FailArrays:
    n_s, n_r = spec.n_s, spec.n_r

    def tup(x, n, default):
        return [default] * n if x is None else x

    def t(x, dtype):
        return torch.tensor(x, dtype=dtype, device=device)

    dp = (spec.drop_pair if spec.drop_pair is not None
          else np.zeros((n_s, n_r), dtype=bool))
    return FailArrays(
        crash_s=t(spec.crash_s, _I32),
        crash_r=t(spec.crash_r, _I32),
        byz_send_drop=t(spec.byz_send_drop, torch.bool),
        byz_recv_drop=t(spec.byz_recv_drop, torch.bool),
        byz_ack_advance=t(spec.byz_ack_advance, _I32),
        byz_ack_low=t(spec.byz_ack_low, torch.bool),
        byz_bcast_partial=t(spec.byz_bcast_partial, torch.bool),
        bcast_limit=t(max(spec.bcast_limit, 0), _I32),
        commit_floor=t(spec.m, _I32),
        byz_equiv_send=t(tup(spec.byz_equiv_send, n_s, False), torch.bool),
        byz_hq_advance=t(tup(spec.byz_hq_advance, n_s, 0), _I32),
        byz_ack_stale=t(tup(spec.byz_ack_stale, n_r, False), torch.bool),
        drop_pair=t(np.asarray(dp, dtype=bool).reshape(n_s, n_r),
                    torch.bool),
        stakes_s=t(spec.stakes_s, torch.float32),
        stakes_r=t(spec.stakes_r, torch.float32),
        quack_thresh=t(spec.quack_thresh, torch.float32),
        dup_thresh=t(spec.dup_thresh, torch.float32),
        hq_thresh=t(spec.hq_thresh, torch.float32),
    )


def _protocol_step(spec: SimSpec, fail: FailArrays, sched_w, base, w: int):
    """Per-round transition over ``w`` window columns starting at ``base``.

    ``base`` is a python int (dense: 0) or a () int32 tensor; all
    sequence-number arithmetic is absolute. Returns ``step(state, t)``
    with ``t`` a python int, giving ``(new_state, metrics)`` where
    ``metrics`` is a (6,) int32 device tensor in ``StepMetrics`` order.
    Nothing in a step waits for the device.
    """
    n_s, n_r, m = spec.n_s, spec.n_r, spec.m
    phi = spec.phi
    orig_sender, orig_recv, orig_step = sched_w
    dev = orig_sender.device
    sender_ix = orig_sender.long()
    recv_ix = orig_recv.long()

    stakes_s = fail.stakes_s
    stakes_r = fail.stakes_r
    rs_seq = torch.tensor(spec.rs_seq, dtype=_I32, device=dev)
    rr_seq = torch.tensor(spec.rr_seq, dtype=_I32, device=dev)
    ls, lr = len(spec.rs_seq), len(spec.rr_seq)

    abs_idx = base + torch.arange(w, dtype=_I32, device=dev)
    idx_r = torch.arange(n_r, dtype=_I32, device=dev)
    idx_s = torch.arange(n_s, dtype=_I32, device=dev)
    honest_r = (fail.crash_r < 0) & ~(fail.byz_recv_drop | fail.byz_ack_low
                                      | (fail.byz_ack_advance > 0)
                                      | fail.byz_bcast_partial
                                      | fail.byz_ack_stale)
    honest_s = (fail.crash_s < 0) & ~(fail.byz_send_drop
                                      | fail.byz_equiv_send
                                      | (fail.byz_hq_advance > 0))

    # broadcast reach matrix (n_r, n_r): who hears j's intra-RSM broadcast.
    partial_reach = idx_r[None, :] < fail.bcast_limit
    reach = torch.where(fail.byz_bcast_partial[:, None], partial_reach, True)
    reach = reach & (idx_r[None, :] != idx_r[:, None])
    reach_t = reach.T.to(torch.float32)                      # (i, j)
    reach_count = reach.sum(dim=1).to(_I32)                  # (n_r,)
    # the original sends' fixed (sender, receiver) pairs
    sender_of = orig_sender[None, :] == idx_s[:, None]       # (n_s, W)
    recv_of = orig_recv[None, :] == idx_r[:, None]           # (n_r, W)
    drop_o = fail.drop_pair[sender_ix, recv_ix]              # (W,)

    def step(state: SimState, t: int):
        alive_s = (fail.crash_s < 0) | (t < fail.crash_s)
        alive_r = (fail.crash_r < 0) | (t < fail.crash_r)

        # (1) broadcasts queued last round land now ------------------------
        bcast_sent = state.bcast_q & alive_r[:, None]
        # einsum("jk,ji->ik") over 0/1 operands as an exact f32 product
        recv_from_bcast = (reach_t @ bcast_sent.to(torch.float32)) > 0
        recv_has = state.recv_has | (recv_from_bcast & alive_r[:, None])
        bcast_done = state.bcast_done | bcast_sent

        # (2) retransmission declaration + election (knowledge of t-1) -----
        quacked_msg_prev, lost_prev, qprefix_prev = stake_quorum_bitmap(
            state.known, state.repeat_c, stakes_r, fail.quack_thresh,
            fail.dup_thresh, use_pallas=spec.use_pallas_quack)
        # losses can only be declared for messages whose original dispatch
        # already happened
        declared = lost_prev & state.orig_sent[None, :]
        retry_new = state.retry + declared.to(_I32)
        # Fig. 6: the a-th retransmission of k is sent by the a-th successor
        # of the original sender: sender_new = (orig + #retransmit) mod n_s.
        elected = (rs_seq[((abs_idx[None, :] + retry_new) % ls).long()]
                   == idx_s[:, None])
        resend = (declared & elected & alive_s[:, None]
                  & ~fail.byz_send_drop[:, None])
        # clear complaint trackers where a loss was declared (fresh cycle)
        complaint = state.complaint & ~declared[:, None, :]
        repeat_c = state.repeat_c & ~declared[:, None, :]
        re_target = rr_seq[((orig_recv[None, :] + retry_new) % lr).long()]
        # an equivocating sender's resends are discarded by receivers;
        # a dropped pair kills the copy in the network
        drop_re = torch.gather(fail.drop_pair, 1, re_target.long())
        resend_land = resend & ~fail.byz_equiv_send[:, None] & ~drop_re
        # hit[l, i, k]: sender l's resend of k lands at receiver i
        hit = (resend_land[:, None, :]
               & (re_target[:, None, :] == idx_r[None, :, None]))

        # (3) original sends + landing --------------------------------------
        due = ((orig_step <= t) & (abs_idx < fail.commit_floor)
               & ~state.orig_sent)
        orig_ok = (due & alive_s[sender_ix]
                   & ~fail.byz_send_drop[sender_ix])
        orig_sent = state.orig_sent | due
        orig_land = orig_ok & ~drop_o
        s_orig = orig_land[None, :] & recv_of                  # (n_r, W)
        s_re = hit.any(dim=0)                                  # (n_r, W)
        wire = s_orig | s_re
        land = wire & alive_r[:, None] & ~fail.byz_recv_drop[:, None]
        recv_has = recv_has | land
        bcast_q = land & ~bcast_done
        deliver_now = (recv_has & honest_r[:, None]).any(dim=0)
        deliver_time = torch.where((state.deliver_time < 0) & deliver_now,
                                   t, state.deliver_time)

        # (3b) highest-quacked metadata rides on every landed data message
        # (constant-size piggyback, §4.3); absolute prefix = base + window
        qp_prev = base + qprefix_prev
        e_lk = sender_of & orig_land[None, :]                  # (n_s, W)
        # einsum("lk,ik->li") as an exact f32 product (counts <= W < 2^24)
        sent_orig_to = (e_lk.to(torch.float32)
                        @ s_orig.to(torch.float32).T) > 0     # (n_s, n_r)
        sent_re_to = hit.any(dim=2)                            # (n_s, n_r)
        heard = (sent_orig_to | sent_re_to).T                  # (n_r, n_s)
        # an hq-lying sender inflates its piggybacked prefix per receiver:
        # receiver i hears min(true + adv + i, m)
        hq_lie = fail.byz_hq_advance                           # (n_s,)
        hq_claim = torch.where(
            hq_lie[None, :] > 0,
            (qp_prev[None, :] + hq_lie[None, :] + idx_r[:, None])
            .clamp(max=m),
            qp_prev[None, :])                                  # (n_r, n_s)
        hq_new = torch.where(heard & alive_r[:, None], hq_claim, 0)
        hq_reports = torch.maximum(state.hq_reports, hq_new.to(_I32))

        # (4) acknowledgements ---------------------------------------------
        ack_floor = weighted_quorum_prefix(hq_reports, stakes_s,
                                           fail.hq_thresh)
        ack_floor = torch.maximum(state.ack_floor, ack_floor)
        eff = recv_has | (abs_idx[None, :] < ack_floor[:, None])
        cum, claim, _known_mask = claim_bitmask(eff, phi, base, m)
        miss = missing_below_horizon(eff, phi, base)
        # Byzantine lies --------------------------------------------------
        advance = fail.byz_ack_advance > 0
        cum = torch.where(fail.byz_ack_low, 0, cum)
        cum = torch.where(advance, (cum + fail.byz_ack_advance).clamp(max=m),
                          cum).to(_I32)
        claim = claim & ~fail.byz_ack_low[:, None]
        claim = torch.where(advance[:, None],
                            abs_idx[None, :] < cum[:, None], claim)
        miss = torch.where(fail.byz_ack_low[:, None],
                           abs_idx[None, :] < phi, miss)
        miss = miss & ~advance[:, None]
        # the ack rotation: receiver j acks sender (j + t) mod n_s
        tgt = (idx_r + t) % n_s                                # (n_r,)
        upd = (tgt[None, :] == idx_s[:, None]) & alive_r[None, :]
        # a stale-acking receiver replays its previous ack to this round's
        # target verbatim (applied last, over the other lies)
        stale = fail.byz_ack_stale                             # (n_r,)
        prev_cum = (torch.where(upd, state.last_cum, 0).sum(dim=0)
                    .clamp(min=0).to(_I32))                    # (n_r,)
        prev_miss = (upd[:, :, None] & state.complaint).any(dim=0)
        cum = torch.where(stale, prev_cum, cum)
        claim = torch.where(stale[:, None],
                            abs_idx[None, :] < prev_cum[:, None], claim)
        miss = torch.where(stale[:, None], prev_miss, miss)
        # implicit duplicate-cum complaint: cum unchanged since last ack to
        # the same sender => complain about index cum (if it exists).
        dup_cum = state.last_cum == cum[None, :]               # (n_s, n_r)
        dup_complaint = (dup_cum[:, :, None]
                         & (abs_idx[None, None, :] == cum[None, :, None])
                         & (cum[None, :, None] < m))
        new_complaint = miss[None, :, :] | dup_complaint       # (n_s,n_r,W)
        upd3 = upd[:, :, None]
        known = state.known | (upd3 & claim[None, :, :])
        repeat_c = torch.where(upd3, repeat_c | (complaint & new_complaint),
                               repeat_c)
        complaint = torch.where(upd3, new_complaint, complaint)
        last_cum = torch.where(upd, cum[None, :], state.last_cum)

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

        qp = base + qprefix
        min_qp = torch.where(honest_s, qp, _BIG).min()
        metrics = torch.stack([
            orig_ok.sum() + resend.sum(),
            (bcast_sent.sum(dim=1) * reach_count).sum(),
            resend.sum(),
            alive_r.sum(),
            (deliver_time >= 0).sum() + state.retired_delivered,
            min_qp,
        ]).to(_I32)
        return new_state, metrics

    return step


def _init_state(spec: SimSpec, w: int, device) -> SimState:
    n_s, n_r = spec.n_s, spec.n_r
    shapes = _window_shapes(n_s, n_r, w)
    window = {
        name: torch.full(shapes[name], fill, device=device,
                         dtype=(torch.bool if isinstance(fill, bool)
                                else _I32))
        for name, fill in _WINDOW_FILLS.items()}
    return SimState(
        **window,
        last_cum=torch.full((n_s, n_r), -1, dtype=_I32, device=device),
        hq_reports=torch.zeros((n_r, n_s), dtype=_I32, device=device),
        ack_floor=torch.zeros((n_r,), dtype=_I32, device=device),
        base=torch.zeros((), dtype=_I32, device=device),
        retired_delivered=torch.zeros((), dtype=_I32, device=device),
    )


def _sched_arrays(spec: SimSpec, device):
    def t(x):
        return torch.tensor(x, dtype=_I32, device=device)

    return t(spec.orig_sender), t(spec.orig_recv), t(spec.orig_step)


# ------------------------------------------------------------------ runs
def _run_dense(spec: SimSpec, device) -> Tuple[SimState, torch.Tensor]:
    """Dense full-stream run: window = [0, M), no rotation.

    Returns the final state and the (steps, 6) int32 metrics, both on
    ``device``; the loop never waits for the device.
    """
    fail = _fail_arrays(spec, device)
    step = _protocol_step(spec, fail, _sched_arrays(spec, device), 0, spec.m)
    state = _init_state(spec, spec.m, device)
    per_round: List[torch.Tensor] = []
    for t in range(spec.steps):
        state, ms = step(state, t)
        per_round.append(ms)
    if per_round:
        metrics = torch.stack(per_round)
    else:
        metrics = torch.zeros((0, len(StepMetrics._fields)), dtype=_I32,
                              device=device)
    return state, metrics


def _to_host(tensors: List[torch.Tensor]) -> List[np.ndarray]:
    """Bring int32/bool device tensors to numpy in ONE device->host copy
    (flattened into one int32 buffer and split back, dtypes kept)."""
    flat = torch.cat([t.reshape(-1).to(_I32) for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        n = t.numel()
        a = flat[at:at + n].reshape(tuple(t.shape))
        out.append(a.astype(bool) if t.dtype == torch.bool else a)
        at += n
    return out


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


def run_simulation(spec: SimSpec, device=None) -> SimResult:
    """Run one spec on ``device`` (default: CUDA; raises if it is absent).

    Only the dense engine exists so far: a spec with ``window_slots > 0``
    or ``collect_metrics`` raises ``NotImplementedError``.
    """
    if spec.window_slots:
        raise NotImplementedError(_WINDOWED_TODO)
    if spec.collect_metrics:
        raise NotImplementedError(_METRICS_TODO)
    dev = _resolve_device(device)
    final, metrics = _run_dense(spec, dev)
    quack_time, deliver_time, retry, recv_has, ms = _to_host(
        [final.quack_time, final.deliver_time, final.retry, final.recv_has,
         metrics])
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
