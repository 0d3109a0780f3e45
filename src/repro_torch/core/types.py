"""Core configuration types for the PICSOU / C3B protocol implementation.

The paper's system model (§2.1) is the UpRight failure model: each RSM has
``n`` replicas, is *live* despite up to ``u`` failures of any kind and *safe*
despite up to ``r`` commission (Byzantine) failures, with ``n = 2u + r + 1``.
``u = r = f`` gives the classic 3f+1 BFT setting; ``r = 0`` gives 2f+1 CFT.

Stake-based RSMs (§5) generalize this: each replica ``j`` holds stake
``delta_j``; thresholds ``u`` / ``r`` are stake amounts instead of counts.
Traditional RSMs set every stake to 1.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "RSMConfig",
    "NetworkModel",
    "FailureScenario",
    "SimConfig",
    "COUNTER_BYTES",
    "SEQNO_BYTES",
    "MAC_BYTES",
]

# Wire-format constants (metadata accounting, §3 P1: constant-size metadata).
COUNTER_BYTES = 8   # one cumulative-ack counter
SEQNO_BYTES = 8     # one sequence number (phi-list entry / piggybacked hq)
MAC_BYTES = 32      # per-message MAC when r > 0 (BFT configurations)


@dataclasses.dataclass(frozen=True)
class RSMConfig:
    """One replicated state machine, in the UpRight model.

    n:      replica count.
    u:      liveness threshold (stake units; replica count when unit stakes).
    r:      safety/commission threshold (stake units). r == 0 => CFT.
    stakes: per-replica stake (defaults to all-ones). Total stake is the
            paper's ``n_i`` in the weighted setting (§5).
    """

    n: int
    u: int
    r: int
    stakes: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        if self.stakes is None:
            object.__setattr__(self, "stakes", tuple([1.0] * self.n))
        if len(self.stakes) != self.n:
            raise ValueError(f"stakes len {len(self.stakes)} != n {self.n}")
        if self.n <= 0:
            raise ValueError("n must be positive")
        if self.u < 0 or self.r < 0:
            raise ValueError("u, r must be non-negative")

    @classmethod
    def bft(cls, f: int,
            stakes: Optional[Sequence[float]] = None) -> "RSMConfig":
        """3f+1 BFT RSM (u = r = f)."""
        return cls(n=3 * f + 1, u=f, r=f,
                   stakes=tuple(stakes) if stakes is not None else None)

    @classmethod
    def cft(cls, f: int,
            stakes: Optional[Sequence[float]] = None) -> "RSMConfig":
        """2f+1 CFT RSM (u = f, r = 0)."""
        return cls(n=2 * f + 1, u=f, r=0,
                   stakes=tuple(stakes) if stakes is not None else None)

    @property
    def total_stake(self) -> float:
        return float(sum(self.stakes))

    @property
    def quack_threshold(self) -> float:
        """Stake that must acknowledge before a QUACK forms: u + 1 (§4.1)."""
        return self.u + 1

    @property
    def dup_threshold(self) -> float:
        """Duplicate-QUACK size proving loss: r + 1, or 1 for CFT (§4.2)."""
        return max(self.r + 1, 1)

    def stake_array(self) -> np.ndarray:
        return np.asarray(self.stakes, dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class NetworkModel:
    """Analytic link model used by the simulator and the capacity analysis.

    The paper's testbed (§6): c2-standard-8 VMs; geo experiments cap each
    *pairwise cross-RSM connection* at 135 Mbit/s with 163 ms ping. We model:

    msg_bytes:       application message size (paper sweeps 0.1 kB .. 1 MB).
    nic_gbps:        per-node NIC bandwidth (full duplex), Gbit/s.
    intra_gbps:      per-pair intra-RSM bandwidth, Gbit/s.
    cross_gbps:      per-pair cross-RSM bandwidth, Gbit/s (135 Mb/s geo).
    rtt_s:           cross-RSM round-trip, seconds (one simulator step).
    phi:             phi-list bound (§4.2 parallel cumulative acks).
    """

    msg_bytes: float = 1e6
    nic_gbps: float = 10.0
    intra_gbps: float = 10.0
    cross_gbps: float = 10.0
    rtt_s: float = 0.001
    phi: int = 1000

    @property
    def nic_Bps(self) -> float:
        return self.nic_gbps * 1e9 / 8.0

    @property
    def intra_Bps(self) -> float:
        return self.intra_gbps * 1e9 / 8.0

    @property
    def cross_Bps(self) -> float:
        return self.cross_gbps * 1e9 / 8.0

    def ack_meta_bytes(self, n_missing: int = 0, bft: bool = True) -> float:
        """Ack = 1 cumulative counter + phi-list entries (+ MAC when BFT)."""
        b = COUNTER_BYTES + SEQNO_BYTES * min(n_missing, self.phi)
        return b + (MAC_BYTES if bft else 0)

    @classmethod
    def geo(cls, msg_bytes: float = 1e6) -> "NetworkModel":
        """Paper's Iowa <-> Hong Kong setup (§6.1 geo-replication)."""
        return cls(msg_bytes=msg_bytes, nic_gbps=10.0, intra_gbps=10.0,
                   cross_gbps=0.135, rtt_s=0.163)

    @classmethod
    def lan(cls, msg_bytes: float = 1e6) -> "NetworkModel":
        return cls(msg_bytes=msg_bytes)


@dataclasses.dataclass(frozen=True)
class FailureScenario:
    """Which replicas misbehave and how.

    crash_s / crash_r:        step at which each sender/receiver replica
                              crashes (never sends/acks/broadcasts after);
                              -1 => never. Shape (n_s,) / (n_r,).
    byz_send_drop:            sender silently never originates its messages
                              (commission failure; still acks on the mirror
                              direction).  Shape (n_s,) bool.
    byz_recv_drop:            receiver drops direct cross-RSM messages (does
                              not store/bcast/ack them). Shape (n_r,) bool.
    byz_ack_advance:          receiver lies: acks +adv beyond truth.
                              Shape (n_r,) int.
    byz_ack_low:              receiver lies: always acks 0. (n_r,) bool.
    byz_bcast_partial:        receiver broadcasts only to the first
                              ``bcast_limit`` replicas (the §4.3 GC-stall
                              attack). (n_r,) bool.
    bcast_limit:              number of replicas a partial broadcaster reaches.
    byz_equiv_send:           equivocating sender: its *retransmissions*
                              carry payloads conflicting with the original,
                              so receivers detect the mismatch and discard
                              them (the message neither lands nor counts as
                              heard). Originals are honest. (n_s,) bool.
    byz_hq_advance:           sender lies in its §4.3 highest-quacked
                              piggyback: receiver ``i`` hears
                              ``min(true_prefix + adv + i, M)`` — a
                              *per-receiver-conflicting* inflated claim
                              (the equivocation form of the GC-stall
                              attack, defended by the r_s+1 attestation
                              quorum). 0 => honest. (n_s,) int.
    byz_ack_stale:            receiver replays its previous QUACK ack to
                              each sender verbatim (stale cum counter,
                              stale claims, stale complaint list) instead
                              of reporting fresh state. (n_r,) bool.
    drop_pair:                selective network fault: messages (originals
                              and retransmissions alike) from sender ``l``
                              to receiver ``j`` are silently dropped when
                              ``drop_pair[l][j]``; acks still flow.
                              Shape (n_s, n_r) bool (tuple of tuples).
    """

    crash_s: Optional[Tuple[int, ...]] = None
    crash_r: Optional[Tuple[int, ...]] = None
    byz_send_drop: Optional[Tuple[bool, ...]] = None
    byz_recv_drop: Optional[Tuple[bool, ...]] = None
    byz_ack_advance: Optional[Tuple[int, ...]] = None
    byz_ack_low: Optional[Tuple[bool, ...]] = None
    byz_bcast_partial: Optional[Tuple[bool, ...]] = None
    bcast_limit: int = 0
    byz_equiv_send: Optional[Tuple[bool, ...]] = None
    byz_hq_advance: Optional[Tuple[int, ...]] = None
    byz_ack_stale: Optional[Tuple[bool, ...]] = None
    drop_pair: Optional[Tuple[Tuple[bool, ...], ...]] = None

    @classmethod
    def none(cls) -> "FailureScenario":
        return cls()

    def validate(self, n_s: int, n_r: int,
                 steps: Optional[int] = None) -> "FailureScenario":
        """Shape/range-check the masks against an RSM pair (and horizon).

        Raises ``ValueError`` naming the offending field instead of
        letting a wrong-length mask fail deep inside tracing (or a
        beyond-horizon crash step silently no-op). Returns ``self`` so
        call sites can validate inline.
        """
        def _len(name, val, n):
            if val is not None and len(val) != n:
                raise ValueError(
                    f"FailureScenario.{name} has {len(val)} entries, "
                    f"RSM has {n} replicas (one entry per replica)")

        for name, n in (("crash_s", n_s), ("byz_send_drop", n_s),
                        ("byz_equiv_send", n_s), ("byz_hq_advance", n_s)):
            _len(name, getattr(self, name), n)
        for name in ("crash_r", "byz_recv_drop", "byz_ack_advance",
                     "byz_ack_low", "byz_bcast_partial", "byz_ack_stale"):
            _len(name, getattr(self, name), n_r)
        if self.drop_pair is not None:
            if len(self.drop_pair) != n_s or any(
                    len(row) != n_r for row in self.drop_pair):
                raise ValueError(
                    f"FailureScenario.drop_pair must be (n_s={n_s}, "
                    f"n_r={n_r}); got "
                    f"{(len(self.drop_pair),) + tuple(set(len(r) for r in self.drop_pair))}")
        for name in ("crash_s", "crash_r"):
            val = getattr(self, name)
            if val is None:
                continue
            for j, step in enumerate(val):
                if step < -1:
                    raise ValueError(
                        f"FailureScenario.{name}[{j}] = {step}: crash "
                        f"steps must be >= 0 (-1 = never crashes)")
                if steps is not None and step >= steps:
                    raise ValueError(
                        f"FailureScenario.{name}[{j}] = {step} is beyond "
                        f"the run horizon (steps = {steps}); the crash "
                        f"would silently never happen — use -1 for "
                        f"'never' or lower the crash step")
        if self.byz_hq_advance is not None and any(
                a < 0 for a in self.byz_hq_advance):
            raise ValueError("FailureScenario.byz_hq_advance entries must "
                             "be >= 0 (0 = honest)")
        if self.byz_ack_advance is not None and any(
                a < 0 for a in self.byz_ack_advance):
            raise ValueError("FailureScenario.byz_ack_advance entries "
                             "must be >= 0 (0 = honest)")
        if self.bcast_limit < 0:
            raise ValueError("FailureScenario.bcast_limit must be >= 0")
        return self

    @classmethod
    def crash_fraction(cls, n_s: int, n_r: int, frac: float,
                       seed: int = 0, at_step: int = 0) -> "FailureScenario":
        """Paper §6.2: randomly fail ``frac`` of replicas (send nothing)."""
        if not 0.0 <= frac <= 1.0:
            raise ValueError(f"crash_fraction frac must be in [0, 1], "
                             f"got {frac}")
        if at_step < 0:
            raise ValueError(f"crash_fraction at_step must be >= 0, "
                             f"got {at_step}")
        if n_s <= 0 or n_r <= 0:
            raise ValueError(f"crash_fraction needs positive replica "
                             f"counts, got n_s={n_s}, n_r={n_r}")
        rng = np.random.RandomState(seed)
        ks = max(0, min(int(round(frac * n_s)), n_s - 1))
        kr = max(0, min(int(round(frac * n_r)), n_r - 1))
        cs = np.full(n_s, -1, dtype=np.int64)
        cr = np.full(n_r, -1, dtype=np.int64)
        cs[rng.choice(n_s, size=ks, replace=False)] = at_step
        cr[rng.choice(n_r, size=kr, replace=False)] = at_step
        return cls(crash_s=tuple(int(x) for x in cs),
                   crash_r=tuple(int(x) for x in cr))


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static shape / schedule parameters for one simulation run.

    n_msgs:          number of messages M transmitted by the sender RSM.
    steps:           number of synchronous rounds T to simulate.
    window:          max new originations per sender per step (TCP window).
    scheduler:       'round_robin' | 'dss' | 'skewed_rr' | 'lottery' (§5.2).
    quantum:         DSS message quantum q (messages per scheduling quantum).
    phi:             phi-list bound (selective-repeat width, §4.2).
    seed:            PRNG seed (lottery scheduler only).
    window_slots:    sliding-window width W for the GC-driven windowed
                     simulator core: scan state covers only the W in-flight
                     sequence numbers above the GC frontier (§4.3) instead
                     of all M. None => dense (full-M) state; "auto" =>
                     sized from n, window, phi and chunk_steps
                     (``gc.default_window_slots``), falling back to the
                     dense path when the computed W would not be smaller
                     than M (windowing would buy nothing); an int fixes W.
    chunk_steps:     rounds per chunk in windowed mode: the GC frontier
                     advances and the host drains once per chunk (also
                     sizes the "auto" window).
    adaptive_window: overflow semantics of the windowed engine: grow W 2x,
                     or migrate to the dense layout once W would reach M
                     (True); raise ``ValueError`` (False).
    superchunk:      fusion depth K of the windowed engine: up to K
                     chunks run as one dispatch (one CUDA-graph replay on
                     a card), drained while the next one computes; the
                     outputs are the same for every K.
    debug_checks:    per-drain invariant checks of the windowed engine
                     (base mirror, GC safety).
    use_pallas_quack: kept only so that configs carry across from the
                     JAX package, where it selects the Pallas quorum
                     kernel. Here the quorum always goes through
                     ``kernels.ops.quack_scan``: the hand-written CUDA
                     kernel for CUDA tensors, its plain torch version for
                     CPU tensors, whatever this flag says.
    collect_metrics: thread the observability fabric
                     (``repro_torch.obs.metrics.MetricsCarry``) through
                     every dense block, chunk and superchunk: each result
                     carries its lane's ``ObsMetrics`` (latency
                     histogram, high-water marks, event counts) in
                     ``obs``. The accumulators ride the drains and the
                     final copy the run makes anyway, and the outputs are
                     the same with it on or off.
    """

    n_msgs: int = 256
    steps: int = 200
    window: int = 4
    scheduler: str = "round_robin"
    quantum: int = 64
    phi: int = 32
    seed: int = 0
    window_slots: Optional[object] = None     # None | "auto" | int
    chunk_steps: int = 32
    adaptive_window: bool = True
    superchunk: int = 8
    debug_checks: bool = False
    use_pallas_quack: bool = False
    collect_metrics: bool = False

    def __post_init__(self):
        ws = self.window_slots
        if ws is not None and ws != "auto" and (not isinstance(ws, int)
                                                or ws <= 0):
            raise ValueError(f"window_slots must be None, 'auto' or a "
                             f"positive int, got {ws!r}")
        if self.chunk_steps <= 0:
            raise ValueError("chunk_steps must be positive")
        if self.superchunk <= 0:
            raise ValueError("superchunk must be positive")


def lcm_scale_factors(total_s: float, total_r: float) -> Tuple[float, float]:
    """§5.3 LCM stake rescaling: psi_s = LCM/delta_s, psi_r = LCM/delta_r.

    Stakes may be non-integer; we rescale via the LCM of the integerized
    totals (the paper assumes integral stake).
    """
    ts, tr = int(round(total_s)), int(round(total_r))
    if ts <= 0 or tr <= 0:
        raise ValueError("total stakes must be positive")
    l = math.lcm(ts, tr)
    return l / ts, l / tr
