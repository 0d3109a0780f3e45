"""The three C3B protocols of §6: PICSOU, ATA, OST.

Each protocol exposes
  * ``loads(...)``  — the per-message resource profile for the analytic
    capacity model (``network.py``), and
  * ``simulate(...)`` — the step simulator run (PICSOU only; ATA and OST
    have closed-form message counts and no ack machinery).

Copies of a message m sent across RSMs (Figure 2):
  ATA    : n_s * n_r   (every replica to every replica; no acks; robust)
  OST    : 1           (single pair; NOT a C3B — delivery not guaranteed)
  PICSOU : 1 + resends (QUACK-driven; the theoretical minimum, robust)
plus intra-RSM: PICSOU broadcasts each message once inside the receiver
RSM (n_r - 1 copies); ATA needs no intra-RSM broadcast.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from .network import NodeLoad, Resources, throughput_from_loads
from .simulator import (SimResult, SimSpec, build_spec, run_simulation,
                        run_simulation_batch)
from .types import (COUNTER_BYTES, MAC_BYTES, SEQNO_BYTES, FailureScenario,
                    NetworkModel, RSMConfig, SimConfig)

__all__ = ["picsou_loads", "ata_loads", "ost_loads", "analytic_throughput",
           "staked_picsou_throughput", "C3BRun", "run_picsou",
           "run_picsou_batch"]


def _ack_bytes(cfg: RSMConfig, backlog: int = 0) -> float:
    """Cumulative counter + quack counter + phi entries (+ MAC if BFT)."""
    b = 2 * COUNTER_BYTES + SEQNO_BYTES * backlog
    if cfg.r > 0:
        b += MAC_BYTES
    return float(b)


def picsou_loads(ns: int, nr: int, net: NetworkModel,
                 sender_cfg: RSMConfig, recv_cfg: RSMConfig,
                 resend_factor: float = 0.0,
                 window: int = 8) -> Resources:
    """PICSOU per-delivered-message loads (§4.1 failure-free + resends).

    resend_factor: expected extra cross copies per message (0 when
    failure-free; ~failure fraction otherwise — each resend re-crosses and
    re-broadcasts).
    """
    s = net.msg_bytes
    a = _ack_bytes(recv_cfg)
    rf = 1.0 + resend_factor
    sender = NodeLoad(
        egress_bytes=rf * s / ns,          # originates 1/ns of the stream
        ingress_bytes=a,                   # one ack per round, piggybacked
        msg_ops=rf * 1.0 / ns + 1.0 / ns,  # send + ack processing share
        cross_egress_bytes=rf * s / ns,
    )
    receiver = NodeLoad(
        # direct share + intra-broadcast ingress of everyone else's shares
        ingress_bytes=rf * s / nr + s * (nr - 1) / nr,
        # re-broadcast of its direct share to nr-1 peers + ack egress
        egress_bytes=rf * s * (nr - 1) / nr + a,
        msg_ops=rf * 1.0 / nr + 1.0 + 1.0 / nr,  # recv + bcast handling
        cross_egress_bytes=a,
    )
    return Resources(
        loads={"sender": sender, "receiver": receiver},
        cross_pair_bytes=rf * s / (ns * nr),   # rotation spreads over pairs
        pairs_used=nr,
        inflight_sources=ns,
        window=window,
    )


def ata_loads(ns: int, nr: int, net: NetworkModel,
              sender_cfg: RSMConfig, recv_cfg: RSMConfig,
              window: int = 8) -> Resources:
    """All-to-all: every replica sends every message to every peer."""
    s = net.msg_bytes
    sender = NodeLoad(
        egress_bytes=s * nr,               # each sender sends nr copies
        msg_ops=float(nr),
        cross_egress_bytes=s * nr,
    )
    receiver = NodeLoad(
        ingress_bytes=s * ns,              # each receiver ingests ns copies
        msg_ops=float(ns),
    )
    return Resources(
        loads={"sender": sender, "receiver": receiver},
        cross_pair_bytes=s,                # every pair carries every message
        pairs_used=nr,
        inflight_sources=ns,
        window=window,
    )


def ost_loads(ns: int, nr: int, net: NetworkModel,
              sender_cfg: RSMConfig, recv_cfg: RSMConfig,
              window: int = 8) -> Resources:
    """One-shot upper bound: single sender-receiver pair per message."""
    s = net.msg_bytes
    sender = NodeLoad(egress_bytes=s / ns, msg_ops=1.0 / ns,
                      cross_egress_bytes=s / ns)
    receiver = NodeLoad(ingress_bytes=s / nr, msg_ops=1.0 / nr)
    return Resources(
        loads={"sender": sender, "receiver": receiver},
        cross_pair_bytes=s / (ns * nr),
        pairs_used=1,                      # unique pairs, no fan-out
        inflight_sources=ns,
        window=window,
    )


_LOADS = {"picsou": picsou_loads, "ata": ata_loads, "ost": ost_loads}


def analytic_throughput(protocol: str, sender_cfg: RSMConfig,
                        recv_cfg: RSMConfig, net: NetworkModel,
                        resend_factor: float = 0.0,
                        window: int = 8) -> Dict[str, float]:
    kw = dict(window=window)
    if protocol == "picsou":
        kw["resend_factor"] = resend_factor
    res = _LOADS[protocol](sender_cfg.n, recv_cfg.n, net,
                           sender_cfg, recv_cfg, **kw)
    return throughput_from_loads(res, net)


def staked_picsou_throughput(stakes, nic_Bps,
                             net: NetworkModel) -> Dict[str, float]:
    """Stake-aware PICSOU capacity (§6.3 scenarios).

    DSS apportions send/receive work proportional to stake, so replica i
    carries share_i = stake_i / total of the per-message load on both the
    send and the receive/broadcast side; the system rate is bound by the
    most-loaded replica relative to its own NIC:

      sender bound_i   = NIC_i / (share_i * s * n)        (its sends)
      receiver bound_i = NIC_i / (share_i * s * (n - 1))  (its broadcasts)
    """
    stakes = np.asarray(stakes, dtype=np.float64)
    nic = np.broadcast_to(np.asarray(nic_Bps, dtype=np.float64),
                          stakes.shape)
    share = stakes / stakes.sum()
    n = len(stakes)
    s = net.msg_bytes
    send_bound = nic / np.maximum(share * s * n, 1e-12)
    recv_bound = nic / np.maximum(share * s * max(n - 1, 1), 1e-12)
    tput = float(min(send_bound.min(), recv_bound.min()))
    # also bounded by the balanced-case receiver ingress NIC/s
    tput = min(tput, float(nic.min()) / s * n / max(n - 1, 1))
    return {"throughput_msgs_per_s": tput,
            "binding_replica": int(np.argmin(np.minimum(send_bound,
                                                        recv_bound)))}


@dataclasses.dataclass
class C3BRun:
    """A PICSOU simulator run + derived protocol-level statistics."""

    result: SimResult
    spec: SimSpec

    @property
    def cross_copies_per_msg(self) -> float:
        return self.result.total_cross_msgs() / self.spec.m

    @property
    def intra_copies_per_msg(self) -> float:
        return self.result.total_intra_msgs() / self.spec.m

    @property
    def resends_per_msg(self) -> float:
        return self.result.total_resends() / self.spec.m

    @property
    def all_quacked(self) -> bool:
        return self.result.completion_step() >= 0

    @property
    def all_delivered(self) -> bool:
        return self.result.delivery_step() >= 0

    def quack_throughput_per_step(self) -> float:
        """Unique QUACKs per round at a correct replica (§6 definition)."""
        done = self.result.completion_step()
        if done < 0:
            return 0.0
        return self.spec.m / max(done, 1)


def run_picsou(sender_cfg: RSMConfig, recv_cfg: RSMConfig,
               sim: SimConfig = SimConfig(),
               failures: FailureScenario = FailureScenario.none(),
               device=None) -> C3BRun:
    """Plan and run one PICSOU link on ``device`` (default: CUDA)."""
    spec = build_spec(sender_cfg, recv_cfg, sim, failures)
    return C3BRun(result=run_simulation(spec, device=device), spec=spec)


def run_picsou_batch(sender_cfg: RSMConfig, recv_cfg: RSMConfig,
                     sim: SimConfig, scenarios: Sequence[FailureScenario],
                     device=None) -> List[C3BRun]:
    """Run a failure-scenario sweep of one link as the lanes of one run
    (``run_simulation_batch``) on ``device`` (default: CUDA).

    All scenarios share the schedules and thresholds of (sender_cfg,
    recv_cfg, sim); each lane is bit-identical to its own ``run_picsou``.
    """
    specs = [build_spec(sender_cfg, recv_cfg, sim, f) for f in scenarios]
    return [C3BRun(result=r, spec=s) for s, r in
            zip(specs, run_simulation_batch(specs, device=device))]
