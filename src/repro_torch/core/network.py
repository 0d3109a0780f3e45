"""Analytic network capacity model for C3B protocol throughput (§6 setup).

The paper measures C3B throughput (completed C3B invocations/sec) on GCP
c2-standard-8 VMs; we model each node as a full-duplex NIC plus a
per-message CPU budget, and cross-RSM pairs as independently capped links
(the geo experiments cap each pairwise connection at 135 Mbit/s).

Throughput of a protocol = min over binding resources of
``capacity / per-message-load``:

  * per-node NIC egress / ingress bytes per delivered message,
  * per-node message-operation count (serialization/syscall CPU),
  * per-pair cross-RSM link bytes,
  * in-flight window / RTT (geo),

Each protocol contributes its own per-message load profile
(see ``protocols.py``). The model is calibrated once (R_MSG_OPS, window)
and validated against the paper's reported ratios in
``benchmarks/fig8_scalability.py`` — agreement is within ~2x everywhere
and the scaling *trends* (ratio grows with n; geo >> LAN; large messages >
small) match exactly; deviations are tabulated in EXPERIMENTS.md.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

from .types import NetworkModel

__all__ = ["NodeLoad", "Resources", "throughput_from_loads", "R_MSG_OPS"]

# Per-node message-operation rate (ops/sec): calibrated so that the LAN
# small-message ratios land in the paper's observed range (§6.1).
R_MSG_OPS = 20_000.0


@dataclasses.dataclass(frozen=True)
class NodeLoad:
    """Per-delivered-message load of one node class."""

    egress_bytes: float = 0.0      # bytes sent per delivered message
    ingress_bytes: float = 0.0     # bytes received per delivered message
    msg_ops: float = 0.0           # message operations per delivered message
    cross_egress_bytes: float = 0.0  # subset of egress crossing RSM boundary


@dataclasses.dataclass(frozen=True)
class Resources:
    """System-level constraints for one protocol run."""

    loads: Dict[str, NodeLoad]      # node-class -> per-message load
    cross_pair_bytes: float = 0.0   # bytes per message on the busiest pair
    pairs_used: int = 1
    inflight_sources: int = 1       # nodes that can have a window in flight
    window: int = 8                 # outstanding messages per source


def throughput_from_loads(res: Resources, net: NetworkModel,
                          msg_ops_rate: float = R_MSG_OPS) -> Dict[str, float]:
    """Messages/sec = min over binding constraints; returns all terms."""
    terms: Dict[str, float] = {}
    for name, load in res.loads.items():
        if load.egress_bytes > 0:
            terms[f"{name}.egress"] = net.nic_Bps / load.egress_bytes
        if load.ingress_bytes > 0:
            terms[f"{name}.ingress"] = net.nic_Bps / load.ingress_bytes
        if load.msg_ops > 0:
            terms[f"{name}.cpu"] = msg_ops_rate / load.msg_ops
        if load.cross_egress_bytes > 0:
            # a node's cross-RSM egress cannot exceed the sum of its pair caps
            per_node_cross = min(net.nic_Bps, res.pairs_used * net.cross_Bps)
            terms[f"{name}.cross"] = per_node_cross / load.cross_egress_bytes
    if res.cross_pair_bytes > 0:
        terms["pair"] = net.cross_Bps / res.cross_pair_bytes
    if net.rtt_s > 0:
        terms["window"] = res.inflight_sources * res.window / net.rtt_s
    tput = min(terms.values()) if terms else math.inf
    out = dict(terms)
    out["throughput_msgs_per_s"] = tput
    out["throughput_MBps"] = tput * net.msg_bytes / 1e6
    out["bottleneck"] = min(terms, key=terms.get)  # type: ignore[assignment]
    return out
