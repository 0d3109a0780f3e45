"""QUACK-tracked cross-pod checkpoint replication + straggler mitigation.

Host-side control plane (pure Python — this is coordination, not compute)
implementing the paper's machinery on checkpoint shards flowing between
pods over DCN:

* each pod is an RSM of hosts: a shard is *durable* once hosts totalling
  ``u+1`` stake at the peer pod acknowledge it (weighted QUACK, §5.1) —
  only then may the sender GC its staging copy (§4.3);
* duplicate acks (a host re-acking its highest contiguous shard) signal a
  lost shard; the retransmitter is elected with zero coordination:
  ``(origin + retries) mod n_hosts`` (§4.2);
* send quotas are apportioned with Hamilton's method over measured host
  throughput ("stake"), re-planned every quantum — slow hosts get
  proportionally fewer shards (straggler mitigation, §5.2 DSS);
* the GC-stall defence: when a sender sees duplicate acks below its GC
  frontier it republishes its highest-quacked shard id; after ``r+1``
  such attestations receivers advance their ack floor (§4.3).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set

import numpy as np

from ..core.scheduler import hamilton_apportion

__all__ = ["ShardState", "ReplicationLedger"]


@dataclasses.dataclass
class ShardState:
    shard_id: int
    origin_host: int
    acked_by: Set[int] = dataclasses.field(default_factory=set)
    retries: int = 0
    durable: bool = False
    gc_done: bool = False


class ReplicationLedger:
    """Tracks replication of checkpoint shards from one pod to another."""

    def __init__(self, n_hosts: int, u: int, r: int,
                 stakes: Optional[np.ndarray] = None):
        self.n = n_hosts
        self.u = u
        self.r = r
        self.stakes = (np.ones(n_hosts) if stakes is None
                       else np.asarray(stakes, dtype=np.float64))
        self.shards: Dict[int, ShardState] = {}
        self.last_ack: Dict[int, int] = {}      # host -> cum ack value
        self.dup_counts: Dict[int, Set[int]] = {}  # shard -> dup hosts
        self.hq_attestations: Dict[int, Set[int]] = {}
        self.ack_floor = 0

    # -- send planning ----------------------------------------------------
    def plan_sends(self, shard_ids: List[int],
                   host_throughput: Optional[np.ndarray] = None
                   ) -> Dict[int, int]:
        """Apportion shards across sender hosts by throughput stakes."""
        tp = (self.stakes if host_throughput is None
              else np.asarray(host_throughput, dtype=np.float64))
        counts = hamilton_apportion(tp, len(shard_ids))
        plan: Dict[int, int] = {}
        host_iter: List[int] = []
        for h, c in enumerate(counts):
            host_iter.extend([h] * int(c))
        for sid, host in zip(shard_ids, host_iter):
            plan[sid] = host
            self.shards[sid] = ShardState(shard_id=sid, origin_host=host)
        return plan

    # -- ack path ----------------------------------------------------------
    def record_ack(self, host: int, cum_shard: int) -> None:
        """Host acks contiguous receipt of shards [0, cum_shard]."""
        prev = self.last_ack.get(host, -1)
        if cum_shard == prev:
            missing = cum_shard + 1
            self.dup_counts.setdefault(missing, set()).add(host)
        self.last_ack[host] = max(prev, cum_shard)
        for sid, st in self.shards.items():
            if sid <= cum_shard and not st.durable:
                st.acked_by.add(host)
                stake = sum(self.stakes[h] for h in st.acked_by)
                if stake >= self.u + 1:
                    st.durable = True
                    st.gc_done = True          # §4.3: quacked => collectable

    # -- failure path --------------------------------------------------------
    def lost_shards(self) -> List[int]:
        """Shards with >= r+1 (stake) duplicate complaints, not durable."""
        out = []
        thresh = max(self.r + 1, 1)
        for sid, hosts in self.dup_counts.items():
            st = self.shards.get(sid)
            if st is None or st.durable:
                continue
            if sum(self.stakes[h] for h in hosts) >= thresh:
                out.append(sid)
        return sorted(out)

    def elect_retransmitter(self, shard_id: int) -> int:
        """§4.2: (origin + #retries) mod n — no coordination messages."""
        st = self.shards[shard_id]
        st.retries += 1
        self.dup_counts.pop(shard_id, None)
        return (st.origin_host + st.retries) % self.n

    # -- GC-stall defence -------------------------------------------------
    def highest_quacked(self) -> int:
        hq = -1
        for sid in sorted(self.shards):
            if self.shards[sid].durable:
                hq = sid
            else:
                break
        return hq

    def record_hq_attestation(self, sender_host: int, hq: int) -> int:
        """Receiver side: after r+1 attestations of hq >= k, the floor
        advances past the hole (§4.3 strategy 1)."""
        self.hq_attestations.setdefault(hq, set()).add(sender_host)
        thresh = max(self.r + 1, 1)
        for k in sorted(self.hq_attestations, reverse=True):
            hosts = set()
            for kk, hh in self.hq_attestations.items():
                if kk >= k:
                    hosts |= hh
            if sum(self.stakes[h] for h in hosts) >= thresh:
                self.ack_floor = max(self.ack_floor, k + 1)
                break
        return self.ack_floor

    # -- invariants -----------------------------------------------------------
    def all_durable(self) -> bool:
        return all(s.durable for s in self.shards.values())

    def summary(self) -> Dict[str, float]:
        n = len(self.shards) or 1
        return {
            "shards": len(self.shards),
            "durable": sum(s.durable for s in self.shards.values()),
            "retries": sum(s.retries for s in self.shards.values()),
            "durable_frac": sum(s.durable for s in self.shards.values()) / n,
        }
