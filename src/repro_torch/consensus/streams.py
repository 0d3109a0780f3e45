"""Consensus commit-stream models.

Baselines measured in the paper (§6.4, n = 4 replicas each):
  * ResilientDB (PBFT)  : 39,000 tx/s
  * Raft (etcd v3.0)    : 39,000 tx/s
  * Algorand (PoS)      :    130 tx/s
  * File                : infinite (in-memory proposal generator, §6.1)

A ``ConsensusModel`` produces a committed-request rate and the
quorum-certificate size attached to each transmitted message
(⟨m, k⟩_{Q_s} in §3); the C3B layer's throughput couples with it by
min(): the RSM cannot respond to clients faster than QUACKs arrive
(the implementation waits for the QUACK before replying, §6).
"""

from __future__ import annotations

import dataclasses

from ..core.types import MAC_BYTES, RSMConfig

__all__ = ["ConsensusModel", "FileModel", "PBFTModel", "RaftModel",
           "AlgorandModel", "coupled_throughput"]


@dataclasses.dataclass(frozen=True)
class ConsensusModel:
    name: str
    commit_rate: float               # committed requests / sec (n=4 baseline)
    quorum_sig_count: int            # signatures in the commit certificate
    intra_msgs_per_commit: float     # intra-RSM message complexity
    cft: bool = False

    def cert_bytes(self, cfg: RSMConfig) -> float:
        """Quorum-certificate bytes on each cross-RSM message."""
        if self.cft:
            return MAC_BYTES  # leader MAC is enough in crash-only settings
        return float(self.quorum_sig_count * MAC_BYTES)

    def rate_at(self, n: int) -> float:
        """Crude scaling of commit rate with replica count (quadratic
        intra-RSM traffic for BFT, linear for CFT)."""
        base_n = 4
        if self.commit_rate == float("inf"):
            return self.commit_rate
        if self.cft:
            return self.commit_rate * base_n / max(n, 1)
        return self.commit_rate * (base_n / max(n, 1)) ** 2


def FileModel() -> ConsensusModel:
    return ConsensusModel("file", float("inf"), 0, 0.0, cft=True)


def PBFTModel() -> ConsensusModel:
    # ResilientDB: PBFT, 2f+1 commit certificate, O(n^2) messages
    return ConsensusModel("pbft", 39_000.0, 3, 2.0 * 4)


def RaftModel() -> ConsensusModel:
    return ConsensusModel("raft", 39_000.0, 1, 2.0, cft=True)


def AlgorandModel() -> ConsensusModel:
    return ConsensusModel("algorand", 130.0, 3, 3.0 * 4)


def coupled_throughput(consensus_rate: float, c3b_rate: float,
                       overhead_ops: float = 0.02) -> float:
    """RSM throughput once PICSOU is attached (§6.4).

    The RSM replies to a client only after the QUACK for the request's
    batch arrives, so sustained rate = min(consensus, C3B) less a small
    CPU share for the two forwarding threads (measured <15% worst case in
    the paper; overhead_ops models that fraction).
    """
    return min(consensus_rate, c3b_rate) * (1.0 - overhead_ops)
