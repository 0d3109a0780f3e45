"""Commit-stream models of the RSM-internal consensus protocols (§6.4).

PICSOU sits *behind* consensus: each replica forwards committed requests to
the co-located PICSOU library (Figure 1). For the heterogeneous-RSM case
study the relevant properties of the consensus protocol are its commit
throughput, quorum-certificate size and intra-RSM message complexity — we
model those (per the paper's own measured baselines) rather than
re-implementing PBFT/Raft/Algorand bit-for-bit.
"""

from .streams import (AlgorandModel, ConsensusModel, FileModel, PBFTModel,
                      RaftModel, coupled_throughput)

__all__ = ["ConsensusModel", "FileModel", "PBFTModel", "RaftModel",
           "AlgorandModel", "coupled_throughput"]
