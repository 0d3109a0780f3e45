"""Cross-pod runtime: the PICSOU schedule mapped onto pod meshes.

The paper's efficiency pillar P1 — "a single copy of each message crosses
the expensive inter-cluster link; broadcast happens intra-cluster" — maps
exactly onto hierarchical collectives over a (pod, data, model) mesh:

    reduce-scatter(intra-pod)  ->  all-reduce(pod axis, 1/N bytes/chip)
                               ->  all-gather(intra-pod)

vs the ATA baseline (flat all-reduce over all axes, every byte crossing
the slow pod boundary multiple times). QUACK bookkeeping drives the
fault-tolerant checkpoint replication (replication.py) and the DSS /
apportionment scheduler drives straggler-aware send quotas. The mesh is
held on one card (``repro_torch.launch.mesh``).
"""

from .collectives import (ata_cross_pod_sync, dcn_bytes_analytic,
                          picsou_cross_pod_sync)
from .compression import (ef_int8_compress, ef_int8_decompress,
                          make_ef_state)
from .replication import ReplicationLedger, ShardState

__all__ = ["picsou_cross_pod_sync", "ata_cross_pod_sync",
           "dcn_bytes_analytic", "ReplicationLedger", "ShardState",
           "ef_int8_compress", "ef_int8_decompress", "make_ef_state"]
