"""Multi-link C3B topologies: RSM cluster graphs on the batched engine.

    from repro_torch.topology import Topology, run_topology

    topo = Topology.fanout("primary", ["b0", "b1"], RSMConfig.bft(1),
                           SimConfig(n_msgs=256, steps=120,
                                     window_slots="auto"))
    res = run_topology(topo)                   # on CUDA
    res = run_topology(topo, device="cpu")
    res["primary->b0"].delivered_prefix()

Every link of the graph runs as one lane of a single windowed chunk
stream (one set of captured programs, one dispatch per chunk, O(L·W)
device state); chained links gate their commit stream on the upstream
link's retired prefix between chunks. ``run_topology_reference`` is the
pure-numpy oracle mirror, run on the host with no device.
"""

from .engine import LinkResult, TopologyResult, link_specs, run_topology
from .graph import LinkSpec, Topology
from .refmirror import (RefLinkResult, RefTopologyResult,
                        run_topology_reference)

__all__ = [
    "LinkSpec", "Topology",
    "LinkResult", "TopologyResult", "link_specs", "run_topology",
    "RefLinkResult", "RefTopologyResult", "run_topology_reference",
]
