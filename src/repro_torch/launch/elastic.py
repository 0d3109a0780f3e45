"""Elastic scaling: membership changes + stake re-apportionment.

The paper assumes periodic reconfigurations with a reliable mechanism to
learn the new configuration (§2.1). At fleet scale that mechanism is the
job scheduler; what PICSOU contributes is *how to re-balance work* when
the membership or relative capacity ("stake") changes:

* on pod loss: rebuild the mesh on the surviving pods, restore the last
  committed (QUACK-durable) checkpoint, and resume — the deterministic
  data pipeline replays the exact step stream;
* on host capacity skew: re-run Hamilton apportionment over measured
  throughput so send quotas track capacity (§5.2 DSS), with LCM rescaling
  when pods have incommensurate totals (§5.3).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.scheduler import hamilton_apportion
from ..core.types import lcm_scale_factors

__all__ = ["ElasticPlan", "replan_membership", "replan_quotas"]


@dataclasses.dataclass
class ElasticPlan:
    n_pods: int
    hosts_per_pod: int
    mesh_shape: Tuple[int, ...]
    mesh_axes: Tuple[str, ...]
    send_quota: Dict[int, int]
    restore_step: Optional[int]


def replan_membership(alive_pods: List[int], hosts_per_pod: int,
                      data_parallel: int, model_parallel: int,
                      last_committed_step: Optional[int]) -> ElasticPlan:
    """Rebuild the mesh over surviving pods; fewer pods = less DP, same
    model sharding (the per-pod submesh is unchanged, so parameter shards
    stay valid and only the data-parallel degree changes)."""
    n = len(alive_pods)
    if n < 1:
        raise RuntimeError("no pods left")
    if n == 1:
        shape: Tuple[int, ...] = (data_parallel, model_parallel)
        axes: Tuple[str, ...] = ("data", "model")
    else:
        shape = (n, data_parallel, model_parallel)
        axes = ("pod", "data", "model")
    return ElasticPlan(n_pods=n, hosts_per_pod=hosts_per_pod,
                       mesh_shape=shape, mesh_axes=axes, send_quota={},
                       restore_step=last_committed_step)


def replan_quotas(host_throughput: np.ndarray, quantum: int,
                  peer_total_stake: Optional[float] = None
                  ) -> Dict[int, int]:
    """DSS re-apportionment of cross-pod send quotas (§5.2/§5.3)."""
    tp = np.asarray(host_throughput, dtype=np.float64)
    if peer_total_stake is not None and peer_total_stake > 0:
        psi, _ = lcm_scale_factors(tp.sum(), peer_total_stake)
        tp = tp * psi
    counts = hamilton_apportion(tp, quantum)
    return {h: int(c) for h, c in enumerate(counts)}
