"""PICSOU-patterned hierarchical cross-pod collectives.

Two gradient-sync schedules over a (pod, data, model) mesh:

* ``ata_cross_pod_sync``    — flat ``psum`` over (pod, data): the all-to-all
  baseline of the paper (§6, Figure 2a): simple, robust, but every gradient
  byte crosses the inter-pod boundary as part of one global ring that mixes
  fast hops with slow ones.

* ``picsou_cross_pod_sync`` — the C3B pattern (Figure 2c):
    1. ``psum_scatter`` over 'data'  (intra-pod): each position now owns
       1/|data| of the pod-reduced gradient — the "partition the send
       task round-robin across all replicas" step (§4.1);
    2. ``psum`` over 'pod' (the slow link): each shard crosses the
       boundary exactly once — the paper's single cross-cluster copy;
    3. ``all_gather`` over 'data' (intra-pod): the receiver-side
       broadcast of §4.1.

  Slow-link bytes drop from 2*N*(P-1)/P per chip (flat ring over pods)
  to 2*(N/D)*(P-1)/P — a |data|x reduction per chip.

Both take and return trees of global tensors, ``in_specs`` (one
``PartitionSpec`` for every leaf, ``P()`` by default) saying which mesh
axes split them, as the JAX package's ``shard_map`` versions do. The
mesh is held on one device (``repro_torch.launch.mesh``): the
collectives are tensor ops over the blocks' mesh dims, and step (2)
reads only the 1/|data| shards of step (1).
"""

from __future__ import annotations

from typing import Dict

import torch

from ..launch.mesh import (Mesh, P, all_gather, psum, psum_scatter,
                           shard_map)
from ..tree_util import tree_map

__all__ = ["picsou_cross_pod_sync", "ata_cross_pod_sync",
           "dcn_bytes_analytic"]


def ata_cross_pod_sync(grads, mesh: Mesh, in_specs=None):
    """Flat all-reduce over (pod, data) — the ATA baseline."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    spec = in_specs if in_specs is not None else P()

    def sync(g):
        return tree_map(
            lambda x: psum(x, mesh, axes) / mesh.shape.get("pod", 1)
            / mesh.shape.get("data", 1), g)

    return shard_map(sync, mesh, spec, grads)


def picsou_cross_pod_sync(grads, mesh: Mesh, in_specs=None):
    """Hierarchical RS(data) -> AR(pod) -> AG(data): one slow-link copy
    per shard."""
    has_pod = "pod" in mesh.shape
    spec = in_specs if in_specs is not None else P()
    d = mesh.shape.get("data", 1)
    p = mesh.shape.get("pod", 1)
    lead = len(mesh.axis_names)

    def one(x):
        pos = x.shape[:lead]
        orig_shape = x.shape[lead:]
        flat = x.reshape(*pos, -1)
        pad = (-flat.shape[-1]) % d
        if pad:
            flat = torch.cat([flat, flat.new_zeros(*pos, pad)], dim=-1)
        # 1) intra-pod reduce-scatter (round-robin send partitioning)
        shard = psum_scatter(flat, mesh, "data")
        # 2) one cross-pod copy per shard (the C3B single-copy step)
        if has_pod:
            shard = psum(shard, mesh, "pod")
        # 3) intra-pod broadcast (receiver-side §4.1 broadcast)
        full = all_gather(shard, mesh, "data")
        if pad:
            full = full[..., :-pad]
        return (full / (d * p)).reshape(*full.shape[:lead], *orig_shape)

    return shard_map(lambda g: tree_map(one, g), mesh, spec, grads)


def dcn_bytes_analytic(n_bytes: float, mesh_shape: Dict[str, int],
                       schedule: str) -> Dict[str, float]:
    """Slow-link (pod-boundary) traffic per chip for one sync of n_bytes.

    ATA    : the flat ring over pod*data chips carries the full tensor
             through every hop class; each chip's DCN share is
             2*n*(P-1)/P (ring segments crossing the boundary).
    PICSOU : only step (2) crosses pods, on 1/D-sized shards:
             2*(n/D)*(P-1)/P per chip.
    """
    p = mesh_shape.get("pod", 1)
    d = mesh_shape.get("data", 1)
    if p <= 1:
        return {"dcn_per_chip": 0.0, "ici_per_chip": 2.0 * n_bytes}
    if schedule == "ata":
        dcn = 2.0 * n_bytes * (p - 1) / p
        ici = 2.0 * n_bytes * (d - 1) / d
    elif schedule == "picsou":
        dcn = 2.0 * (n_bytes / d) * (p - 1) / p
        ici = (n_bytes * (d - 1) / d          # reduce-scatter
               + n_bytes * (d - 1) / d)       # all-gather
    else:
        raise ValueError(schedule)
    return {"dcn_per_chip": dcn, "ici_per_chip": ici,
            "dcn_reduction": (2.0 * n_bytes * (p - 1) / p) / max(dcn, 1e-9)}
