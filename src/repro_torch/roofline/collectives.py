"""Collective wire bytes derived from a step's recorded shardings.

The JAX package parses the collectives XLA inserts into the partitioned
module (``repro.roofline.hlo``). A step on the port's mesh, held on one
card, runs no collective, so the bytes that would cross the links come
from the parameters' ``PartitionSpec``s (``BASIS`` says how), priced at
the ring formulas of ``repro.roofline.hlo``, N being the per-position
bytes of the op's result and g its group size:

  all-reduce      : 2 * N * (g-1)/g      (reduce-scatter + all-gather)
  all-gather      : N/g * (g-1)          (each shard forwarded g-1 times)
  reduce-scatter  : N * (g-1)            (the operand is N * g)
  all-to-all      : N * (g-1)/g
  collective-permute : N                 (one hop)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..models.sharding import _present
from ..tree_util import tree_flatten_with_path, tree_leaves

__all__ = ["KINDS", "BASIS", "DerivedCollective", "ring_wire_bytes",
           "derive_collectives", "breakdown", "argument_bytes"]

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")

BASIS = ("derived from the recorded shardings, not inserted by a "
         "compiler and not run (the port's mesh is held on one card): "
         "for each parameter leaf, an all-gather over the batch axes its "
         "PartitionSpec names (FSDP) and, in a train step, a "
         "reduce-scatter of its gradient over those axes and an "
         "all-reduce over the batch axes it does not name; ring costs of "
         "repro.roofline.hlo; tensor-parallel activation collectives and "
         "MoE dispatch are not counted")


def ring_wire_bytes(kind: str, n: float, g: int) -> float:
    """Wire bytes a position sends for one collective of ``kind`` whose
    per-position result is ``n`` bytes, over a group of ``g``."""
    if kind == "all-reduce":
        return 2.0 * n * (g - 1) / max(g, 1)
    if kind == "all-gather":
        return (n / max(g, 1)) * (g - 1)
    if kind == "reduce-scatter":
        return float(n) * (g - 1)
    if kind == "all-to-all":
        return float(n) * (g - 1) / max(g, 1)
    if kind == "collective-permute":
        return float(n)
    raise ValueError(f"unknown collective {kind!r}")


@dataclasses.dataclass(frozen=True)
class DerivedCollective:
    kind: str
    leaf: str                 # the parameter's key path
    axes: Tuple[str, ...]     # the mesh axes of the group
    group_size: int
    result_bytes: float       # per position, the op's result
    wire_bytes_per_chip: float


def _spec_axes(spec) -> Tuple[str, ...]:
    out: List[str] = []
    for e in spec:
        if e is None:
            continue
        out += [e] if isinstance(e, str) else list(e)
    return tuple(out)


def _size(mesh, axes: Sequence[str]) -> int:
    return int(np.prod([mesh.shape[a] for a in axes])) if axes else 1


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def derive_collectives(p_shapes, p_shardings, mesh, rules,
                       train: bool) -> List[DerivedCollective]:
    """The collectives ``BASIS`` names for a step's parameters (a tree of
    ``meta`` tensors and its tree of NamedShardings)."""
    batch = _present(mesh, rules.get("batch"))
    batch = (batch,) if isinstance(batch, str) else tuple(batch or ())
    out: List[DerivedCollective] = []
    shards = tree_leaves(p_shardings)
    for (path, t), sh in zip(tree_flatten_with_path(p_shapes)[0], shards):
        named = _spec_axes(sh.spec)
        fsdp = tuple(a for a in batch if a in named)
        rest = tuple(a for a in batch if a not in named)
        # the leaf on a position once gathered: split over its other axes
        full = _nbytes(t) / _size(mesh, [a for a in named if a not in fsdp])
        g = _size(mesh, fsdp)

        def add(kind, axes, n):
            size = _size(mesh, axes)
            if size > 1:
                out.append(DerivedCollective(
                    kind, path, tuple(axes), size, n,
                    ring_wire_bytes(kind, n, size)))

        add("all-gather", fsdp, full)
        if train:
            add("reduce-scatter", fsdp, full / g)
            add("all-reduce", rest, full / g)
    return out


def breakdown(colls: Sequence[DerivedCollective]) -> Dict[str, float]:
    """Per-position wire bytes and counts by kind, and the total, under
    the JAX package's keys (``bytes.<kind>``, ``count.<kind>``,
    ``bytes.total``)."""
    res = {f"bytes.{k}": 0.0 for k in KINDS}
    res.update({f"count.{k}": 0.0 for k in KINDS})
    for c in colls:
        res[f"bytes.{c.kind}"] += c.wire_bytes_per_chip
        res[f"count.{c.kind}"] += 1.0
    res["bytes.total"] = sum(res[f"bytes.{k}"] for k in KINDS)
    return res


def argument_bytes(in_shapes, in_shardings, mesh) -> float:
    """Bytes of a step's arguments on one position: each leaf's bytes over
    the sizes of the mesh axes its PartitionSpec names."""
    total = 0.0
    for t, sh in zip(tree_leaves(in_shapes), tree_leaves(in_shardings)):
        total += _nbytes(t) / _size(mesh, _spec_axes(sh.spec))
    return total
