"""Logical-axis sharding rules with a divisibility-aware planner.

MaxText-style, as in the JAX package: every tensor dimension carries a
logical name; rules map names to mesh axes; the planner drops a mapping
whenever the dimension is not divisible by the mesh-axis extent (e.g.
qwen2's 8 KV heads cannot shard over a 16-way 'model' axis: the KV
*cache sequence* axis picks up the sharding instead, through the
'cache_seq' fallback rule).

The planner reads only ``mesh.shape`` (axis name -> size), so it plans
for any mesh, the production (2, 16, 16) included. A sharding is a
``NamedSharding``: the port's mesh (``launch.mesh.Mesh``, held on one
card) with a ``PartitionSpec``. On one card nothing is moved by it: the
step builders record the shardings beside the steps, and ``constrain``
(a sharding hint inside model code) returns its input.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple, Union

from ..tree_util import tree_map

__all__ = ["AxisRules", "DEFAULT_RULES", "SP_RULES", "PartitionSpec", "P",
           "NamedSharding", "spec_for", "sharding_for", "tree_shardings",
           "mesh_axis_size", "activation_sharding", "constrain"]

AxisVal = Union[None, str, Tuple[str, ...]]
AxisRules = Dict[str, AxisVal]


class PartitionSpec(tuple):
    """Which mesh axes split each dimension: one entry per leading dim,
    ``None`` (not split), an axis name, or a tuple of names (split over
    their product, the first the major one). ``P()`` replicates."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A mesh and the spec that lays a tensor on it."""

    mesh: Any
    spec: PartitionSpec


# Logical-axis vocabulary used across the model zoo.
DEFAULT_RULES: AxisRules = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp_act": "model",
    "cache_seq": None,       # fallback target when kv_heads won't shard
    "vision_seq": None,
    "enc_seq": None,
    # parameters (FSDP over 'data', TP over 'model')
    "p_embed": "data",
    "vocab": "model",
    "p_heads": "model",
    "p_kv_heads": "model",
    "p_head_dim": None,
    "p_mlp": "model",
    "experts": "model",
    "p_expert_mlp": "model",      # fallback TP when experts don't divide
    "expert_cap": "data",         # MoE capacity dim (2D dispatch lever)
    "ssm_state": None,
    "layers": None,
    # optimizer / scalars
    "none": None,
}

# Sequence-parallel override used for the 500k-context SSM path.
SP_RULES: AxisRules = dict(DEFAULT_RULES, seq="model", cache_seq="model")


def mesh_axis_size(mesh, axes: AxisVal) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    size = 1
    for a in axes:
        size *= mesh.shape.get(a, 1)
    return size


def _present(mesh, axes: AxisVal) -> AxisVal:
    """Drop mesh axes that don't exist on this mesh (e.g. 'pod' on 2D)."""
    if axes is None:
        return None
    if isinstance(axes, str):
        return axes if axes in mesh.shape else None
    kept = tuple(a for a in axes if a in mesh.shape)
    if not kept:
        return None
    return kept if len(kept) > 1 else kept[0]


def spec_for(mesh, logical: Sequence[Optional[str]], shape: Sequence[int],
             rules: Optional[AxisRules] = None) -> PartitionSpec:
    """Resolve logical dim names -> PartitionSpec, enforcing divisibility.

    A mesh axis may be consumed by at most one tensor dimension; when a
    dimension's size is not divisible by its rule's extent the dimension
    falls back to replication (and the freed axis stays available for a
    later dimension such as 'cache_seq').
    """
    rules = rules or DEFAULT_RULES
    used: set = set()
    out = []
    for name, dim in zip(logical, shape):
        axes = _present(mesh, rules.get(name)) if name else None
        if axes is None:
            out.append(None)
            continue
        tup = (axes,) if isinstance(axes, str) else tuple(axes)
        if any(a in used for a in tup):
            out.append(None)
            continue
        ext = mesh_axis_size(mesh, tup)
        if ext <= 1 or dim % ext != 0:
            out.append(None)
            continue
        used.update(tup)
        out.append(axes)
    return P(*out)


def sharding_for(mesh, logical: Sequence[Optional[str]],
                 shape: Sequence[int],
                 rules: Optional[AxisRules] = None) -> NamedSharding:
    return NamedSharding(mesh, spec_for(mesh, logical, shape, rules))


@contextlib.contextmanager
def activation_sharding(mesh, rules: Optional[AxisRules] = None):
    """The JAX package's scope for ``constrain``: a no-op here, since
    ``constrain`` is the identity on a mesh held on one card."""
    yield


def constrain(x, *names: Optional[str], rules: Optional[AxisRules] = None):
    """A logical-axis sharding hint: the identity, since every position of
    a mesh held on one card sees the whole tensor."""
    return x


def tree_shardings(mesh, shapes_tree, logical_tree,
                   rules: Optional[AxisRules] = None):
    """A tree of shape stand-ins (anything with ``.shape``) and its tree
    of logical-name tuples -> a tree of NamedShardings."""
    return tree_map(lambda s, names: sharding_for(mesh, names, s.shape,
                                                  rules),
                    shapes_tree, logical_tree)
