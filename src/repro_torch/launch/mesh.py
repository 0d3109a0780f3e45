"""The device mesh, held on one card.

The JAX package lays a ``jax.sharding.Mesh`` over real devices: 8 host
devices in its tests, (2, 16, 16) = 512 chips in production, with axes
(pod, data, model). The port runs on one H100. NCCL puts no two ranks on
one GPU, and gloo's CUDA support covers broadcast and all-reduce only,
so a mesh of processes on one card is not on offer. Here a ``Mesh`` is a
named shape on one explicit device, and every mesh position's local
block of a tensor is a view of that one tensor on the card:

* ``to_blocks`` views a global tensor, split as a ``PartitionSpec``
  says, as one tensor whose leading dims are the mesh axes (in
  ``mesh.axis_names`` order) and whose other dims are a position's local
  block. An axis along which the positions hold the same block (one the
  spec does not name) has size 1 there: broadcast, never copied.
* ``psum``, ``psum_scatter`` and ``all_gather`` are the collectives of
  ``jax.lax`` inside ``shard_map``, written as tensor ops over those
  leading dims.
* ``from_blocks`` assembles the global result the out-spec names.
* ``shard_map`` applies a function of block trees to a tree of global
  tensors, one spec for every leaf, with out-specs = in-specs.

Times taken on such a mesh are one card's memory traffic, not the links
between chips; the bytes that would cross them are counted analytically
(``crosspod.collectives.dcn_bytes_analytic``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.params import resolve_device
from ..models.sharding import P, PartitionSpec
from ..tree_util import tree_flatten, tree_map, tree_unflatten

__all__ = ["Mesh", "PartitionSpec", "P", "make_production_mesh",
           "make_mesh", "small_mesh", "parse_mesh", "to_blocks",
           "from_blocks", "psum", "psum_scatter", "all_gather", "shard_map"]


class Mesh:
    """A named mesh shape held on one device.

    ``shape`` maps each axis name to its size, as ``jax.sharding.Mesh``
    does. Every position lives on ``device``, so there is no device-count
    check: (2, 16, 16) holds 512 positions on one card, each block a view
    of the tensors there. The device is CUDA unless the caller names
    another (``device="cpu"``); without a card and without a device
    named, construction raises.
    """

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 device=None):
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} do not "
                             "match")
        if any(s < 1 for s in shape):
            raise ValueError(f"mesh axis sizes must be positive: {shape}")
        self.axis_names: Tuple[str, ...] = axes
        self.shape: Dict[str, int] = dict(zip(axes, shape))
        self.size = int(np.prod(shape))
        self.device = resolve_device(device, "the mesh is held")


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device=None) -> Mesh:
    return Mesh(shape, axes, device)


def parse_mesh(s: str, device=None) -> Mesh:
    """A launcher's ``--mesh``: ``"DxM"`` as (data, model), ``"PxDxM"``
    as (pod, data, model)."""
    dims = [int(x) for x in s.split("x")]
    if len(dims) == 3:
        return make_mesh(dims, ("pod", "data", "model"), device)
    return make_mesh(dims, ("data", "model"), device)


def small_mesh(data: int = 2, model: int = 2, pod: Optional[int] = None,
               device=None) -> Mesh:
    """Reduced mesh for CPU tests."""
    if pod:
        return make_mesh((pod, data, model), ("pod", "data", "model"),
                         device)
    return make_mesh((data, model), ("data", "model"), device)


# ------------------------------------------------------ blocks of a leaf
def _dim_axes(spec, ndim: int, mesh: Mesh) -> Tuple[Tuple[str, ...], ...]:
    """The mesh axes that split each of ``ndim`` dims."""
    if len(spec) > ndim:
        raise ValueError(f"{spec!r} names {len(spec)} dims of a tensor "
                         f"with {ndim}")
    out = []
    for e in tuple(spec) + (None,) * (ndim - len(spec)):
        axes = () if e is None else (e,) if isinstance(e, str) else tuple(e)
        for a in axes:
            if a not in mesh.shape:
                raise ValueError(f"{spec!r}: no mesh axis {a!r} in "
                                 f"{mesh.axis_names}")
        out.append(axes)
    used = [a for axes in out for a in axes]
    if len(used) != len(set(used)):
        raise ValueError(f"{spec!r} uses a mesh axis twice")
    return tuple(out)


def to_blocks(x: torch.Tensor, mesh: Mesh, spec) -> torch.Tensor:
    """Every position's local block of the global tensor ``x``, as one
    view: leading dims the mesh axes (size 1 where the spec does not
    split, the block being the same there), then the local block."""
    if x.device != mesh.device:
        raise ValueError(f"a tensor on {x.device} given to a mesh on "
                         f"{mesh.device}")
    dim_axes = _dim_axes(spec, x.dim(), mesh)
    split = []
    for g, axes in zip(x.shape, dim_axes):
        n = int(np.prod([mesh.shape[a] for a in axes]))
        if g % n:
            raise ValueError(f"dim of size {g} does not split over "
                             f"{axes} ({n} positions)")
        split += [mesh.shape[a] for a in axes] + [g // n]
    v = x.reshape(split)
    # where each mesh axis and each local dim sits in ``v``
    pos, at = {}, 0
    local_at = []
    for axes in dim_axes:
        for a in axes:
            pos[a] = at
            at += 1
        local_at.append(at)
        at += 1
    order = [pos[a] for a in mesh.axis_names if a in pos] + local_at
    v = v.permute(order)
    for i, a in enumerate(mesh.axis_names):
        if a not in pos:
            v = v.unsqueeze(i)
    return v


def from_blocks(b: torch.Tensor, mesh: Mesh, spec) -> torch.Tensor:
    """The global tensor whose blocks ``b`` holds (``to_blocks``'
    inverse). An axis the spec splits but ``b`` holds once is copied to
    every position; an axis the spec does not split is read at its first
    position."""
    nax = len(mesh.axis_names)
    local_shape = b.shape[nax:]
    dim_axes = _dim_axes(spec, len(local_shape), mesh)
    named = {a for axes in dim_axes for a in axes}
    for i, a in enumerate(mesh.axis_names):
        if a in named:
            b = b.expand(*b.shape[:i], mesh.shape[a], *b.shape[i + 1:])
    keep = [a for a in mesh.axis_names if a in named]
    b = b[tuple(slice(None) if a in named else 0 for a in mesh.axis_names)]
    # b: (kept mesh axes..., local dims...) -> global dims
    order = []
    for k, axes in enumerate(dim_axes):
        order += [keep.index(a) for a in axes] + [len(keep) + k]
    shape = [n * int(np.prod([mesh.shape[a] for a in axes]))
             for n, axes in zip(local_shape, dim_axes)]
    return b.permute(order).reshape(shape)


# ----------------------------------------- collectives over block dims
def _axis(mesh: Mesh, name: str) -> int:
    if name not in mesh.shape:
        raise ValueError(f"no mesh axis {name!r} in {mesh.axis_names}")
    return mesh.axis_names.index(name)


def psum(b: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """``jax.lax.psum`` over the named axes: every position along them
    gets the sum of their blocks (held once: size 1 on those axes)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    dims = [_axis(mesh, a) for a in axes]
    held = [d for d in dims if b.shape[d] > 1]
    once = [d for d in dims if b.shape[d] == 1]
    if held:
        b = b.sum(dim=held, keepdim=True)
    copies = int(np.prod([mesh.shape[mesh.axis_names[d]] for d in once]))
    return b * copies if copies > 1 else b


def psum_scatter(b: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``jax.lax.psum_scatter(x, axis, scatter_dimension=0, tiled=True)``:
    the sum over ``axis``, its local dim 0 cut into ``mesh.shape[axis]``
    tiles, tile j at position j."""
    i, n = _axis(mesh, axis), mesh.shape[axis]
    nax = len(mesh.axis_names)
    s = psum(b, mesh, axis).squeeze(i)
    rows = s.shape[nax - 1]
    if rows % n:
        raise ValueError(f"psum_scatter: dim of size {rows} does not tile "
                         f"over {axis!r} ({n})")
    s = s.reshape(*s.shape[:nax - 1], n, rows // n, *s.shape[nax:])
    return s.movedim(nax - 1, i)


def all_gather(b: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``jax.lax.all_gather(x, axis, axis=0, tiled=True)``: every position
    along ``axis`` gets the blocks of ``axis``' positions concatenated
    along local dim 0 (held once: size 1 on ``axis``)."""
    i, n = _axis(mesh, axis), mesh.shape[axis]
    nax = len(mesh.axis_names)
    if b.shape[i] == 1:
        b = b.expand(*b.shape[:i], n, *b.shape[i + 1:])
    g = b.movedim(i, nax - 1)
    g = g.reshape(*g.shape[:nax - 1], n * g.shape[nax], *g.shape[nax + 1:])
    return g.unsqueeze(i)


def shard_map(fn: Callable, mesh: Mesh, spec, tree):
    """``fn`` (a function of a tree of blocks) applied to the tree of
    global tensors ``tree``, ``spec`` for every leaf in and out."""
    leaves, treedef = tree_flatten(tree)
    blocks = tree_unflatten(treedef, [to_blocks(x, mesh, spec)
                                      for x in leaves])
    return tree_map(lambda b: from_blocks(b, mesh, spec), fn(blocks))
