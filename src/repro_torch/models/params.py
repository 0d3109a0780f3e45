"""Parameter declarations and their random init, on trees of tensors.

Every parameter is declared once as a ``PD(shape, names, scale)``, as in
the JAX package; ``init_params`` draws a tree of tensors from it,
``shape_tree`` gives its shapes and dtypes as ``meta`` tensors (the
stand-ins for ``jax.ShapeDtypeStruct``: nothing is allocated),
``names_tree`` its logical axis names, and ``params_from_numpy``
carries the JAX package's weights and AdamW state (numpy leaves) into
the port's trees, same key paths, shapes and dtypes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..tree_util import tree_leaves, tree_map

__all__ = ["PD", "init_params", "shape_tree", "names_tree",
           "count_params", "params_from_numpy", "resolve_device",
           "torch_dtype", "meta"]


@dataclasses.dataclass(frozen=True)
class PD:
    """Parameter definition: shape, logical axis names, init scale."""

    shape: Tuple[int, ...]
    names: Tuple[Optional[str], ...]
    scale: float = 1.0
    init: str = "normal"        # normal | zeros | ones
    dtype: Optional[str] = None  # override param dtype

    def __post_init__(self):
        assert len(self.shape) == len(self.names), (self.shape, self.names)


def torch_dtype(name) -> torch.dtype:
    """``"float32"`` / ``"bfloat16"`` (a config's spelling) -> the dtype."""
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


def resolve_device(device=None, what: str = "models run") -> torch.device:
    """The device ``what`` uses: CUDA (the current card) unless the caller
    names another; with no card and no device named, raise."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{what} on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def init_params(gen: torch.Generator, defs, param_dtype: str = "float32",
                device=None):
    """Materialize a PD tree into a tree of tensors on ``device``, drawn
    from ``gen`` (a generator of that device's type), leaf by leaf in
    tree order. A normal leaf has std ``scale / sqrt(shape[0])``: for a
    stacked (L, ...) leaf that is the layer count, as in the JAX
    package."""
    dev = resolve_device(device)
    if gen.device.type != dev.type:
        raise ValueError(f"init_params: a {gen.device.type} generator "
                         f"cannot draw onto {dev}")

    def draw(d: PD):
        dt = torch_dtype(d.dtype or param_dtype)
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dt, device=dev)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dt, device=dev)
        fan_in = d.shape[0] if d.shape else 1
        std = d.scale / np.sqrt(max(fan_in, 1))
        x = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                        device=dev)
        return x.mul_(float(std)).to(dt)

    return tree_map(draw, defs)


def meta(shape, dtype) -> torch.Tensor:
    """A shape and dtype with no storage: a ``meta`` tensor."""
    return torch.empty(tuple(shape), dtype=torch_dtype(dtype),
                       device="meta")


def shape_tree(defs, param_dtype: str = "float32"):
    """PD tree -> tree of ``meta`` tensors (shapes and dtypes, no
    allocation)."""
    return tree_map(lambda d: meta(d.shape, d.dtype or param_dtype), defs)


def names_tree(defs):
    """PD tree -> tree of logical-name tuples (read a tuple leaf against
    the structure of ``shape_tree``: ``tree_util.tree_map(fn, shapes,
    names)``)."""
    return tree_map(lambda d: d.names, defs)


def count_params(defs) -> int:
    return int(sum(int(np.prod(d.shape)) for d in tree_leaves(defs)))


def _from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":                 # ml_dtypes' bfloat16
        t = torch.from_numpy(np.array(a.view(np.uint16))).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def _is_adamw_state(node) -> bool:
    return (isinstance(node, tuple) and type(node).__name__ == "AdamWState"
            and getattr(type(node), "_fields", ()) == ("step", "m", "v"))


def _carry(node, dev):
    if _is_adamw_state(node):
        from ..optim.adamw import AdamWState
        return AdamWState(*(_carry(x, dev) for x in node))
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _carry(v, dev) for k, v in node.items()}
    if isinstance(node, tuple) and hasattr(type(node), "_fields"):
        return type(node)(*(_carry(x, dev) for x in node))
    if isinstance(node, (list, tuple)):
        return type(node)(_carry(x, dev) for x in node)
    return _from_numpy(node, dev)


def params_from_numpy(tree, device=None):
    """The JAX package's parameter tree (numpy leaves, e.g. from
    ``jax.device_get``) as the port's: the same structure, key paths,
    shapes and dtypes (bfloat16 carried bit for bit through a uint16
    view), on ``device`` (CUDA unless named). An AdamW state in the tree
    (the JAX package's ``AdamWState(step, m, v)``) becomes the port's
    ``optim.AdamWState``, so ``(params, opt_state)`` carries across
    whole."""
    return _carry(tree, resolve_device(device))
