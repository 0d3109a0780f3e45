"""Parameter declarations and their random init, on trees of tensors.

Every parameter is declared once as a ``PD(shape, names, scale)``, as in
the JAX package; ``init_params`` draws a tree of tensors from it, and
``params_from_numpy`` carries the JAX package's weights (numpy leaves)
into the port's tree, same key paths, shapes and dtypes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..tree_util import tree_leaves, tree_map

__all__ = ["PD", "init_params", "count_params", "params_from_numpy",
           "resolve_device", "torch_dtype"]


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


def params_from_numpy(tree, device=None):
    """The JAX package's parameter tree (numpy leaves, e.g. from
    ``jax.device_get``) as the port's: the same structure, key paths,
    shapes and dtypes (bfloat16 carried bit for bit through a uint16
    view), on ``device`` (CUDA unless named)."""
    dev = resolve_device(device)
    return tree_map(lambda a: _from_numpy(a, dev), tree)
