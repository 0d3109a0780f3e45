"""AdamW with decoupled weight decay + global-norm clipping.

Plain functions on trees of tensors, the JAX package's formula step for
step (bias-corrected moments, eps added to sqrt(v-hat), decay on the
f32 parameters, updates computed in f32 and cast back to each
parameter's dtype); not ``torch.optim.AdamW``, whose formula differs.
The m/v trees have the parameters' structure, and their declarations
(``opt_state_specs``, ``meta`` tensors) the parameters' logical names.

``adamw_update_`` writes the new parameters, m, v and step into the
ones it is given (the JAX train step's ``donate_argnums=(0, 1)``);
``adamw_update`` runs it on copies, so the old ones stay as they were,
as the JAX package's undonated callers see them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import torch

from ..tree_util import tree_flatten, tree_leaves, tree_map, tree_unflatten

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "adamw_update_", "global_norm", "opt_state_specs"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


def adamw_init(params) -> AdamWState:
    """Zero moments in f32 beside each parameter; ``step`` an int32
    scalar on the first parameter's device."""
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    device = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=zeros, v=tree_map(torch.clone, zeros))


def opt_state_specs(param_shapes, param_names):
    """``meta`` tensors + logical names for the optimizer state tree: m and
    v in f32 with the parameters' shapes and names, ``step`` an int32
    scalar named ``()``."""
    def f32(s):
        return torch.empty(s.shape, dtype=torch.float32, device="meta")

    shapes = AdamWState(step=torch.empty((), dtype=torch.int32,
                                         device="meta"),
                        m=tree_map(f32, param_shapes),
                        v=tree_map(f32, param_shapes))
    names = AdamWState(step=(), m=param_names, v=param_names)
    return shapes, names


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(l.to(torch.float32)))
                          for l in leaves))


def adamw_update(cfg: AdamWConfig, grads, params, state: AdamWState,
                 lr_scale: Optional[torch.Tensor] = None
                 ) -> Tuple[Any, AdamWState]:
    """New parameters and state beside the old ones, which stay as they
    were: ``adamw_update_`` on copies of them."""
    return adamw_update_(cfg, grads, tree_map(torch.clone, params),
                         AdamWState(step=state.step.clone(),
                                    m=tree_map(torch.clone, state.m),
                                    v=tree_map(torch.clone, state.v)),
                         lr_scale)


def adamw_update_(cfg: AdamWConfig, grads, params, state: AdamWState,
                  lr_scale: Optional[torch.Tensor] = None
                  ) -> Tuple[Any, AdamWState]:
    """AdamW on donated arguments: the parameters, m, v and step are
    written in place, leaf by leaf, and returned; the gradients are read
    only. No second set of parameters and moments is alive at once."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step.add_(1)
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)
    lr = cfg.lr * (lr_scale if lr_scale is not None else 1.0)

    flat_g, treedef = tree_flatten(grads)
    flat_p, flat_m, flat_v = (_leaves_as(treedef, t, what) for t, what in
                              ((params, "params"), (state.m, "m"),
                               (state.v, "v")))
    for g, p, m, v in zip(flat_g, flat_p, flat_m, flat_v):
        g = g.to(torch.float32) * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        delta = delta + cfg.weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * delta)
    return params, state


def _leaves_as(treedef, tree, what: str):
    leaves, td = tree_flatten(tree)
    if td != treedef:
        raise ValueError(f"adamw_update: {what} has another structure than "
                         "the gradients")
    return leaves
