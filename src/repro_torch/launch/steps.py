"""Step builders: the train, prefill and decode steps with their declared
shardings.

The JAX package jits each step with explicit in/out shardings, built
from ``ShapeDtypeStruct`` trees, so that its dry run can lower every
(arch x shape x mesh) cell without allocating. Here the shapes are
``meta`` tensors (``models.param_specs``, ``models.input_specs``,
``optim.opt_state_specs``) and the shardings ``NamedSharding``s of the
port's mesh, held on one card (``launch.mesh``): a step computes on whole
tensors on the mesh's device, and its bundle records the shardings the
planner gives (``models.sharding.spec_for``) beside it.
``StepBundle.lower()`` is the counterpart of JAX's lowering: it counts
the step on those ``meta`` inputs (``roofline.lowered``), allocating
nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.profiler import record_function

from ..configs.base import ModelConfig, ShapeSpec
from ..models import model as M
from ..models.sharding import DEFAULT_RULES, sharding_for
from ..optim import (AdamWConfig, adamw_update, cosine_schedule,
                     opt_state_specs)
from ..tree_util import tree_flatten, tree_map, tree_unflatten

__all__ = ["rules_for", "param_shardings", "value_and_grad",
           "train_update", "build_train_step", "build_prefill_step",
           "build_decode_step", "build_step", "StepBundle"]


def rules_for(cfg: ModelConfig, mesh) -> Dict[str, Any]:
    """Divisibility-aware rule selection.

    When KV heads cannot shard over 'model' (e.g. qwen2 kv=8 on a 16-way
    axis) the KV-cache sequence axis takes the sharding instead.
    """
    rules = dict(DEFAULT_RULES)
    model_size = mesh.shape.get("model", 1)
    if model_size > 1 and cfg.n_kv_heads % model_size != 0:
        rules["cache_seq"] = "model"
    return rules


def _shardings_from(mesh, shapes, names, rules):
    return tree_map(lambda s, n: sharding_for(mesh, n, s.shape, rules),
                    shapes, names)


def param_shardings(cfg: ModelConfig, mesh, rules=None):
    """(tree of NamedShardings, tree of ``meta`` tensors) of the
    parameters."""
    shapes, names = M.param_specs(cfg)
    rules = rules or rules_for(cfg, mesh)
    return _shardings_from(mesh, shapes, names, rules), shapes


@dataclasses.dataclass
class StepBundle:
    """A step with its declared inputs: ``in_shapes`` are ``meta`` tensor
    trees, ``in_shardings`` their NamedShardings on ``mesh``, ``shape``
    the cell it was built for."""

    fn: Any
    in_shapes: Tuple[Any, ...]
    in_shardings: Tuple[Any, ...]
    mesh: Optional[Any] = None
    rules: Optional[Dict[str, Any]] = None
    shape: Optional[ShapeSpec] = None

    def lower(self):
        """The step counted on its ``meta`` inputs: a
        ``roofline.lowered.Lowered`` with ``cost_analysis()``,
        ``memory_analysis()`` and the derived collectives."""
        from ..roofline.lowered import lower
        return lower(self)

    def __call__(self, *args):
        return self.fn(*args)


def value_and_grad(params, cfg: ModelConfig, batch, *,
                   impl: Optional[str] = None):
    """((loss, {"ce", "aux"}), grads) of ``models.loss_fn`` at ``params``,
    grads a tree of the parameters' structure and dtypes (zeros for a
    parameter the loss does not read, as JAX gives)."""
    leaves, treedef = tree_flatten(params)
    with torch.enable_grad(), record_function("train.value_and_grad"):
        live = [p.detach().requires_grad_() for p in leaves]
        loss, metrics = M.loss_fn(tree_unflatten(treedef, live), cfg, batch,
                                  impl=impl)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_unflatten(treedef, grads)


def train_update(opt_cfg: AdamWConfig, grads, params, opt_state,
                 warmup: int, total_steps: int):
    """A train step's update after its gradients: AdamW at
    ``cosine_schedule(opt_state.step, warmup, total_steps)``;
    ``(params, opt_state)``."""
    lr_scale = cosine_schedule(opt_state.step, warmup, total_steps)
    with record_function("train.adamw"):
        return adamw_update(opt_cfg, grads, params, opt_state, lr_scale)


def build_train_step(cfg: ModelConfig, mesh, shape: ShapeSpec,
                     opt_cfg: AdamWConfig = AdamWConfig(),
                     impl: Optional[str] = None,
                     warmup: int = 100, total_steps: int = 10_000
                     ) -> StepBundle:
    """``(params, opt_state, batch) -> (params, opt_state, {"loss", "ce",
    "aux"})``: value and grad of ``loss_fn``, then AdamW at
    ``cosine_schedule(opt_state.step, warmup, total_steps)``."""
    rules = rules_for(cfg, mesh)
    p_shard, p_shapes = param_shardings(cfg, mesh, rules)
    _, p_names = M.param_specs(cfg)
    o_shapes, o_names = opt_state_specs(p_shapes, p_names)
    o_shard = _shardings_from(mesh, o_shapes, o_names, rules)
    b_shapes, b_names = M.input_specs(cfg, shape)
    b_shard = _shardings_from(mesh, b_shapes, b_names, rules)

    def train_step(params, opt_state, batch):
        (loss, metrics), grads = value_and_grad(params, cfg, batch,
                                                impl=impl)
        params, opt_state = train_update(opt_cfg, grads, params, opt_state,
                                         warmup, total_steps)
        return params, opt_state, {"loss": loss, **metrics}

    return StepBundle(fn=train_step, in_shapes=(p_shapes, o_shapes,
                                                b_shapes),
                      in_shardings=(p_shard, o_shard, b_shard),
                      mesh=mesh, rules=rules, shape=shape)


def build_prefill_step(cfg: ModelConfig, mesh, shape: ShapeSpec,
                       impl: Optional[str] = None) -> StepBundle:
    rules = rules_for(cfg, mesh)
    p_shard, p_shapes = param_shardings(cfg, mesh, rules)
    b_shapes, b_names = M.input_specs(cfg, shape)
    b_shard = _shardings_from(mesh, b_shapes, b_names, rules)

    @torch.no_grad()
    def prefill_step(params, batch):
        memory = batch.get("frames", batch.get("memory"))
        return M.prefill(params, cfg, batch["tokens"], memory=memory,
                         impl=impl)

    return StepBundle(fn=prefill_step, in_shapes=(p_shapes, b_shapes),
                      in_shardings=(p_shard, b_shard), mesh=mesh,
                      rules=rules, shape=shape)


def build_decode_step(cfg: ModelConfig, mesh,
                      shape: ShapeSpec) -> StepBundle:
    rules = rules_for(cfg, mesh)
    p_shard, p_shapes = param_shardings(cfg, mesh, rules)
    b_shapes, b_names = M.input_specs(cfg, shape)
    b_shard = _shardings_from(mesh, b_shapes, b_names, rules)

    @torch.no_grad()
    def serve_step(params, caches, token, pos: int):
        # the caller gives the position as a Python int (``lower`` gives
        # ``seq_len - 1``): a meta tensor has no value to read
        return M.decode_step(params, cfg, caches, token, int(pos))

    return StepBundle(
        fn=serve_step,
        in_shapes=(p_shapes, b_shapes["caches"], b_shapes["token"],
                   b_shapes["pos"]),
        in_shardings=(p_shard, b_shard["caches"], b_shard["token"],
                      b_shard["pos"]),
        mesh=mesh, rules=rules, shape=shape)


def build_step(cfg: ModelConfig, mesh, shape: ShapeSpec,
               impl: Optional[str] = None) -> StepBundle:
    """Dispatch on the shape kind: train_step / prefill / serve_step."""
    if shape.kind == "train":
        return build_train_step(cfg, mesh, shape, impl=impl)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, mesh, shape, impl=impl)
    return build_decode_step(cfg, mesh, shape)
