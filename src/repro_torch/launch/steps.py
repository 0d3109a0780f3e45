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

The two steps the JAX package compiles with donated arguments run here
as it compiles them:

* the train step (``donate_argnums=(0, 1)``) updates the parameters and
  AdamW state it is given in place (``optim.adamw_update_``) and returns
  them;
* the decode step (``jax.jit`` with ``donate_argnums=(1,)``; ``pos`` a
  traced int32 scalar, so one program serves every position) is
  ``decode``: on a CUDA device one CUDA graph captured from a
  ``core.graphs.Programs`` set and replayed once a step, its caches
  written in place in the set's buffers. On the CPU the set runs the
  same body eagerly; on ``meta`` (the dry run) the body runs alone.

The prefill and the ddp step run eagerly (the JAX package jits them,
without donation).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.profiler import record_function

from ..configs.base import ModelConfig, ShapeSpec
from ..core.graphs import (Programs, cached_items, drop_set,
                           program_set)
from ..models import model as M
from ..models.sharding import DEFAULT_RULES, sharding_for
from ..optim import (AdamWConfig, adamw_update_, cosine_schedule,
                     opt_state_specs)
from ..tree_util import tree_flatten, tree_leaves, tree_map, tree_unflatten

__all__ = ["rules_for", "param_shardings", "value_and_grad",
           "train_update", "decode", "decode_body", "build_train_step",
           "build_prefill_step", "build_decode_step", "build_step",
           "StepBundle"]


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
    ``cosine_schedule(opt_state.step, warmup, total_steps)``, written in
    place into ``params`` and ``opt_state`` (donated); returns them."""
    lr_scale = cosine_schedule(opt_state.step, warmup, total_steps)
    with record_function("train.adamw"):
        return adamw_update_(opt_cfg, grads, params, opt_state, lr_scale)


def build_train_step(cfg: ModelConfig, mesh, shape: ShapeSpec,
                     opt_cfg: AdamWConfig = AdamWConfig(),
                     impl: Optional[str] = None,
                     warmup: int = 100, total_steps: int = 10_000
                     ) -> StepBundle:
    """``(params, opt_state, batch) -> (params, opt_state, {"loss", "ce",
    "aux"})``: value and grad of ``loss_fn``, then AdamW at
    ``cosine_schedule(opt_state.step, warmup, total_steps)``. The params
    and optimiser state are donated, as the JAX package's
    ``donate_argnums=(0, 1)``: updated in place and returned, so one set
    of them is alive."""
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


def _layout(tensors) -> Tuple:
    return tuple((tuple(t.shape), t.dtype) for t in tensors)


def _addresses(tensors) -> Tuple:
    """Where a graph reads each tensor: address, shape, strides, dtype."""
    return tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                 for t in tensors)


def decode_body(params, cfg: ModelConfig, treedef, token):
    """The decode step as a ``Programs`` body: ``body(cache leaves, pos) ->
    (the same leaves, [logits])``, ``models.decode_step`` writing the
    caches in place (so a capture copies nothing back) on ``token``,
    which the set keeps."""
    def body(state, t0):
        logits, _ = M.decode_step(params, cfg,
                                  tree_unflatten(treedef, list(state)),
                                  token, t0)
        return state, [logits]
    return body


# decode sets that no generation holds, kept (most recently used first)
# for later generations; beyond them such a set is dropped with its
# buffers and graph pool
DECODE_SETS = 2


@torch.no_grad()
def decode(params, cfg: ModelConfig, caches, token, pos):
    """One decode step as the JAX package compiles it: ``(logits (B,1,V),
    caches)``, the caches donated. ``pos`` is a Python int or a 0-d
    integer tensor on the token's device.

    On a CUDA device the step replays one program of a
    ``core.graphs.Programs`` set, captured at its first use. The set is
    keyed by the device, ``cfg``, the caches' structure, shapes and
    dtypes, the token's, and the address, shape, strides and dtype of
    every parameter leaf (the graph reads them by address), and by a slot
    number. The set's state is the cache leaves. Caches the set lent at
    the last step are decoded on in place; other caches (a new
    generation) are copied into a set of the key that no generation holds
    (``Programs.load``), or a new slot's, and the set lends its buffers
    as the returned caches (``Programs.lend``): what the caller passed in
    is consumed, as with donation. A generation holds its set while any
    cache tensor it was lent lives, so generations that interleave decode
    on sets of their own, and one that follows a finished one of the same
    key captures nothing. The captured body writes the caches in place,
    so a replay copies nothing back; the token goes into a buffer the set
    keeps, so a step costs the host one ``copy_`` of the token, one
    ``fill_`` of ``pos`` and one graph launch. The logits are cloned out
    of the graph's output buffer, which the next replay overwrites.

    The set keeps no reference to the parameters: the caller's tree
    holds them, and a replay happens only while tensors of the keyed
    layout sit at the keyed addresses. What a set holds (cache buffers,
    the token, the graph and its pool) lives while a generation holds
    it; of the decode sets no generation holds, ``DECODE_SETS`` stay
    cached and the older are dropped. The cache of sets
    (``graphs.CACHE_SETS``, least recently used first) or
    ``graphs.clear_programs()`` may drop one sooner.

    On the CPU the set runs the same body eagerly; on ``meta`` (the dry
    run's count) the body runs alone on the caches given."""
    dev = token.device
    if dev.type == "meta":
        return M.decode_step(params, cfg, caches, token, pos)
    leaves, treedef = tree_flatten(caches)
    base = (dev, cfg, treedef, _layout(leaves), _layout([token]),
            _addresses(tree_leaves(params)))
    ps, lent = _decode_set(base, leaves, lambda: Programs(
        tuple(torch.empty_like(x) for x in leaves), dev,
        keep=(torch.empty_like(token),)))
    tok = ps.keep[0]
    tok.copy_(token)
    logits = ps.run("decode", decode_body(params, cfg, treedef, tok),
                    pos)[0]
    if dev.type == "cuda":
        logits = logits.clone()
    return logits, tree_unflatten(treedef, list(lent))


def _decode_set(base, leaves, build) -> Tuple[Programs, Tuple]:
    """(the set, the caches it lends) for a decode step on ``leaves``: the
    set of layout ``base`` that lent them, else the most recently used
    one that no generation holds, else a new slot's, loaded with them."""
    ours = [(k, ps) for k, ps in reversed(cached_items())
            if k[0] == "decode" and k[1] == base]
    for key, ps in ours:
        if ps.lent(leaves):
            program_set(key, build)             # most recently used
            return ps, tuple(leaves)
    free = [k for k, ps in ours if not ps.held()]
    slots = {k[2] for k, _ in ours}
    key = free[0] if free else (
        "decode", base, min(set(range(len(ours) + 1)) - slots))
    ps = program_set(key, build)
    ps.load(tuple(leaves))
    lent = ps.lend()
    idle = [k for k, other in reversed(cached_items())
            if k[0] == "decode" and not other.held()]
    for k in idle[DECODE_SETS:]:
        drop_set(k)
    return ps, lent


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
    """``(params, caches, token, pos) -> (logits, caches)``: ``decode``,
    the caches donated; ``lower()`` counts its body on the ``meta``
    inputs, ``pos`` a meta int32 scalar."""
    rules = rules_for(cfg, mesh)
    p_shard, p_shapes = param_shardings(cfg, mesh, rules)
    b_shapes, b_names = M.input_specs(cfg, shape)
    b_shard = _shardings_from(mesh, b_shapes, b_names, rules)

    def serve_step(params, caches, token, pos):
        return decode(params, cfg, caches, token, pos)

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
