"""Model assembly: layer plans, parameter trees, the training loss,
prefill and decode, and the shape declarations of a step's inputs.

A config resolves to a *layer plan*, an ordered list of (block kind,
count) segments, as in the JAX package. A segment of several layers
holds its parameters stacked on a leading (count, ...) axis and runs as a
loop over per-layer views, each layer's weights cast to the activations'
dtype where they are used (the JAX package's ``lax.scan``); its caches
come back stacked the same way. With ``cfg.remat`` (the default) each
layer of such a segment runs under activation checkpointing when
gradients are recorded (the JAX package's ``jax.checkpoint`` of the scan
body; ``remat_policy="dots"`` keeps the matmul outputs, as
``dots_with_no_batch_dims_saveable`` does). Recurrent families (rwkv /
hybrid) thread their state through the blocks; decode writes the
per-layer caches in place. ``param_specs`` / ``cache_specs`` /
``input_specs`` declare shapes and dtypes as ``meta`` tensors, with their
logical axis names.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ModelConfig, ShapeSpec
from ..roofline import count
from ..tree_util import tree_flatten, tree_map, tree_unflatten
from . import blocks as B
from .params import (PD, init_params, meta, names_tree, resolve_device,
                     shape_tree, torch_dtype)

__all__ = ["Segment", "layer_plan", "encoder_plan", "model_defs",
           "init_model", "param_specs", "encode", "forward", "loss_fn",
           "prefill", "decode_step", "cache_specs", "input_specs"]


@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str
    count: int


def layer_plan(cfg: ModelConfig) -> List[Segment]:
    f = cfg.family
    L = cfg.n_layers
    if f == "dense":
        return [Segment("dense_swa" if cfg.sliding_window else "dense", L)]
    if f == "moe":
        kind = "moe_swa" if cfg.sliding_window else "moe"
        segs = []
        if cfg.first_dense_layers:
            segs.append(Segment("dense", cfg.first_dense_layers))
        segs.append(Segment(kind, L - cfg.first_dense_layers))
        return segs
    if f == "ssm":
        return [Segment("rwkv", L)]
    if f == "hybrid":
        # global full attention at the first, middle and last layer
        # (hymba), sliding window + parallel SSM heads elsewhere
        glb = {0, L // 2, L - 1}
        segs: List[Segment] = []
        for i in range(L):
            k = "hybrid_global" if i in glb else "hybrid"
            if segs and segs[-1].kind == k:
                segs[-1] = Segment(k, segs[-1].count + 1)
            else:
                segs.append(Segment(k, 1))
        return segs
    if f == "encdec":
        return [Segment("dec", L)]
    if f == "vlm":
        period = cfg.cross_attn_period
        n_cross = L // period
        per_group = period - 1
        segs = []
        for _ in range(n_cross):
            segs.append(Segment("dense", per_group))
            segs.append(Segment("cross", 1))
        rem = L - n_cross - n_cross * per_group
        if rem > 0:
            segs.append(Segment("dense", rem))
        return segs
    raise ValueError(f"unknown family {f}")


def encoder_plan(cfg: ModelConfig) -> List[Segment]:
    if cfg.encoder_layers:
        return [Segment("enc", cfg.encoder_layers)]
    return []


def _stack_defs(defs, n: int):
    """Add a leading 'layers' axis of extent n to every PD in the tree."""
    return tree_map(lambda d: PD((n,) + d.shape, ("layers",) + d.names,
                                 scale=d.scale, init=d.init, dtype=d.dtype),
                    defs)


def _segment_defs(cfg: ModelConfig, segs: List[Segment]):
    return [_stack_defs(B.block_defs(cfg, s.kind), s.count) if s.count > 1
            else B.block_defs(cfg, s.kind) for s in segs]


def model_defs(cfg: ModelConfig) -> Dict[str, Any]:
    out: Dict[str, Any] = {"embed": B.embed_defs(cfg),
                           "segments": _segment_defs(cfg, layer_plan(cfg))}
    enc = encoder_plan(cfg)
    if enc:
        out["encoder"] = _segment_defs(cfg, enc)
        out["embed"]["enc_ln"] = PD((cfg.d_model,), ("p_embed",),
                                    init="ones")
    return out


def init_model(cfg: ModelConfig,
               seed_or_generator: Union[int, torch.Generator],
               device=None):
    """Random weights of ``cfg`` on ``device`` (CUDA unless named), from a
    seed or from a generator of that device's type."""
    dev = resolve_device(device)
    gen = seed_or_generator
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(gen))
    return init_params(gen, model_defs(cfg), cfg.param_dtype, dev)


def param_specs(cfg: ModelConfig):
    """(tree of ``meta`` tensors, tree of logical-name tuples) of the
    parameters."""
    defs = model_defs(cfg)
    return shape_tree(defs, cfg.param_dtype), names_tree(defs)


# --------------------------------------------------------------------------
# forward (prefill)
# --------------------------------------------------------------------------

def _zero_carry(cfg: ModelConfig, kind: str, batch: int, dev):
    hd, d = cfg.resolved_head_dim, cfg.d_model

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    if kind == "rwkv":
        return {"tm_state": zeros(batch, cfg.n_heads, hd, hd),
                "tm_xprev": zeros(batch, d), "cm_xprev": zeros(batch, d)}
    if kind in ("hybrid", "hybrid_global"):
        return {"ssm_state": zeros(batch, cfg.ssm_heads or cfg.n_heads, hd,
                                   cfg.ssm_state)}
    return {}


def _layer(tree, i: int):
    """Layer i's view of a stacked (count, ...) tree."""
    return tree_map(lambda a: a[i], tree)


# matmul outputs without batch dims (a bmm of batch 1 is torch.einsum's
# form of a plain product): what "dots" keeps for the backward
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_BATCHED_DOTS = (torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    if op in _DOTS or (op in _BATCHED_DOTS and args[-2].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ModelConfig):
    """``fn`` under activation checkpointing (non-reentrant: its forward
    runs again in the backward) when ``cfg.remat`` and gradients are being
    recorded; ``fn`` itself otherwise."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)

    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **kw)
    return run


def _run_segment(seg_p, x, cfg: ModelConfig, seg: Segment, *, positions,
                 memory, impl, return_cache: bool):
    """Returns (x, aux, caches), caches stacked over the segment's
    layers. The layers of a stacked segment run under ``_remat``, as a
    ``count.loop`` (which a dry run's counter scales)."""
    def one(p, x, memory):
        carry = _zero_carry(cfg, seg.kind, x.shape[0], x.device)
        xx, aux, nc = B.block_fwd(p, x, cfg, seg.kind, positions=positions,
                                  memory=memory, impl=impl, carry=carry)
        cache = (_build_cache(p, nc, x, cfg, seg.kind, memory)
                 if return_cache else {})
        return xx, aux, cache

    if seg.count == 1:
        return one(seg_p, x, memory)
    layer = _remat(one, cfg)
    leaves, treedef = tree_flatten(seg_p)

    def body(i, carry, shared):
        x, aux = carry
        p = _layer(tree_unflatten(treedef, list(shared[:-1])), i)
        x, a, cache = layer(p, x, shared[-1])
        return (x, aux + a), cache

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    (x, aux), caches = count.loop(seg.count, body, (x, aux),
                                  tuple(leaves) + (memory,))
    return x, aux, caches


def _build_cache(p, new_carry, x_in, cfg: ModelConfig, kind: str, memory):
    """Materialize decode caches during prefill."""
    if kind == "rwkv":
        return dict(new_carry)
    cache: Dict[str, Any] = {}
    if kind in ("hybrid", "hybrid_global"):
        cache["ssm_state"] = new_carry["ssm_state"]
    if kind != "cross":
        # recompute the k/v projections for the cache
        xin = B.rmsnorm(x_in, p["ln1"], cfg.norm_eps)
        positions = torch.arange(x_in.shape[1], dtype=torch.int32,
                                 device=x_in.device)
        _, k, v = B._qkv(p["attn"], xin, xin, cfg)
        k = B.rope(k, positions, cfg.rope_theta)
        window = B.window_for(cfg, kind)
        if window and k.shape[1] > window:
            k, v = k[:, -window:], v[:, -window:]
        cache["k"], cache["v"] = k, v
    if kind in ("dec", "cross"):
        _, cache["xk"], cache["xv"] = B._qkv(p["xattn"], memory, memory, cfg)
    return cache


def encode(params, cfg: ModelConfig, frames, impl: Optional[str] = None):
    """Whisper-style encoder over stub frame embeddings, in their dtype."""
    x = frames + params["embed"]["enc_pos"][None].to(frames.dtype)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    for seg_p, seg in zip(params["encoder"], encoder_plan(cfg)):
        x, _, _ = _run_segment(seg_p, x, cfg, seg, positions=positions,
                               memory=None, impl=impl, return_cache=False)
    return B.rmsnorm(x, params["embed"]["enc_ln"], cfg.norm_eps)


def _embed(params, tokens, dtype):
    # the gather before the cast: the same values as casting the table
    return params["embed"]["tok"][tokens.long()].to(dtype)


def _logits(params, x, cfg: ModelConfig, dtype):
    x = B.rmsnorm(x, params["embed"]["ln_f"].to(dtype), cfg.norm_eps)
    return torch.einsum("bsd,dv->bsv", x,
                        params["embed"]["unembed"].to(dtype))


def forward(params, cfg: ModelConfig, tokens, *, memory=None,
            impl: Optional[str] = None, return_cache: bool = False):
    """tokens: (B,S) -> logits (B,S,V), aux [, caches]. memory: encoder or
    vision embeddings for the encdec / vlm families. ``impl`` picks the
    attention route (``attention.attention``)."""
    dtype = torch_dtype(cfg.dtype)
    x = _embed(params, tokens, dtype)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=x.device)
    if memory is not None:
        memory = memory.to(dtype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    for seg_p, seg in zip(params["segments"], layer_plan(cfg)):
        x, a, cache = _run_segment(seg_p, x, cfg, seg, positions=positions,
                                   memory=memory, impl=impl,
                                   return_cache=return_cache)
        aux = aux + a
        caches.append(cache)
    logits = _logits(params, x, cfg, dtype)
    if return_cache:
        return logits, aux, caches
    return logits, aux


def loss_fn(params, cfg: ModelConfig, batch, *, impl: Optional[str] = None):
    """Next-token cross entropy (+0.01 * MoE aux), in f32: returns
    (loss, {"ce", "aux"})."""
    tokens = batch["tokens"]
    memory = batch.get("memory")
    if cfg.family == "encdec":
        memory = encode(params, cfg, batch["frames"], impl=impl)
    logits, aux = forward(params, cfg, tokens, memory=memory, impl=impl)
    logits = logits[:, :-1].float()
    targets = tokens[:, 1:].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    ce = (logz - gold).mean()
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def prefill(params, cfg: ModelConfig, tokens, *, memory=None,
            impl: Optional[str] = None, cache_len: Optional[int] = None):
    """Full-sequence prefill: returns (last-token logits, caches).

    ``cache_len`` pads full-attention KV caches to a capacity decode can
    append to. SWA caches are ring buffers of capacity ``window``; the
    prefill length must be a multiple of the window so that the ring's
    write pointer (pos % window) lines up with the oldest entry.
    """
    s = tokens.shape[1]
    if cfg.sliding_window and s % cfg.sliding_window != 0:
        raise ValueError("prefill length must be a multiple of the window")
    if cfg.family == "encdec":
        memory = encode(params, cfg, memory, impl=impl)
    logits, _, caches = forward(params, cfg, tokens, memory=memory,
                                impl=impl, return_cache=True)
    if cache_len is not None and cache_len > s:
        pad = [0, 0, 0, 0, 0, cache_len - s]          # dim -3, at the end

        def pad_kv(seg_cache):
            return {key: (F.pad(c, pad) if key in ("k", "v")
                          and c.shape[-3] == s else c)
                    for key, c in seg_cache.items()}

        caches = [pad_kv(c) for c in caches]
    return logits[:, -1:], caches


def decode_step(params, cfg: ModelConfig, caches, token, pos):
    """One decode step. token: (B,1) int; pos: the next index, a 0-d int32
    tensor on the token's device (a Python int is made one), so that one
    captured step serves every position. Writes the caches it is given in
    place, each layer of a stacked segment into its view of the stacked
    cache, and returns (logits (B,1,V), those caches): the JAX package's
    step with the caches donated. SWA caches are ring buffers (written at
    pos % capacity)."""
    dtype = torch_dtype(cfg.dtype)
    x = _embed(params, token, dtype)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)

    def one(p, c, kind, x):
        if kind == "cross":
            return B.block_decode_cross(p, x, cfg, cache=c, pos=pos)[0]
        return B.block_decode(p, x, cfg, kind, cache=c, pos=pos)[0]

    for j, seg in enumerate(layer_plan(cfg)):
        seg_p, seg_c = params["segments"][j], caches[j]
        if seg.count == 1:
            x = one(seg_p, seg_c, seg.kind, x)
            continue
        for i in range(seg.count):
            x = one(_layer(seg_p, i), _layer(seg_c, i), seg.kind, x)
    return _logits(params, x, cfg, dtype), caches


# --------------------------------------------------------------------------
# shape declarations (meta tensors: no allocation)
# --------------------------------------------------------------------------

def cache_specs(cfg: ModelConfig, batch: int, seq: int):
    """``meta`` tensor + logical-name trees for the decode caches."""
    dtype = torch_dtype(cfg.dtype)
    shapes, names = [], []
    for seg in layer_plan(cfg):
        defs = B.cache_defs_for_kind(cfg, seg.kind, batch, seq)
        sh: Dict[str, Any] = {}
        nm: Dict[str, Any] = {}
        for key, (shape, lnames) in defs.items():
            dt = torch.float32 if ("state" in key or "xprev" in key) else dtype
            if seg.count > 1:
                sh[key] = meta((seg.count,) + shape, dt)
                nm[key] = ("layers",) + lnames
            else:
                sh[key] = meta(shape, dt)
                nm[key] = lnames
        shapes.append(sh)
        names.append(nm)
    return shapes, names


def input_specs(cfg: ModelConfig, shape: ShapeSpec):
    """Model inputs as ``meta`` tensors (+ logical names) for a cell.

    Stub frontends (whisper frames / VLM patches) appear here as
    precomputed embeddings.
    """
    b, s = shape.global_batch, shape.seq_len
    dtype = torch_dtype(cfg.dtype)
    ii = torch.int32
    specs: Dict[str, Any] = {}
    names: Dict[str, Any] = {}
    if shape.kind in ("train", "prefill"):
        specs["tokens"] = meta((b, s), ii)
        names["tokens"] = ("batch", "seq")
        if cfg.family == "encdec":
            specs["frames"] = meta((b, cfg.encoder_seq, cfg.d_model), dtype)
            names["frames"] = ("batch", "enc_seq", "embed")
        if cfg.family == "vlm":
            specs["memory"] = meta((b, cfg.vision_seq, cfg.d_model), dtype)
            names["memory"] = ("batch", "vision_seq", "embed")
    else:  # decode: one new token against a seq-long cache
        specs["token"] = meta((b, 1), ii)
        names["token"] = ("batch", None)
        specs["pos"] = meta((), ii)
        names["pos"] = ()
        cache_sh, cache_nm = cache_specs(cfg, b, s)
        specs["caches"] = cache_sh
        names["caches"] = cache_nm
    return specs, names
