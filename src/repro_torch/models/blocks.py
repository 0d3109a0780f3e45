"""Layer definitions for every architecture family of the model zoo.

Pure functions over trees of tensors, as in the JAX package: each
``*_defs`` returns a PD tree, each ``*_fwd`` consumes the matching
parameters. Weights arrive in their parameter dtype and are cast to the
activations' dtype where they are used. The products are plain
``torch.einsum``; prefill attention takes ``attention.attention``'s route
(the hand-written kernel on CUDA). The JAX package's ``constrain`` (a
sharding hint) has no counterpart on one card.

Dtype rule: JAX promotes bf16 with a non-weak f32 array to f32 whatever
its rank, where torch keeps bf16 beside a 0-dim f32 tensor; every mixed
product here has operands of rank >= 1, or casts explicitly.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..roofline import count
from .attention import attention, attention_decode, update_kv_cache
from .params import PD

__all__ = [
    "rmsnorm", "rope", "swiglu", "block_defs", "block_fwd", "block_decode",
    "block_decode_cross", "embed_defs", "moe_ffn", "moe_ffn_dense",
    "cache_defs_for_kind", "init_cache_shapes",
]


# --------------------------------------------------------------------------
# primitives
# --------------------------------------------------------------------------

def rmsnorm(x, scale, eps=1e-5):
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale).to(x.dtype)


def rope(x, positions, theta: float):
    """x: (B,S,H,D); positions: (B,S) or (S,)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs               # (B,S,half)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def swiglu(x, wi, wg, wo):
    h = F.silu(torch.einsum("bsd,df->bsf", x, wi))
    h = h * torch.einsum("bsd,df->bsf", x, wg)
    return torch.einsum("bsf,fd->bsd", h, wo)


def _mlp(m, x):
    return swiglu(x, m["wi"].to(x.dtype), m["wg"].to(x.dtype),
                  m["wo"].to(x.dtype))


# --------------------------------------------------------------------------
# attention sub-block
# --------------------------------------------------------------------------

def attn_defs(cfg: ModelConfig, cross: bool = False) -> Dict[str, PD]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    out = {
        "wq": PD((d, h, hd), ("p_embed", "p_heads", "p_head_dim")),
        "wk": PD((d, kv, hd), ("p_embed", "p_kv_heads", "p_head_dim")),
        "wv": PD((d, kv, hd), ("p_embed", "p_kv_heads", "p_head_dim")),
        "wo": PD((h, hd, d), ("p_heads", "p_head_dim", "p_embed"),
                 scale=1.0 / math.sqrt(2 * max(cfg.n_layers, 1))),
    }
    if cfg.qkv_bias:
        out["bq"] = PD((h, hd), ("p_heads", "p_head_dim"), init="zeros")
        out["bk"] = PD((kv, hd), ("p_kv_heads", "p_head_dim"), init="zeros")
        out["bv"] = PD((kv, hd), ("p_kv_heads", "p_head_dim"), init="zeros")
    if cross:
        out["gate"] = PD((), (), init="zeros")   # tanh-gated cross-attn
    return out


def _qkv(p, x, kv_x, cfg: ModelConfig):
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhe->bshe", kv_x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhe->bshe", kv_x, p["wv"].to(x.dtype))
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return q, k, v


def _gated(p, o):
    if "gate" in p:
        o = o * torch.tanh(p["gate"]).to(o.dtype)
    return o


def attn_fwd(p, x, cfg: ModelConfig, *, positions, window: int,
             causal: bool = True, kv_x=None, cross_positions=None,
             impl: Optional[str] = None):
    """Full-sequence attention (prefill). Returns (out, (k, v))."""
    kv_inp = x if kv_x is None else kv_x
    q, k, v = _qkv(p, x, kv_inp, cfg)
    if causal or kv_x is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions if cross_positions is None else cross_positions,
                 cfg.rope_theta)
    o = attention(q, k, v, causal=causal, window=window, impl=impl,
                  block_q=cfg.attn_block_q, block_kv=cfg.attn_block_kv)
    o = _gated(p, o)
    out = torch.einsum("bshe,hed->bsd", o, p["wo"].to(x.dtype))
    return out, (k, v)


def attn_decode_fwd(p, x, cfg: ModelConfig, *, cache, pos: torch.Tensor,
                    window: int, static_kv: bool = False):
    """One-token decode. cache = (k_cache, v_cache), written in place;
    pos = the write index, a 0-d int32 tensor on x's device."""
    q, k_new, v_new = _qkv(p, x, x, cfg)
    k_cache, v_cache = cache
    if static_kv:
        # cross-attention: the cache holds the projected memory
        o = attention_decode(q, k_cache, v_cache, window=0)
    else:
        posv = pos.reshape(1, 1).expand(x.shape[0], 1)
        q = rope(q, posv, cfg.rope_theta)
        k_new = rope(k_new, posv, cfg.rope_theta)
        k_cache, v_cache = update_kv_cache(k_cache, v_cache, k_new, v_new,
                                           pos)
        o = attention_decode(q, k_cache, v_cache, window=window,
                             valid_len=torch.clamp(pos + 1,
                                                   max=k_cache.shape[1]))
    o = _gated(p, o)
    out = torch.einsum("bshe,hed->bsd", o, p["wo"].to(x.dtype))
    return out, (k_cache, v_cache)


# --------------------------------------------------------------------------
# MoE FFN (capacity-buffer dispatch)
# --------------------------------------------------------------------------

def moe_defs(cfg: ModelConfig) -> Dict[str, Any]:
    d, ef, e = cfg.d_model, cfg.expert_d_ff, cfg.n_experts
    out = {
        "router": PD((d, e), ("p_embed", "experts")),
        "wi": PD((e, d, ef), ("experts", "p_embed", "p_expert_mlp")),
        "wg": PD((e, d, ef), ("experts", "p_embed", "p_expert_mlp")),
        "wo": PD((e, ef, d), ("experts", "p_expert_mlp", "p_embed"),
                 scale=1.0 / math.sqrt(2 * max(cfg.n_layers, 1))),
    }
    if cfg.n_shared_experts:
        sf = cfg.n_shared_experts * ef
        out["shared"] = {
            "wi": PD((d, sf), ("p_embed", "p_mlp")),
            "wg": PD((d, sf), ("p_embed", "p_mlp")),
            "wo": PD((sf, d), ("p_mlp", "p_embed"),
                     scale=1.0 / math.sqrt(2 * max(cfg.n_layers, 1))),
        }
    return out


def _aux_loss(logits, idx, e: int):
    """Switch-style load balancing: E * sum(mean prob * routed share)."""
    me = torch.softmax(logits, dim=-1).reshape(-1, e).mean(dim=0)
    # the routed counts as an int64 one-hot sum: bincount's exact values,
    # and it runs on meta tensors too
    ce = (F.one_hot(idx.reshape(-1), e).sum(dim=0).float()
          / idx.numel())
    return e * torch.sum(me * ce)


def moe_ffn_dense(p, x, cfg: ModelConfig) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Dense-dispatch MoE: every expert runs on every token, combined with
    the renormalized top-k gates."""
    e, k = cfg.n_experts, cfg.top_k
    logits = torch.einsum("bsd,de->bse", x,
                          p["router"].to(x.dtype)).float()
    gate_vals, idx = torch.topk(logits, k, dim=-1)
    gates_k = torch.softmax(gate_vals, dim=-1)
    gates = torch.einsum("bske,bsk->bse", F.one_hot(idx, e).float(), gates_k)
    aux = _aux_loss(logits, idx, e)
    h = F.silu(torch.einsum("bsd,edf->ebsf", x, p["wi"].to(x.dtype)))
    h = h * torch.einsum("bsd,edf->ebsf", x, p["wg"].to(x.dtype))
    y = torch.einsum("ebsf,efd->ebsd", h, p["wo"].to(x.dtype))
    out = torch.einsum("ebsd,bse->bsd", y, gates.to(x.dtype))
    if "shared" in p:
        out = out + _mlp(p["shared"], x)
    return out, aux.float()


def moe_ffn(p, x, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k capacity-buffer MoE. Returns (out, aux_loss)."""
    if cfg.moe_impl == "dense":
        return moe_ffn_dense(p, x, cfg)
    b, s, d = x.shape
    n = b * s
    e, k = cfg.n_experts, cfg.top_k
    cap = int(cfg.capacity_factor * n * k / e)
    cap = max(8, -(-cap // 8) * 8)
    xt = x.reshape(n, d)
    logits = torch.einsum("nd,de->ne", xt, p["router"].to(x.dtype)).float()
    gate_vals, idx = torch.topk(logits, k, dim=-1)            # (N,k)
    gates = torch.softmax(gate_vals, dim=-1)
    aux = _aux_loss(logits, idx, e)

    dev = x.device
    flat_e = idx.reshape(-1)                                  # (N*k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(e, device=dev))
    ranks = torch.empty(n * k, dtype=torch.int64, device=dev)
    ranks[order] = torch.arange(n * k, device=dev) - starts[sorted_e]
    keep = ranks < cap
    slot = torch.where(keep, flat_e * cap + ranks, e * cap)  # drop: sentinel
    tok = torch.arange(n, device=dev).repeat_interleave(k)
    buf = x.new_zeros((e * cap + 1, d))
    buf[slot] = xt[tok]
    buf = buf[:e * cap].reshape(e, cap, d)
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, p["wi"].to(x.dtype)))
    h = h * torch.einsum("ecd,edf->ecf", buf, p["wg"].to(x.dtype))
    y = torch.einsum("ecf,efd->ecd", h, p["wo"].to(x.dtype))
    y = torch.cat([y.reshape(e * cap, d), x.new_zeros((1, d))], dim=0)
    out_tok = y[slot] * gates.reshape(-1)[:, None].to(x.dtype)
    out = out_tok.reshape(n, k, d).sum(dim=1).reshape(b, s, d)
    if "shared" in p:
        out = out + _mlp(p["shared"], x)
    return out, aux.float()


# --------------------------------------------------------------------------
# RWKV6 time-mix / channel-mix (Finch: data-dependent decay)
# --------------------------------------------------------------------------

def rwkv_defs(cfg: ModelConfig) -> Dict[str, Any]:
    d, dff = cfg.d_model, cfg.d_ff
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    lora = 64
    return {
        "mu": PD((5, d), (None, "p_embed")),         # r,k,v,w,g token-shift
        "wr": PD((d, d), ("p_embed", "p_mlp")),
        "wk": PD((d, d), ("p_embed", "p_mlp")),
        "wv": PD((d, d), ("p_embed", "p_mlp")),
        "wg": PD((d, d), ("p_embed", "p_mlp")),
        "w0": PD((h, hd), ("p_heads", "p_head_dim"), init="zeros"),
        "wa": PD((d, lora), ("p_embed", None)),
        "wb": PD((lora, d), (None, "p_mlp")),
        "u": PD((h, hd), ("p_heads", "p_head_dim")),
        "ln_x": PD((d,), ("p_embed",), init="ones"),
        "wo": PD((d, d), ("p_mlp", "p_embed"),
                 scale=1.0 / math.sqrt(2 * max(cfg.n_layers, 1))),
        "cm_mu": PD((2, d), (None, "p_embed")),      # channel-mix shifts
        "cm_wk": PD((d, dff), ("p_embed", "p_mlp")),
        "cm_wv": PD((dff, d), ("p_mlp", "p_embed"),
                    scale=1.0 / math.sqrt(2 * max(cfg.n_layers, 1))),
        "cm_wr": PD((d, d), ("p_embed", "p_mlp")),
    }


def _token_shift(x, x_prev):
    """x: (B,S,D); x_prev: (B,D) last token of the previous segment."""
    return torch.cat([x_prev[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


def _time_steps(step, state, inputs, params=()):
    """Run ``step(state, inputs at t, *params) -> (state, y_t)`` over the
    time axis (dim 0 of every input); returns (state, ys stacked on dim
    0). The JAX package's blocked scan (``rwkv_scan_block``) runs the same
    steps in the same order, so one loop serves every block size. The
    loop is ``count.loop``'s, which a dry run's counter scales."""
    n_in = len(inputs)

    def body(t, carry, shared):
        state, y = step(carry[0], tuple(a[t] for a in shared[:n_in]),
                        *shared[n_in:])
        return (state,), y

    (state,), ys = count.loop(inputs[0].shape[0], body, (state,),
                              tuple(inputs) + tuple(params))
    return state, ys


def rwkv_time_mix(p, x, cfg: ModelConfig, state, x_prev):
    """state: (B,H,hd,hd) recurrent matrix; x_prev: (B,D).

    Returns (out, new_state, new_x_prev): the sequential recurrence over
    time, as the JAX package's model computes it.
    """
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    xs = _token_shift(x, x_prev)
    mu = p["mu"].to(x.dtype)
    xr, xk, xv, xw, xg = (x + (xs - x) * mu[i] for i in range(5))
    r = torch.einsum("bsd,de->bse", xr, p["wr"].to(x.dtype))
    k = torch.einsum("bsd,de->bse", xk, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,de->bse", xv, p["wv"].to(x.dtype))
    g = F.silu(torch.einsum("bsd,de->bse", xg, p["wg"].to(x.dtype)))
    # data-dependent decay (the Finch signature): w = exp(-exp(w0 + lora))
    dw = torch.einsum("bsd,dl,le->bse", xw, p["wa"].to(x.dtype),
                      p["wb"].to(x.dtype))
    w_log = -torch.exp(torch.clamp(
        p["w0"].reshape(-1).float() + dw.float(), -8.0, 4.0))  # (B,S,D)
    r, k, v = (a.reshape(b, s, h, hd) for a in (r, k, v))
    w = torch.exp(w_log).reshape(b, s, h, hd)           # decay in (0,1)
    u = p["u"].float()

    def step(S, inp, u):
        rt, kt, vt, wt = inp                            # (B,H,hd) each
        kv = torch.einsum("bhk,bhv->bhkv", kt, vt)
        yt = torch.einsum("bhk,bhkv->bhv", rt, S + u[None, :, :, None] * kv)
        return wt[..., None] * S + kv, yt

    new_state, ys = _time_steps(step, state.float(), tuple(
        a.permute(1, 0, 2, 3).float() for a in (r, k, v, w)), (u,))
    y = ys.permute(1, 0, 2, 3).reshape(b, s, d).to(x.dtype)
    y = rmsnorm(y, p["ln_x"].to(x.dtype), cfg.norm_eps) * g
    out = torch.einsum("bsd,de->bse", y, p["wo"].to(x.dtype))
    return out, new_state.float(), x[:, -1, :]


def rwkv_channel_mix(p, x, cfg: ModelConfig, x_prev):
    xs = _token_shift(x, x_prev)
    mu = p["cm_mu"].to(x.dtype)
    xk = x + (xs - x) * mu[0]
    xr = x + (xs - x) * mu[1]
    kk = torch.square(F.relu(
        torch.einsum("bsd,df->bsf", xk, p["cm_wk"].to(x.dtype))))
    rr = torch.sigmoid(
        torch.einsum("bsd,de->bse", xr, p["cm_wr"].to(x.dtype)))
    out = rr * torch.einsum("bsf,fd->bsd", kk, p["cm_wv"].to(x.dtype))
    return out, x[:, -1, :]


# --------------------------------------------------------------------------
# Hymba-style parallel SSM heads (diagonal selective state space)
# --------------------------------------------------------------------------

def ssm_defs(cfg: ModelConfig) -> Dict[str, PD]:
    d = cfg.d_model
    h = cfg.ssm_heads or cfg.n_heads
    hd = cfg.resolved_head_dim
    st = cfg.ssm_state
    return {
        "wx": PD((d, h, hd), ("p_embed", "p_heads", "p_head_dim")),
        "wdt": PD((d, h), ("p_embed", "p_heads")),
        "wB": PD((d, h, st), ("p_embed", "p_heads", "ssm_state")),
        "wC": PD((d, h, st), ("p_embed", "p_heads", "ssm_state")),
        "a_log": PD((h, st), ("p_heads", "ssm_state")),
        "skip": PD((h,), ("p_heads",), init="ones"),
        "wo": PD((h, hd, d), ("p_heads", "p_head_dim", "p_embed"),
                 scale=1.0 / math.sqrt(2 * max(cfg.n_layers, 1))),
    }


def ssm_fwd(p, x, cfg: ModelConfig, state):
    """state: (B,H,hd,st). Sequential selective scan; returns (out, state)."""
    xh = torch.einsum("bsd,dhe->bshe", x, p["wx"].to(x.dtype))
    dt = F.softplus(torch.einsum("bsd,dh->bsh", x,
                                 p["wdt"].to(x.dtype)).float())
    bb = torch.einsum("bsd,dhn->bshn", x, p["wB"].to(x.dtype))
    cc = torch.einsum("bsd,dhn->bshn", x, p["wC"].to(x.dtype))
    a = -torch.exp(p["a_log"].float())                  # (H,st), < 0

    def step(hstate, inp, a):
        xt, dtt, bt, ct = inp
        decay = torch.exp(dtt[..., None] * a[None])     # (B,H,st)
        upd = torch.einsum("bhe,bhn->bhen", xt, bt * dtt[..., None])
        hstate = hstate * decay[:, :, None, :] + upd
        return hstate, torch.einsum("bhen,bhn->bhe", hstate, ct)

    new_state, ys = _time_steps(step, state.float(), (
        xh.permute(1, 0, 2, 3).float(), dt.permute(1, 0, 2),
        bb.permute(1, 0, 2, 3).float(), cc.permute(1, 0, 2, 3).float()),
        (a,))
    y = ys.permute(1, 0, 2, 3)
    y = y + xh.float() * p["skip"].float()[None, None, :, None]
    out = torch.einsum("bshe,hed->bsd", y.to(x.dtype), p["wo"].to(x.dtype))
    return out, new_state.float()


# --------------------------------------------------------------------------
# block assembly per family
# --------------------------------------------------------------------------

def mlp_defs(cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict[str, PD]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "wi": PD((d, f), ("p_embed", "p_mlp")),
        "wg": PD((d, f), ("p_embed", "p_mlp")),
        "wo": PD((f, d), ("p_mlp", "p_embed"),
                 scale=1.0 / math.sqrt(2 * max(cfg.n_layers, 1))),
    }


def block_defs(cfg: ModelConfig, kind: str) -> Dict[str, Any]:
    """kind: dense | dense_swa | moe | moe_swa | rwkv | hybrid |
    hybrid_global | enc | dec | cross."""
    d = cfg.d_model
    ln = lambda: PD((d,), ("p_embed",), init="ones")  # noqa: E731
    if kind == "rwkv":
        return {"ln1": ln(), "tm": rwkv_defs(cfg), "ln2": ln(),
                "cm": {k: v for k, v in rwkv_defs(cfg).items()
                       if k.startswith("cm_")}}
    if kind in ("hybrid", "hybrid_global"):
        return {"ln1": ln(), "attn": attn_defs(cfg), "ssm": ssm_defs(cfg),
                "ln_attn": ln(), "ln_ssm": ln(),
                "ln2": ln(), "mlp": mlp_defs(cfg)}
    if kind in ("moe", "moe_swa"):
        return {"ln1": ln(), "attn": attn_defs(cfg), "ln2": ln(),
                "moe": moe_defs(cfg)}
    if kind == "dec":
        return {"ln1": ln(), "attn": attn_defs(cfg),
                "lnx": ln(), "xattn": attn_defs(cfg),
                "ln2": ln(), "mlp": mlp_defs(cfg)}
    if kind == "cross":
        return {"lnx": ln(), "xattn": attn_defs(cfg, cross=True),
                "ln2": ln(), "mlp": mlp_defs(cfg)}
    # dense / dense_swa / enc
    return {"ln1": ln(), "attn": attn_defs(cfg), "ln2": ln(),
            "mlp": mlp_defs(cfg, cfg.d_ff)}


def window_for(cfg: ModelConfig, kind: str) -> int:
    if kind.endswith("_swa") or kind == "hybrid":
        return cfg.sliding_window
    return 0


def _hybrid_mix(p, ao, so, cfg):
    return 0.5 * (rmsnorm(ao, p["ln_attn"], cfg.norm_eps)
                  + rmsnorm(so, p["ln_ssm"], cfg.norm_eps))


def block_fwd(p, x, cfg: ModelConfig, kind: str, *, positions,
              memory=None, impl: Optional[str] = None,
              carry: Optional[Dict[str, Any]] = None):
    """Full-sequence forward. Returns (x, aux_loss, new_carry); ``carry``
    holds the recurrent state of rwkv/ssm blocks."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_carry: Dict[str, Any] = {}
    window = window_for(cfg, kind)
    if kind == "rwkv":
        h, tm_state, xp = rwkv_time_mix(
            p["tm"], rmsnorm(x, p["ln1"], cfg.norm_eps), cfg,
            carry["tm_state"], carry["tm_xprev"])
        new_carry["tm_state"], new_carry["tm_xprev"] = tm_state, xp
        x = x + h
        h, xp2 = rwkv_channel_mix(p["cm"],
                                  rmsnorm(x, p["ln2"], cfg.norm_eps), cfg,
                                  carry["cm_xprev"])
        new_carry["cm_xprev"] = xp2
        return x + h, aux, new_carry
    if kind in ("hybrid", "hybrid_global"):
        xin = rmsnorm(x, p["ln1"], cfg.norm_eps)
        ao, _ = attn_fwd(p["attn"], xin, cfg, positions=positions,
                         window=window, impl=impl)
        so, sstate = ssm_fwd(p["ssm"], xin, cfg, carry["ssm_state"])
        new_carry["ssm_state"] = sstate
        x = x + _hybrid_mix(p, ao, so, cfg)
        x = x + _mlp(p["mlp"], rmsnorm(x, p["ln2"], cfg.norm_eps))
        return x, aux, new_carry
    if kind == "cross":
        h, _ = attn_fwd(p["xattn"], rmsnorm(x, p["lnx"], cfg.norm_eps), cfg,
                        positions=positions, window=0, causal=False,
                        kv_x=memory, impl=impl)
        x = x + h
        x = x + _mlp(p["mlp"], rmsnorm(x, p["ln2"], cfg.norm_eps))
        return x, aux, new_carry
    # attention blocks (dense / moe / enc / dec)
    h, _ = attn_fwd(p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps), cfg,
                    positions=positions, window=window,
                    causal=kind != "enc", impl=impl)
    x = x + h
    if kind == "dec":
        h, _ = attn_fwd(p["xattn"], rmsnorm(x, p["lnx"], cfg.norm_eps), cfg,
                        positions=positions, window=0, causal=False,
                        kv_x=memory, impl=impl)
        x = x + h
    if kind in ("moe", "moe_swa"):
        h, aux = moe_ffn(p["moe"], rmsnorm(x, p["ln2"], cfg.norm_eps), cfg)
        x = x + h
    else:
        x = x + _mlp(p["mlp"], rmsnorm(x, p["ln2"], cfg.norm_eps))
    return x, aux, new_carry


def block_decode(p, x, cfg: ModelConfig, kind: str, *, cache,
                 pos: torch.Tensor):
    """One-token decode. ``cache`` is a dict whose tensors are written in
    place (K/V at ring slot ``pos % capacity``, the recurrent state
    leaves replaced); returns (x, cache)."""
    window = window_for(cfg, kind)
    if kind == "rwkv":
        h, st, xp = rwkv_time_mix(p["tm"], rmsnorm(x, p["ln1"], cfg.norm_eps),
                                  cfg, cache["tm_state"], cache["tm_xprev"])
        cache["tm_state"].copy_(st)
        cache["tm_xprev"].copy_(xp)
        x = x + h
        h, xp2 = rwkv_channel_mix(p["cm"],
                                  rmsnorm(x, p["ln2"], cfg.norm_eps), cfg,
                                  cache["cm_xprev"])
        cache["cm_xprev"].copy_(xp2)
        return x + h, cache
    if kind in ("hybrid", "hybrid_global"):
        xin = rmsnorm(x, p["ln1"], cfg.norm_eps)
        ao, _ = attn_decode_fwd(p["attn"], xin, cfg,
                                cache=(cache["k"], cache["v"]), pos=pos,
                                window=window)
        so, sstate = ssm_fwd(p["ssm"], xin, cfg, cache["ssm_state"])
        cache["ssm_state"].copy_(sstate)
        x = x + _hybrid_mix(p, ao, so, cfg)
        x = x + _mlp(p["mlp"], rmsnorm(x, p["ln2"], cfg.norm_eps))
        return x, cache
    h, _ = attn_decode_fwd(p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps),
                           cfg, cache=(cache["k"], cache["v"]), pos=pos,
                           window=window)
    x = x + h
    if kind in ("dec", "cross"):
        # the projected memory (xk, xv) is read, never written
        h, _ = attn_decode_fwd(p["xattn"],
                               rmsnorm(x, p["lnx"], cfg.norm_eps), cfg,
                               cache=(cache["xk"], cache["xv"]), pos=pos,
                               window=0, static_kv=True)
        x = x + h
    if kind in ("moe", "moe_swa"):
        h, _ = moe_ffn(p["moe"], rmsnorm(x, p["ln2"], cfg.norm_eps), cfg)
        x = x + h
    else:
        x = x + _mlp(p["mlp"], rmsnorm(x, p["ln2"], cfg.norm_eps))
    return x, cache


def block_decode_cross(p, x, cfg: ModelConfig, *, cache, pos: torch.Tensor):
    """Decode through a VLM 'cross' block (no self-attention); its cache
    is read only."""
    h, _ = attn_decode_fwd(p["xattn"], rmsnorm(x, p["lnx"], cfg.norm_eps),
                           cfg, cache=(cache["xk"], cache["xv"]), pos=pos,
                           window=0, static_kv=True)
    x = x + h
    x = x + _mlp(p["mlp"], rmsnorm(x, p["ln2"], cfg.norm_eps))
    return x, cache


# --------------------------------------------------------------------------
# embeddings + cache shape declarations
# --------------------------------------------------------------------------

def embed_defs(cfg: ModelConfig) -> Dict[str, PD]:
    d = cfg.d_model
    out = {
        "tok": PD((cfg.vocab, d), ("vocab", "p_embed"), scale=1.0),
        "ln_f": PD((d,), ("p_embed",), init="ones"),
        "unembed": PD((d, cfg.vocab), ("p_embed", "vocab")),
    }
    if cfg.encoder_seq:
        out["enc_pos"] = PD((cfg.encoder_seq, d), ("enc_seq", "p_embed"),
                            scale=0.02)
    return out


def cache_defs_for_kind(cfg: ModelConfig, kind: str, batch: int,
                        seq: int) -> Dict[str, Tuple[Tuple[int, ...], Tuple]]:
    """Cache entry shapes + logical names for one block of ``kind``."""
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    h = cfg.ssm_heads or cfg.n_heads
    window = window_for(cfg, kind)
    s_eff = min(seq, window) if window else seq
    out: Dict[str, Tuple[Tuple[int, ...], Tuple]] = {}
    if kind == "rwkv":
        d = cfg.d_model
        out["tm_state"] = ((batch, cfg.n_heads, hd, hd),
                           ("batch", "heads", "head_dim", None))
        out["tm_xprev"] = ((batch, d), ("batch", "embed"))
        out["cm_xprev"] = ((batch, d), ("batch", "embed"))
        return out
    if kind in ("hybrid", "hybrid_global"):
        out["ssm_state"] = ((batch, h, hd, cfg.ssm_state),
                            ("batch", "heads", "head_dim", "ssm_state"))
    out["k"] = ((batch, s_eff, kv, hd),
                ("batch", "cache_seq", "kv_heads", "head_dim"))
    out["v"] = ((batch, s_eff, kv, hd),
                ("batch", "cache_seq", "kv_heads", "head_dim"))
    if kind in ("dec", "cross"):
        mem = cfg.encoder_seq or cfg.vision_seq
        out["xk"] = ((batch, mem, kv, hd),
                     ("batch", None, "kv_heads", "head_dim"))
        out["xv"] = ((batch, mem, kv, hd),
                     ("batch", None, "kv_heads", "head_dim"))
    if kind == "cross":
        out.pop("k"), out.pop("v")
    return out


def init_cache_shapes(cfg, kind, batch, seq):
    return cache_defs_for_kind(cfg, kind, batch, seq)
