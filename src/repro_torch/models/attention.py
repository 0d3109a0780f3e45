"""Attention of the model zoo: the JAX package's plain strategies, and
the route to the hand-written kernel.

* ``attention_scan``: blocked online softmax over KV blocks, causal and
  window masks added to every block (a causal mask still computes every
  block), as the JAX package's ``lax.scan``.
* ``attention_triangular``: query block i reads only the KV range its
  causal/window mask can reach.
* ``attention_decode``: q length 1 against a KV cache (full or a ring of
  capacity ``window``); plain torch on every device.
* ``attention(impl=None)``: on a CUDA tensor,
  ``kernels.ops.flash_attention`` (``csrc/flash_attention_sm90.cu`` in
  bf16, ``csrc/flash_attention_f32_sm90.cu`` in f32); on a CPU tensor,
  ``attention_scan``. ``impl="kernel"`` takes the op on any device (its
  plain ``ref.mha_reference`` on the CPU); ``"scan"`` and
  ``"triangular"`` are plain on any device. A shape the kernel refuses
  raises; nothing falls back.

All take q (B,S,H,D), k and v (B,Skv,KV,D) and fold query heads onto KV
heads, query head h reading KV head h // (H/KV). The arithmetic sits where
the JAX package has it: ``q * scale`` in q's dtype, the score product in
the input dtype before the cast to f32, softmax in f32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..kernels import ops

__all__ = ["attention", "attention_scan", "attention_triangular",
           "attention_decode", "update_kv_cache", "IMPLS"]

NEG_INF = -1e30
IMPLS = (None, "kernel", "scan", "triangular")


def _gqa_reshape(q, n_kv: int):
    """(B,S,H,D) -> (B,S,KV,G,D) where H = KV * G."""
    b, s, h, d = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, d)


def _scale(x, d: int):
    """``x * (1 / sqrt(d))`` in x's dtype, the factor first rounded to that
    dtype, as JAX multiplies by a weakly typed Python float."""
    return x * float(torch.tensor(1.0 / math.sqrt(d), dtype=x.dtype))


def _mask(q_pos, k_pos, causal: bool, window: int):
    """Additive (len(q_pos), len(k_pos)) f32 mask: 0 or -1e30."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def _online_update(carry, scores, vb):
    """Online-softmax accumulate: carry = (m, l, acc)."""
    m_prev, l_prev, acc = carry
    m_new = torch.maximum(m_prev, scores.amax(dim=-1))
    alpha = torch.exp(m_prev - m_new)
    p = torch.exp(scores - m_new[..., None])
    l_new = l_prev * alpha + p.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p, vb)
    return m_new, l_new, acc


def _pad_seq(x, n: int):
    """Zero-pad dim 1 of (B,S,...) by ``n``."""
    return torch.cat([x, x.new_zeros((x.shape[0], n) + x.shape[2:])], dim=1)


def attention_scan(q, k, v, *, causal: bool, window: int = 0,
                   block_q: int = 512, block_kv: int = 1024):
    """Blocked online-softmax attention; masked blocks still compute."""
    b, sq, h, d = q.shape
    skv, n_kv = k.shape[1], k.shape[2]
    g = h // n_kv
    bq, bkv = min(block_q, sq), min(block_kv, skv)
    nq, nkv = -(-sq // bq), -(-skv // bkv)
    pad_q, pad_kv = nq * bq - sq, nkv * bkv - skv
    if pad_q:
        q = _pad_seq(q, pad_q)
    if pad_kv:
        k, v = _pad_seq(k, pad_kv), _pad_seq(v, pad_kv)
    qr = _gqa_reshape(_scale(q, d), n_kv).reshape(b, nq, bq, n_kv, g, d)
    kr = k.reshape(b, nkv, bkv, n_kv, d)
    vr = v.reshape(b, nkv, bkv, n_kv, d)
    dev = q.device
    outs = []
    for qi in range(nq):
        qb = qr[:, qi]
        q_pos = qi * bq + torch.arange(bq, device=dev)
        m = torch.full((b, n_kv, g, bq), NEG_INF, dtype=torch.float32,
                       device=dev)
        carry = (m, torch.zeros_like(m),
                 torch.zeros((b, n_kv, g, bq, d), dtype=torch.float32,
                             device=dev))
        for kv_i in range(nkv):
            k_pos = kv_i * bkv + torch.arange(bkv, device=dev)
            s = torch.einsum("bqkgd,bskd->bkgqs", qb, kr[:, kv_i]).float()
            s = s + _mask(q_pos, k_pos, causal, window)
            s = torch.where(k_pos < skv, s, NEG_INF)     # padded kv tail
            carry = _online_update(carry, s, vr[:, kv_i].float())
        _, l, acc = carry
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.stack(outs, dim=1)                   # (B,nq,KV,G,bq,D)
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(b, nq * bq, h, d)
    return out[:, :sq].to(q.dtype)


def attention_triangular(q, k, v, *, causal: bool, window: int = 0,
                         block_q: int = 512, block_kv: int = 1024):
    """Unrolled triangular schedule: q block i reads only kv blocks that
    intersect its causal/window range."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    bq = min(block_q, sq)
    nq = -(-sq // bq)
    qr = _gqa_reshape(_scale(q, d), k.shape[2])
    offset = skv - sq               # cache prefix (prefill after a cache)
    dev = q.device
    outs = []
    for qi in range(nq):
        q_lo, q_hi = qi * bq, min(qi * bq + bq, sq)
        k_hi = (q_hi + offset) if causal else skv
        k_lo = max(0, q_lo + offset - window + 1) if window > 0 else 0
        s = torch.einsum("bqkgd,bskd->bkgqs", qr[:, q_lo:q_hi],
                         k[:, k_lo:k_hi]).float()
        s = s + _mask(torch.arange(q_lo, q_hi, device=dev) + offset,
                      torch.arange(k_lo, k_hi, device=dev), causal, window)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqs,bskd->bqkgd", p, v[:, k_lo:k_hi].float())
        outs.append(o.reshape(b, q_hi - q_lo, h, d))
    return torch.cat(outs, dim=1).to(q.dtype)


def _kernel_attention(q, k, v, *, causal: bool, window: int):
    """``kernels.ops.flash_attention`` in the model's (B,S,H,D) layout:
    the hand-written kernel on CUDA, ``ref.mha_reference`` on the CPU.
    Whole-length blocks meet its divisibility contract at any length."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError("attention: the kernel route has no backward; "
                           "pass impl='scan' to differentiate")
    sq, skv = q.shape[1], k.shape[1]
    if (causal or window > 0) and sq != skv:
        raise ValueError(f"attention: the kernel aligns queries to the end "
                         f"of the keys, the scan to the start; a masked "
                         f"call needs Sq == Skv, got {sq} and {skv}")
    o = ops.flash_attention(*(x.transpose(1, 2).contiguous()
                              for x in (q, k, v)),
                            causal=causal, window=window, block_q=sq,
                            block_kv=skv)
    return o.transpose(1, 2)


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              impl: Optional[str] = None, block_q: int = 512,
              block_kv: int = 1024):
    """q: (B,Sq,H,D); k,v: (B,Skv,KV,D) -> (B,Sq,H,D) in q's dtype.
    ``impl`` None routes by device (CUDA: the kernel; CPU: the scan)."""
    if impl not in IMPLS:
        raise ValueError(f"attention: impl {impl!r} not in {IMPLS}")
    if impl == "kernel" or (impl is None and q.device.type == "cuda"):
        return _kernel_attention(q, k, v, causal=causal, window=window)
    if impl == "triangular":
        return attention_triangular(q, k, v, causal=causal, window=window,
                                    block_q=block_q, block_kv=block_kv)
    return attention_scan(q, k, v, causal=causal, window=window,
                          block_q=block_q, block_kv=block_kv)


def attention_decode(q, k_cache, v_cache, *, window: int = 0,
                     valid_len=None):
    """Single-token decode: q (B,1,H,D) against a cache (B,S,KV,D).

    SWA caches are ring buffers of capacity == window, so they arrive here
    already window-sized; ``valid_len`` masks unwritten slots.
    """
    b, _, h, d = q.shape
    s, n_kv = k_cache.shape[1], k_cache.shape[2]
    if window > 0 and s > window:
        k_cache, v_cache = k_cache[:, s - window:], v_cache[:, s - window:]
        s = window
    qr = _gqa_reshape(_scale(q, d), n_kv)[:, 0]   # (B,KV,G,D)
    s_ = torch.einsum("bkgd,bskd->bkgs", qr, k_cache).float()
    if valid_len is not None:
        pos_k = torch.arange(s, device=q.device)
        s_ = torch.where(pos_k < valid_len, s_, NEG_INF)
    p = torch.softmax(s_, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return o.reshape(b, 1, h, d).to(q.dtype)


def update_kv_cache(k_cache, v_cache, k_new, v_new, pos: int):
    """New caches with K/V written at ring position ``pos % capacity``."""
    write = pos % k_cache.shape[1]
    k_cache, v_cache = k_cache.clone(), v_cache.clone()
    k_cache[:, write:write + 1] = k_new.to(k_cache.dtype)
    v_cache[:, write:write + 1] = v_new.to(v_cache.dtype)
    return k_cache, v_cache
