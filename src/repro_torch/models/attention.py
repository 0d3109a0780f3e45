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
  raises; nothing falls back. The kernel route is differentiable: its
  backward is ``scan_backward``, the gradient of ``attention_scan`` (what
  the JAX package differentiates) recomputed from the saved q, k, v one
  query block at a time.

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
from ..roofline import count

__all__ = ["attention", "attention_scan", "attention_triangular",
           "attention_decode", "update_kv_cache", "scan_backward", "IMPLS"]

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


def _scan_operands(q, k, v, block_q: int, block_kv: int):
    """The scan's blocked operands: q scaled and padded as (B,nq,bq,KV,G,D),
    k and v padded as (B,nkv,bkv,KV,D), and (bq, bkv, nq, nkv)."""
    b, sq, h, d = q.shape
    skv, n_kv = k.shape[1], k.shape[2]
    bq, bkv = min(block_q, sq), min(block_kv, skv)
    nq, nkv = -(-sq // bq), -(-skv // bkv)
    pad_q, pad_kv = nq * bq - sq, nkv * bkv - skv
    if pad_q:
        q = _pad_seq(q, pad_q)
    if pad_kv:
        k, v = _pad_seq(k, pad_kv), _pad_seq(v, pad_kv)
    qr = _gqa_reshape(_scale(q, d), n_kv).reshape(b, nq, bq, n_kv,
                                                  h // n_kv, d)
    kr = k.reshape(b, nkv, bkv, n_kv, d)
    vr = v.reshape(b, nkv, bkv, n_kv, d)
    return qr, kr, vr, (bq, bkv, nq, nkv)


def _scan_block(qr, kr, vr, qi: int, blocks, skv: int, causal: bool,
                window: int):
    """Query block ``qi`` of the scan: (B,KV,G,bq,D) in f32."""
    b, _, _, n_kv, g, d = qr.shape
    bq, bkv, _, nkv = blocks
    qb = qr[:, qi]
    dev = qr.device
    q_pos = qi * bq + torch.arange(bq, device=dev)
    m = torch.full((b, n_kv, g, bq), NEG_INF, dtype=torch.float32,
                   device=dev)
    carry = (m, torch.zeros_like(m),
             torch.zeros((b, n_kv, g, bq, d), dtype=torch.float32,
                         device=dev))

    def body(kv_i, carry, shared):
        qb, kr, vr = shared
        k_pos = kv_i * bkv + torch.arange(bkv, device=dev)
        s = torch.einsum("bqkgd,bskd->bkgqs", qb, kr[:, kv_i]).float()
        s = s + _mask(q_pos, k_pos, causal, window)
        s = torch.where(k_pos < skv, s, NEG_INF)     # padded kv tail
        return _online_update(carry, s, vr[:, kv_i].float()), None

    (_, l, acc), _ = count.loop(nkv, body, carry, (qb, kr, vr))
    return acc / torch.clamp(l, min=1e-30)[..., None]


def attention_scan(q, k, v, *, causal: bool, window: int = 0,
                   block_q: int = 512, block_kv: int = 1024):
    """Blocked online-softmax attention; masked blocks still compute."""
    b, sq, h, d = q.shape
    qr, kr, vr, blocks = _scan_operands(q, k, v, block_q, block_kv)
    bq, nq = blocks[0], blocks[2]

    def body(qi, carry, shared):
        return carry, _scan_block(*shared, qi, blocks, k.shape[1], causal,
                                  window)

    _, out = count.loop(nq, body, (), (qr, kr, vr), dim=1)
    # out: (B,nq,KV,G,bq,D)
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(b, nq * bq, h, d)
    return out[:, :sq].to(q.dtype)


def scan_backward(q, k, v, do, *, causal: bool, window: int = 0,
                  block_q: int = 512, block_kv: int = 1024):
    """dQ, dK, dV of ``attention_scan`` for the output gradient ``do``,
    recomputed one query block at a time: block ``qi``'s part of the scan
    is rebuilt from q, k, v and differentiated alone, so only one block's
    scores are alive at once. dQ's blocks are disjoint; dK and dV sum
    the blocks' parts in the scan's own order (the last query block
    first, in the inputs' dtype), which is the order autograd sums them
    in when it differentiates the whole scan."""
    b, sq, h, d = q.shape
    n_kv = k.shape[2]
    with torch.enable_grad():
        q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
        qr, kr, vr, blocks = _scan_operands(q, k, v, block_q, block_kv)
        bq, nq = blocks[0], blocks[2]
        # the output gradient as the scan's per-block layout sees it
        g = do.to(torch.float32)
        if nq * bq > sq:
            g = _pad_seq(g, nq * bq - sq)
        g = g.reshape(b, nq, bq, n_kv, h // n_kv, d).permute(0, 1, 3, 4, 2,
                                                            5)
        dq = dk = dv = None
        for qi in reversed(range(nq)):
            out = _scan_block(qr, kr, vr, qi, blocks, k.shape[1], causal,
                              window)
            gq, gk, gv = torch.autograd.grad(out, (q, k, v), g[:, qi],
                                             retain_graph=qi > 0)
            dq = gq if dq is None else dq + gq
            dk = gk if dk is None else dk + gk
            dv = gv if dv is None else dv + gv
            del out
    return dq, dk, dv


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


def _kernel_forward(q, k, v, *, causal: bool, window: int):
    """``kernels.ops.flash_attention`` in the model's (B,S,H,D) layout:
    the hand-written kernel on CUDA, ``ref.mha_reference`` on the CPU.
    Whole-length blocks meet its divisibility contract at any length."""
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


class _KernelAttention(torch.autograd.Function):
    """The kernel route under autograd: the forward is the kernel
    (``_kernel_forward``); the backward is the gradient of
    ``attention_scan`` with the same masks and blocks, recomputed from the
    saved q, k, v one query block at a time (``scan_backward``). The JAX
    package has no backward kernel: it differentiates that same scan."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, block_q, block_kv):
        ctx.save_for_backward(q, k, v)
        ctx.args = dict(causal=causal, window=window, block_q=block_q,
                        block_kv=block_kv)
        return _kernel_forward(q, k, v, causal=causal, window=window)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        with torch.profiler.record_function("attention.scan_backward"):
            grads = scan_backward(q, k, v, do, **ctx.args)
        return tuple(g if need else None for g, need in
                     zip(grads, ctx.needs_input_grad)) + (None,) * 4


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              impl: Optional[str] = None, block_q: int = 512,
              block_kv: int = 1024):
    """q: (B,Sq,H,D); k,v: (B,Skv,KV,D) -> (B,Sq,H,D) in q's dtype.
    ``impl`` None routes by device (CUDA: the kernel; CPU: the scan)."""
    if impl not in IMPLS:
        raise ValueError(f"attention: impl {impl!r} not in {IMPLS}")
    if impl == "kernel" or (impl is None and q.device.type == "cuda"):
        return _KernelAttention.apply(q, k, v, causal, window, block_q,
                                      block_kv)
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
