"""Plain torch versions of the package's kernels (the CPU path and the
oracle the kernels are held against on the card)."""

from __future__ import annotations

import math

import torch

__all__ = ["quack_reference", "mha_reference", "mha_split_p",
           "mha_split_tf32", "rwkv6_reference", "rwkv6_factored"]

MASK_VALUE = -1e30      # the masked score of the JAX package's attention


def _weigh(bitmaps: torch.Tensor, stakes: torch.Tensor) -> torch.Tensor:
    """(..., S, R, W) bool, stakes (..., R) -> (..., S, W) f32 stake sums,
    summed over r ascending.

    The same order as the CUDA kernel; each term is the stake or 0
    exactly, so the two agree bit for bit for any stakes.
    """
    acc = torch.zeros(bitmaps.shape[:-2] + bitmaps.shape[-1:],
                      dtype=torch.float32, device=bitmaps.device)
    for r in range(bitmaps.shape[-2]):
        st = stakes[..., r, None, None]            # (..., 1, 1)
        acc = acc + st * bitmaps[..., r, :].to(torch.float32)
    return acc


def _lane_thresh(x, like: torch.Tensor) -> torch.Tensor:
    """A threshold (float, () tensor or one per lane) shaped to broadcast
    against (..., S, W)."""
    x = torch.as_tensor(x, dtype=torch.float32, device=like.device)
    return x[..., None, None]


def quack_reference(claims, complaints, stakes, quack_thresh, dup_thresh,
                    *, compute_lost: bool = True):
    """QUACK aggregation oracle, in the lane form of the kernel or the
    reference's one-lane form.

    claims:     (B, S, R, W) or (S, R, W) bool — receiver r claims message
                w (to sender s)
    complaints: the same shape — repeat complaints (unused, may be
                ``None``, when ``compute_lost`` is false)
    stakes:     (B, R) or (R,) float32
    thresholds: (B,) tensors, or floats / () tensors
    Returns (quacked (B,S,W) bool, lost (B,S,W) bool or ``None``,
    prefix (B,S) int32), without the B axis in the one-lane form.
    """
    stakes = stakes.to(torch.float32)
    quacked = _weigh(claims, stakes) >= _lane_thresh(quack_thresh, claims)
    lost = None
    if compute_lost:
        lost = ((_weigh(complaints, stakes)
                 >= _lane_thresh(dup_thresh, claims)) & ~quacked)
    prefix = torch.cumprod(quacked.to(torch.int32), dim=-1).sum(dim=-1)
    return quacked, lost, prefix.to(torch.int32)


def _mask(s, *, causal: bool, window: int):
    """(..., Sq, Skv) scores with the masked keys at -1e30: query i at
    position Skv - Sq + i, key j masked when causal and j > position or
    when window > 0 and j <= position - window."""
    sq, skv = s.shape[-2:]
    q_pos = (skv - sq) + torch.arange(sq, device=s.device)[:, None]
    k_pos = torch.arange(skv, device=s.device)[None, :]
    ok = torch.ones((sq, skv), dtype=torch.bool, device=s.device)
    if causal:
        ok &= k_pos <= q_pos
    if window > 0:
        ok &= k_pos > q_pos - window
    return s.masked_fill(~ok, MASK_VALUE)


def _acc(x) -> torch.dtype:
    """The attention oracle's arithmetic: f32, or f64 for f64 inputs."""
    return torch.promote_types(x.dtype, torch.float32)


def _grouped(q, k):
    """q as (B,KV,H/KV,Sq,D) in ``_acc``, beside k's (B,KV,Skv,D)."""
    b, h, sq, d = q.shape
    n_kv = k.shape[1]
    return q.reshape(b, n_kv, h // n_kv, sq, d).to(_acc(q))


def _scores(q, k, *, causal: bool, window: int):
    """(B,KV,H/KV,Sq,Skv) scores of ``mha_reference`` in ``_acc``, masked
    with -1e30."""
    s = torch.einsum("bkgqd,bksd->bkgqs", _grouped(q, k), k.to(_acc(q)))
    return _mask(s / math.sqrt(q.shape[-1]), causal=causal, window=window)


def mha_reference(q, k, v, *, causal: bool = True, window: int = 0):
    """Attention oracle. q: (B,H,Sq,D); k,v: (B,KV,Skv,D), H % KV == 0;
    query head h reads kv head h // (H/KV).

    Returns (B,H,Sq,D) in q's dtype. Query i sits at position Skv - Sq + i
    (aligned to the end, as in a prefill after a cache); key j is masked
    with -1e30 when ``causal`` and j > position, or when ``window > 0`` and
    j <= position - window. Scores and softmax are f32 (f64 for f64
    inputs), so a row whose keys are all masked gets the uniform mean of
    v.
    """
    p = torch.softmax(_scores(q, k, causal=causal, window=window), dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.to(_acc(q)))
    return o.reshape(q.shape).to(q.dtype)


def mha_split_p(q, k, v, *, causal: bool = True, window: int = 0):
    """``mha_reference`` with the arithmetic the bf16 attention kernel
    promises: P = exp(s - max) in f32 (the kernel takes it as exp2 of
    (s - max) log2(e)), its row sum l from the f32 P, and P split into
    P_hi = bf16(P) and P_lo = bf16(P - P_hi) for the product with v,
    o = (P_hi v + P_lo v) / l. A plain oracle of the contract, called by
    tests and checks only, never on an op's path."""
    s = _scores(q, k, causal=causal, window=window)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    p_hi = p.to(torch.bfloat16).to(torch.float32)
    p_lo = (p - p_hi).to(torch.bfloat16).to(torch.float32)
    vf = v.to(torch.float32)
    o = (torch.einsum("bkgqs,bksd->bkgqd", p_hi, vf)
         + torch.einsum("bkgqs,bksd->bkgqd", p_lo, vf)) / l
    return o.reshape(q.shape).to(q.dtype)


def tf32_rn(x):
    """f32 ``x`` rounded to TF32 (10 mantissa bits) as ``cvt.rna.tf32.f32``
    rounds: to nearest, ties away from zero, on the bit pattern (add
    0x1000, clear the low 13 bits). Returns f32."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return torch.bitwise_and(bits + 0x1000, -0x2000).view(torch.float32)


def _split_tf32(x):
    """x = hi + lo with hi = tf32(x), lo = tf32(x - hi)."""
    hi = tf32_rn(x)
    return hi, tf32_rn(x.to(torch.float32) - hi)


def mha_split_tf32(q, k, v, *, causal: bool = True, window: int = 0):
    """``mha_reference`` with the split the f32 attention kernel makes:
    every product in three TF32 passes. q, k, v and P are split as
    x = hi + lo, hi = tf32(x), lo = tf32(x - hi) (``tf32_rn``);
    S = Q_hi K_hi^T + (Q_hi K_lo^T + Q_lo K_hi^T) in f32, times the f32
    reciprocal of sqrt(D), masked with -1e30; P = exp(S - max) in f32 and l
    its row sum; O = (P_hi V_hi + (P_hi V_lo + P_lo V_hi)) / max(l, 1e-30).
    The sums here round to nearest over whole rows. The kernel's tensor
    cores round toward zero as they accumulate, which this does not model:
    the kernel keeps that drift inside 2e-6 by starting each 64-key tile's
    P V from zero (``tests/test_torch_kernels.py`` models the truncation).
    A plain oracle of the split, called by tests and checks only, never
    on an op's path."""
    d = q.shape[-1]

    def product(eq, a, b):
        (a_hi, a_lo), (b_hi, b_lo) = _split_tf32(a), _split_tf32(b)
        small = torch.einsum(eq, a_hi, b_lo) + torch.einsum(eq, a_lo, b_hi)
        return torch.einsum(eq, a_hi, b_hi) + small

    s = product("bkgqd,bksd->bkgqs", _grouped(q, k), k)
    scale = 1.0 / torch.tensor(math.sqrt(d), dtype=torch.float32)
    s = _mask(s * scale.to(s.device), causal=causal, window=window)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = product("bkgqs,bksd->bkgqd", p, v) / l.clamp(min=1e-30)
    return o.reshape(q.shape).to(q.dtype)


def rwkv6_reference(r, k, v, w, u, state=None):
    """RWKV6 (Finch) recurrence, one step at a time, in f32 from any type.

    r,k,v,w: (B,H,T,D), w the per-step decay in (0,1); u: (H,D) bonus;
    state: (B,H,D,D) or ``None`` for zeros. Returns ``(y (B,H,T,D) f32,
    final_state (B,H,D,D) f32)``::

      y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
      S_t = diag(w_t) S_{t-1} + k_t^T v_t
    """
    b, h, t, d = r.shape
    r, k, v, w = (x.to(torch.float32) for x in (r, k, v, w))
    bonus = u.to(torch.float32)[None, :, :, None]
    S = (torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
         if state is None else state.to(torch.float32))
    y = torch.empty((b, h, t, d), dtype=torch.float32, device=r.device)
    for i in range(t):
        kv = k[:, :, i, :, None] * v[:, :, i, None, :]
        y[:, :, i] = torch.einsum("bhk,bhkv->bhv", r[:, :, i], S + bonus * kv)
        S = w[:, :, i, :, None] * S + kv
    return y, S


def rwkv6_factored(r, k, v, w, u):
    """``rwkv6_reference``'s y with the arithmetic the CUDA kernel
    promises: the u bonus factored out of the (D,D) work,

      y_t[j] = r_t . S_{t-1}[:, j] + v_t[j] q_t,  q_t = sum_i r_t[i] u[i] k_t[i]

    and S_t = diag(w_t) S_{t-1} + k_t^T v_t, in f32 from a zero state. A
    plain oracle of the contract, called by tests and checks only, never
    on an op's path. Returns y (B,H,T,D) f32."""
    b, h, t, d = r.shape
    r, k, v, w = (x.to(torch.float32) for x in (r, k, v, w))
    uf = u.to(torch.float32)[None]
    S = torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
    y = torch.empty((b, h, t, d), dtype=torch.float32, device=r.device)
    for i in range(t):
        q = (r[:, :, i] * uf * k[:, :, i]).sum(-1, keepdim=True)
        y[:, :, i] = (torch.einsum("bhk,bhkv->bhv", r[:, :, i], S)
                      + v[:, :, i] * q)
        S = w[:, :, i, :, None] * S + k[:, :, i, :, None] * v[:, :, i, None, :]
    return y
