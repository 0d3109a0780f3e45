"""Public entry points of the kernels.

The rule for every op: a CPU tensor goes to the plain torch version, a
CUDA tensor goes to the hand-written kernel, which launches or raises.
There is no fallback from the kernel to the plain version.
"""

from __future__ import annotations

import torch

from .flash_attention import check_attention_args
from .flash_attention import flash_attention as _cuda_flash_attention
from .quack_scan import quack_scan as _cuda_quack_scan
from .ref import mha_reference, quack_reference, rwkv6_reference
from .rwkv6_scan import check_rwkv6_args
from .rwkv6_scan import rwkv6_chunked as _cuda_rwkv6_chunked

__all__ = ["quack_scan", "flash_attention", "rwkv6_chunked"]


def _no_kernel(op: str, dev: torch.device) -> ValueError:
    return ValueError(f"{op}: no kernel for device {dev}")


def quack_scan(claims: torch.Tensor, complaints, stakes: torch.Tensor,
               quack_thresh, dup_thresh, *, compute_lost: bool = True):
    """Stake-weighted QUACK / loss quorums and the quacked prefix.

    The reference's form: claims/complaints (S,R,W) bool, stakes (R,)
    float32, thresholds floats or () float32 tensors; returns
    ``(quacked (S,W) bool, lost (S,W) bool or None, prefix (S,) int32)``.
    The lane form puts B independent lanes in front: claims/complaints
    (B,S,R,W), stakes (B,R), thresholds (B,) tensors; outputs (B,S,W) and
    (B,S). Both are one launch of the same kernel. ``lost`` is ``None``
    when ``compute_lost`` is false, and ``complaints`` may then be
    ``None``.
    """
    dev = claims.device
    if dev.type == "cpu":
        return quack_reference(claims, complaints, stakes, quack_thresh,
                               dup_thresh, compute_lost=compute_lost)
    if dev.type != "cuda":
        raise _no_kernel("quack_scan", dev)

    def thr(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    return _cuda_quack_scan(
        claims, complaints, stakes, thr(quack_thresh),
        thr(dup_thresh) if compute_lost else None,
        compute_lost=compute_lost)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, block_q: int = 128,
                    block_kv: int = 128) -> torch.Tensor:
    """Attention with f32 softmax: q (B,H,Sq,D), k/v (B,KV,Skv,D) ->
    (B,H,Sq,D) in q's dtype.

    Query positions are aligned to the end of the keys; ``causal`` masks
    later keys and ``window > 0`` keys at or beyond ``window`` positions
    back. Sq and Skv must be multiples of min(block, length) and H of KV
    (``ValueError`` otherwise), as in the JAX kernel.
    """
    check_attention_args(q, k, v, block_q, block_kv)
    dev = q.device
    if dev.type == "cpu":
        return mha_reference(q, k, v, causal=causal, window=window)
    if dev.type != "cuda":
        raise _no_kernel("flash_attention", dev)
    return _cuda_flash_attention(q, k, v, causal=causal, window=window,
                                 block_q=block_q, block_kv=block_kv)


def rwkv6_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor, *,
                  chunk: int = 128) -> torch.Tensor:
    """The RWKV6 recurrence from a zero state: r,k,v,w (B,H,T,D), u (H,D)
    -> y (B,H,T,D) float32. T must be a multiple of ``chunk``
    (``ValueError`` otherwise), as in the JAX kernel."""
    check_rwkv6_args(r, k, v, w, u, chunk)
    dev = r.device
    if dev.type == "cpu":
        return rwkv6_reference(r, k, v, w, u)[0]
    if dev.type != "cuda":
        raise _no_kernel("rwkv6_chunked", dev)
    return _cuda_rwkv6_chunked(r, k, v, w, u, chunk=chunk)
