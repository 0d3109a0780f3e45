"""Error-feedback int8 compression for the DCN-crossing sync segment.

Beyond-paper optimization: the cross-pod step of the picsou schedule
moves 1/D-sized f32 shards over the slow links; quantizing that segment
to int8 with per-block scales and an error-feedback residual cuts DCN
bytes another ~4x with provably bounded bias accumulation (the residual
re-enters the next step's gradient, standard EF-SGD).

The arithmetic is the JAX package's, op for op: true divisions (never a
multiply by a reciprocal, on the CPU or the card) and round half to
even, so q, scales and residuals are bit-identical to it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..tree_util import tree_map

__all__ = ["make_ef_state", "ef_int8_compress", "ef_int8_decompress"]

BLOCK = 256


def make_ef_state(tree):
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), tree)


def _quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, int]:
    flat = x.reshape(-1).to(torch.float32)
    pad = (-flat.shape[0]) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, BLOCK)
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by
    # its reciprocal, which can differ from the division in the last bit
    scale = blocks.abs().amax(dim=1, keepdim=True) / torch.full(
        (), 127.0, device=blocks.device)
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale, pad


def _dequant(q: torch.Tensor, scale: torch.Tensor, pad: int,
             shape) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def ef_int8_compress(grad: torch.Tensor, residual: torch.Tensor):
    """Returns ((q, scale, pad), new_residual). grad+residual is quantized;
    the quantization error becomes the next residual."""
    target = grad.to(torch.float32) + residual
    q, scale, pad = _quant(target)
    deq = _dequant(q, scale, pad, grad.shape)
    return (q, scale, pad), target - deq


def ef_int8_decompress(packed, shape) -> torch.Tensor:
    q, scale, pad = packed
    return _dequant(q, scale, pad, shape)
