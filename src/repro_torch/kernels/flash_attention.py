"""Attention on the GPU: the wrapper of the two attention kernels.

Online-softmax attention over q (B,H,Sq,D) and k, v (B,KV,Skv,D), causal
and/or with a sliding window, query head h reading kv head h // (H/KV),
query positions aligned to the end of the keys (Skv - Sq + i), masked
scores -1e30, f32 sums, output in q's dtype.

The route is fixed by dtype, before launch: bfloat16 goes to
``csrc/flash_attention_sm90.cu`` (wgmma and TMA, P split into two bf16
halves), float32 to ``csrc/flash_attention_f32_sm90.cu`` (wgmma and TMA
in three TF32 passes, each operand split into two tf32 halves, after a
pre-pass that splits k and transposes v into a workspace). Both are CUDA
C++ for Hopper, built with ``nvcc`` at first use (``kernels.build``) and
launched on PyTorch's current stream; a failed build or launch raises.
Their plain torch version is ``kernels.ref.mha_reference``;
``ref.mha_split_p`` and ``ref.mha_split_tf32`` are the two kernels'
splits. ``kernels.ops.flash_attention`` picks between kernel and
plain version by the device of the tensors.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .build import load_library
from .checks import check_tensor, require_cuda

__all__ = ["flash_attention", "check_attention_args"]

_HEAD_DIMS = (16, 32, 64, 128)
# dtype -> the source under csrc/ whose kernel serves it
ROUTES = {torch.bfloat16: "flash_attention_sm90",
          torch.float32: "flash_attention_f32_sm90"}
_F32 = ROUTES[torch.float32]
_MAX_BH = 65535            # the grid's y extent


@functools.cache
def _entry(name: str):
    lib = load_library(name)
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p])
    if name == _F32:                   # + the workspace
        fn.argtypes += [ctypes.c_void_p]
        size = lib.flash_attention_f32_sm90_workspace
        size.argtypes = [ctypes.c_int] * 4
        size.restype = ctypes.c_longlong
        fn.workspace = size
    fn.restype = ctypes.c_int
    return fn


def check_attention_args(q, k, v, block_q: int, block_kv: int) -> None:
    """The JAX kernel's contract, raised as ``ValueError``: q (B,H,Sq,D),
    k and v (B,KV,Skv,D) with H % KV == 0, Sq a multiple of
    min(block_q, Sq) and Skv a multiple of min(block_kv, Skv)."""
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"flash_attention: expected q (B,H,Sq,D) and k, v "
                         f"(B,KV,Skv,D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    bk, n_kv, skv, dk = k.shape
    if bk != b or dk != d or min(b, h, sq, d, n_kv, skv) <= 0:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not fit together")
    if h % n_kv:
        raise ValueError(f"flash_attention: H = {h} is not a multiple of "
                         f"KV = {n_kv}")
    bq, bkv = min(block_q, sq), min(block_kv, skv)
    if bq <= 0 or bkv <= 0 or sq % bq or skv % bkv:
        raise ValueError(f"flash_attention: Sq = {sq} and Skv = {skv} must "
                         f"be multiples of the blocks {bq} and {bkv}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, block_q: int = 128,
                    block_kv: int = 128) -> torch.Tensor:
    """Launch the dtype's CUDA kernel (``ROUTES``). All tensors lie on one
    CUDA device, are contiguous, and share one dtype, float32 or bfloat16;
    D is 16, 32, 64 or 128. ``block_q``/``block_kv`` only set the
    divisibility contract: the kernels tile by their own sizes and mask
    ragged edges themselves. Returns (B,H,Sq,D) in q's dtype."""
    require_cuda("flash_attention", q)
    check_attention_args(q, k, v, block_q, block_kv)
    b, h, sq, d = q.shape
    n_kv, skv = k.shape[1], k.shape[2]
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in "
                         f"{_HEAD_DIMS}")
    if q.dtype not in ROUTES:
        raise TypeError(f"flash_attention: dtype {q.dtype} is not float32 "
                        f"or bfloat16")
    if b * h > _MAX_BH:
        raise ValueError(f"flash_attention: B*H = {b * h} exceeds {_MAX_BH}")
    check = functools.partial(check_tensor, "flash_attention", align=16)
    check("q", q, q.dtype, q.shape, q.device)
    check("k", k, q.dtype, k.shape, q.device)
    check("v", v, q.dtype, k.shape, q.device)
    route = ROUTES[q.dtype]
    # a window at least Skv masks nothing; clamping keeps int32 positions
    window = min(int(window), skv) if window > 0 else 0

    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        fn = _entry(route)
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h,
                n_kv, sq, skv, d, int(bool(causal)), window, math.sqrt(d),
                stream]
        if route == _F32:
            ws = torch.empty(fn.workspace(b, n_kv, skv, d),
                             dtype=torch.float32, device=q.device)
            args.append(ws.data_ptr())
        rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"flash_attention: {route} launch failed with "
                           f"CUDA error {rc}")
    flash_attention.launches += 1
    if route == "flash_attention_sm90":
        flash_attention.launches_sm90 += 1
    else:
        flash_attention.launches_f32 += 1
    return o


# launches of the kernels: all, then by route (bf16 on
# flash_attention_sm90.cu, f32 on flash_attention_f32_sm90.cu)
flash_attention.launches = 0
flash_attention.launches_sm90 = 0
flash_attention.launches_f32 = 0
