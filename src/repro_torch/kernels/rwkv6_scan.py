"""The RWKV6 recurrence on the GPU: the wrapper of ``csrc/rwkv6_scan.cu``.

Per (b, h), from a zero (D,D) f32 state::

    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
    S_t = diag(w_t) S_{t-1} + k_t^T v_t

The kernel is CUDA C++ for Hopper, built with ``nvcc`` at first use
(``kernels.build``) and launched on PyTorch's current stream. One block
owns a (b, h) and keeps S in registers, a 4 x 8 tile a thread; r, k, w, v
arrive through ``cp.async.bulk`` copies into three shared-memory stages.
It computes the bonus factored as ``y_j = r S_{t-1}[:, j] + v_j q`` with
``q = sum_i r_i u_i k_i``, the arithmetic of ``kernels.ref.
rwkv6_factored``. Its plain torch version is ``kernels.ref.
rwkv6_reference``; ``kernels.ops.rwkv6_chunked`` picks between the two by
the device of the tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import load_library
from .checks import check_tensor, require_cuda

__all__ = ["rwkv6_chunked", "check_rwkv6_args"]

_HEAD_DIMS = (16, 32, 64, 128)
_BF16 = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _entry():
    fn = load_library("rwkv6_scan").rwkv6_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def check_rwkv6_args(r, k, v, w, u, chunk: int) -> None:
    """The JAX kernel's contract, raised as ``ValueError``: r, k, v, w
    (B,H,T,D), u (H,D), T a multiple of ``chunk``."""
    if r.dim() != 4 or any(tuple(x.shape) != tuple(r.shape)
                           for x in (k, v, w)):
        raise ValueError(f"rwkv6_chunked: r, k, v, w must share one "
                         f"(B,H,T,D) shape, got {tuple(r.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(w.shape)}")
    b, h, t, d = r.shape
    if tuple(u.shape) != (h, d):
        raise ValueError(f"rwkv6_chunked: u has shape {tuple(u.shape)}, "
                         f"expected {(h, d)}")
    if min(b, h, t, d) <= 0 or chunk <= 0 or t % chunk:
        raise ValueError(f"rwkv6_chunked: T = {t} must be a positive "
                         f"multiple of chunk = {chunk}")


def rwkv6_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor, *,
                  chunk: int = 128) -> torch.Tensor:
    """Launch the CUDA kernel. All five tensors lie on one CUDA device,
    are contiguous, start on a 16-byte boundary (the bulk copies' unit) and
    share one dtype, float32 or bfloat16; D is 16, 32, 64 or 128.
    ``chunk`` only sets the contract T % chunk == 0: the state never
    leaves the kernel's registers. Returns y (B,H,T,D) float32."""
    require_cuda("rwkv6_chunked", r)
    check_rwkv6_args(r, k, v, w, u, chunk)
    b, h, t, d = r.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"rwkv6_chunked: head dim {d} not in "
                         f"{_HEAD_DIMS}")
    if r.dtype not in _BF16:
        raise TypeError(f"rwkv6_chunked: dtype {r.dtype} is not float32 or "
                        f"bfloat16")
    check = functools.partial(check_tensor, "rwkv6_chunked")
    for name, x in (("r", r), ("k", k), ("v", v), ("w", w)):
        check(name, x, r.dtype, r.shape, r.device, align=16)
    check("u", u, r.dtype, (h, d), r.device, align=16)

    y = torch.empty((b, h, t, d), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = _entry()(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                      u.data_ptr(), y.data_ptr(), b * h, h, t, d,
                      _BF16[r.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"rwkv6_chunked: kernel launch failed with CUDA "
                           f"error {rc}")
    rwkv6_chunked.launches += 1
    return y


# launches of the kernel
rwkv6_chunked.launches = 0
