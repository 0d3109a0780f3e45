"""Argument checks shared by the wrappers of the CUDA kernels.

A kernel reads raw pointers, so its wrapper checks every tensor's device,
dtype, shape, contiguity and alignment first and raises on what the
kernel does not take.
"""

from __future__ import annotations

import torch

__all__ = ["require_cuda", "check_tensor"]


def require_cuda(op: str, t) -> None:
    """Raise unless ``t`` is a tensor on a CUDA device."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{op}: the kernel takes CUDA tensors; use "
                         f"kernels.ops.{op} for CPU tensors")


def check_tensor(op: str, name: str, t, dtype: torch.dtype, shape,
                 device: torch.device, align: int = 1) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` whose data starts on an ``align``-byte boundary."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{op}: {name} must be a tensor, got "
                        f"{type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{op}: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{op}: {name} has dtype {t.dtype}, expected "
                        f"{dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{op}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{op}: {name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{op}: {name} must start on a {align}-byte "
                         f"boundary")
