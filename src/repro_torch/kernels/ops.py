"""Public entry points of the kernels.

The rule for every op: a CPU tensor goes to the plain torch version, a
CUDA tensor goes to the hand-written kernel, which launches or raises.
There is no fallback from the kernel to the plain version.
"""

from __future__ import annotations

import torch

from .quack_scan import quack_scan as _cuda_quack_scan
from .ref import quack_reference

__all__ = ["quack_scan"]


def quack_scan(claims: torch.Tensor, complaints, stakes: torch.Tensor,
               quack_thresh, dup_thresh, *, compute_lost: bool = True):
    """Stake-weighted QUACK / loss quorums and the quacked prefix.

    claims/complaints: (S,R,W) bool; stakes: (R,) float32; thresholds
    are floats or () float32 tensors. Returns ``(quacked (S,W) bool,
    lost (S,W) bool or None, prefix (S,) int32)``; ``lost`` is ``None``
    when ``compute_lost`` is false, and ``complaints`` may then be
    ``None``.
    """
    dev = claims.device
    if dev.type == "cpu":
        return quack_reference(claims, complaints, stakes, quack_thresh,
                               dup_thresh, compute_lost=compute_lost)
    if dev.type != "cuda":
        raise ValueError(f"quack_scan: no kernel for device {dev}")

    def thr(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    return _cuda_quack_scan(
        claims, complaints, stakes, thr(quack_thresh),
        thr(dup_thresh) if compute_lost else None,
        compute_lost=compute_lost)
