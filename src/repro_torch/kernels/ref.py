"""Plain torch versions of the package's kernels (the CPU path and the
oracle the kernels are held against on the card)."""

from __future__ import annotations

import torch

__all__ = ["quack_reference"]


def _weigh(bitmaps: torch.Tensor, stakes: torch.Tensor) -> torch.Tensor:
    """(S,R,W) bool -> (S,W) f32 stake sums, summed over r ascending.

    The same order as the CUDA kernel; each term is the stake or 0
    exactly, so the two agree bit for bit for any stakes.
    """
    acc = torch.zeros((bitmaps.shape[0], bitmaps.shape[2]),
                      dtype=torch.float32, device=bitmaps.device)
    for r in range(bitmaps.shape[1]):
        acc = acc + stakes[r] * bitmaps[:, r, :].to(torch.float32)
    return acc


def quack_reference(claims, complaints, stakes, quack_thresh, dup_thresh,
                    *, compute_lost: bool = True):
    """QUACK aggregation oracle.

    claims:     (S, R, W) bool — receiver r claims message w (to sender s)
    complaints: (S, R, W) bool — repeat complaints (unused, may be
                ``None``, when ``compute_lost`` is false)
    stakes:     (R,) float32
    Returns (quacked (S,W) bool, lost (S,W) bool or ``None``,
    prefix (S,) int32).
    """
    stakes = stakes.to(torch.float32)
    quacked = _weigh(claims, stakes) >= quack_thresh
    lost = None
    if compute_lost:
        lost = (_weigh(complaints, stakes) >= dup_thresh) & ~quacked
    prefix = torch.cumprod(quacked.to(torch.int32), dim=1).sum(dim=1)
    return quacked, lost, prefix.to(torch.int32)
