"""Learning-rate schedules."""

from __future__ import annotations

import math

import torch

__all__ = ["cosine_schedule"]


def cosine_schedule(step: torch.Tensor, warmup: int, total: int,
                    floor: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to ``floor`` of peak (scale factor)."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
