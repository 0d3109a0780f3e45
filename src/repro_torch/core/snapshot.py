"""Window-layout invariants of the simulator's scan state.

Which ``SimState`` fields are window-indexed, what a fresh (never-touched)
slot holds, and each field's shape at window width ``w``. The single
source of truth for state initialisation; the windowed engine's rotation
and growth will refill from the same table.
"""

from __future__ import annotations

__all__ = ["WINDOW_FILLS", "window_shapes"]

# window-indexed SimState fields -> neutral fill for a fresh slot
WINDOW_FILLS = dict(recv_has=False, bcast_q=False, bcast_done=False,
                    orig_sent=False, known=False, complaint=False,
                    repeat_c=False, retry=0, quack_time=-1, deliver_time=-1)


def window_shapes(n_s: int, n_r: int, w: int) -> dict:
    """Window-indexed SimState field -> shape at window width ``w``."""
    return dict(recv_has=(n_r, w), bcast_q=(n_r, w), bcast_done=(n_r, w),
                orig_sent=(w,), known=(n_s, n_r, w),
                complaint=(n_s, n_r, w), repeat_c=(n_s, n_r, w),
                retry=(n_s, w), quack_time=(n_s, w), deliver_time=(w,))
