"""Window sizing for the GC-driven simulator core (§4.3), host half.

Only the two host-side sizing helpers that ``build_spec`` needs live here
so far. The on-device GC frontier and adaptive window growth belong to
the windowed engine, which is not ported yet.
"""

from __future__ import annotations

__all__ = ["default_window_slots", "resolve_window_slots"]


def default_window_slots(n_s: int, n_r: int, send_window: int, phi: int,
                         chunk_steps: int, slack_rounds: int = 8) -> int:
    """Window width W for the sliding-window simulator (§4.3 sizing).

    The frontier only advances at chunk boundaries, so the window must hold
    one chunk's worth of fresh originations (``n_s * send_window`` per
    round) plus the un-retired backlog: a message QUACKs at every sender
    only after the ack rotation has visited all of them (~``n_s`` rounds)
    and the intra-RSM broadcast landed (+receiver rotation slack, ~``n_r``),
    and the phi-list bounds how far ahead complaints reach. Failure-free
    this is a constant independent of stream length — the paper's P1.
    """
    lag = chunk_steps + n_s + n_r + slack_rounds
    w = n_s * max(send_window, 1) * lag + phi
    return int(-(-w // 64) * 64)


def resolve_window_slots(window_slots, *, n_s: int, n_r: int,
                         send_window: int, phi: int, chunk_steps: int,
                         m: int) -> int:
    """Resolve ``SimConfig.window_slots`` (None | "auto" | int) to a width.

    Returns the concrete window width W, with 0 meaning the dense
    (full-M) engine. ``"auto"`` sizes W via :func:`default_window_slots`
    and clamps to dense when the computed W would not be smaller than M —
    windowing would buy nothing there.
    """
    if window_slots is None:
        return 0
    if window_slots == "auto":
        w = default_window_slots(n_s, n_r, send_window, phi, chunk_steps)
        return 0 if w >= m else w
    return int(window_slots)
