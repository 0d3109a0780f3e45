"""Garbage collection (§4.3), including the Byzantine GC-stall defence.

Naive rule: a QUACKed message has provably reached an honest receiver, so
the sender may drop it. The paper's counterexample: a Byzantine receiver
broadcasts m_k to exactly u_r+1 replicas of which u_r are faulty; a QUACK
forms, m_k is GC'd, the faulty replicas go silent — now no QUACK can ever
form past k and honest receivers keep duplicate-acking a message the sender
no longer holds.

Fix: when a sender sees a duplicate QUACK for k' below its GC frontier, it
piggybacks its *highest quacked sequence number* k on outgoing traffic.
After ``r_s + 1`` distinct senders (stake-weighted) report >= k, receivers
know >= 1 honest sender attests that every message <= k reached *some*
honest receiver, and may advance their cumulative ack floor to k (§4.3
strategy (1); strategy (2) — fetching m from peers — is modelled by the
intra-RSM broadcast already).

The windowed simulator retires the prefix both sides may forget: the
numpy ``gc_frontier`` states the rule, ``gc_frontier_device`` evaluates
it on lane-batched device tensors inside a chunk, and ``grow_window`` /
the sizing helpers decide the window width.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .quack import stake_quorum_bitmap, weighted_quorum_prefix

__all__ = ["collectable", "ack_floor_from_reports", "gc_frontier",
           "gc_frontier_device", "grow_window", "default_window_slots",
           "resolve_window_slots", "chunk_boundaries", "snap_to_boundary"]

_I32 = torch.int32


def chunk_boundaries(steps: int, chunk_steps: int) -> np.ndarray:
    """Rounds at which a chunked windowed run starts a chunk.

    These are the only rounds where the state is observable from the
    host: where the GC frontier advances and the window may grow.
    """
    if steps <= 0:
        return np.zeros(0, dtype=np.int64)
    return np.arange(0, steps, max(int(chunk_steps), 1), dtype=np.int64)


def snap_to_boundary(t: int, chunk_steps: int) -> int:
    """Largest chunk-boundary round <= ``t`` (where a mid-run event can
    actually take effect)."""
    c = max(int(chunk_steps), 1)
    return (max(int(t), 0) // c) * c


def collectable(quacked_prefix: torch.Tensor, m: int) -> torch.Tensor:
    """(n_s,) quacked prefix -> (n_s, M) bool of GC-able messages."""
    idx = torch.arange(m, dtype=_I32, device=quacked_prefix.device)
    return idx[None, :] < quacked_prefix[:, None]


def ack_floor_from_reports(hq_reports: torch.Tensor,
                           sender_stakes: torch.Tensor,
                           r_s_threshold) -> torch.Tensor:
    """Receivers' provable ack floor from highest-quacked metadata.

    hq_reports: (n_r, n_s) int — highest-quacked seqno claimed by each
    sender, as heard by each receiver (0 if never heard). The floor is the
    largest k such that senders totalling >= r_s + 1 stake claim >= k —
    the same order-statistic as a QUACK, on the sender side.
    Returns (n_r,) int32.
    """
    return weighted_quorum_prefix(hq_reports, sender_stakes, r_s_threshold)


def gc_frontier(*, base: int, t_next: int, m: int,
                known: np.ndarray, bcast_q: np.ndarray,
                recv_has: np.ndarray, ack_floor: np.ndarray,
                stakes_r: np.ndarray, quack_thresh: float,
                orig_sent: np.ndarray, crash_r: np.ndarray,
                byz_ack_low: np.ndarray) -> int:
    """How many window slots may be retired without changing the run.

    Host-side (numpy) statement of the rule: given one lane's window state
    after round ``t_next - 1`` (window columns = absolute indices
    ``base .. base + W``), return the number of leading slots whose
    per-message state can never change again, so the window base may
    advance past them. A slot ``k`` is retirable iff

      * its original send has actually been dispatched (``orig_sent[k]``),
      * it is QUACKed at *every* sender — so no sender can ever declare a
        loss / resend / re-quack it (§4.3: the quacked prefix is what both
        sides are allowed to forget),
      * no intra-RSM broadcast of it is still queued, and
      * every receiver that will still emit acks (not crashed by
        ``t_next``, not a low-acking liar whose payload ignores its state)
        effectively holds it (``recv_has`` or below its §4.3 ack floor) —
        otherwise the slot would keep occupying one of the receiver's phi
        gap slots and perturb future ack payloads.

    The retired prefix is exactly the metadata both RSMs "forget" in the
    paper's GC; the conjunction above is what makes forgetting *exact* in
    the simulator (bit-identical to the dense run).
    """
    w = known.shape[-1]
    abs_idx = base + np.arange(w, dtype=np.int64)
    # float32, as the step's stake sums
    w_known = np.einsum("ljm,j->lm", known.astype(np.float32),
                        np.asarray(stakes_r, dtype=np.float32))
    quacked_everywhere = (w_known >= np.float32(quack_thresh)).all(axis=0)
    dispatched = np.asarray(orig_sent)[:w]
    no_pending_bcast = ~bcast_q.any(axis=0)
    relevant = ((np.asarray(crash_r) < 0) | (np.asarray(crash_r) > t_next))
    relevant = relevant & ~np.asarray(byz_ack_low)
    eff = recv_has | (abs_idx[None, :] < np.asarray(ack_floor)[:, None])
    eff_full = (eff | ~relevant[:, None]).all(axis=0)
    ok = (quacked_everywhere & dispatched & no_pending_bcast & eff_full
          & (abs_idx < m))
    return int(np.cumprod(ok.astype(np.int64)).sum())


def gc_frontier_device(*, base, t_next, m: int,
                       known, bcast_q, recv_has, ack_floor,
                       stakes_r, quack_thresh,
                       orig_sent, crash_r, byz_ack_low) -> torch.Tensor:
    """:func:`gc_frontier` on lane-batched device tensors, in a chunk.

    Every tensor carries a leading lane axis B: ``base`` (B,) int32,
    ``known`` (B, n_s, n_r, W), ``bcast_q``/``recv_has`` (B, n_r, W),
    ``ack_floor``/``crash_r``/``byz_ack_low`` (B, n_r), ``stakes_r``
    (B, n_r) float32, ``quack_thresh`` (B,) float32, ``orig_sent`` (B, W).
    ``t_next`` is an int or a () int32 tensor. Returns (B,) int32: each
    lane's number of leading window slots that may be retired.

    "QUACKed at every sender" is the simulator's own quorum decision:
    ``stake_quorum_bitmap`` without the loss quorum (the CUDA kernel on
    the card), so retirement agrees bit for bit with the step's QUACKs.
    Nothing here waits for the device.
    """
    w = known.shape[-1]
    abs_idx = base[:, None] + torch.arange(w, dtype=_I32,
                                           device=known.device)
    quacked, _, _ = stake_quorum_bitmap(known, None, stakes_r, quack_thresh,
                                        None, need_lost=False)
    quacked_everywhere = quacked.all(dim=1)                      # (B, W)
    no_pending_bcast = ~bcast_q.any(dim=1)
    # crashed strictly after t_next: the step's `alive` is t < crash_r
    relevant = ((crash_r < 0) | (crash_r > t_next)) & ~byz_ack_low
    eff = recv_has | (abs_idx[:, None, :] < ack_floor[:, :, None])
    eff_full = (eff | ~relevant[:, :, None]).all(dim=1)
    ok = (quacked_everywhere & orig_sent & no_pending_bcast & eff_full
          & (abs_idx < m))
    # the prefix is at most W: the scan and the sum stay in int32
    return torch.cumprod(ok, dim=-1, dtype=_I32).sum(dim=-1, dtype=_I32)


def grow_window(w: int, base: int, need: int, m: int) -> Optional[int]:
    """Adaptive window sizing on overflow (§4.3 under a stalled frontier).

    A Byzantine stall can pin the GC frontier while originals keep
    dispatching, so the highest in-flight sequence number ``need`` outruns
    the window ``[base, base + w)``. Double ``w`` until the window covers
    ``need`` again; if the required width would reach the full stream
    length ``m``, windowing buys nothing over the dense state — return
    ``None`` to signal the caller to migrate the state into the dense
    layout (base 0, W = M) and continue from there.
    """
    new_w = max(int(w), 1)
    while need >= base + new_w:
        new_w *= 2
    if new_w >= m:
        return None
    return new_w


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
