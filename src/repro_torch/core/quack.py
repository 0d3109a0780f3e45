"""QUACK (cumulative quorum acknowledgement) primitives (§4.1, §5.1).

All functions are plain torch tensor ops on the device of their inputs.
Sequence numbers are 0-based and acks are *counts*: ``ack == p`` means "I
hold the contiguous prefix of p messages m_0 .. m_{p-1}". A QUACK for
prefix p forms at a sender once replicas totalling ``u_r + 1`` stake have
acked >= p — at least one of those is honest, and an honest receiver
broadcasts intra-RSM, so delivery of m_0..m_{p-1} is guaranteed (§4.1
"Detecting successful sends").

Sliding-window (offset-aware) form: every function takes an optional
``base`` — the absolute sequence number of column 0 of the ``received``
array. Everything below ``base`` counts as held, so the absolute
cumulative ack is ``base +`` the in-window prefix. ``base == 0`` with a
full-width array is the dense semantics. ``base`` may be a python int, a
() int32 tensor, or one int32 base per lane: a (B,) tensor beside
(B, n_r, W) bitmaps. All offset arithmetic is int32, and so are the
scans (counts stay below W), as the JAX package's int32 scans are.
"""

from __future__ import annotations

import torch

from ..kernels.ops import quack_scan

__all__ = [
    "cumulative_ack",
    "claim_bitmask",
    "weighted_quorum_prefix",
    "selective_quack",
    "missing_below_horizon",
    "stake_quorum_bitmap",
]

_I32 = torch.int32


def _rows(base):
    """``base`` broadcast against per-row values (..., n_r)."""
    if isinstance(base, torch.Tensor) and base.dim():
        return base[..., None]
    return base


def _arange(w: int, base, device) -> torch.Tensor:
    """Absolute indices of the window columns, broadcast against
    (..., n_r, W)."""
    return _rows(_rows(base)) + torch.arange(w, dtype=_I32, device=device)


def stake_quorum_bitmap(claims: torch.Tensor, complaints: torch.Tensor,
                        stakes: torch.Tensor, quack_thresh, dup_thresh, *,
                        use_pallas: bool = False, need_lost: bool = True):
    """Stake-weighted QUACK / loss quorums over a window (§4.1/§4.2).

    claims / complaints: (n_s, n_r, W) bool — receiver claim and
    repeat-complaint bitmaps as known to each sender — with stakes (n_r,)
    and scalar thresholds, or the lane form: (B, n_s, n_r, W), stakes
    (B, n_r), thresholds (B,). Returns
    ``(quacked (n_s, W) bool, lost (n_s, W) bool, prefix (n_s,) int32)``
    (with the B axis in front in the lane form) where ``quacked`` is the
    u_r+1 stake quorum, ``lost`` the r_r+1 duplicate-complaint quorum on
    not-yet-quacked messages, and
    ``prefix`` the contiguous quacked prefix length (window-relative; the
    caller adds its window ``base``).

    Always goes through ``kernels.ops.quack_scan``: the CUDA kernel for
    CUDA tensors, its plain torch version for CPU tensors.
    ``use_pallas`` is accepted so that calls carry across from the JAX
    package, and is ignored. ``need_lost=False`` selects the kernel
    variant that never reads ``complaints``; ``lost`` is then ``None``.
    """
    return quack_scan(claims, complaints if need_lost else None,
                      stakes.to(torch.float32), quack_thresh, dup_thresh,
                      compute_lost=need_lost)


def cumulative_ack(received: torch.Tensor, base=0) -> torch.Tensor:
    """Highest contiguous prefix count per receiver.

    received: (..., n_r, W) bool -> (..., n_r) int32 *absolute* counts.
    ``base`` is the absolute index of column 0 (window invariant:
    everything below it counts as received).
    """
    prefix = torch.cumprod(received, dim=-1, dtype=_I32).sum(dim=-1,
                                                              dtype=_I32)
    return (_rows(base) + prefix).to(_I32)


def missing_below_horizon(received: torch.Tensor, phi: int,
                          base=0) -> torch.Tensor:
    """Which messages a receiver reports missing, bounded by the phi-list.

    A receiver only reports gaps below its highest received index (anything
    above could simply not have been sent yet), and at most ``phi`` of them
    (§4.2 Parallel Cumulative Acknowledgments). Returns (..., n_r, W) bool
    for the window columns; gaps can only exist at or above ``base``.
    """
    w = received.shape[-1]
    idx = _arange(w, base, received.device)
    rows = _rows(base)
    # top[j] = 1 + highest received index (base if nothing in-window);
    # argmax returns the first maximum, as jnp.argmax does
    last = torch.argmax(torch.flip(received, dims=(-1,)).to(_I32), dim=-1)
    top = torch.where(received.any(dim=-1), rows + w - last.to(_I32),
                      rows).to(_I32)
    missing = (~received) & (idx < top[..., None])
    # keep only the first `phi` missing entries per row
    rank = torch.cumsum(missing, dim=-1, dtype=_I32)
    return missing & (rank <= phi)


def claim_bitmask(received: torch.Tensor, phi: int, base=0, total=None):
    """Receiver's honest ack payload: (cum_ack, claim, claim_known).

    claim_known[j, k] — the ack message from j describes the status of k
    (true for all k below the horizon where <= phi gaps exist);
    claim[j, k]      — j claims to have received k (only meaningful where
    claim_known). This is exactly "cumulative counter + phi-list" in array
    form: below the horizon, claim == received; missing list = the gaps.

    ``base``/``total`` select the sliding-window form: columns cover
    absolute indices [base, base + W) of a stream of ``total`` messages.
    """
    w = received.shape[-1]
    rows = _rows(base)
    if total is None:
        total = rows + w
    idx = _arange(w, base, received.device)
    cum = cumulative_ack(received, base)
    # horizon: everything strictly below the (phi+1)-th missing index is
    # described; (phi+1)-th missing position per row, or `total`
    rank_all = torch.cumsum(~received, dim=-1, dtype=_I32)
    over = rank_all > phi
    first_over = torch.argmax(over.to(_I32), dim=-1).to(_I32)
    horizon = torch.where(over.any(dim=-1), rows + first_over,
                          total).to(_I32)
    known = idx < horizon[..., None]
    claim = received & known
    # everything below cum is received by definition of cum
    below_cum = idx < cum[..., None]
    return cum, claim | below_cum, known | below_cum


def weighted_quorum_prefix(ack_vals: torch.Tensor, stakes: torch.Tensor,
                           threshold) -> torch.Tensor:
    """Largest prefix p such that stake >= threshold has acked >= p (§5.1).

    ack_vals: (..., n_r) int; stakes: (n_r,) or broadcastable to
    ``ack_vals``; threshold: a scalar or broadcastable to ``ack_vals``
    (e.g. (B, 1, 1) beside (B, n_r, n_s)); returns (...,) int32.
    Sort acks descending (stably, as ``jnp.argsort``), accumulate stake,
    and take the largest ack value at which the running stake first
    reaches the threshold.
    """
    order = torch.argsort(-ack_vals, dim=-1, stable=True)
    sorted_acks = torch.gather(ack_vals, -1, order)
    sorted_stakes = torch.gather(stakes.expand(ack_vals.shape), -1, order)
    ok = torch.cumsum(sorted_stakes, dim=-1) >= threshold
    idx = torch.argmax(ok.to(_I32), dim=-1)  # first position reaching quorum
    val = torch.gather(sorted_acks, -1, idx[..., None])[..., 0]
    return torch.where(ok.any(dim=-1), val, 0).to(_I32)


def selective_quack(known_has: torch.Tensor, stakes: torch.Tensor,
                    threshold) -> torch.Tensor:
    """Per-message QUACK with phi-list info (§4.2 parallel recovery).

    known_has: (..., n_r, M) bool — sender's knowledge that receiver j claims
    to hold message k. Returns (..., M) bool: stake-weighted count >= u_r+1.
    """
    w = torch.einsum("...jm,j->...m", known_has.to(stakes.dtype), stakes)
    return w >= threshold
