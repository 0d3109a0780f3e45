"""Sender/receiver scheduling (§4.1 round-robin, §5.2 stake-aware DSS).

Four schedulers, matching the paper:

* ``round_robin``  — unit-stake partitioning: message k is originated by
  sender ``k mod n_s``; each sender rotates its receiver every send (§4.1).
* ``skewed_rr``    — strawman V1: sender l takes delta_l consecutive turns.
* ``lottery``      — strawman V2: ticket lottery proportional to stake.
* ``dss``          — Dynamic Sharewise Scheduler: Hamilton apportionment of
  a message quantum q across stakes, interleaved smoothly (WFQ-style) so
  fairness holds *within* the quantum, not just across quanta (§5.2).

All return an assignment ``sender_of(k)`` for message indices and a receiver
rotation; they are numpy-side (schedule construction is control-plane work —
the hot data-plane state transitions run as torch tensor ops).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = [
    "hamilton_apportion",
    "dss_sequence",
    "skewed_rr_sequence",
    "lottery_sequence",
    "round_robin_sequence",
    "sender_assignment",
    "receiver_for",
]


def hamilton_apportion(stakes: np.ndarray, q: int) -> np.ndarray:
    """Hamilton's method of apportionment (§5.2 DSS, Figure 7).

    stakes: (n,) positive weights; q: total seats (messages per quantum).
    Returns integer counts c with sum(c) == q, matching the paper's worked
    example: standard divisor SD = total/q, standard quota SQ_l = delta_l/SD,
    lower quota LQ_l = floor(SQ_l), leftover seats go to the largest
    penalty ratios PR_l = SQ_l - LQ_l (ties broken by replica index for
    determinism).
    """
    stakes = np.asarray(stakes, dtype=np.float64)
    if q < 0:
        raise ValueError("q must be >= 0")
    total = stakes.sum()
    if total <= 0:
        raise ValueError("total stake must be positive")
    sd = total / max(q, 1)
    sq = stakes / sd if q > 0 else np.zeros_like(stakes)
    lq = np.floor(sq).astype(np.int64)
    pr = sq - lq
    left = q - int(lq.sum())
    # largest penalty ratio first; ties by lower index (stable determinism)
    order = np.lexsort((np.arange(len(stakes)), -pr))
    c = lq.copy()
    if left > 0:
        c[order[:left]] += 1
    return c


def _smooth_interleave(counts: np.ndarray) -> np.ndarray:
    """WFQ-style smooth sequencing of per-node counts within a quantum.

    Deterministic earliest-virtual-finish-time ordering: node l's i-th slot
    has virtual time (i + 1) / counts[l]; emit in ascending virtual time.
    Guarantees each node's sends are spread evenly through the quantum (the
    DSS 'fairness over short periods' requirement that lottery scheduling
    fails, §5.2).
    """
    counts = np.asarray(counts, dtype=np.int64)
    q = int(counts.sum())
    nodes = []
    vtimes = []
    for l, c in enumerate(counts):
        if c <= 0:
            continue
        i = np.arange(1, c + 1, dtype=np.float64)
        nodes.append(np.full(c, l, dtype=np.int64))
        vtimes.append(i / c)
    if not nodes:
        return np.zeros(0, dtype=np.int64)
    nodes = np.concatenate(nodes)
    vtimes = np.concatenate(vtimes)
    order = np.lexsort((nodes, vtimes))
    seq = nodes[order]
    assert seq.shape[0] == q
    return seq


def dss_sequence(stakes: np.ndarray, q: int, n_msgs: int) -> np.ndarray:
    """DSS sender sequence for ``n_msgs`` messages with quantum ``q``."""
    counts = hamilton_apportion(stakes, q)
    quantum_seq = _smooth_interleave(counts)
    if quantum_seq.shape[0] == 0:
        raise ValueError("empty quantum")
    reps = -(-n_msgs // quantum_seq.shape[0])
    return np.tile(quantum_seq, reps)[:n_msgs]


def skewed_rr_sequence(stakes: np.ndarray, n_msgs: int) -> np.ndarray:
    """Strawman V1 (§5.2): node l takes floor(delta_l) consecutive turns.

    Fair in the long run but serializes: a single high-stake faulty node can
    own a long contiguous block of the stream.
    """
    stakes = np.asarray(stakes)
    blocks = [np.full(max(int(round(s)), 1), l, dtype=np.int64)
              for l, s in enumerate(stakes)]
    cycle = np.concatenate(blocks)
    reps = -(-n_msgs // cycle.shape[0])
    return np.tile(cycle, reps)[:n_msgs]


def lottery_sequence(stakes: np.ndarray, n_msgs: int,
                     seed: int = 0) -> np.ndarray:
    """Strawman V2 (§5.2): ticket lottery. Fair only in expectation."""
    stakes = np.asarray(stakes, dtype=np.float64)
    p = stakes / stakes.sum()
    rng = np.random.RandomState(seed)
    return rng.choice(len(stakes), size=n_msgs, p=p).astype(np.int64)


def round_robin_sequence(n_nodes: int, n_msgs: int) -> np.ndarray:
    """§4.1: message k is sent by replica k mod n_s."""
    return (np.arange(n_msgs, dtype=np.int64) % n_nodes)


def sender_assignment(scheduler: str, stakes: np.ndarray, n_msgs: int,
                      quantum: int = 64, seed: int = 0) -> np.ndarray:
    """Original sender of each message index under the chosen scheduler."""
    n = len(stakes)
    if scheduler == "round_robin":
        return round_robin_sequence(n, n_msgs)
    if scheduler == "dss":
        return dss_sequence(np.asarray(stakes), quantum, n_msgs)
    if scheduler == "skewed_rr":
        return skewed_rr_sequence(np.asarray(stakes), n_msgs)
    if scheduler == "lottery":
        return lottery_sequence(np.asarray(stakes), n_msgs, seed)
    raise ValueError(f"unknown scheduler {scheduler!r}")


def receiver_for(sender_seq: np.ndarray, n_r: int,
                 recv_stakes: Optional[np.ndarray] = None,
                 scheduler: str = "round_robin",
                 quantum: int = 64, seed: int = 1) -> np.ndarray:
    """Receiver of each message's original send.

    §4.1: the l-th sender rotates receivers every send: its i-th message
    goes to ``(prev + 1) mod n_r``. For stake-aware scheduling the receiver
    side is apportioned with the same DSS machinery (the paper notes DSS
    identifies senders and receivers identically, §5.2).
    """
    n_msgs = sender_seq.shape[0]
    if (scheduler in ("dss", "skewed_rr", "lottery")
            and recv_stakes is not None):
        base = sender_assignment(scheduler, recv_stakes, n_msgs,
                                 quantum=quantum, seed=seed)
        return base
    # per-sender rotation: i-th send of sender l -> (l + i) mod n_r
    recv = np.zeros(n_msgs, dtype=np.int64)
    counters = np.zeros(int(sender_seq.max()) + 1 if n_msgs else 1,
                        dtype=np.int64)
    for k in range(n_msgs):
        l = sender_seq[k]
        recv[k] = (l + counters[l]) % n_r
        counters[l] += 1
    return recv
