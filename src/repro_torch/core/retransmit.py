"""Retransmission logic (§4.2) — detection, election, and bounds.

* loss is declared only after ``r + 1`` distinct replicas (stake-weighted)
  repeat a complaint — no single Byzantine replica can trigger a spurious
  resend (1 complaint suffices in CFT mode, r == 0);
* the retransmitter is elected with *zero* extra communication:
  ``sender_new = (sender_orig + #retransmit) mod n_s``;
* at most ``u_s + u_r + 1`` retransmissions are needed under synchrony
  (Lemma 1), and with random pairings 72 resends reach 1e-9 failure
  probability regardless of RSM size (Theorem 1).
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "elect_retransmitter",
    "declared_lost",
    "max_retransmissions",
    "theorem1_resends",
    "faulty_pair_bound",
    "empirical_delivery_probability",
]


def elect_retransmitter(orig_sender: torch.Tensor, retry_count: torch.Tensor,
                        n_s: int) -> torch.Tensor:
    """§4.2: sender_new = (sender_original + #retransmit) mod n_s.

    orig_sender, retry_count: (M,) int tensors; elementwise election.
    Every honest replica evaluates this identically — a single
    retransmitter per round with no coordination messages.
    """
    return ((orig_sender + retry_count) % n_s).to(torch.int32)


def declared_lost(repeat_complaints: torch.Tensor, stakes: torch.Tensor,
                  dup_threshold: float) -> torch.Tensor:
    """Stake-weighted repeated-complaint quorum (§4.2 duplicate QUACKs).

    repeat_complaints: (n_r, M) bool — receiver j has complained about
    message k in two successive acks to the same sender. A message is
    *definitely* lost when complainers total >= dup_threshold stake (r+1;
    at least one honest). Returns (M,) bool.
    """
    w = torch.einsum("jm,j->m", repeat_complaints.to(stakes.dtype), stakes)
    return w >= dup_threshold


def max_retransmissions(u_s: int, u_r: int) -> int:
    """Lemma 1: at most u_s + u_r + 1 attempts reach a correct pair."""
    return u_s + u_r + 1


def faulty_pair_bound(n_s: int, u_s: int, n_r: int, u_r: int) -> float:
    """Theorem 1, Eq. (1)/(5): fraction of sender-receiver pairs with a fault.

    Faulty = u_s*n_r + u_r*n_s - u_s*u_r; the bound Faulty/(n_s*n_r) <= 3/4
    holds whenever both replication factors a = (n-1)/u are >= 2.
    """
    faulty = u_s * n_r + u_r * n_s - u_s * u_r
    return faulty / float(n_s * n_r)


def theorem1_resends(p_fail: float = 1e-9, p_pair: float = 0.75) -> int:
    """Theorem 1: q = ceil(log_{p_pair} p_fail); 72 for 1e-9 at 3/4."""
    return int(math.ceil(math.log(p_fail) / math.log(p_pair)))


def empirical_delivery_probability(n_s: int, u_s: int, n_r: int, u_r: int,
                                   retries: int, trials: int = 20000,
                                   seed: int = 0) -> float:
    """Monte-Carlo check of the §4.2 claim: with a fixed ratio of faulty
    nodes and random ids, ~8 retries already give 99.9% delivery.
    Host-only numpy, the JAX package's ``RandomState`` stream."""
    rng = np.random.RandomState(seed)
    faulty_s = np.zeros(n_s, bool)
    faulty_s[:u_s] = True
    faulty_r = np.zeros(n_r, bool)
    faulty_r[:u_r] = True
    ok = 0
    for _ in range(trials):
        s = rng.permutation(n_s)[:retries % n_s or n_s]
        r = rng.permutation(n_r)[:retries % n_r or n_r]
        # a rotation visits distinct pairs; success iff some pair is clean
        m = min(retries, len(s), len(r))
        if np.any(~faulty_s[s[:m]] & ~faulty_r[r[:m]]):
            ok += 1
    return ok / trials
