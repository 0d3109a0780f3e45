"""Named constructors for Byzantine scenarios and reconfigurations.

Each constructor returns a plain :class:`~repro_torch.core.FailureScenario`
(or a replay :class:`~repro_torch.replay.Injection` for the
reconfiguration half), so palette output composes with everything the
fault pipeline already does: static specs (``build_spec(failures=...)``),
mid-stream swaps (``fail_schedule``) and replay edits.
``adversary_scenario`` is the uniform sweep entry point the property
tests iterate over. Host-only code: the same constructors as
``repro.adversary.palette``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from ..core.types import FailureScenario
from ..replay.trace import Injection

__all__ = ["ADVERSARY_KINDS", "adversary_scenario", "equivocators",
           "stale_ackers", "hq_liars", "selective_drops", "stake_attack",
           "streaming_attack", "remove_receiver", "join_receiver"]


def _mask(n: int, idxs: Sequence[int], name: str) -> Tuple[bool, ...]:
    idxs = tuple(int(i) for i in idxs)
    for i in idxs:
        if not 0 <= i < n:
            raise ValueError(f"{name} index {i} out of range [0, {n})")
    return tuple(i in idxs for i in range(n))


def equivocators(n_s: int, senders: Sequence[int] = (0,),
                 base: FailureScenario = FailureScenario(),
                 ) -> FailureScenario:
    """Senders whose retransmissions equivocate (conflicting payloads).

    Receivers detect the mismatch against the original's digest and
    discard the copy — the resend burns wire budget and a rotation slot
    but never lands, so recovery waits for the election to rotate past
    the equivocator (§4.2's coordination-free election is what bounds
    the damage).
    """
    return dataclasses.replace(
        base, byz_equiv_send=_mask(n_s, senders, "equivocators"))


def stale_ackers(n_r: int, receivers: Sequence[int] = (0,),
                 base: FailureScenario = FailureScenario(),
                 ) -> FailureScenario:
    """Receivers that replay their previous QUACK ack verbatim.

    Truthful-but-old: a replayed claim can never fabricate receipt (so
    retirement stays safe with *any* stake behind it), but the frozen
    cumulative counter trips duplicate-cum complaints at every sender —
    manufactured loss suspicion, resend load, and quorum drag.
    """
    return dataclasses.replace(
        base, byz_ack_stale=_mask(n_r, receivers, "stale_ackers"))


def hq_liars(n_s: int, senders: Sequence[int] = (0,), advance: int = 4,
             base: FailureScenario = FailureScenario(),
             ) -> FailureScenario:
    """Senders inflating their §4.3 highest-quacked piggyback.

    Receiver ``i`` hears ``min(true + advance + i, M)`` — per-receiver
    conflicting, so the lie cannot be cross-checked. The r_s+1
    attestation quorum is the defence: an ack floor only advances where
    senders totalling >= r_s+1 stake agree, and at most r_s stake of
    that can be lying.
    """
    if advance <= 0:
        raise ValueError("advance must be > 0 (0 = honest)")
    adv = _mask(n_s, senders, "hq_liars")
    return dataclasses.replace(
        base, byz_hq_advance=tuple(advance if x else 0 for x in adv))


def selective_drops(n_s: int, n_r: int,
                    pairs: Sequence[Tuple[int, int]],
                    base: FailureScenario = FailureScenario(),
                    ) -> FailureScenario:
    """Network faults scoped to (sender, receiver) edges.

    Originals and retransmissions on a dropped edge vanish silently
    (acks still flow) — the adversarial network of §4.2, where recovery
    must route around the dead edges through the retransmitter rotation
    and the intra-RSM broadcast.
    """
    dp = np.zeros((n_s, n_r), dtype=bool)
    for (l, j) in pairs:
        if not (0 <= int(l) < n_s and 0 <= int(j) < n_r):
            raise ValueError(f"selective_drops pair ({l}, {j}) out of "
                             f"range ({n_s}, {n_r})")
        dp[int(l), int(j)] = True
    return dataclasses.replace(
        base, drop_pair=tuple(tuple(bool(x) for x in row) for row in dp))


def stake_attack(stakes: Sequence[float], thresh: float,
                 side: str = "receiver", advance: int = 4,
                 base: FailureScenario = FailureScenario(),
                 ) -> FailureScenario:
    """Greedy maximal-stake quorum attack within the corruption budget.

    Corrupts replicas in descending stake order while the corrupted
    total stays strictly below ``thresh`` — the strongest coalition the
    UpRight model admits (one more and the adversary *owns* the quorum,
    which no protocol survives). ``side="receiver"`` makes the coalition
    fabricate ack claims (``byz_ack_advance``) against the QUACK
    threshold u_r+1; ``side="sender"`` makes it inflate §4.3
    highest-quacked attestations (``byz_hq_advance``) against the
    attestation threshold r_s+1. Both stay inside the provable
    retirement-safety budget (``adversary.safety.quorum_budget``).
    """
    st = np.asarray(list(stakes), dtype=np.float64)
    order = np.argsort(-st, kind="stable")
    chosen, total = [], 0.0
    for i in order:
        if total + st[i] >= thresh:
            continue
        chosen.append(int(i))
        total += st[i]
    if side == "receiver":
        adv = tuple(advance if i in chosen else 0
                    for i in range(len(st)))
        return dataclasses.replace(base, byz_ack_advance=adv)
    if side == "sender":
        adv = tuple(advance if i in chosen else 0
                    for i in range(len(st)))
        return dataclasses.replace(base, byz_hq_advance=adv)
    raise ValueError(f"side must be 'receiver' or 'sender', got {side!r}")


# --- sweep entry point ----------------------------------------------------

ADVERSARY_KINDS = ("equivocate", "stale_ack", "hq_lie", "selective_drop",
                   "stake_attack")


def adversary_scenario(kind: str, n_s: int, n_r: int, seed: int = 0,
                       stakes_r: Optional[Sequence[float]] = None,
                       quack_thresh: Optional[float] = None,
                       ) -> FailureScenario:
    """One seeded scenario of the given kind (tests / bench sweeps).

    Picks the attacked replicas pseudo-randomly but keeps the corrupted
    coalition within the u/r budget of a BFT-1 configuration (at most
    one replica per side for the lie kinds), so every generated schedule
    is one the protocol must *survive*, not merely detect.
    """
    rng = np.random.default_rng(seed)
    if kind == "equivocate":
        return equivocators(n_s, (int(rng.integers(n_s)),))
    if kind == "stale_ack":
        return stale_ackers(n_r, (int(rng.integers(n_r)),))
    if kind == "hq_lie":
        return hq_liars(n_s, (int(rng.integers(n_s)),),
                        advance=int(rng.integers(1, 6)))
    if kind == "selective_drop":
        n_edges = int(rng.integers(1, max(n_s * n_r // 4, 2)))
        pairs = {(int(rng.integers(n_s)), int(rng.integers(n_r)))
                 for _ in range(n_edges)}
        return selective_drops(n_s, n_r, sorted(pairs))
    if kind == "stake_attack":
        st = (tuple(stakes_r) if stakes_r is not None
              else (1.0,) * n_r)
        thr = (float(quack_thresh) if quack_thresh is not None
               else 2.0)
        return stake_attack(st, thr, side="receiver",
                            advance=int(rng.integers(1, 6)))
    raise ValueError(f"unknown adversary kind {kind!r}; "
                     f"palette: {ADVERSARY_KINDS}")


def streaming_attack(kind: str, n_s: int, n_r: int) -> FailureScenario:
    """A palette attack dressed for the streaming SLO demo.

    A *single* liar in a BFT-1 configuration is fully masked — the
    honest quorums outvote it and the watchdogs see nothing, which is
    the defence working, not the demo failing. To make each adversary's
    marginal cost observable (resend-rate / latency breach while the
    attack is on, recovery after it is healed), the lie kinds are paired
    with the network pressure that exposes them: an edge partition
    forces retransmissions, which equivocators void, hq liars poison
    with false floors, and stale/advancing ackers drag through the
    complaint machinery. Every returned scenario keeps the fabricating
    stake inside the provable §4.3 budget — the stream degrades but
    never retires an undelivered message.
    """
    drop_to_0 = selective_drops(n_s, n_r, [(l, 0) for l in range(n_s)])
    if kind == "equivocate":
        # all-but-one sender equivocates: every resend voids until the
        # election rotates to the lone honest retransmitter
        return equivocators(n_s, tuple(range(max(n_s - 1, 1))),
                            base=drop_to_0)
    if kind == "stale_ack":
        # a stale coalition plus one crashed honest receiver makes the
        # stalers' stake pivotal to the QUACK quorum: their frozen
        # claims stall the quacked prefix and the GC frontier until the
        # heal (crash round 0 = dead for this scenario's whole reign)
        crash = [-1] * n_r
        crash[n_r - 1] = 0
        return stale_ackers(n_r, tuple(range(min(2, n_r))),
                            base=FailureScenario(crash_r=tuple(crash)))
    if kind == "hq_lie":
        return hq_liars(n_s, (0,), advance=8, base=drop_to_0)
    if kind == "selective_drop":
        return drop_to_0
    if kind == "stake_attack":
        # receiver 0's inbound edges are dead while receiver 1 fabricates
        # claims — the quorum must still find an honest voter
        return stake_attack((1.0,) * n_r, 2.0, side="receiver",
                            advance=6, base=drop_to_0)
    raise ValueError(f"unknown adversary kind {kind!r}; "
                     f"palette: {ADVERSARY_KINDS}")


# --- reconfiguration ------------------------------------------------------

def remove_receiver(n_r: int, j: int, at_step: int,
                    stakes_r: Sequence[float],
                    quack_thresh: float, dup_thresh: float,
                    base: FailureScenario = FailureScenario(),
                    ) -> Injection:
    """Membership change: receiver ``j`` leaves the RSM at ``at_step``.

    Expressed entirely through per-lane inputs: a crash mask stops the
    replica (it never acks again) and a stake re-weight removes its
    vote, with the quorum thresholds handed in already adjusted for the
    smaller membership (the config-service commit the paper delegates
    membership to, here the caller). No program is captured again.
    """
    if not 0 <= j < n_r:
        raise ValueError(f"receiver index {j} out of range [0, {n_r})")
    crash = list(base.crash_r or (-1,) * n_r)
    crash[j] = int(at_step)
    st = [float(x) for x in stakes_r]
    st[j] = 0.0
    return Injection(
        at_step=int(at_step),
        failures=dataclasses.replace(base, crash_r=tuple(crash)),
        stakes_r=tuple(st), quack_thresh=float(quack_thresh),
        dup_thresh=float(dup_thresh))


def join_receiver(n_r: int, j: int, at_step: int,
                  stakes_r: Sequence[float],
                  quack_thresh: float, dup_thresh: float,
                  base: FailureScenario = FailureScenario(),
                  ) -> Injection:
    """Membership change: receiver ``j`` joins the RSM at ``at_step``.

    The join twin of :func:`remove_receiver`: the base run models the
    future member as crashed-from-round-0 (``crash_r[j] == 0``); the
    injection flips its crash entry to ``-1`` (alive from the swap
    boundary on: the alive mask is recomputed every round) and weights
    its stake in.
    """
    if not 0 <= j < n_r:
        raise ValueError(f"receiver index {j} out of range [0, {n_r})")
    crash = list(base.crash_r or (-1,) * n_r)
    crash[j] = -1
    return Injection(
        at_step=int(at_step),
        failures=dataclasses.replace(base, crash_r=tuple(crash)),
        stakes_r=tuple(float(x) for x in stakes_r),
        quack_thresh=float(quack_thresh), dup_thresh=float(dup_thresh))
