"""§4.3 retirement-safety budgets and assertion helpers.

The GC frontier retires a window slot only when it is QUACKed at every
sender — and a QUACK is only as trustworthy as the stake behind it. Two
palette adversaries can *fabricate* effective claims (everything else
merely suppresses): an ack-advancing receiver coalition fabricates
receipt claims against the QUACK threshold u_r+1, and an hq-lying
sender coalition fabricates §4.3 attestations against the attestation
threshold r_s+1 (whose false ack floor turns into receiver claims). As
long as each coalition's stake stays strictly below its threshold,
every quorum that forms contains at least one honest voter and "no
undelivered message is ever retired" is provable: the engine asserts
it at drain time under ``debug_checks``, the port's numpy oracle counts
violations in ``RefResult.retired_undelivered``, and this module makes
the budget arithmetic and the assertions reusable.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.simulator import SimSpec, retire_safety_stakes_ok

__all__ = ["QuorumBudget", "quorum_budget", "assert_safe_retirement"]


@dataclasses.dataclass(frozen=True)
class QuorumBudget:
    """How much fabricating stake a spec's adversaries wield.

    ``provable`` == both margins positive == the §4.3 argument applies:
    every QUACK and every attestation floor contains an honest voter, so
    no undelivered message can ever be retired. A non-provable spec is
    still *runnable* (the engine happily simulates an owned quorum —
    that is how the defence's necessity is demonstrated), but the safety
    assertions below must not be applied to it.
    """

    fabricating_receiver_stake: float   # byz_ack_advance coalition
    quack_thresh: float
    fabricating_sender_stake: float     # byz_hq_advance coalition
    hq_thresh: float
    provable: bool

    @property
    def receiver_margin(self) -> float:
        return self.quack_thresh - self.fabricating_receiver_stake

    @property
    def sender_margin(self) -> float:
        return self.hq_thresh - self.fabricating_sender_stake


def quorum_budget(spec: SimSpec) -> QuorumBudget:
    """The fabricating-stake arithmetic behind
    :func:`~repro_torch.core.simulator.retire_safety_stakes_ok`,
    itemised."""
    st_r = np.asarray(spec.stakes_r, dtype=np.float64)
    st_s = np.asarray(spec.stakes_s, dtype=np.float64)
    adv_r = np.asarray(spec.byz_ack_advance or (0,) * spec.n_r) > 0
    adv_s = np.asarray(spec.byz_hq_advance or (0,) * spec.n_s) > 0
    return QuorumBudget(
        fabricating_receiver_stake=float(st_r[adv_r].sum()),
        quack_thresh=float(spec.quack_thresh),
        fabricating_sender_stake=float(st_s[adv_s].sum()),
        hq_thresh=float(spec.hq_thresh),
        provable=retire_safety_stakes_ok(spec))


def assert_safe_retirement(spec: SimSpec, result) -> None:
    """Assert a finished run never retired an undelivered message.

    "Delivered" here is ground-truth receipt: every sequence number
    below the final GC frontier must be physically held by >= 1 replica
    of the receiver RSM (``recv_has``; fabricated claims never set it —
    a bcast-partial or later-crashing holder still counts). Applies to
    both engine results (``SimResult``) and oracle results
    (``RefResult`` — the retirement-time counter must be zero). Only
    meaningful when the spec's budget is provable; raises ``ValueError``
    on a non-provable spec instead of asserting a property the
    adversary is entitled to break.
    """
    budget = quorum_budget(spec)
    if not budget.provable:
        raise ValueError(
            "retirement safety is not provable for this spec: "
            f"fabricating receiver stake {budget.fabricating_receiver_stake}"
            f" vs quack_thresh {budget.quack_thresh}, fabricating sender "
            f"stake {budget.fabricating_sender_stake} vs hq_thresh "
            f"{budget.hq_thresh} — an owned quorum may retire anything")
    ru = getattr(result, "retired_undelivered", None)
    if ru is not None:
        assert ru == 0, (f"oracle retired {ru} undelivered slot(s) "
                         f"despite a provable stake budget")
        return
    frontiers = getattr(result, "gc_frontiers", None)
    if frontiers is None:
        return                       # dense run: nothing was retired
    final = int(np.asarray(frontiers)[-1])
    held = np.asarray(result.recv_has).any(axis=0)[:final]
    bad = np.flatnonzero(~held)
    assert bad.size == 0, (
        f"engine retired seqnos {bad.tolist()} (frontier {final}) that "
        f"no replica has received, despite a provable stake budget")
