"""Byzantine adversary palette + mid-stream reconfiguration toolkit.

The counterpart of ``repro.adversary``. The engine's fault model
(:class:`~repro_torch.core.FailureScenario`) carries every adversary as
per-lane inputs riding the ``FailArrays``, which the captured programs
read by address, so an attack can be switched on, escalated, or healed
at any chunk boundary (by a ``fail_schedule`` callback or a replay
:class:`~repro_torch.replay.Injection`) without capturing a program
again. This package is the scenario-construction layer on top:

* :mod:`~repro_torch.adversary.palette` — named constructors for each
  adversary kind (equivocating senders, stale/replayed QUACK acks,
  §4.3 highest-quacked liars, selective per-pair drops, greedy
  stake-weighted quorum attacks) and for the reconfiguration
  injections (remove/join a replica, re-weight stakes) expressed as
  crash-mask flips plus ``spec_with_quorum`` swaps.
  ``streaming_attack`` builds the scenarios the JAX package's streaming
  sessions use; the streaming session itself is not ported yet.
* :mod:`~repro_torch.adversary.safety` — the §4.3 retirement-safety budget:
  which adversary stake totals keep "no undelivered message is ever
  retired" *provable*, and assertion helpers that check engine and
  oracle runs against it.

Every palette scenario is mirrored bit-exactly by the port's numpy
oracle (``core/refsim.py``): ``tests/test_torch_adversary.py`` sweeps the
palette across the dense, windowed and superchunk engine paths against
it and against ``repro``.
"""

from .palette import (ADVERSARY_KINDS, adversary_scenario, equivocators,
                      hq_liars, join_receiver, remove_receiver,
                      selective_drops, stake_attack, stale_ackers,
                      streaming_attack)
from .safety import (QuorumBudget, assert_safe_retirement, quorum_budget)

__all__ = [
    "ADVERSARY_KINDS", "adversary_scenario", "equivocators", "hq_liars",
    "selective_drops", "stake_attack", "stale_ackers", "streaming_attack",
    "remove_receiver", "join_receiver",
    "QuorumBudget", "quorum_budget", "assert_safe_retirement",
]
