"""Data reconciliation over C3B (the paper's §6 application).

N RSMs (the paper's microbenchmark uses two) hold divergent key-value
stores: a common history plus keys the peers are missing or hold at older
versions. Each reconciliation round builds a full bidirectional mesh
topology — every ordered cluster pair is one C3B link, all executed as
the lanes of one windowed run — and every cluster streams the entries
its peer lacks. Received entries merge with last-writer-wins resolution
on ``(version, value)``, a commutative/idempotent merge in the spirit of
log-free state replication (merging *state deltas*, not replaying full
histories), so out-of-order delivery needs no sequencing: the delivered
*set* of a link, not just its prefix, is applied. Rounds repeat — each
round re-streams whatever differences remain (undelivered entries under
failures, or stores larger than one stream) — until the stores are equal
or ``max_rounds`` is hit.

The per-round deltas are computed from the global view of both stores,
modelling the digest exchange real reconcilers run out of band; the C3B
links carry the actual entries. ``use_reference=True`` runs every round
on the pure-numpy multi-link oracle instead of the engine; the two must
converge to identical stores on every fixture
(``tests/test_torch_apps.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

from ..core.simulator import _resolve_device
from ..core.types import FailureScenario, RSMConfig, SimConfig
from ..topology import (LinkSpec, RefTopologyResult, Topology,
                        TopologyResult, run_topology,
                        run_topology_reference)

__all__ = ["ReconciliationReport", "lww_merge", "run_reconciliation"]

# a store maps key -> (value, version); higher (version, value) wins.
Store = Dict[int, Tuple[int, int]]


def _wins(entry: Tuple[int, int], over: Optional[Tuple[int, int]]) -> bool:
    if over is None:
        return True
    return (entry[1], entry[0]) > (over[1], over[0])


def lww_merge(dst: Store, entries: Sequence[Tuple[int, int, int]]) -> int:
    """Merge ``(key, value, version)`` entries into ``dst`` (LWW).

    Returns how many entries changed the store. Commutative and
    idempotent, so delivery order across links/rounds cannot matter.
    """
    changed = 0
    for key, value, version in entries:
        if _wins((value, version), dst.get(key)):
            dst[key] = (value, version)
            changed += 1
    return changed


def _delta(src: Store, dst: Store) -> List[Tuple[int, int, int]]:
    """Entries of ``src`` that would change ``dst``, sorted by key."""
    return [(k, v, ver) for k, (v, ver) in sorted(src.items())
            if _wins((v, ver), dst.get(k))]


@dataclasses.dataclass
class ReconciliationReport:
    rounds: int                         # reconciliation rounds executed
    converged: bool                     # all stores identical at the end
    stores: Dict[str, Store]            # final stores (merged in place)
    exchanged: int                      # entries delivered+merged in total
    sessions: List[Union[TopologyResult, RefTopologyResult]]


def run_reconciliation(
        cfg: RSMConfig, stores: Dict[str, Store], sim: SimConfig,
        failures: Optional[Dict[str, FailureScenario]] = None,
        max_rounds: int = 4,
        use_reference: bool = False,
        device=None) -> ReconciliationReport:
    """Reconcile N divergent stores over a bidirectional C3B mesh, on
    ``device`` (default: CUDA; raises if it is absent), or on the numpy
    oracle with ``use_reference`` (no device).

    stores: cluster name -> store; merged **in place** round by round.
    failures: link name (``"a->b"``) -> that link's failure scenario,
    applied every round.
    """
    if len(stores) < 2:
        raise ValueError("reconciliation needs >= 2 stores")
    names = sorted(stores)
    m = sim.n_msgs
    if use_reference:
        run = run_topology_reference
    else:
        dev = _resolve_device(device)

        def run(topo):
            return run_topology(topo, device=dev)
    sessions: List[Union[TopologyResult, RefTopologyResult]] = []
    exchanged = 0
    rounds = 0

    for _ in range(max_rounds):
        deltas = {(a, b): _delta(stores[a], stores[b])
                  for a in names for b in names if a != b}
        if not any(deltas.values()):
            break
        rounds += 1
        links = tuple(
            LinkSpec(f"{a}->{b}", a, b,
                     (failures or {}).get(f"{a}->{b}",
                                          FailureScenario.none()))
            for a in names for b in names if a != b)
        topo = Topology(clusters={n: cfg for n in names}, links=links,
                        sim=sim)
        res = run(topo)
        sessions.append(res)
        for (a, b), delta in deltas.items():
            delivered = res[f"{a}->{b}"].delivered_mask()
            # message k of the link carries delta[k]; slots beyond the
            # delta (or beyond the stream) carry nothing this round.
            got = [delta[k] for k in range(min(len(delta), m))
                   if delivered[k]]
            exchanged += lww_merge(stores[b], got)

    converged = all(stores[n] == stores[names[0]] for n in names[1:])
    return ReconciliationReport(rounds=rounds, converged=converged,
                                stores=stores, exchanged=exchanged,
                                sessions=sessions)
