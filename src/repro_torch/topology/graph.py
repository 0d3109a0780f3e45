"""Link-graph model for multi-link C3B sessions.

A :class:`Topology` is a set of named RSM clusters plus directed C3B
links between them. Every link carries its own failure scenario, but all
links share one :class:`~repro_torch.core.SimConfig` stream shape and
every link's (source config, destination config) pair must resolve to
the same schedules/thresholds — that uniformity is what lets the engine
execute *all* links as the lanes of one batched windowed run (one set of
captured chunk programs, one device dispatch per chunk, O(L·W) state)
instead of a Python loop over per-link runs.

A link may name an ``upstream`` link: its commit stream is then gated by
the upstream link's retired prefix (chained RSMs — cluster B only
forwards to C what it has durably received from A). The engine routes the
upstream's retired prefix into the downstream link's ``commit_floor``
between chunks; the programs read the floor from a tensor the engine
rewrites in place, so the plumbing captures no new program.

Constructors cover the paper's application shapes: ``pair`` (a
bidirectional link pair, data reconciliation §6), ``fanout`` (a primary
streaming its committed log to N backups, disaster recovery §6) and
``chain`` (relay pipelines, each hop gated by the previous one).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

from ..core.types import FailureScenario, RSMConfig, SimConfig

__all__ = ["LinkSpec", "Topology"]


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """One directed C3B link: ``src`` cluster streams to ``dst`` cluster.

    upstream: optional name of the link whose retired prefix gates this
              link's commit stream (chained delivery). ``None`` means the
              full stream is committed at the source from round 0.
    """

    name: str
    src: str
    dst: str
    failures: FailureScenario = FailureScenario.none()
    upstream: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class Topology:
    """A graph of RSM clusters and directed C3B links (uniform shape)."""

    clusters: Mapping[str, RSMConfig]
    links: Tuple[LinkSpec, ...]
    sim: SimConfig = SimConfig()

    def __post_init__(self):
        if not self.links:
            raise ValueError("topology has no links")
        names = [l.name for l in self.links]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate link names: {names}")
        by_name = {l.name: l for l in self.links}
        for l in self.links:
            for c in (l.src, l.dst):
                if c not in self.clusters:
                    raise ValueError(f"link {l.name!r} references unknown "
                                     f"cluster {c!r}")
            if l.src == l.dst:
                raise ValueError(f"link {l.name!r} is a self-loop")
            if l.upstream is not None and l.upstream not in by_name:
                raise ValueError(f"link {l.name!r} chains unknown upstream "
                                 f"{l.upstream!r}")
        # chained delivery must be acyclic (a cycle would deadlock every
        # floor at 0 forever)
        for l in self.links:
            seen = {l.name}
            cur = l.upstream
            while cur is not None:
                if cur in seen:
                    raise ValueError(f"chained-delivery cycle through "
                                     f"{l.name!r}")
                seen.add(cur)
                cur = by_name[cur].upstream
        # one batched dispatch needs one shape: every link's (src, dst)
        # config pair must match the first link's.
        l0 = self.links[0]
        pair0 = (self.clusters[l0.src], self.clusters[l0.dst])
        for l in self.links[1:]:
            pair = (self.clusters[l.src], self.clusters[l.dst])
            if pair != pair0:
                raise ValueError(
                    f"link {l.name!r} has cluster configs {pair} != "
                    f"{pair0} of link {l0.name!r}; all links of one "
                    f"topology must share (src config, dst config) so the "
                    f"whole graph runs as one batched windowed dispatch")

    @property
    def link_names(self) -> Tuple[str, ...]:
        return tuple(l.name for l in self.links)

    def link(self, name: str) -> LinkSpec:
        for l in self.links:
            if l.name == name:
                return l
        raise KeyError(name)

    # --- constructors for the paper's application shapes -----------------

    @classmethod
    def pair(cls, a: str, b: str, cfg: RSMConfig,
             sim: SimConfig = SimConfig(),
             failures_ab: FailureScenario = FailureScenario.none(),
             failures_ba: FailureScenario = FailureScenario.none(),
             ) -> "Topology":
        """Bidirectional link pair ``a<->b`` (data reconciliation)."""
        return cls(clusters={a: cfg, b: cfg},
                   links=(LinkSpec(f"{a}->{b}", a, b, failures_ab),
                          LinkSpec(f"{b}->{a}", b, a, failures_ba)),
                   sim=sim)

    @classmethod
    def fanout(cls, primary: str, backups: Sequence[str], cfg: RSMConfig,
               sim: SimConfig = SimConfig(),
               failures: Optional[Dict[str, FailureScenario]] = None,
               backup_cfg: Optional[RSMConfig] = None) -> "Topology":
        """Primary streaming its committed log to N backups (disaster
        recovery). ``failures`` maps backup name -> that link's scenario
        (e.g. the primary's crash round plus per-backup receiver faults).
        """
        if not backups:
            raise ValueError("fanout needs at least one backup")
        failures = failures or {}
        bcfg = backup_cfg if backup_cfg is not None else cfg
        clusters = {primary: cfg}
        clusters.update({b: bcfg for b in backups})
        links = tuple(
            LinkSpec(f"{primary}->{b}", primary, b,
                     failures.get(b, FailureScenario.none()))
            for b in backups)
        return cls(clusters=clusters, links=links, sim=sim)

    @classmethod
    def chain(cls, hops: Sequence[str], cfg: RSMConfig,
              sim: SimConfig = SimConfig(),
              failures: Optional[Dict[str, FailureScenario]] = None,
              ) -> "Topology":
        """Relay pipeline ``hops[0] -> hops[1] -> ...``: each hop's commit
        stream is gated by the previous link's retired prefix (chained
        delivery), so downstream clusters only ever forward entries the
        upstream hop has durably received — the prefix-consistency
        invariant ``tests/test_torch_topology.py`` checks against the
        oracle.
        ``failures`` maps link name (``"a->b"``) -> scenario."""
        if len(hops) < 2:
            raise ValueError("chain needs at least two clusters")
        failures = failures or {}
        links = []
        prev = None
        for src, dst in zip(hops[:-1], hops[1:]):
            name = f"{src}->{dst}"
            links.append(LinkSpec(
                name, src, dst,
                failures.get(name, FailureScenario.none()), upstream=prev))
            prev = name
        return cls(clusters={h: cfg for h in hops}, links=tuple(links),
                   sim=sim)
