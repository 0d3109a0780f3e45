"""Multi-link C3B session engine on the port's batched windowed loop.

``run_topology`` resolves every link of a :class:`Topology` into a
``SimSpec`` (identical modulo failure masks — enforced) and executes all
of them as the lanes of one windowed run
(``simulator._run_windowed_batch``): one set of captured chunk programs,
one device dispatch per chunk across links, per-link window bases and
frontiers, O(L·W) device state. There is no per-link loop over runs: a
link is one lane of the batch, and one ``quack_scan`` launch covers
every lane.

Chained delivery rides the commit-floor plumbing: between chunks the
engine sets each chained link's ``commit_floor`` to its upstream link's
retired prefix (the window base the GC rotation has advanced past). A
retired slot is QUACKed at every sender — provably held by at least one
honest receiver — so the floor is a *durable delivered* prefix:
downstream clusters only ever originate entries the upstream hop cannot
lose, which is the prefix-consistency contract the oracle mirror
(``refmirror``) and ``tests/test_torch_topology.py`` check bit for bit.

Topology execution is always chunked (the floors must be able to move
between chunks), so a stream small enough for ``window_slots="auto"`` to
clamp to the dense engine instead runs the windowed engine at full width
W = M — same observable results, chunk boundaries retained.

Because the floors are recomputed from every boundary's actual retired
prefixes, a commit-floor callback is a mandatory host interaction: a
topology runs chunk at a time (a floor boundary fuses nothing: a drain,
the callback in a ``plan_floors`` span, and the floors written in place
into the tensor the captured programs read) and is bit-identical for
every ``SimConfig.superchunk``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from ..core.simulator import (SimResult, SimSpec, _resolve_device,
                              _run_windowed_batch, build_spec,
                              require_uniform_batch)
from ..obs.tracer import obs_span
from .graph import LinkSpec, Topology

__all__ = ["LinkAccessors", "TopologyAccessors", "LinkResult",
           "TopologyResult", "link_specs", "plan_floors", "FloorPlanner",
           "run_topology"]


def link_specs(topo: Topology) -> List[SimSpec]:
    """Per-link SimSpecs, forced onto the chunked windowed engine."""
    specs = [build_spec(topo.clusters[l.src], topo.clusters[l.dst],
                        topo.sim, l.failures)
             for l in topo.links]
    if specs[0].window_slots == 0:
        # commit-floor plumbing needs chunk boundaries: when the auto
        # sizing clamps to dense (W >= M), run the windowed engine at full
        # width instead — bit-identical results, boundaries retained.
        specs = [dataclasses.replace(s, window_slots=s.m,
                                     chunk_steps=topo.sim.chunk_steps)
                 for s in specs]
    require_uniform_batch(specs)
    return specs


class LinkAccessors:
    """Shared derived views over one link's outputs (engine AND oracle —
    both result flavours expose ``result.deliver_time`` /
    ``result.gc_frontiers``, so the prefix semantics cannot drift between
    the engine run and its numpy mirror)."""

    def delivered_mask(self) -> np.ndarray:
        """(M,) bool — messages that reached >=1 honest dst replica."""
        return np.asarray(self.result.deliver_time) >= 0

    def delivered_prefix(self) -> int:
        """Length of the contiguous delivered prefix (the applied log)."""
        mask = self.delivered_mask()
        return int(np.argmin(mask)) if not mask.all() else len(mask)

    def retired_prefix(self) -> int:
        """Final GC frontier — the durable prefix both sides may forget."""
        return int(self.result.gc_frontiers[-1])


class TopologyAccessors:
    """Shared by-name addressing over a run's links (engine AND oracle)."""

    def __getitem__(self, name: str):
        return self.links[name]

    def delivered_prefixes(self) -> Dict[str, int]:
        return {n: lr.delivered_prefix() for n, lr in self.links.items()}


@dataclasses.dataclass
class LinkResult(LinkAccessors):
    """One link's simulation outputs + the commit floors it ran under."""

    link: LinkSpec
    result: SimResult
    commit_floors: np.ndarray      # (n_chunks,) floor per chunk start


@dataclasses.dataclass
class TopologyResult(TopologyAccessors):
    """All links' results, addressable by link name."""

    topology: Topology
    links: Dict[str, LinkResult]


def _floor_plan(topo: Topology) -> Dict[int, int]:
    """link index -> upstream link index, for chained links only."""
    idx = {l.name: i for i, l in enumerate(topo.links)}
    return {i: idx[l.upstream] for i, l in enumerate(topo.links)
            if l.upstream is not None}


def plan_floors(plan: Dict[int, int], n_lanes: int, m: int,
                bases) -> np.ndarray:
    """Commit floors for one chunk from the lanes' retired prefixes.

    ``plan`` maps lane -> upstream lane; unchained lanes are fully
    committed (floor = m). Shared by the engine, the numpy mirror and the
    replay and what-if runs (which tile the plan across fork blocks), so
    the chained-delivery rule has exactly one implementation.
    """
    floors = np.full(n_lanes, m, dtype=np.int64)
    for i, j in plan.items():
        floors[i] = np.int64(bases[j])
    return floors


class FloorPlanner:
    """Reusable commit-floor callback over a lane -> upstream plan.

    One instance is one session's floor stream: the engine calls it at
    every chunk boundary with the lanes' retired prefixes and it applies
    the shared :func:`plan_floors` rule. ``keep_history=True`` (batch
    topology runs) records every boundary's floors so
    ``LinkResult.commit_floors`` can be reconstructed; streaming
    sessions pass ``False`` — only the latest floors are retained and
    host memory stays O(1) in stream length.
    """

    def __init__(self, plan: Dict[int, int], n_lanes: int, m: int,
                 keep_history: bool = True):
        self.plan = dict(plan)
        self.n_lanes = int(n_lanes)
        self.m = int(m)
        self.keep_history = keep_history
        self.history: List[np.ndarray] = []
        self.last: np.ndarray = np.full(n_lanes, m, dtype=np.int64)
        self.calls = 0

    @classmethod
    def chain(cls, n_lanes: int, m: int,
              keep_history: bool = True) -> "FloorPlanner":
        """Lane i is chained behind lane i-1 (lane 0 unchained)."""
        return cls({i: i - 1 for i in range(1, n_lanes)}, n_lanes, m,
                   keep_history=keep_history)

    def seed_history(self, bases_rows) -> None:
        """Reconstruct pre-resume floors from a checkpoint's base
        trajectory (same rule — bit-identical to the original run)."""
        self.history = [plan_floors(self.plan, self.n_lanes, self.m, row)
                        for row in bases_rows]

    def __call__(self, t: int, bases: np.ndarray) -> np.ndarray:
        floors = plan_floors(self.plan, self.n_lanes, self.m, bases)
        self.calls += 1
        self.last = floors.copy()
        if self.keep_history:
            self.history.append(self.last)
        return floors

    def stacked(self) -> np.ndarray:
        return np.stack(self.history)


def run_topology(topo: Topology, *, device=None, recorder=None,
                 resume=None, fail_schedule=None) -> TopologyResult:
    """Execute every link of the graph as the lanes of one windowed run
    on ``device`` (default: CUDA; raises if it is absent).

    ``recorder`` / ``resume`` / ``fail_schedule`` pass straight through
    to the windowed loop: chunk-boundary checkpoints, resume from one,
    and mid-stream swaps of the links' inputs, for the replay subsystem
    (``repro_torch.replay``). On resume the commit-floor history of the
    chunks already run is rebuilt from the checkpoint's base trajectory
    by the same ``plan_floors`` rule, so a replayed
    ``LinkResult.commit_floors`` is bit-identical to the original run's.
    """
    dev = _resolve_device(device)
    specs = link_specs(topo)
    planner = FloorPlanner(_floor_plan(topo), len(specs), specs[0].m)
    if resume is not None:
        planner.seed_history(np.asarray(resume.bases_hist)[:-1])
    # the loop wraps each floor callback in a "plan_floors" span; this
    # outer span makes whole-graph sessions addressable in the timeline
    with obs_span("run_topology", cat="engine",
                  links=[l.name for l in topo.links]):
        results = _run_windowed_batch(specs, dev, commit_floors=planner,
                                      recorder=recorder, resume=resume,
                                      fail_schedule=fail_schedule)
    hist = planner.stacked()                      # (n_chunks, L)
    links = {
        l.name: LinkResult(link=l, result=r, commit_floors=hist[:, i])
        for i, (l, r) in enumerate(zip(topo.links, results))}
    return TopologyResult(topology=topo, links=links)
