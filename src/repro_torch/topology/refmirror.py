"""Pure-numpy multi-link oracle mirroring the topology engine.

One :class:`~repro_torch.core.refsim._RefMachine` per link, driven with
exactly the engine's chunk structure: the same commit floors computed
from the same retired-prefix plumbing at the same chunk starts, the same
per-lane overflow decisions (batch-wide window growth, dense-layout
migration mirrored as widening to W = M), and the same GC-frontier
advances at chunk boundaries. Every per-message output, every frontier
trajectory and every commit-floor trajectory must agree bit for bit with
``run_topology`` — the ground truth ``tests/test_torch_topology.py`` and
``chip_smoke.py`` hold the engine to, on the CPU and on the card. It
runs no torch.

The machines also snapshot every retired slot and assert at the end that
no retired output ever changed, which is what makes routing the retired
prefix into a downstream link's commit stream sound: a downstream
cluster never commits an entry its upstream hop could still lose.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from ..core.refsim import RefResult, _RefMachine
from ..core.simulator import (SimSpec, _max_msg_by_round,
                              _widen_on_overflow, spec_failures)
from .engine import (LinkAccessors, TopologyAccessors, _floor_plan,
                     link_specs, plan_floors)
from .graph import LinkSpec, Topology

__all__ = ["RefLinkResult", "RefTopologyResult", "run_topology_reference"]


@dataclasses.dataclass
class RefLinkResult(LinkAccessors):
    """Oracle twin of :class:`repro_torch.topology.engine.LinkResult`."""

    link: LinkSpec
    result: RefResult
    commit_floors: np.ndarray      # (n_chunks,) floor per chunk start


@dataclasses.dataclass
class RefTopologyResult(TopologyAccessors):
    topology: Topology
    links: Dict[str, RefLinkResult]


def run_topology_reference(topo: Topology,
                           fail_schedule=None) -> RefTopologyResult:
    """Oracle topology run; ``fail_schedule(t)`` may return one entry
    per link at a chunk start to swap the failure state in force from
    round ``t`` on (the numpy twin of a mid-stream ``FailArrays`` swap —
    replay-with-injection ground truth). Each
    entry is a ``FailureScenario`` (mask swap) or a full ``SimSpec``
    (mask swap plus stake/threshold reconfiguration)."""
    specs = link_specs(topo)
    spec0 = specs[0]
    n_l, m = len(specs), spec0.m
    machines = [_RefMachine(s) for s in specs]
    up = _floor_plan(topo)
    w = spec0.window_slots
    c_full = max(spec0.chunk_steps, 1)
    dispatched_by = _max_msg_by_round(spec0)

    bases = np.zeros(n_l, dtype=np.int64)
    bases_hist = [bases.copy()]
    floors_hist: List[np.ndarray] = []
    t = 0
    while t < spec0.steps:
        c = min(c_full, spec0.steps - t)
        if fail_schedule is not None:
            new_fails = fail_schedule(t)
            if new_fails is not None:
                for mac, f in zip(machines, new_fails):
                    if isinstance(f, SimSpec):
                        mac.set_quorum(f)
                        mac.set_failures(spec_failures(f))
                    else:
                        mac.set_failures(f)
        # commit floors for this chunk: a chained link may originate only
        # what its upstream link has retired (durably delivered) so far.
        floors = plan_floors(up, n_l, m, bases)
        floors_hist.append(floors.copy())
        # per-link overflow check + batch-wide growth, exactly like the
        # engine: the whole batch shares one window width.
        need_b = np.minimum(int(dispatched_by[t + c - 1]), floors - 1)
        over = need_b - bases
        b = int(over.argmax())
        if over[b] >= w:
            new_w = _widen_on_overflow(spec0, w, int(bases[b]),
                                       int(need_b[b]), t + c - 1)
            w = m if new_w is None else new_w
        last = t + c >= spec0.steps
        for i, mac in enumerate(machines):
            for tt in range(t, t + c):
                mac.step(tt, commit_floor=int(floors[i]))
        t += c
        if not last:
            for i, mac in enumerate(machines):
                f = mac.frontier(int(bases[i]), w, t)
                mac.retire(int(bases[i]), f)
                bases[i] += f
            bases_hist.append(bases.copy())

    for mac in machines:
        mac.assert_retirement_safe()

    traj = np.stack(bases_hist)                   # (n_boundaries, L)
    fhist = np.stack(floors_hist)                 # (n_chunks, L)
    links = {}
    for i, (l, mac) in enumerate(zip(topo.links, machines)):
        res = mac.result(traj[:, i].astype(np.int64), True)
        links[l.name] = RefLinkResult(link=l, result=res,
                                      commit_floors=fhist[:, i])
    return RefTopologyResult(topology=topo, links=links)
