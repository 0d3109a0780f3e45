"""Forked what-if runs: N divergent futures from one shared prefix.

``fork_whatif`` takes a checkpoint and N schedule variants
(:class:`ForkSpec`), tiles the checkpointed state across N fork blocks,
and executes *all* forks as the lanes of one windowed run: one dispatch
per chunk for the entire fork set, per-fork (indeed per-lane) window
bases, O(N·B·W) device state. The chunk programs are captured per
(window width, lanes): a cold fork batch pays that once for its N·B
shape, independent of chunk count, fork count and edit content (the
edits are swaps of the inputs the programs read in place), and
re-forking at the same shape captures *nothing*, however different the
edits, because the programs outlive the run (``core/graphs.py``). The
capture delta is measured (``WhatIfReport.chunk_traces``, from
``chunk_trace_count``) rather than assumed.

Chained topologies fork too: the lane->upstream commit-floor plan is
replicated per fork block, so each future routes its own retired
prefixes downstream independently.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from ..core.simulator import (ChunkCheckpoint, SimResult, _resolve_device,
                              _run_windowed_batch, chunk_trace_count)
from ..topology.engine import plan_floors
from .replay import (InjectionSet, _normalize_injections,
                     _validate_injection, build_fail_schedule)
from .trace import Injection, RunTrace

__all__ = ["ForkSpec", "ForkOutcome", "WhatIfReport", "fork_whatif"]


@dataclasses.dataclass(frozen=True)
class ForkSpec:
    """One what-if future: a name and its schedule edits (an empty edit
    list is the baseline fork — the original schedule continued)."""

    name: str
    injections: InjectionSet = ()


def _lane_stats(r: SimResult) -> Dict[str, int]:
    mask = np.asarray(r.deliver_time) >= 0
    prefix = int(np.argmin(mask)) if not mask.all() else int(len(mask))
    return dict(
        delivered=int(mask.sum()),
        delivered_prefix=prefix,
        retired_prefix=int(r.gc_frontiers[-1]),
        resends=int(np.sum(r.metrics.resends)),
        delivery_step=int(r.deliver_time.max()) if mask.all() else -1,
    )


@dataclasses.dataclass
class ForkOutcome:
    """One future's results plus per-lane divergence metrics."""

    name: str
    results: List[SimResult]            # one per lane
    stats: Dict[str, Dict[str, int]]    # lane name -> metrics
    divergence: Dict[str, Dict[str, int]]  # lane -> metric -> delta vs base

    def __getitem__(self, lane: str) -> SimResult:
        return self.results[list(self.stats).index(lane)]


@dataclasses.dataclass
class WhatIfReport:
    """All futures forked from one checkpoint, executed as one batch."""

    from_step: int
    lane_names: List[str]
    forks: List[ForkOutcome]
    baseline: Dict[str, Dict[str, int]]   # the original schedule's stats
    chunk_traces: int    # chunk programs the fork batch captured

    def __getitem__(self, name: str) -> ForkOutcome:
        for f in self.forks:
            if f.name == name:
                return f
        raise KeyError(name)

    def rows(self) -> List[dict]:
        """Flat per-fork-per-lane rows (bench / JSON friendly)."""
        out = []
        for f in self.forks:
            for lane in self.lane_names:
                out.append(dict(fork=f.name, lane=lane, **f.stats[lane],
                                **{f"d_{k}": v
                                   for k, v in f.divergence[lane].items()}))
        return out


def _tile_checkpoint(ckpt: ChunkCheckpoint, n: int) -> ChunkCheckpoint:
    """Replicate a B-lane checkpoint into N fork blocks (N*B lanes)."""

    def rep(a, axis=0):
        return np.concatenate([np.asarray(a)] * n, axis=axis)

    return ChunkCheckpoint(
        t=ckpt.t, window_slots=ckpt.window_slots,
        bases=rep(ckpt.bases),
        state=type(ckpt.state)(*(rep(x) for x in ckpt.state)),
        fails=type(ckpt.fails)(*(rep(x) for x in ckpt.fails)),
        floors=rep(ckpt.floors),
        out_quack=rep(ckpt.out_quack), out_deliver=rep(ckpt.out_deliver),
        out_retry=rep(ckpt.out_retry), out_recv=rep(ckpt.out_recv),
        metric_parts=tuple(type(part)(*(rep(x) for x in part))
                           for part in ckpt.metric_parts),
        bases_hist=rep(ckpt.bases_hist, axis=1),
        growth_events=ckpt.growth_events,
        send_step=(None if ckpt.send_step is None
                   else rep(ckpt.send_step)),
    )


def _reattribute_events(events, n_b: int, from_step: int):
    """Map tiled-lane growth indices back to (fork, lane).

    Events inherited from the shared pre-fork prefix (``step <
    from_step``) already carry original lane indices; events the fork
    batch itself recorded use the tiled N*B layout and are split back
    into a fork id + original lane, so consumers never see a mixed
    index space.
    """
    return tuple(
        e if e.step < from_step else dataclasses.replace(
            e, fork=e.scenario // n_b, scenario=e.scenario % n_b)
        for e in events)


def fork_whatif(trace: RunTrace, from_step: int,
                forks: Sequence[ForkSpec], device=None) -> WhatIfReport:
    """Execute N schedule variants from one checkpoint as one batch on
    ``device`` (default: CUDA; raises if it is absent).

    Each fork's injections use the same format as :func:`replay` /
    :func:`replay_topology` (lane-keyed mapping, or a bare sequence for
    lane 0). Divergence metrics are reported per fork and lane, deltas
    taken against the original run's outputs when the trace carries
    them.
    """
    if not forks:
        raise ValueError("fork_whatif needs at least one ForkSpec")
    names = [f.name for f in forks]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate fork names: {names}")
    n_forks, n_b = len(forks), trace.n_lanes
    ckpt = trace.checkpoint_at(int(from_step))
    dev = _resolve_device(device)

    # per-fork edits re-keyed onto the tiled (fork-major) lane layout
    tiled_specs = [s for _ in range(n_forks) for s in trace.specs]
    by_tiled_lane: Dict[int, List[Injection]] = {}
    for f_idx, fork in enumerate(forks):
        by_lane = _normalize_injections(trace, fork.injections)
        for lane, edits in by_lane.items():
            for e in edits:
                _validate_injection(trace, e, int(from_step))
            by_tiled_lane[f_idx * n_b + lane] = edits
    schedule, _ = build_fail_schedule(trace, by_tiled_lane,
                                      specs=tiled_specs)

    commit_floors = None
    if trace.floor_plan:
        m = trace.specs[0].m
        plan = {f * n_b + i: f * n_b + j
                for f in range(n_forks)
                for i, j in trace.floor_plan.items()}

        def commit_floors(t, bases):        # noqa: F811
            return plan_floors(plan, n_forks * n_b, m, bases)

    traces_before = chunk_trace_count()
    results = _run_windowed_batch(
        tiled_specs, dev, commit_floors=commit_floors,
        resume=_tile_checkpoint(ckpt, n_forks),
        fail_schedule=schedule if by_tiled_lane else None)
    traces_after = chunk_trace_count()

    # divergence baseline: the original run's outputs when the trace
    # still carries them; for traces loaded from disk, an unchanged
    # replay of the same checkpoint (bit-identical to the original, so
    # the deltas are the same).
    base_results = trace.results
    if base_results is None:
        cf = None
        if trace.floor_plan:
            m = trace.specs[0].m

            def cf(t, bases):                   # noqa: F811
                return plan_floors(trace.floor_plan, n_b, m, bases)

        base_results = _run_windowed_batch(list(trace.specs), dev,
                                           commit_floors=cf, resume=ckpt)
    baseline = {lane: _lane_stats(r)
                for lane, r in zip(trace.lane_names, base_results)}

    outcomes = []
    for f_idx, fork in enumerate(forks):
        block = results[f_idx * n_b:(f_idx + 1) * n_b]
        for r in block:
            r.window_growth_events = _reattribute_events(
                r.window_growth_events, n_b, int(from_step))
        stats = {lane: _lane_stats(r)
                 for lane, r in zip(trace.lane_names, block)}
        divergence = {
            lane: {k: stats[lane][k] - baseline[lane][k]
                   for k in stats[lane]}
            for lane in trace.lane_names}
        outcomes.append(ForkOutcome(name=fork.name, results=block,
                                    stats=stats, divergence=divergence))
    return WhatIfReport(from_step=int(from_step),
                        lane_names=list(trace.lane_names),
                        forks=outcomes, baseline=baseline,
                        chunk_traces=traces_after - traces_before)
