"""Record runs with chunk-boundary checkpoints; replay them with edits.

Recording drives the existing engines (``_run_windowed_batch`` /
``run_topology``) with a :class:`~repro_torch.replay.trace.TraceRecorder`
attached: the same cached chunk programs, the same results, plus a
:class:`~repro_torch.replay.trace.RunTrace` of resumable checkpoints.

Replaying resumes a checkpoint with an optional list of
:class:`~repro_torch.replay.trace.Injection` schedule edits. The edits
become the engine's ``fail_schedule`` callback: at each edited chunk
boundary the lanes' ``FailArrays`` are rebuilt from the trace's
structural specs with the edits overlaid (``spec_with_failures`` /
``spec_with_quorum``) and copied into the tensors the captured programs
read, so nothing is captured again and the replay runs the programs its
recording captured. With no edits, replay is bit-identical to the
original run; with edits, it is bit-identical to a from-scratch run
executing the merged schedule (``tests/test_torch_replay.py`` checks
both, against the numpy oracles in ``repro_torch.replay.oracle``). Every
entry point runs on ``device`` (default: CUDA; it raises if there is
none).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

from ..core.simulator import (SimResult, SimSpec, _resolve_device,
                              _run_windowed_batch, spec_with_failures,
                              spec_with_quorum)
from ..core.types import FailureScenario
from ..obs.tracer import obs_span
from ..topology.engine import (TopologyResult, _floor_plan, link_specs,
                               run_topology)
from ..topology.graph import Topology
from .trace import Injection, RunTrace, TraceRecorder

__all__ = ["record_simulation", "record_batch", "record_topology",
           "replay", "replay_topology", "build_fail_schedule",
           "scenario_swaps", "spec_swaps", "apply_injection"]

# per-lane edit sets: a bare sequence applies to lane 0 (the common
# single-link case); a mapping keys lanes by index or lane name.
InjectionSet = Union[Sequence[Injection],
                     Mapping[Union[int, str], Sequence[Injection]]]


def _force_windowed(spec: SimSpec, chunk_steps: int) -> SimSpec:
    """Checkpoint/replay needs chunk boundaries: dense specs run the
    windowed engine at full width instead (bit-identical results, the
    ``link_specs`` rule for topologies)."""
    if spec.window_slots:
        return spec
    return dataclasses.replace(spec, window_slots=spec.m,
                               chunk_steps=max(chunk_steps, 1))


def record_simulation(spec: SimSpec, every: int = 1,
                      chunk_steps: int = 32, device=None,
                      ) -> Tuple[SimResult, RunTrace]:
    """Run one spec on the windowed engine, capturing checkpoints.

    Dense specs (``window_slots == 0``) are promoted to the windowed
    engine at full width so chunk boundaries exist; ``chunk_steps`` sets
    the boundary spacing in that case. ``every`` thins the recorded
    boundaries (a checkpoint at round 0 is always captured).
    """
    results, trace = record_batch([_force_windowed(spec, chunk_steps)],
                                  every=every, device=device)
    return results[0], trace


def record_batch(specs: Sequence[SimSpec], every: int = 1, device=None,
                 ) -> Tuple[List[SimResult], RunTrace]:
    """Run a scenario batch as the lanes of one windowed run, capturing
    chunk-boundary checkpoints for the whole batch (one snapshot covers
    every lane; forks and replays stay one dispatch a chunk)."""
    specs = list(specs)
    if not specs or not specs[0].window_slots:
        raise ValueError("record_batch needs windowed specs "
                         "(window_slots > 0); use record_simulation for "
                         "automatic dense promotion")
    dev = _resolve_device(device)
    rec = TraceRecorder(specs[0].chunk_steps, every=every)
    results = _run_windowed_batch(specs, dev, recorder=rec)
    trace = RunTrace(kind="link", specs=specs,
                     lane_names=[f"lane{i}" for i in range(len(specs))],
                     floor_plan={}, checkpoints=rec.checkpoints,
                     results=results)
    return results, trace


def record_topology(topo: Topology, every: int = 1, device=None,
                    ) -> Tuple[TopologyResult, RunTrace]:
    """Run a topology, capturing checkpoints across all links at once."""
    specs = link_specs(topo)
    rec = TraceRecorder(specs[0].chunk_steps, every=every)
    result = run_topology(topo, device=device, recorder=rec)
    trace = RunTrace(kind="topology", specs=specs,
                     lane_names=[l.name for l in topo.links],
                     floor_plan=_floor_plan(topo),
                     checkpoints=rec.checkpoints,
                     results=[result.links[l.name].result
                              for l in topo.links],
                     topology=topo)
    return result, trace


# --- failure timelines ---------------------------------------------------

def _lane_index(trace: RunTrace, key: Union[int, str]) -> int:
    if isinstance(key, str):
        try:
            return trace.lane_names.index(key)
        except ValueError:
            raise KeyError(f"unknown lane {key!r}; lanes: "
                           f"{trace.lane_names}") from None
    if not 0 <= int(key) < trace.n_lanes:
        raise KeyError(f"lane index {key} out of range "
                       f"[0, {trace.n_lanes})")
    return int(key)


def _normalize_injections(trace: RunTrace,
                          injections: Optional[InjectionSet],
                          ) -> Dict[int, List[Injection]]:
    if injections is None:
        return {}
    if isinstance(injections, Mapping):
        by_lane = {_lane_index(trace, k): list(v)
                   for k, v in injections.items()}
    else:
        by_lane = {0: list(injections)} if injections else {}
    for lane, edits in by_lane.items():
        by_lane[lane] = sorted(edits, key=lambda e: e.at_step)
    return by_lane


def _validate_injection(trace: RunTrace, inj: Injection,
                        from_step: int) -> None:
    spec = trace.specs[0]
    if inj.at_step % trace.chunk_steps != 0:
        raise ValueError(
            f"injection at round {inj.at_step} is not a chunk boundary "
            f"(chunk_steps={trace.chunk_steps}); mid-run edits can only "
            f"take effect where the scan state is host-observable")
    if not from_step <= inj.at_step < trace.steps:
        raise ValueError(
            f"injection at round {inj.at_step} outside the replayed "
            f"range [{from_step}, {trace.steps})")
    if inj.failures is None and not inj.reconfigures:
        raise ValueError(
            f"injection at round {inj.at_step} edits nothing: give "
            f"failure masks, a stake re-weight, or both")
    if inj.failures is not None:
        # full palette validation (shapes, crash horizons, lie ranges)
        inj.failures.validate(spec.n_s, spec.n_r, trace.steps)
    for name, n in (("stakes_s", spec.n_s), ("stakes_r", spec.n_r)):
        v = getattr(inj, name)
        if v is not None and len(v) != n:
            raise ValueError(f"injection {name} has {len(v)} entries, "
                             f"RSM has {n} replicas")


def scenario_swaps(base_scenarios: Sequence[FailureScenario],
                   by_lane: Dict[int, List[Injection]]):
    """Merge per-lane *mask* edits into cumulative swap points.

    Returns ``(swaps, final)`` where ``swaps`` maps each edited
    chunk-boundary round to the full per-lane scenario list in force
    from that round on — unedited lanes keep their current masks through
    every swap — and ``final`` is each lane's scenario at the end.
    Reconfiguration (stake/threshold) edits are invisible here; the
    full merge rule including them is :func:`spec_swaps`.
    """
    current = list(base_scenarios)
    swaps: Dict[int, List[FailureScenario]] = {}
    for t in sorted({e.at_step for edits in by_lane.values()
                     for e in edits}):
        for lane, edits in by_lane.items():
            for e in edits:
                if e.at_step == t and e.failures is not None:
                    current[lane] = e.failures
        swaps[t] = list(current)
    return swaps, current


def apply_injection(spec: SimSpec, inj: Injection) -> SimSpec:
    """Overlay one edit onto a lane's current spec (masks, then quorum).

    Both halves rewrite per-lane inputs only (``spec_with_failures`` /
    ``spec_with_quorum``), so the result shares the input spec's cached
    chunk programs.
    """
    s = spec
    if inj.failures is not None:
        s = spec_with_failures(s, inj.failures)
    if inj.reconfigures:
        s = spec_with_quorum(s, stakes_s=inj.stakes_s,
                             stakes_r=inj.stakes_r,
                             quack_thresh=inj.quack_thresh,
                             dup_thresh=inj.dup_thresh,
                             hq_thresh=inj.hq_thresh)
    return s


def spec_swaps(base_specs: Sequence[SimSpec],
               by_lane: Dict[int, List[Injection]]):
    """Merge per-lane edits into cumulative spec-level swap points.

    The single home of the timeline-merge rule (engine schedules and the
    numpy oracles both layer on it, so they cannot drift): returns
    ``(swaps, final)`` where ``swaps`` maps each edited chunk-boundary
    round to the full per-lane *spec* list in force from that round on —
    masks AND stakes/thresholds, cumulatively overlaid in ``at_step``
    order — and ``final`` is each lane's spec at the end of the run.
    """
    current = list(base_specs)
    swaps: Dict[int, List[SimSpec]] = {}
    for t in sorted({e.at_step for edits in by_lane.values()
                     for e in edits}):
        for lane, edits in by_lane.items():
            for e in edits:
                if e.at_step == t:
                    current[lane] = apply_injection(current[lane], e)
        swaps[t] = list(current)
    return swaps, current


def build_fail_schedule(trace: RunTrace,
                        by_lane: Dict[int, List[Injection]],
                        specs: Optional[List[SimSpec]] = None):
    """Compile per-lane edits into the engine's ``fail_schedule`` fn.

    Returns ``(schedule, final_specs)``: ``schedule(t)`` yields the
    full per-lane spec list whenever any lane's masks, stakes or
    thresholds change at ``t`` (``None`` otherwise), per the
    :func:`spec_swaps` merge rule.
    """
    specs = list(trace.specs) if specs is None else list(specs)
    swaps, current = spec_swaps(specs, by_lane)

    def schedule(t: int):
        return swaps.get(int(t))

    return schedule, list(current)


def _prepare(trace: RunTrace, from_step: int,
             injections: Optional[InjectionSet]):
    ckpt = trace.checkpoint_at(int(from_step))
    by_lane = _normalize_injections(trace, injections)
    for edits in by_lane.values():
        for e in edits:
            _validate_injection(trace, e, int(from_step))
    schedule, _ = build_fail_schedule(trace, by_lane)
    return ckpt, (schedule if by_lane else None)


def replay(trace: RunTrace, from_step: int,
           injections: Optional[InjectionSet] = None,
           device=None) -> List[SimResult]:
    """Resume a link trace from the checkpoint at ``from_step``.

    With no ``injections`` the replayed tail is bit-identical to the
    original run (same frontiers, delivered masks, metrics). Each
    injection swaps a lane's failure masks at a chunk boundary
    ``>= from_step``; the result equals a from-scratch run executing the
    merged schedule. ``SimResult.spec`` keeps the structural (original)
    masks — the edits live in the injection list.
    """
    if trace.kind != "link":
        raise ValueError(f"replay() takes a link trace, got "
                         f"{trace.kind!r}; use replay_topology()")
    dev = _resolve_device(device)
    ckpt, schedule = _prepare(trace, from_step, injections)
    with obs_span("replay_resume", cat="engine", from_step=int(ckpt.t)):
        return _run_windowed_batch(trace.specs, dev, resume=ckpt,
                                   fail_schedule=schedule)


def replay_topology(trace: RunTrace, from_step: int,
                    injections: Optional[InjectionSet] = None,
                    device=None) -> TopologyResult:
    """Resume a topology trace from ``from_step`` (per-link injections
    keyed by link name). Commit-floor plumbing picks up exactly where
    the checkpoint left it: the floor history of the skipped chunks is
    reconstructed from the checkpoint's base trajectory."""
    if trace.kind != "topology" or trace.topology is None:
        raise ValueError(f"replay_topology() takes a topology trace, "
                         f"got {trace.kind!r}")
    ckpt, schedule = _prepare(trace, from_step, injections)
    with obs_span("replay_resume", cat="engine", from_step=int(ckpt.t)):
        return run_topology(trace.topology, device=device, resume=ckpt,
                            fail_schedule=schedule)
