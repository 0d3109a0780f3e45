"""Numpy oracles for replay: from-scratch runs of the merged schedule.

The replay contract is checked against ground truth the same way the
windowed engine is: the port's pure-numpy reference machines
(``core/refsim.py``, ``topology/refmirror.py``) execute the *merged*
schedule (the original failure masks until each injection's
``at_step``, the edited masks after) from round 0, with the same chunk
boundaries, the same window-growth mirror and the same commit-floor
plumbing as the engine. An engine replay from any checkpoint must match
this from-scratch oracle bit for bit (and, with no edits, the original
run itself). The oracles run on the host, with no device.

``replay_oracle`` covers single-lane link traces (per-message outputs
and the GC-frontier trajectory are comparable); for multi-lane link
batches compare per-message outputs only: the engine grows the window
batch-wide, so a lone lane's frontier trajectory can legitimately
differ while every output stays bit-identical.
"""

from __future__ import annotations

from typing import Optional

from ..core.refsim import RefResult, run_reference
from ..topology.refmirror import (RefTopologyResult,
                                  run_topology_reference)
from .replay import (InjectionSet, _normalize_injections,
                     _validate_injection, spec_swaps)
from .trace import RunTrace

__all__ = ["replay_oracle", "replay_topology_oracle"]


def _trace_swaps(trace: RunTrace, by_lane):
    """Swap points for a trace's lanes (the shared merge rule: the oracle
    applies the exact spec lists the engine schedule was built from,
    masks and stake/threshold reconfigurations alike)."""
    swaps, _ = spec_swaps(trace.specs, by_lane)
    return swaps


def replay_oracle(trace: RunTrace,
                  injections: Optional[InjectionSet] = None,
                  lane: int = 0) -> RefResult:
    """From-scratch oracle run of lane ``lane`` under the merged
    schedule (original masks, then each injection at its boundary)."""
    by_lane = _normalize_injections(trace, injections)
    for edits in by_lane.values():
        for e in edits:
            _validate_injection(trace, e, 0)
    swaps = _trace_swaps(trace, by_lane)
    spec = trace.specs[lane]

    def schedule(t):
        s = swaps.get(int(t))
        return None if s is None else s[lane]

    return run_reference(spec, fail_schedule=schedule)


def replay_topology_oracle(trace: RunTrace,
                           injections: Optional[InjectionSet] = None,
                           ) -> RefTopologyResult:
    """From-scratch topology oracle under the merged schedule: one
    reference machine per link, the same chunk structure, batch-wide
    window growth and commit-floor plumbing as the engine."""
    if trace.kind != "topology" or trace.topology is None:
        raise ValueError("replay_topology_oracle needs a topology trace")
    by_lane = _normalize_injections(trace, injections)
    for edits in by_lane.values():
        for e in edits:
            _validate_injection(trace, e, 0)
    swaps = _trace_swaps(trace, by_lane)

    def schedule(t):
        return swaps.get(int(t))

    return run_topology_reference(trace.topology, fail_schedule=schedule)
