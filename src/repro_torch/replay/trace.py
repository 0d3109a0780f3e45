"""RunTrace: chunk-boundary checkpoints with a stable npz serialisation.

A :class:`RunTrace` is the replayable record of one engine run: the
per-lane structural specs, the topology (for multi-link runs), the
lane->upstream commit-floor plan, and a list of
:class:`~repro_torch.core.simulator.ChunkCheckpoint` snapshots captured
at chunk boundaries. Every checkpoint leaf is host-side numpy (int32 /
bool, and the float32 stakes and thresholds bit for bit), so
``save``/``load`` round-trips exactly: a trace loaded from disk resumes
into the very same chunk stream as one captured in memory. The npz
layout (format v1) is the JAX package's, so a trace written by either
package resumes in the other.

:class:`Injection` is one schedule edit of a lane (a full
:class:`~repro_torch.core.FailureScenario` replacement, a stake /
threshold re-weight, or both) taking effect at a chunk-boundary round.
Edits compose into a failure *timeline*; ``repro_torch.replay.replay``
turns a timeline into the engine's ``fail_schedule`` callback (and the
oracle's numpy twin).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

import numpy as np

from ..core.simulator import (ChunkCheckpoint, FailArrays, SimResult,
                              SimSpec, SimState, StepMetrics,
                              WindowGrowthEvent)
from ..core.snapshot import state_from_arrays, state_to_arrays
from ..core.types import FailureScenario, RSMConfig, SimConfig
from ..topology.graph import LinkSpec, Topology

__all__ = ["Injection", "TraceRecorder", "RunTrace"]

_FORMAT_VERSION = 1


@dataclasses.dataclass(frozen=True)
class Injection:
    """One schedule edit taking effect at chunk boundary ``at_step``.

    ``failures`` (when given) replaces the lane's failure masks wholesale
    from round ``at_step`` on — crash or recover a replica, open or heal
    a partition, change drop/lie schedules. The quorum fields (when
    given) re-weight the lane's stakes / thresholds from the same round —
    the mid-stream *reconfiguration* primitive: a membership change is a
    crash-mask flip (remove = crash at ``at_step``; add = flip a replica
    that was "crashed since round 0" back to ``-1``) plus a stake
    re-weight moving the new member's stake and the u/r quorum thresholds
    (``simulator.spec_with_quorum``). Both ride the ``FailArrays``, which
    a swap rewrites in place, so applying an edit captures no program;
    edits compose
    cumulatively (a later injection overlays the lane state the earlier
    ones produced). ``at_step`` must be a multiple of the run's
    ``chunk_steps``."""

    at_step: int
    failures: Optional[FailureScenario] = None
    stakes_s: Optional[tuple] = None
    stakes_r: Optional[tuple] = None
    quack_thresh: Optional[float] = None
    dup_thresh: Optional[float] = None
    hq_thresh: Optional[float] = None

    @property
    def reconfigures(self) -> bool:
        """True when this edit changes stakes or quorum thresholds."""
        return any(v is not None for v in (
            self.stakes_s, self.stakes_r, self.quack_thresh,
            self.dup_thresh, self.hq_thresh))


class TraceRecorder:
    """Checkpoint sink handed to the engine (``wants``/``capture``).

    Captures every ``every``-th chunk boundary (the boundary at round 0
    always qualifies, so a trace can replay from the very start). The
    capture cost (one device->host copy of the O(B·W) state, and copies
    of the O(B·M) host mirrors) is only paid at boundaries ``wants``
    accepts.
    """

    def __init__(self, chunk_steps: int, every: int = 1):
        if every < 1:
            raise ValueError("every must be >= 1")
        self.chunk = max(int(chunk_steps), 1)
        self.every = int(every)
        self.checkpoints: List[ChunkCheckpoint] = []

    def wants(self, t: int) -> bool:
        return (t // self.chunk) % self.every == 0

    def capture(self, ckpt: ChunkCheckpoint) -> None:
        self.checkpoints.append(ckpt)


@dataclasses.dataclass
class RunTrace:
    """Replayable record of one chunked windowed run.

    kind:        "link" (single spec or scenario batch) | "topology".
    specs:       per-lane structural specs, masks = the original run's
                 static failure scenario (the base every timeline edit
                 overlays onto).
    lane_names:  one name per batch lane (link names for topologies).
    floor_plan:  lane -> upstream lane (chained commit gating); empty
                 for standalone links and fanouts.
    checkpoints: chunk-boundary snapshots, ascending ``t``.
    results:     the original run's per-lane outputs (in-memory traces
                 only — not serialized; baselines are re-derivable by an
                 unchanged replay).
    topology:    the graph (topology traces), serialized with the trace.
    """

    kind: str
    specs: List[SimSpec]
    lane_names: List[str]
    floor_plan: Dict[int, int]
    checkpoints: List[ChunkCheckpoint]
    results: Optional[List[SimResult]] = None
    topology: Optional[Topology] = None

    # --- addressing ------------------------------------------------------
    @property
    def n_lanes(self) -> int:
        return len(self.specs)

    @property
    def chunk_steps(self) -> int:
        return max(self.specs[0].chunk_steps, 1)

    @property
    def steps(self) -> int:
        return self.specs[0].steps

    def boundaries(self) -> np.ndarray:
        """Rounds at which this trace holds a checkpoint."""
        return np.asarray([c.t for c in self.checkpoints], dtype=np.int64)

    def checkpoint_at(self, t: int) -> ChunkCheckpoint:
        for c in self.checkpoints:
            if c.t == t:
                return c
        raise KeyError(
            f"no checkpoint at round {t}; recorded boundaries: "
            f"{self.boundaries().tolist()}")

    def last_checkpoint_before(self, t: int) -> ChunkCheckpoint:
        """Latest checkpoint with ``ckpt.t <= t`` (e.g. the pre-crash
        snapshot for an event scheduled at round ``t``)."""
        best = None
        for c in self.checkpoints:
            if c.t <= t and (best is None or c.t > best.t):
                best = c
        if best is None:
            raise KeyError(f"no checkpoint at or before round {t}")
        return best

    # --- serialization ---------------------------------------------------
    def save(self, path: str) -> None:
        """Serialise to one compressed npz (stable, numpy-only form)."""
        meta = {
            "version": _FORMAT_VERSION,
            "kind": self.kind,
            "lane_names": list(self.lane_names),
            "floor_plan": {str(k): int(v)
                           for k, v in self.floor_plan.items()},
            "specs": [dataclasses.asdict(s) for s in self.specs],
            "topology": (_topology_to_json(self.topology)
                         if self.topology is not None else None),
            "checkpoints": [
                {"t": int(c.t), "window_slots": int(c.window_slots),
                 "growth_events": [dataclasses.asdict(e)
                                   for e in c.growth_events]}
                for c in self.checkpoints],
        }
        arrays: Dict[str, np.ndarray] = {}
        for i, c in enumerate(self.checkpoints):
            p = f"c{i}."
            arrays[p + "bases"] = np.asarray(c.bases)
            arrays[p + "floors"] = np.asarray(c.floors)
            arrays[p + "bases_hist"] = np.asarray(c.bases_hist)
            arrays[p + "out_quack"] = np.asarray(c.out_quack)
            arrays[p + "out_deliver"] = np.asarray(c.out_deliver)
            arrays[p + "out_retry"] = np.asarray(c.out_retry)
            arrays[p + "out_recv"] = np.asarray(c.out_recv)
            if c.send_step is not None:
                arrays[p + "send_step"] = np.asarray(c.send_step)
            arrays.update(state_to_arrays(c.state, p + "state."))
            arrays.update(state_to_arrays(c.fails, p + "fails."))
            # per-chunk metric blocks flatten to the (B, t) view on disk
            arrays.update(state_to_arrays(c.metrics(), p + "metrics."))
        np.savez_compressed(path, meta=np.asarray(json.dumps(meta)),
                            **arrays)

    @classmethod
    def load(cls, path: str) -> "RunTrace":
        with np.load(path, allow_pickle=False) as d:
            meta = json.loads(str(d["meta"]))
            if meta["version"] != _FORMAT_VERSION:
                raise ValueError(
                    f"trace format v{meta['version']} != "
                    f"v{_FORMAT_VERSION}")
            specs = [_spec_from_json(s) for s in meta["specs"]]
            fail_defaults = _fail_array_defaults(specs)
            checkpoints = []
            for i, cm in enumerate(meta["checkpoints"]):
                p = f"c{i}."
                checkpoints.append(ChunkCheckpoint(
                    t=int(cm["t"]),
                    window_slots=int(cm["window_slots"]),
                    bases=d[p + "bases"],
                    state=state_from_arrays(SimState, d, p + "state."),
                    fails=state_from_arrays(FailArrays, d, p + "fails.",
                                            defaults=fail_defaults),
                    floors=d[p + "floors"],
                    out_quack=d[p + "out_quack"],
                    out_deliver=d[p + "out_deliver"],
                    out_retry=d[p + "out_retry"],
                    out_recv=d[p + "out_recv"],
                    metric_parts=(state_from_arrays(StepMetrics, d,
                                                    p + "metrics."),),
                    bases_hist=d[p + "bases_hist"],
                    growth_events=tuple(
                        WindowGrowthEvent(**e)
                        for e in cm["growth_events"]),
                    # absent in traces written before the mirror
                    # existed: ChunkCheckpoint defaults it to None and
                    # the engine falls back to the schedule rounds
                    send_step=(d[p + "send_step"]
                               if p + "send_step" in d else None),
                ))
        topo = (_topology_from_json(meta["topology"])
                if meta["topology"] is not None else None)
        return cls(
            kind=meta["kind"],
            specs=specs,
            lane_names=list(meta["lane_names"]),
            floor_plan={int(k): int(v)
                        for k, v in meta["floor_plan"].items()},
            checkpoints=checkpoints,
            results=None,
            topology=topo,
        )


def _fail_array_defaults(specs: List[SimSpec]) -> dict:
    """Stacked-``FailArrays`` fields absent from pre-palette traces.

    Adversary masks default to all-honest (the fields did not exist, so
    nothing could have injected them), and the stakes/thresholds
    default to each lane's *spec* values — NOT neutral ones: a resumed
    old trace must run the same quorum rules it was recorded under.
    """
    b, n_s, n_r = len(specs), specs[0].n_s, specs[0].n_r
    return dict(
        byz_equiv_send=np.zeros((b, n_s), dtype=bool),
        byz_hq_advance=np.zeros((b, n_s), dtype=np.int32),
        byz_ack_stale=np.zeros((b, n_r), dtype=bool),
        drop_pair=np.zeros((b, n_s, n_r), dtype=bool),
        stakes_s=np.asarray([s.stakes_s for s in specs], dtype=np.float32),
        stakes_r=np.asarray([s.stakes_r for s in specs], dtype=np.float32),
        quack_thresh=np.asarray([s.quack_thresh for s in specs],
                                dtype=np.float32),
        dup_thresh=np.asarray([s.dup_thresh for s in specs],
                              dtype=np.float32),
        hq_thresh=np.asarray([s.hq_thresh for s in specs],
                             dtype=np.float32),
    )


# --- dataclass <-> json (tuples come back from JSON as lists) -------------

def _deep_tuple(v):
    return (tuple(_deep_tuple(x) for x in v) if isinstance(v, list)
            else v)


def _retuple(cls, d: dict):
    fields = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            # field added after the trace was written: keep its default
            # (new fields must always be default-compatible additions)
            continue
        # deep: nested masks like ``drop_pair`` must come back as tuples
        # of tuples, or spec equality (a schedule swap compares the
        # specs' layouts) would break on list != tuple
        fields[f.name] = _deep_tuple(d[f.name])
    return cls(**fields)


def _spec_from_json(d: dict) -> SimSpec:
    return _retuple(SimSpec, d)


def _failures_from_json(d: dict) -> FailureScenario:
    return _retuple(FailureScenario, d)


def _topology_to_json(topo: Topology) -> dict:
    return {
        "clusters": {n: dataclasses.asdict(c)
                     for n, c in topo.clusters.items()},
        "links": [dataclasses.asdict(l) for l in topo.links],
        "sim": dataclasses.asdict(topo.sim),
    }


def _topology_from_json(d: dict) -> Topology:
    links = []
    for ld in d["links"]:
        ld = dict(ld)
        ld["failures"] = _failures_from_json(ld["failures"])
        links.append(LinkSpec(**ld))
    return Topology(
        clusters={n: _retuple(RSMConfig, c)
                  for n, c in d["clusters"].items()},
        links=tuple(links),
        sim=SimConfig(**d["sim"]),
    )
