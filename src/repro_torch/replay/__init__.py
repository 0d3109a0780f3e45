"""Checkpointing, deterministic replay and what-if forking on the port.

The counterpart of ``repro.replay``. The simulator's chunked windowed
runs expose their state at chunk boundaries; this package turns that
into an experimentation engine:

* **Checkpointing** — ``record_simulation`` / ``record_batch`` /
  ``record_topology`` run the existing engines while capturing
  chunk-boundary snapshots (``RunTrace``: ring-buffer scan state, window
  bases, GC-frontier trajectory, drained output prefix, commit floors
  and the ``FailArrays`` in force), serialisable via ``save``/``load``
  (npz, the JAX package's format: traces move between the packages).
* **Deterministic replay with injection** — ``replay`` /
  ``replay_topology`` resume any checkpoint, optionally with
  ``Injection`` schedule edits (crash/recover a replica, open/heal a
  partition, change drop schedules or stakes from a chunk boundary on),
  on the chunk programs the recording captured (they outlive runs).
  Replay with an unchanged schedule is bit-identical to the original
  run; replay with edits is bit-identical to a from-scratch run
  executing the merged schedule (engine and numpy oracle both,
  ``repro_torch.replay.oracle``).
* **Forked what-if runs** — ``fork_whatif`` executes N schedule
  variants from one checkpoint as the lanes of one run (one dispatch
  per chunk, per-fork window bases) and reports per-fork divergence.

Every entry point runs on CUDA unless the caller passes ``device``
(``device="cpu"`` runs on the CPU):

    res, trace = record_simulation(spec)
    futures = fork_whatif(trace, from_step=32, forks=[
        ForkSpec("crash-early", [Injection(32, crash_scenario)]),
        ForkSpec("baseline", []),
    ])
"""

from .oracle import replay_oracle, replay_topology_oracle
from .replay import (record_batch, record_simulation, record_topology,
                     replay, replay_topology)
from .trace import Injection, RunTrace, TraceRecorder
from .whatif import ForkOutcome, ForkSpec, WhatIfReport, fork_whatif

__all__ = [
    "Injection", "RunTrace", "TraceRecorder",
    "record_simulation", "record_batch", "record_topology",
    "replay", "replay_topology",
    "replay_oracle", "replay_topology_oracle",
    "ForkSpec", "ForkOutcome", "WhatIfReport", "fork_whatif",
]
