"""Disaster recovery over C3B (the paper's §6 application).

A primary RSM streams its committed log to N backup RSMs over a fanout
topology (one C3B link per backup, all executed as the lanes of one
windowed run). At a configured round every primary replica crashes; each
backup is left with whatever contiguous log prefix reached at least one
of its honest replicas. Failover then elects the most-caught-up backup
(longest applied prefix, deterministic name tiebreak) and, in a second
fanout session, the elected backup streams its log so the remaining
backups converge to the elected prefix. The report records both phases,
the election, and a convergence check on the reconstructed logs
themselves (payload values, not just lengths).

Backups apply their log *in order*: a backup's state after a phase is the
contiguous delivered prefix of that phase's stream — exactly an RSM
replaying a log — so holes (deliverable only out of order) do not count
until filled. With ``use_reference=True`` the same procedure runs on the
pure-numpy multi-link oracle instead of the engine; the two must produce
identical reports on every fixture (``tests/test_torch_apps.py``).

With ``inject_via_replay=True`` the crash is no longer a static
schedule: phase 1 streams failure-free (on the primary side) while
``repro_torch.replay`` records chunk-boundary checkpoints, and the crash
is *injected* at the last boundary before ``crash_at``: a mid-stream
swap of the ``FailArrays`` the already-captured chunk programs read. The
report is bit-identical to the static-schedule run (a crash at round
``t`` only affects rounds ``>= t``), and the returned ``phase1_trace``
holds the pre-crash checkpoints, so what-if studies can fork alternative
futures (different crash times, no crash at all) from the same shared
prefix (``repro_torch.replay.fork_whatif``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Union

import numpy as np

from ..core.gc import snap_to_boundary
from ..core.simulator import _resolve_device
from ..core.types import FailureScenario, RSMConfig, SimConfig
from ..replay.trace import Injection as _Injection
from ..topology import (RefTopologyResult, Topology, TopologyResult,
                        link_specs, run_topology, run_topology_reference)

__all__ = ["RecoveryReport", "run_disaster_recovery"]


@dataclasses.dataclass
class RecoveryReport:
    """Outcome of a primary-crash + failover + catch-up cycle."""

    elected: str                        # most-caught-up backup
    phase1_prefixes: Dict[str, int]     # per-backup applied prefix at crash
    final_prefixes: Dict[str, int]      # per-backup prefix after catch-up
    converged: bool                     # all backups hold the elected log
    recovered_log: np.ndarray           # the elected backup's log (payloads)
    phase1: Union[TopologyResult, RefTopologyResult]
    phase2: Optional[Union[TopologyResult, RefTopologyResult]]
    # replay-injection provenance (inject_via_replay only): the chunk
    # boundary the crash was injected at, and the recorded pre-crash
    # trace for what-if forking (engine runs only).
    injected_at: Optional[int] = None
    phase1_trace: Optional[object] = None

    @property
    def recovered_entries(self) -> int:
        return int(len(self.recovered_log))


def _with_primary_crash(fails: FailureScenario, n_s: int,
                        crash_at: Optional[int]) -> FailureScenario:
    """Overlay the primary's crash round on a per-backup link scenario."""
    if crash_at is None:
        return fails
    if fails.crash_s is not None and any(c >= 0 for c in fails.crash_s):
        raise ValueError("backup link scenarios describe the receiver "
                         "side; the primary crash is set via crash_at")
    return dataclasses.replace(fails, crash_s=(crash_at,) * n_s)


def _catchup_steps(m: int, n_s: int, window: int) -> int:
    """Rounds for a failure-free catch-up stream of m messages."""
    return m // max(n_s * max(window, 1), 1) + 16 * n_s + 48


def _oracle_with_injection(topo: Topology, at_step: int,
                           scenarios) -> RefTopologyResult:
    """Numpy oracle of the injected run: the merged schedule from
    scratch, base masks until ``at_step``, crash masks after."""

    def schedule(t):
        return scenarios if t == at_step else None

    return run_topology_reference(topo, fail_schedule=schedule)


def run_disaster_recovery(
        primary_cfg: RSMConfig, backup_cfg: RSMConfig,
        sim: SimConfig,
        backups: Sequence[str] = ("backup-0", "backup-1"),
        crash_at: Optional[int] = None,
        backup_failures: Optional[Dict[str, FailureScenario]] = None,
        payloads: Optional[np.ndarray] = None,
        use_reference: bool = False,
        inject_via_replay: bool = False,
        device=None) -> RecoveryReport:
    """Stream, crash, elect, catch up, verify convergence, on ``device``
    (default: CUDA; raises if it is absent), or on the numpy oracle with
    ``use_reference`` (no device).

    backup_failures maps backup name -> receiver-side scenario on its
    link (crashed/byzantine backup replicas make the backups genuinely
    diverge); the primary's ``crash_at`` is overlaid on every link, as
    a static schedule by default, or as a replay-injected mid-stream
    event (``inject_via_replay=True``): the failure-free stream is
    recorded with checkpoints and the crash swapped in at the last chunk
    boundary before ``crash_at``, which produces the identical report
    and also returns the pre-crash trace for what-if forking.
    """
    if len(backups) < 2:
        raise ValueError("disaster recovery needs >= 2 backups (the "
                         "elected one must have peers to catch up)")
    m = sim.n_msgs
    payloads = (np.arange(m, dtype=np.int64) if payloads is None
                else np.asarray(payloads))
    if len(payloads) != m:
        raise ValueError(f"payloads has {len(payloads)} entries, stream "
                         f"carries {m}")
    if use_reference:
        dev = None
        run = run_topology_reference
    else:
        dev = _resolve_device(device)

        def run(topo):
            return run_topology(topo, device=dev)
    base_fails = {
        b: (backup_failures or {}).get(b, FailureScenario.none())
        for b in backups}
    fails = {
        b: _with_primary_crash(base_fails[b], primary_cfg.n, crash_at)
        for b in backups}

    # --- phase 1: primary streams its log until it crashes ---------------
    injected_at = None
    trace = None
    if inject_via_replay and crash_at is not None:
        # the crash is an *event*: record the no-crash stream, then swap
        # the crash schedule in at the last boundary before it hits.
        topo1 = Topology.fanout("primary", list(backups), primary_cfg,
                                sim, failures=base_fails,
                                backup_cfg=backup_cfg)
        injected_at = snap_to_boundary(
            crash_at, link_specs(topo1)[0].chunk_steps)
        injections = {
            f"primary->{b}": [_Injection(injected_at, fails[b])]
            for b in backups}
        if use_reference:
            r1 = _oracle_with_injection(topo1, injected_at,
                                        [fails[b] for b in backups])
        else:
            from ..replay import record_topology, replay_topology
            _, trace = record_topology(topo1, device=dev)
            r1 = replay_topology(trace, injected_at, injections, device=dev)
    else:
        topo1 = Topology.fanout("primary", list(backups), primary_cfg,
                                sim, failures=fails, backup_cfg=backup_cfg)
        r1 = run(topo1)
    prefixes = {b: r1[f"primary->{b}"].delivered_prefix() for b in backups}

    # --- failover: elect the most-caught-up backup (name tiebreak) -------
    elected = min(sorted(backups), key=lambda b: -prefixes[b])
    e_prefix = prefixes[elected]
    recovered = payloads[:e_prefix].copy()
    behind = [b for b in backups if b != elected]

    # --- phase 2: elected backup streams its log to the others -----------
    final = dict(prefixes)
    r2 = None
    if e_prefix > 0 and any(prefixes[b] < e_prefix for b in behind):
        sim2 = dataclasses.replace(
            sim, n_msgs=e_prefix,
            steps=_catchup_steps(e_prefix, backup_cfg.n, sim.window))
        topo2 = Topology.fanout(elected, behind, backup_cfg, sim2)
        r2 = run(topo2)
        for b in behind:
            caught = r2[f"{elected}->{b}"].delivered_prefix()
            # the backup already held prefixes[b]; replaying the elected
            # log extends its contiguous applied prefix to the catch-up
            # stream's own delivered prefix (same entries, same order).
            final[b] = max(prefixes[b], caught)

    converged = all(final[b] == e_prefix for b in backups) and bool(
        np.array_equal(recovered, payloads[:e_prefix]))
    return RecoveryReport(
        elected=elected, phase1_prefixes=prefixes, final_prefixes=final,
        converged=converged, recovered_log=recovered, phase1=r1, phase2=r2,
        injected_at=injected_at, phase1_trace=trace)
