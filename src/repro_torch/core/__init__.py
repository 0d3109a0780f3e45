"""PICSOU / C3B protocol core on torch — the paper's contribution.

Public API (the names of ``repro.core``):

    from repro_torch.core import (RSMConfig, NetworkModel, SimConfig,
                                  FailureScenario, run_picsou,
                                  analytic_throughput)

    run = run_picsou(RSMConfig.bft(1), RSMConfig.bft(1))   # on CUDA
    run = run_picsou(RSMConfig.bft(1), RSMConfig.bft(1), device="cpu")
    assert run.all_delivered and run.cross_copies_per_msg < 1.01

A ``SimConfig`` with ``window_slots`` (an int or ``"auto"``) runs the
windowed engine: O(W) device state, GC rotation, adaptive growth, up to
``superchunk`` chunks a dispatch. ``run_picsou_batch`` runs a sweep of
failure scenarios as the lanes of one run. On CUDA every dispatch is a
CUDA-graph replay (``graphs``).
"""

from .gc import (ack_floor_from_reports, chunk_boundaries, collectable,
                 default_window_slots, gc_frontier, gc_frontier_device,
                 grow_window, resolve_window_slots, snap_to_boundary)
from .protocols import (C3BRun, analytic_throughput, ata_loads, ost_loads,
                        picsou_loads, run_picsou, run_picsou_batch,
                        staked_picsou_throughput)
from .quack import (claim_bitmask, cumulative_ack, missing_below_horizon,
                    selective_quack, stake_quorum_bitmap,
                    weighted_quorum_prefix)
from .retransmit import (declared_lost, elect_retransmitter,
                         empirical_delivery_probability, faulty_pair_bound,
                         max_retransmissions, theorem1_resends)
from .scheduler import (dss_sequence, hamilton_apportion, lottery_sequence,
                        round_robin_sequence, sender_assignment,
                        skewed_rr_sequence)
from .simulator import (ChunkQueue, FailArrays, SimResult, SimSpec,
                        WindowGrowthEvent, build_spec, chunk_dispatch_count,
                        chunk_trace_count, host_sync_count,
                        require_uniform_batch, run_simulation,
                        run_simulation_batch)
from .types import (FailureScenario, NetworkModel, RSMConfig, SimConfig,
                    lcm_scale_factors)

__all__ = [
    "RSMConfig", "NetworkModel", "SimConfig", "FailureScenario",
    "SimSpec", "SimResult", "FailArrays", "build_spec", "run_simulation",
    "run_simulation_batch", "require_uniform_batch", "chunk_trace_count",
    "chunk_dispatch_count", "host_sync_count",
    "ChunkQueue", "WindowGrowthEvent",
    "default_window_slots", "resolve_window_slots", "gc_frontier",
    "gc_frontier_device", "grow_window", "collectable",
    "ack_floor_from_reports", "chunk_boundaries", "snap_to_boundary",
    "C3BRun", "run_picsou", "run_picsou_batch", "analytic_throughput",
    "staked_picsou_throughput",
    "picsou_loads", "ata_loads", "ost_loads",
    "cumulative_ack", "claim_bitmask", "missing_below_horizon",
    "weighted_quorum_prefix", "selective_quack", "stake_quorum_bitmap",
    "elect_retransmitter", "declared_lost", "max_retransmissions",
    "faulty_pair_bound", "theorem1_resends",
    "empirical_delivery_probability",
    "hamilton_apportion", "dss_sequence", "skewed_rr_sequence",
    "lottery_sequence", "round_robin_sequence", "sender_assignment",
    "lcm_scale_factors",
]
