"""Paper §6 applications of C3B, end to end on the topology layer.

    from repro_torch.apps import run_disaster_recovery, run_reconciliation

Disaster recovery: a primary RSM streams its committed log to N backup
RSMs; on a primary crash, failover elects the most-caught-up backup and
a catch-up session converges the rest. Data reconciliation: N RSMs with
divergent key-value stores exchange deltas over a bidirectional link
mesh until the stores merge (last-writer-wins). Both run every link as
one lane of one windowed run, one dispatch per chunk, on CUDA unless the
caller passes ``device="cpu"``, and are bit-identical to the pure-numpy
multi-link oracle (``use_reference=True``, no device).
"""

from .disaster_recovery import RecoveryReport, run_disaster_recovery
from .reconciliation import (ReconciliationReport, lww_merge,
                             run_reconciliation)

__all__ = [
    "RecoveryReport", "run_disaster_recovery",
    "ReconciliationReport", "lww_merge", "run_reconciliation",
]
