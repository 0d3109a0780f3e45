"""repro_torch.stream — streaming session driver ("C3B fabric as a
service").

Turns the fixed M-message batch engine into a resident service: a
seeded workload generator (:mod:`repro_torch.stream.workload` —
constant / diurnal / bursty / heavy-tailed arrival processes) schedules
an unbounded message horizon onto the link fabric, the engine runs it in
horizon mode (``drain_sink`` — O(W) device state, O(1) host memory per
superchunk, zero extra dispatches), and
:mod:`repro_torch.stream.session` aggregates the per-chunk
``MetricsBlock`` feed into live percentiles, rates, SLO watchdog events
and a periodic ``LiveReport``, calibrated against the analytic capacity
model in ``core/network.py``. Sessions run on the card unless the
caller passes ``device="cpu"``.

CLI: ``python -m repro_torch.stream`` (``--selftest`` for the smoke
check, ``--device cpu`` to run it on the CPU).
"""

from .session import (  # noqa: F401
    StreamConfig,
    StreamResult,
    StreamSession,
    analytic_capacity,
    run_stream,
)
from .workload import (  # noqa: F401
    ArrivalProcess,
    arrivals_per_round,
    build_stream_spec,
    dispatch_rounds,
    stream_window_slots,
)
