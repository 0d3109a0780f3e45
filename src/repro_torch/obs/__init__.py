"""repro_torch.obs — the observability layer (the names of ``repro.obs``).

  * :mod:`repro_torch.obs.metrics` — the metrics fabric carried through
    the dense blocks, chunks and superchunks (and so through their CUDA
    graphs): delivery-latency histograms, occupancy/GC-lag high-water
    marks, quorum trigger counts. Device half in torch, host half numpy.
  * :mod:`repro_torch.obs.tracer` — host-side monotonic-clock span tracer
    with Chrome-trace/Perfetto export and the drain-overlap ratio.
  * :mod:`repro_torch.obs.live` — online aggregation over the per-chunk
    blocks (mergeable latency sketches, windowed rates, trend lines, SLO
    watchdogs, ``LiveReport``).
  * :mod:`repro_torch.obs.report` — merges device metrics and host spans
    into one ``RunReport`` (npz + json); CLI via
    ``python -m repro_torch.obs``.

``report`` imports the engine, and the engine imports ``metrics`` and
``tracer``, so this package init pulls in only the cycle-free halves;
import ``repro_torch.obs.report`` directly.
"""

from .live import (  # noqa: F401
    LatencySketch,
    LiveAggregator,
    LiveReport,
    LiveSample,
    SLOConfig,
    SLOEvent,
    SLOWatchdog,
    TrendLine,
)
from .metrics import (  # noqa: F401
    LATENCY_BUCKET_EDGES,
    NUM_LATENCY_BUCKETS,
    MetricsBlock,
    MetricsCarry,
    ObsMetrics,
    bucket_label,
    delta_metrics_block,
    init_metrics_carry,
    latency_bucket,
    latency_bucket_np,
    latency_histogram_np,
    merge_metrics_blocks,
    migrate_dense_metrics,
    obs_from_carry,
    obs_from_final,
    pad_metrics,
    percentile_from_hist,
    resume_metrics_carry,
    rotate_metrics,
    snapshot_metrics,
    update_metrics,
    zero_metrics_block,
)
from .tracer import (  # noqa: F401
    CounterSample,
    InstantEvent,
    Span,
    SpanTracer,
    current_tracer,
    obs_begin,
    obs_end,
    obs_span,
    tracing,
)
