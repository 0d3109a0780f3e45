"""The metrics fabric: per-lane observability carried through the engine.

A small ``NamedTuple`` of device tensors (:class:`MetricsCarry`) rides
beside ``SimState`` through every dense block, chunk and superchunk, and
so through every captured CUDA graph. Every protocol round it
accumulates, per lane:

  * a delivery-latency histogram: bucketed ``retire_step - send_step``
    deltas over fixed power-of-two buckets,
  * window-occupancy and GC-frontier-lag high-water marks,
  * QUACK / loss-quorum trigger counts and cumulative resend totals.

Every leaf has a leading lane axis B and is int32: ``send_time`` (B, W),
``latency_hist`` (B, 18), the rest (B,). Every reduction sums in int32,
so nothing here adds an int64 pass to the round. Only the scalar
accumulators leave the device: :func:`snapshot_metrics` gives a
:class:`MetricsBlock` (no window-shaped leaves) that rides the drain
each dispatch already has, so the fabric adds no dispatch, no copy and
no host sync. The per-slot ``send_time`` ring stays on the device and is
rotated and padded in lockstep with the window (:func:`rotate_metrics`,
:func:`pad_metrics`).

Everything is derived from state deltas: ``_protocol_step`` is
untouched, and with ``SimConfig.collect_metrics`` off the engine runs
exactly the programs it runs without the fabric.

The histogram is a one-hot sum over W: each counted delivery's bucket is
compared with the 18 bucket ids and the (B, W, 18) booleans summed over
W in int32, with uncounted slots sent to an id no bucket has. Integer
sums are exact in any order, as the JAX package's ``.at[bucket].add`` is;
a ``scatter_add_`` into (B, 18) would be exact too, but on the card it
is W atomic adds into a handful of addresses (every slot of a lane tends
to fall in the same bucket), which serialise, while the one-hot sum is
one pass over 18 W bytes.

The second half is host-side numpy: the block algebra (delta, merge),
the numpy oracles of the histogram, percentiles and :class:`ObsMetrics`,
the per-lane summary a run returns.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

__all__ = [
    "NUM_LATENCY_BUCKETS",
    "LATENCY_BUCKET_EDGES",
    "MetricsCarry",
    "MetricsBlock",
    "ObsMetrics",
    "init_metrics_carry",
    "update_metrics",
    "metrics_updater",
    "rotate_metrics",
    "pad_metrics",
    "snapshot_metrics",
    "stack_blocks",
    "zero_metrics_block",
    "delta_metrics_block",
    "merge_metrics_blocks",
    "latency_bucket",
    "latency_bucket_np",
    "latency_histogram_np",
    "bucket_label",
    "percentile_from_hist",
    "migrate_dense_metrics",
    "resume_metrics_carry",
    "obs_from_carry",
    "obs_from_final",
]

# Power-of-two bucket edges. A latency ``x`` lands in bucket ``#edges <=
# x``: bucket 0 holds x < 1 (same-round retirement), bucket i holds
# 2^(i-1) <= x < 2^i, and the last bucket is the >= 2^16 overflow sink.
NUM_LATENCY_BUCKETS = 18
LATENCY_BUCKET_EDGES = tuple(2 ** i for i in range(NUM_LATENCY_BUCKETS - 1))

_I32 = torch.int32


class MetricsCarry(NamedTuple):
    """Device-resident metrics state of B lanes at window width W.

    ``send_time`` is window-shaped (one slot per live message, -1 when
    the slot's message has not been dispatched); everything else is a
    per-lane accumulator.
    """

    send_time: torch.Tensor      # (B, W) int32, dispatch round or -1
    latency_hist: torch.Tensor   # (B, NUM_LATENCY_BUCKETS) int32
    occupancy_hwm: torch.Tensor  # (B,) int32, max in-flight msgs
    gc_lag_hwm: torch.Tensor     # (B,) int32, max dispatched-in-window
    quack_events: torch.Tensor   # (B,) int32, QUACK quorum first-trips
    loss_events: torch.Tensor    # (B,) int32, loss-quorum (retry) triggers
    resend_total: torch.Tensor   # (B,) int32, cumulative resent messages
    uncounted: torch.Tensor      # (B,) int32, deliveries with unknown send


class MetricsBlock(NamedTuple):
    """The accumulators of a ``MetricsCarry``, drained per chunk: device
    tensors in the engine, numpy arrays on the host."""

    latency_hist: torch.Tensor   # (B, NUM_LATENCY_BUCKETS)
    occupancy_hwm: torch.Tensor  # (B,)
    gc_lag_hwm: torch.Tensor
    quack_events: torch.Tensor
    loss_events: torch.Tensor
    resend_total: torch.Tensor
    uncounted: torch.Tensor


def init_metrics_carry(w_slots: int, device, lanes: int = 1) -> MetricsCarry:
    """A fresh carry of ``lanes`` lanes at width ``w_slots`` on
    ``device``. The leaves are distinct tensors (a captured graph
    rewrites each in place)."""
    def zeros():
        return torch.zeros((lanes,), dtype=_I32, device=device)

    return MetricsCarry(
        send_time=torch.full((lanes, w_slots), -1, dtype=_I32,
                             device=device),
        latency_hist=torch.zeros((lanes, NUM_LATENCY_BUCKETS), dtype=_I32,
                                 device=device),
        occupancy_hwm=zeros(), gc_lag_hwm=zeros(), quack_events=zeros(),
        loss_events=zeros(), resend_total=zeros(), uncounted=zeros())


def _edges(device) -> torch.Tensor:
    """The bucket edges as an int32 tensor made on ``device`` (a kernel,
    no host copy: safe inside a capture)."""
    ids = torch.arange(NUM_LATENCY_BUCKETS - 1, dtype=_I32, device=device)
    return torch.bitwise_left_shift(torch.ones_like(ids), ids)


def latency_bucket(lat: torch.Tensor) -> torch.Tensor:
    """Bucket index (int32) of each int32 latency."""
    return torch.bucketize(lat, _edges(lat.device), out_int32=True,
                           right=True)


def metrics_updater(device):
    """``update(mc, old_state, new_state, metrics, t)``: the round update
    of :func:`update_metrics`, with its constants (bucket edges and ids)
    made once on ``device``, so that a chunk of rounds makes them once."""
    edges = _edges(device)
    ids = torch.arange(NUM_LATENCY_BUCKETS, dtype=_I32, device=device)

    def update(mc: MetricsCarry, old, new, metrics: torch.Tensor,
               t: torch.Tensor) -> MetricsCarry:
        sent_now = new.orig_sent > old.orig_sent
        send_time = torch.where(sent_now, t, mc.send_time)

        delivered_now = (old.deliver_time < 0) & (new.deliver_time >= 0)
        known = send_time >= 0
        counted = delivered_now & known
        lat = (t - send_time).clamp_(min=0)
        bucket = torch.where(counted,
                             torch.bucketize(lat, edges, out_int32=True,
                                             right=True),
                             NUM_LATENCY_BUCKETS)
        hist = (bucket[:, :, None] == ids).sum(dim=1, dtype=_I32)

        # in flight; dispatched slots still resident in the window (how
        # far the GC frontier trails the dispatch head); deliveries whose
        # send round is unknown
        per_slot = torch.stack([new.orig_sent & (new.deliver_time < 0),
                                new.orig_sent, delivered_now > known], 1)
        in_flight, gc_lag, unknown = per_slot.sum(dim=2, dtype=_I32).unbind(1)
        quacked = ((old.quack_time < 0) & (new.quack_time >= 0)).sum(
            dim=(1, 2), dtype=_I32)
        losses = (new.retry - old.retry).sum(dim=(1, 2), dtype=_I32)
        return MetricsCarry(
            send_time=send_time,
            latency_hist=mc.latency_hist + hist,
            occupancy_hwm=torch.maximum(mc.occupancy_hwm, in_flight),
            gc_lag_hwm=torch.maximum(mc.gc_lag_hwm, gc_lag),
            quack_events=mc.quack_events + quacked,
            loss_events=mc.loss_events + losses,
            resend_total=mc.resend_total + metrics[:, 2],
            uncounted=mc.uncounted + unknown)

    return update


def update_metrics(mc: MetricsCarry, old_state, new_state,
                   metrics: torch.Tensor, t: torch.Tensor) -> MetricsCarry:
    """Fold one protocol round's state delta into the carry.

    ``old_state``/``new_state`` are the window-shaped ``SimState`` of B
    lanes before/after ``_protocol_step`` at round ``t`` (a () int32
    tensor); ``metrics`` is the round's (B, 6) int32 ``StepMetrics``
    tensor. A pure function of its inputs that neither copies from the
    host nor waits for the device, so it can be captured in a graph.
    """
    return metrics_updater(mc.send_time.device)(mc, old_state, new_state,
                                                metrics, t)


def rotate_metrics(mc: MetricsCarry, frontier: torch.Tensor,
                   w_slots: int) -> MetricsCarry:
    """Shift each lane's ``send_time`` by its GC frontier (B,), the same
    gather as the ring rotation of the state, filling with -1."""
    st = mc.send_time
    ext = torch.cat([st, torch.full_like(st, -1)], dim=1)
    ix = (frontier[:, None]
          + torch.arange(w_slots, dtype=_I32, device=st.device)).long()
    return mc._replace(send_time=torch.gather(ext, 1, ix))


def pad_metrics(mc: MetricsCarry, new_w: int) -> MetricsCarry:
    """Grow ``send_time`` to ``new_w`` slots."""
    st = mc.send_time
    fill = torch.full(st.shape[:-1] + (new_w - st.shape[-1],), -1,
                      dtype=_I32, device=st.device)
    return mc._replace(send_time=torch.cat([st, fill], dim=-1))


def snapshot_metrics(mc: MetricsCarry) -> MetricsBlock:
    """The accumulators only: what rides the drain."""
    return MetricsBlock(*(getattr(mc, f) for f in MetricsBlock._fields))


def stack_blocks(blocks: Sequence[MetricsBlock]) -> MetricsBlock:
    """K blocks as one with a leading K axis (a superchunk's output)."""
    return MetricsBlock(*(torch.stack([getattr(b, f) for b in blocks])
                          for f in MetricsBlock._fields))


# Block algebra (host-side numpy). Snapshots drained from the engine are
# cumulative: the block after chunk i holds totals since round 0.
# ``delta_metrics_block`` turns consecutive snapshots into per-interval
# sketches; ``merge_metrics_blocks`` recombines any grouping of those
# sketches. Counters are integer-additive and HWMs are maxes of a
# monotone sequence, so folds are exact in any association order.

_BLOCK_ADDITIVE = ("latency_hist", "quack_events", "loss_events",
                   "resend_total", "uncounted")
_BLOCK_HWM = ("occupancy_hwm", "gc_lag_hwm")


def _block_np(b: MetricsBlock) -> MetricsBlock:
    return MetricsBlock(*(np.asarray(v, dtype=np.int64) for v in b))


def zero_metrics_block(n_lanes: Optional[int] = None) -> MetricsBlock:
    """Identity element for :func:`merge_metrics_blocks` (numpy)."""
    lead = () if n_lanes is None else (n_lanes,)
    return MetricsBlock(
        latency_hist=np.zeros(lead + (NUM_LATENCY_BUCKETS,),
                              dtype=np.int64),
        **{f: np.zeros(lead, dtype=np.int64)
           for f in MetricsBlock._fields if f != "latency_hist"})


def delta_metrics_block(prev: Optional[MetricsBlock],
                        cur: MetricsBlock) -> MetricsBlock:
    """Per-interval sketch between two cumulative snapshots.

    Additive counters subtract; HWMs keep ``cur`` (the running max is
    monotone, so re-merging deltas restores the end-of-run max).
    ``prev=None`` means the start of the stream (all-zero baseline).
    """
    cur = _block_np(cur)
    if prev is None:
        return cur
    prev = _block_np(prev)
    return cur._replace(**{f: getattr(cur, f) - getattr(prev, f)
                           for f in _BLOCK_ADDITIVE})


def merge_metrics_blocks(a: MetricsBlock, b: MetricsBlock) -> MetricsBlock:
    """Exact merge of two interval sketches (add counters, max HWMs)."""
    a, b = _block_np(a), _block_np(b)
    out = {f: getattr(a, f) + getattr(b, f) for f in _BLOCK_ADDITIVE}
    out.update({f: np.maximum(getattr(a, f), getattr(b, f))
                for f in _BLOCK_HWM})
    return MetricsBlock(**out)


# ---------------------------------------------------------------------------
# Host-side mirrors & summaries
# ---------------------------------------------------------------------------


def latency_bucket_np(lat) -> np.ndarray:
    edges = np.asarray(LATENCY_BUCKET_EDGES, dtype=np.int64)
    return (np.asarray(lat)[..., None] >= edges).sum(axis=-1)


def latency_histogram_np(latencies) -> np.ndarray:
    """Oracle histogram from a raw latency array (-1 = undelivered)."""
    lat = np.asarray(latencies).ravel()
    lat = lat[lat >= 0]
    hist = np.zeros(NUM_LATENCY_BUCKETS, dtype=np.int64)
    np.add.at(hist, latency_bucket_np(lat), 1)
    return hist


def bucket_label(i: int) -> str:
    if i == 0:
        return "0"
    if i == NUM_LATENCY_BUCKETS - 1:
        return ">=%d" % LATENCY_BUCKET_EDGES[-1]
    lo, hi = LATENCY_BUCKET_EDGES[i - 1], LATENCY_BUCKET_EDGES[i]
    if hi - lo == 1:
        return "%d" % lo
    return "%d-%d" % (lo, hi - 1)


def percentile_from_hist(hist, q: float) -> int:
    """Upper bucket edge covering the q-th percentile (q in [0,100]).

    Conservative (bucketed) estimate: returns the smallest power-of-two
    edge E such that at least q% of counted deliveries had latency < E
    (0 for bucket 0). -1 when the histogram is empty.
    """
    hist = np.asarray(hist, dtype=np.int64)
    total = int(hist.sum())
    if total == 0:
        return -1
    need = q / 100.0 * total
    cum = np.cumsum(hist)
    idx = int(np.searchsorted(cum, need))       # bucket holding the q-th
    if idx == 0:
        return 0                                # bucket 0: latency < 1
    # bucket i (i >= 1) holds [2^(i-1), 2^i): upper edge = edges[i]; the
    # overflow sink has no finite upper edge, so report its lower one
    return int(LATENCY_BUCKET_EDGES[min(idx,
                                        len(LATENCY_BUCKET_EDGES) - 1)])


@dataclasses.dataclass
class ObsMetrics:
    """Per-lane device-metrics summary drained from one run."""

    latency_hist: np.ndarray            # (NUM_LATENCY_BUCKETS,) int64
    occupancy_hwm: int
    gc_lag_hwm: int
    quack_events: int
    loss_events: int
    resend_total: int
    uncounted: int
    per_chunk_hist: Optional[np.ndarray] = None  # (n_chunks, NB) int64

    def total_counted(self) -> int:
        return int(np.asarray(self.latency_hist).sum())

    def percentiles(self, qs=(50, 95, 99)) -> dict:
        return {"p%g" % q: percentile_from_hist(self.latency_hist, q)
                for q in qs}

    def to_dict(self) -> dict:
        d = {
            "latency_hist": np.asarray(self.latency_hist).tolist(),
            "bucket_labels": [bucket_label(i)
                              for i in range(NUM_LATENCY_BUCKETS)],
            "occupancy_hwm": int(self.occupancy_hwm),
            "gc_lag_hwm": int(self.gc_lag_hwm),
            "quack_events": int(self.quack_events),
            "loss_events": int(self.loss_events),
            "resend_total": int(self.resend_total),
            "uncounted": int(self.uncounted),
            "total_counted": self.total_counted(),
        }
        d.update(self.percentiles())
        return d


def migrate_dense_metrics(mc: MetricsCarry, bases: Sequence[int],
                          send_step: np.ndarray, m: int,
                          device) -> MetricsCarry:
    """Re-embed a carry fetched to the host (numpy leaves, lane axis in
    front) into the dense layout (base 0, W = M), on ``device``.

    Called only from the engine's dense migration, whose one
    device->host copy of the state fetched ``mc`` too. Slots already
    retired out of the ring are refilled from the host ``send_step``
    dispatch mirror (B, M), so the carry stays exact across the fallback.
    """
    st = np.asarray(mc.send_time)
    n_b, w = st.shape
    dense = np.full((n_b, m), -1, dtype=np.int32)
    for b in range(n_b):
        lo = int(bases[b])
        live = min(w, m - lo)
        if live > 0:
            dense[b, lo:lo + live] = st[b, :live]
        if lo > 0:
            dense[b, :lo] = send_step[b, :lo]
    return MetricsCarry(*(torch.tensor(np.asarray(x, dtype=np.int32),
                                       device=device)
                          for x in (dense,) + tuple(mc[1:])))


def resume_metrics_carry(w_slots: int, bases: Sequence[int],
                         send_step: np.ndarray, m: int,
                         device) -> MetricsCarry:
    """Fresh carry of ``len(bases)`` lanes for a replay resume, on
    ``device``.

    Accumulators restart at zero (metrics cover the resumed segment);
    ``send_time`` is seeded from the checkpointed dispatch mirror (B, M)
    so latencies of messages in flight across the boundary stay exact.
    """
    n_b = len(bases)
    st = np.full((n_b, w_slots), -1, dtype=np.int32)
    for b in range(n_b):
        lo = int(bases[b])
        live = max(0, min(w_slots, m - lo))
        if live > 0:
            st[b, :live] = send_step[b, lo:lo + live]
    mc = init_metrics_carry(w_slots, device, n_b)
    return mc._replace(send_time=torch.tensor(st, device=device))


def obs_from_carry(mc) -> ObsMetrics:
    """Unbatched carry of host values (one lane without a lane axis)."""
    return ObsMetrics(
        latency_hist=np.asarray(mc.latency_hist, dtype=np.int64),
        occupancy_hwm=int(mc.occupancy_hwm),
        gc_lag_hwm=int(mc.gc_lag_hwm),
        quack_events=int(mc.quack_events),
        loss_events=int(mc.loss_events),
        resend_total=int(mc.resend_total),
        uncounted=int(mc.uncounted),
    )


def obs_from_final(final_mc, blocks, lane: int) -> ObsMetrics:
    """One lane's :class:`ObsMetrics` from the fetched final carry (numpy
    leaves with a lane axis) plus the per-chunk :class:`MetricsBlock`
    drain parts."""
    per_chunk = None
    if blocks:
        per_chunk = np.stack(
            [np.asarray(b.latency_hist[lane], dtype=np.int64)
             for b in blocks])
    return ObsMetrics(
        latency_hist=np.asarray(final_mc.latency_hist[lane],
                                dtype=np.int64),
        occupancy_hwm=int(final_mc.occupancy_hwm[lane]),
        gc_lag_hwm=int(final_mc.gc_lag_hwm[lane]),
        quack_events=int(final_mc.quack_events[lane]),
        loss_events=int(final_mc.loss_events[lane]),
        resend_total=int(final_mc.resend_total[lane]),
        uncounted=int(final_mc.uncounted[lane]),
        per_chunk_hist=per_chunk,
    )
