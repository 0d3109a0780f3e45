"""Seeded workload generator for streaming sessions.

An :class:`ArrivalProcess` describes client traffic offered to one C3B
link in *messages per protocol round* (one round = one cross-RSM RTT,
``NetworkModel.rtt_s``).  :func:`arrivals_per_round` expands it into a
deterministic per-round arrival count sequence covering exactly
``horizon`` messages, and :func:`build_stream_spec` turns that sequence
into an engine ``SimSpec`` whose ``orig_step`` schedule *is* the
arrival process — the protocol's dispatch gate (``orig_step <= t``)
injects messages at the generated rounds, so no engine changes are
needed to shape traffic.

Four process kinds:

  ``constant``   fixed rate via exact fractional accumulation (no rng);
  ``diurnal``    sinusoidal rate modulation (period/amplitude) with
                 Poisson per-round counts — the paper's "millions of
                 simulated clients" day/night envelope;
  ``bursty``     two-state Markov-modulated Poisson process (on/off
                 transition probabilities, elevated on-state rate);
  ``heavytail``  Pareto-sized batches (shape ``alpha``) scaled so the
                 long-run mean matches ``rate``.

Everything is seeded and host-side numpy: the same seed gives the JAX
package's schedule, and ``build_stream_spec`` its ``SimSpec``, field by
field.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core.simulator import SimSpec, build_spec
from ..core.types import FailureScenario, RSMConfig, SimConfig

__all__ = [
    "ArrivalProcess",
    "arrivals_per_round",
    "dispatch_rounds",
    "stream_window_slots",
    "build_stream_spec",
]

KINDS = ("constant", "diurnal", "bursty", "heavytail")


@dataclasses.dataclass(frozen=True)
class ArrivalProcess:
    """One link's offered-load description (messages per round)."""

    kind: str = "constant"
    rate: float = 4.0          # long-run mean arrivals per round
    period: int = 512          # diurnal: rounds per day/night cycle
    amplitude: float = 0.5     # diurnal: fractional swing in [0, 1)
    p_on: float = 0.05         # bursty: off->on transition probability
    p_off: float = 0.25        # bursty: on->off transition probability
    burst_factor: float = 4.0  # bursty: on-state rate multiplier
    alpha: float = 1.8         # heavytail: Pareto shape (> 1)
    cap: int = 0               # per-round arrival cap (0 = 8x rate)
    seed: int = 0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown arrival kind {self.kind!r}; "
                             f"have {KINDS}")
        if self.rate <= 0:
            raise ValueError("rate must be positive")
        if self.kind == "heavytail" and self.alpha <= 1.0:
            raise ValueError("heavytail alpha must exceed 1 (finite mean)")

    def round_cap(self) -> int:
        return self.cap if self.cap > 0 else max(int(8 * self.rate), 64)


def _per_round_rates(p: ArrivalProcess, n: int) -> np.ndarray:
    t = np.arange(n, dtype=np.float64)
    if p.kind == "diurnal":
        return p.rate * (1.0 + p.amplitude
                         * np.sin(2.0 * np.pi * t / max(p.period, 1)))
    return np.full(n, p.rate, dtype=np.float64)


def arrivals_per_round(process: ArrivalProcess,
                       horizon: int) -> np.ndarray:
    """Per-round arrival counts summing exactly to ``horizon``.

    Generates in blocks until the cumulative count covers the horizon,
    then trims the final round so the stream carries exactly ``horizon``
    messages — the schedule length (number of loaded rounds) is the
    process's own, not fixed up front.
    """
    if horizon <= 0:
        raise ValueError("horizon must be positive")
    rng = np.random.default_rng(process.seed)
    cap = process.round_cap()
    counts: list = []
    total = 0
    frac = 0.0            # constant-kind exact accumulator
    on = False            # bursty-kind Markov state
    block = max(int(np.ceil(horizon / process.rate)) + 64, 256)
    while total < horizon:
        n0 = len(counts)
        if process.kind == "constant":
            got = np.empty(block, dtype=np.int64)
            for i in range(block):
                frac += process.rate
                got[i] = int(frac)
                frac -= got[i]
        elif process.kind == "diurnal":
            got = rng.poisson(
                np.clip(_per_round_rates(process, n0 + block)[n0:],
                        0.0, None)).astype(np.int64)
        elif process.kind == "bursty":
            pi_on = process.p_on / max(process.p_on + process.p_off,
                                       1e-12)
            rate_on = process.rate * process.burst_factor
            # off-state rate chosen so the long-run mean stays `rate`
            rate_off = max((process.rate - pi_on * rate_on)
                           / max(1.0 - pi_on, 1e-12), 0.0)
            got = np.empty(block, dtype=np.int64)
            flips = rng.random(block)
            for i in range(block):
                on = (flips[i] < process.p_on) if not on else \
                    (flips[i] >= process.p_off)
                got[i] = rng.poisson(rate_on if on else rate_off)
        else:  # heavytail
            # Pareto(alpha, xm) has mean alpha*xm/(alpha-1); pick xm so
            # floor(batch) keeps roughly the configured long-run rate
            xm = process.rate * (process.alpha - 1.0) / process.alpha
            got = np.floor((rng.pareto(process.alpha, block) + 1.0)
                           * xm).astype(np.int64)
        got = np.minimum(got, cap)
        counts.extend(int(x) for x in got)
        total += int(got.sum())
    # trim to exactly `horizon` messages
    out = np.asarray(counts, dtype=np.int64)
    cum = np.cumsum(out)
    last = int(np.searchsorted(cum, horizon))
    out = out[:last + 1].copy()
    out[last] -= int(cum[last]) - horizon
    return out


def dispatch_rounds(counts: np.ndarray) -> np.ndarray:
    """Expand per-round counts into each message's dispatch round."""
    counts = np.asarray(counts, dtype=np.int64)
    return np.repeat(np.arange(len(counts), dtype=np.int64), counts)


def stream_window_slots(counts: np.ndarray, n_s: int, n_r: int,
                        chunk_steps: int, phi: int,
                        slack_rounds: int = 8) -> int:
    """Window sized for the *offered load* instead of the send pacing.

    The frontier can trail the dispatch head by roughly a chunk plus
    the ack/retransmission rotation; the window must hold every arrival
    inside that lag, so we take the peak arrivals over any lag-sized
    span of the actual schedule (plus the phi slack), rounded up to 64.
    """
    counts = np.asarray(counts, dtype=np.int64)
    lag = max(int(chunk_steps), 1) + n_s + n_r + slack_rounds
    cum = np.concatenate([[0], np.cumsum(counts)])
    if len(cum) <= lag:
        peak = int(cum[-1])
    else:
        peak = int((cum[lag:] - cum[:-lag]).max())
        peak = max(peak, int(cum[min(lag, len(cum) - 1)]))
    return max(int(-(-(peak + phi) // 64) * 64), 64)


def build_stream_spec(sender: RSMConfig, receiver: RSMConfig,
                      sim: SimConfig, process: ArrivalProcess,
                      horizon: int,
                      failures: FailureScenario = FailureScenario.none(),
                      drain_slack: Optional[int] = None,
                      ) -> SimSpec:
    """Resolve a workload into an engine spec with an arrival-driven
    ``orig_step`` schedule.

    ``sim.n_msgs``/``sim.steps`` are derived (horizon; last arrival
    plus a drain tail), ``collect_metrics`` is forced on (the blocks
    are the session's live feed), and ``window_slots="auto"`` resolves
    through :func:`stream_window_slots` — sized for the offered load,
    never the dense fallback.
    """
    counts = arrivals_per_round(process, horizon)
    ostep = dispatch_rounds(counts)
    n_rounds = len(counts)
    if drain_slack is None:
        drain_slack = (max(sim.chunk_steps, 1) + sender.n + receiver.n
                       + 2 * sim.phi + 96)
    w_slots = sim.window_slots
    if w_slots in (None, "auto", 0):
        w_slots = stream_window_slots(counts, sender.n, receiver.n,
                                      sim.chunk_steps, sim.phi)
    w_slots = min(int(w_slots), max(horizon, 64))
    sim2 = dataclasses.replace(
        sim, n_msgs=horizon, steps=n_rounds + drain_slack,
        window_slots=int(w_slots), collect_metrics=True)
    spec = build_spec(sender, receiver, sim2, failures)
    return dataclasses.replace(
        spec, orig_step=tuple(int(x) for x in ostep))
