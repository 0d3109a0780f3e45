"""Readable pure-numpy reference simulator (the protocol oracle).

The port's own copy of the JAX package's ``core/refsim.py``: numpy only,
no torch. It mirrors ``simulator.py``'s round step for step in explicit
loops, so the protocol logic can be read top to bottom against §4–§5 of
the paper and the tensor implementation (on the CPU or the card) can be
held to it exactly, with no other package at run time.

The per-round transition lives in :class:`_RefMachine` so it can be driven
two ways: ``run_reference`` replays one link exactly like ``run_simulation``
(including the sliding-window mirror below), and the multi-link topology
oracle (``repro_torch.topology.refmirror``) drives one machine per link
with the same chunk boundaries and commit-floor plumbing as the topology
engine. Original dispatch is commit-gated exactly like the engine's step:
message ``k`` is attempted at the first round ``t >= orig_step[k]`` with
``k < commit_floor`` (a standalone link has ``commit_floor == m``, which
reduces the gate to the ungated schedule).

For a windowed spec (``spec.window_slots > 0``) the oracle also mirrors
the sliding-window machinery: it keeps full dense state (it is the
*oracle*, it never forgets) but advances the same GC frontier with the
same shared ``gc.gc_frontier`` rule at the same chunk boundaries as the
windowed engine — including the adaptive overflow policy
(``gc.grow_window``: widen the mirrored window 2x when a stalled frontier
would overflow it; when the doubling would reach M the engine migrates
its state into the dense layout and keeps rotating, which the oracle
mirrors by widening its window to M and carrying the frontier trajectory
on) — snapshots every retired slot's outputs at retirement time, and
asserts at the end of the run that none of them ever changed afterwards.
That is the ground truth for the windowed core: if the retirement rule
ever forgot a slot whose state could still move, the snapshot check fails
here first. The frontier trajectory is returned in
``RefResult.gc_frontiers`` so tests can compare it bit-for-bit against
``SimResult.gc_frontiers``, and ``RefResult.retired_quack_margin`` records
the smallest stake-weighted QUACK margin over all retired slots (a retired
slot must be QUACKed at *every* sender — §4.3's "both sides may forget the
quacked prefix").
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .gc import gc_frontier
from .simulator import (SimSpec, _max_msg_by_round, _widen_on_overflow,
                        spec_failures)

__all__ = ["run_reference"]


@dataclasses.dataclass
class RefResult:
    quack_time: np.ndarray    # (n_s, M)
    deliver_time: np.ndarray  # (M,)
    retry: np.ndarray         # (n_s, M)
    recv_has: np.ndarray      # (n_r, M)
    cross_msgs: np.ndarray    # (T,)
    intra_msgs: np.ndarray    # (T,)
    resends: np.ndarray      # (T,)
    gc_frontiers: Optional[np.ndarray] = None   # (n_chunks,) window base
    retired_quack_margin: Optional[float] = None
    # number of window slots the GC frontier retired while undelivered —
    # 0 whenever the adversary stake budget is within the §4.3 bound
    # (``simulator.retire_safety_stakes_ok``); the oracle counts it so
    # the safety property can be asserted independently of the engine
    retired_undelivered: Optional[int] = None
    # dispatch round of each original send (-1 = never dispatched) and
    # per-message retire-step - send-step (-1 = not delivered) — the
    # oracle for ``SimResult.send_step`` / ``SimResult.delivery_latency``
    send_step: Optional[np.ndarray] = None      # (M,)
    delivery_latency: Optional[np.ndarray] = None  # (M,)


def _cum(received_row: np.ndarray) -> int:
    p = 0
    for v in received_row:
        if not v:
            break
        p += 1
    return p


def _claim_and_missing(received_row: np.ndarray, phi: int):
    """Honest ack payload: (cum, claim bitmask, missing list<=phi)."""
    m = received_row.shape[0]
    cum = _cum(received_row)
    top = 0
    for k in range(m - 1, -1, -1):
        if received_row[k]:
            top = k + 1
            break
    missing = [k for k in range(top) if not received_row[k]][:phi]
    # horizon: strictly below the (phi+1)-th missing index
    gaps = [k for k in range(m) if not received_row[k]]
    horizon = gaps[phi] if len(gaps) > phi else m
    claim = np.zeros(m, dtype=bool)
    for k in range(m):
        if k < cum or (k < horizon and received_row[k]):
            claim[k] = True
    return cum, claim, missing


def _quorum_prefix(vals: np.ndarray, stakes: np.ndarray, thr: float) -> int:
    order = np.argsort(-vals, kind="stable")
    w = 0.0
    for i in order:
        w += stakes[i]
        if w >= thr:
            return int(vals[i])
    return 0


class _RefMachine:
    """One link's full protocol state + per-round transition (explicit
    loops). ``step(t, commit_floor)`` advances one synchronous round;
    ``frontier``/``retire`` mirror the device chunk-boundary rotation."""

    def __init__(self, spec: SimSpec):
        self.spec = spec
        self.n_s, self.n_r, self.m = spec.n_s, spec.n_r, spec.m
        self.phi = spec.phi
        self.set_quorum(spec)
        self.orig_sender = np.asarray(spec.orig_sender)
        self.orig_recv = np.asarray(spec.orig_recv)
        self.orig_step = np.asarray(spec.orig_step)
        self.rs_seq = np.asarray(spec.rs_seq)
        self.rr_seq = np.asarray(spec.rr_seq)
        self.set_failures(spec_failures(spec))

        n_s, n_r, m = self.n_s, self.n_r, self.m
        self.recv_has = np.zeros((n_r, m), dtype=bool)
        self.bcast_q = np.zeros((n_r, m), dtype=bool)
        self.bcast_done = np.zeros((n_r, m), dtype=bool)
        self.orig_sent = np.zeros(m, dtype=bool)
        self.known = np.zeros((n_s, n_r, m), dtype=bool)
        self.complaint = np.zeros((n_s, n_r, m), dtype=bool)
        self.repeat_c = np.zeros((n_s, n_r, m), dtype=bool)
        self.last_cum = np.full((n_s, n_r), -1, dtype=np.int64)
        self.retry = np.zeros((n_s, m), dtype=np.int64)
        self.quack_time = np.full((n_s, m), -1, dtype=np.int64)
        self.deliver_time = np.full(m, -1, dtype=np.int64)
        self.send_time = np.full(m, -1, dtype=np.int64)
        self.hq_reports = np.zeros((n_r, n_s), dtype=np.int64)
        self.ack_floor = np.zeros(n_r, dtype=np.int64)

        self.cross_hist: List[int] = []
        self.intra_hist: List[int] = []
        self.resend_hist: List[int] = []
        # (k, quack col, deliver, retry col, recv col) at retirement time
        self.retired_snaps: list = []
        self.retired_margin = np.inf
        self.retired_undelivered = 0

    def set_quorum(self, spec: SimSpec) -> None:
        """Swap stakes / quorum thresholds in force from the next step on.

        The oracle twin of the engine's stake re-weighting: stakes and
        thresholds ride the ``FailArrays`` the engine's programs read
        (``simulator.spec_with_quorum``), so a mid-stream swap at a chunk
        boundary changes no program — and costs the oracle one attribute
        update. The retransmit rotations (``rs_seq`` /
        ``rr_seq``) are committed at build and intentionally not swapped,
        matching the engine.
        """
        self.st_s = np.asarray(spec.stakes_s, dtype=np.float64)
        self.st_r = np.asarray(spec.stakes_r, dtype=np.float64)
        self.quack_thresh = float(spec.quack_thresh)
        self.dup_thresh = float(spec.dup_thresh)
        self.hq_thresh = float(spec.hq_thresh)

    def set_failures(self, failures) -> None:
        """Swap the failure masks in force from the next ``step`` on.

        The oracle twin of the engine's mid-stream ``FailArrays`` swap at
        a chunk boundary (replay schedule injection): crash or
        recover replicas, open or heal a partition, change drop/lie
        schedules. Protocol state (received sets, complaints, QUACK
        bookkeeping) is untouched — only the masks change.
        """
        n_s, n_r = self.n_s, self.n_r

        def tup(x, n, default):
            return np.asarray([default] * n if x is None else list(x))

        self.crash_s = tup(failures.crash_s, n_s, -1)
        self.crash_r = tup(failures.crash_r, n_r, -1)
        self.byz_send_drop = tup(failures.byz_send_drop, n_s, False)
        self.byz_recv_drop = tup(failures.byz_recv_drop, n_r, False)
        self.byz_ack_advance = tup(failures.byz_ack_advance, n_r, 0)
        self.byz_ack_low = tup(failures.byz_ack_low, n_r, False)
        self.byz_bcast_partial = tup(failures.byz_bcast_partial, n_r, False)
        self.bcast_limit = int(failures.bcast_limit)
        self.byz_equiv_send = tup(failures.byz_equiv_send, n_s, False)
        self.byz_hq_advance = tup(failures.byz_hq_advance, n_s, 0)
        self.byz_ack_stale = tup(failures.byz_ack_stale, n_r, False)
        dp = failures.drop_pair
        self.drop_pair = (np.zeros((n_s, n_r), dtype=bool) if dp is None
                          else np.asarray([list(r) for r in dp], dtype=bool))
        self.honest_r = ((self.crash_r < 0)
                         & ~(self.byz_recv_drop | self.byz_ack_low
                             | (self.byz_ack_advance > 0)
                             | self.byz_bcast_partial
                             | self.byz_ack_stale))

    def quacked_at(self, l: int) -> np.ndarray:
        w = (self.known[l].astype(np.float64)
             * self.st_r[:, None]).sum(axis=0)
        return w >= self.quack_thresh

    def delivered_prefix(self) -> int:
        return _cum(self.deliver_time >= 0)

    def step(self, t: int, commit_floor: Optional[int] = None) -> None:
        n_s, n_r, m, phi = self.n_s, self.n_r, self.m, self.phi
        floor = m if commit_floor is None else int(commit_floor)
        alive_s = (self.crash_s < 0) | (t < self.crash_s)
        alive_r = (self.crash_r < 0) | (t < self.crash_r)
        # stale-ack replay reads the complaint list as it stood at the
        # start of the round — before step (2) clears declared cycles —
        # exactly like the vectorized step reads ``state.complaint``
        stale_any = bool(self.byz_ack_stale.any())
        complaint_prev = self.complaint.copy() if stale_any else None

        # (1) broadcasts land
        intra = 0
        new_recv = np.zeros((n_r, m), dtype=bool)
        for j in range(n_r):
            if not alive_r[j]:
                continue
            for k in range(m):
                if self.bcast_q[j, k]:
                    targets = (range(min(self.bcast_limit, n_r))
                               if self.byz_bcast_partial[j] else range(n_r))
                    for i in targets:
                        if i == j:
                            continue
                        intra += 1
                        if alive_r[i]:
                            new_recv[i, k] = True
                    self.bcast_done[j, k] = True
        self.bcast_q[:] = False
        self.recv_has |= new_recv

        # (2) retransmissions (from knowledge as of t-1; only messages
        # whose original dispatch already happened — the sent bit, not the
        # schedule round, under commit-gated dispatch). Each wire entry
        # carries a ``lands`` flag: an equivocating sender's resend is
        # detected and discarded wholesale by the receiver, and a
        # drop_pair edge kills the copy in the network — either way the
        # wire copy happened (it counts in the metrics, the retry counter
        # and the election rotation advance) but nothing is stored, acked
        # or heard as §4.3 metadata.
        resends = []  # (sender, msg, target, lands)
        for l in range(n_s):
            qk = self.quacked_at(l)
            for k in range(m):
                w = float((self.repeat_c[l, :, k] * self.st_r).sum())
                if (w >= self.dup_thresh and not qk[k]
                        and self.orig_sent[k]):
                    self.retry[l, k] += 1
                    self.complaint[l, :, k] = False
                    self.repeat_c[l, :, k] = False
                    if self.rs_seq[(k + self.retry[l, k])
                                   % len(self.rs_seq)] == l:
                        if alive_s[l] and not self.byz_send_drop[l]:
                            tgt = int(self.rr_seq[(self.orig_recv[k]
                                                   + self.retry[l, k])
                                                  % len(self.rr_seq)])
                            lands = (not self.byz_equiv_send[l]
                                     and not self.drop_pair[l, tgt])
                            resends.append((l, k, tgt, lands))

        # (3) original sends + landing: a message is due once its schedule
        # round has passed AND its entry is committed on the source RSM;
        # the dispatch attempt happens exactly once, alive or not.
        wire = []  # (sender, msg, target, lands)
        for k in range(m):
            if (self.orig_sent[k] or self.orig_step[k] > t or k >= floor):
                continue
            self.orig_sent[k] = True
            self.send_time[k] = t
            l = self.orig_sender[k]
            if alive_s[l] and not self.byz_send_drop[l]:
                i = int(self.orig_recv[k])
                wire.append((int(l), k, i, not self.drop_pair[l, i]))
        wire.extend(resends)
        qp_prev = np.array([int(np.cumprod(self.quacked_at(l)).sum())
                            for l in range(n_s)])
        for (l, k, i, lands) in wire:
            if alive_r[i] and lands:
                # §4.3 metadata piggyback; an hq-lying sender inflates
                # its claimed prefix per receiver (min(true+adv+i, m)) so
                # no two receivers can cross-check the same number
                adv = int(self.byz_hq_advance[l])
                hq = (int(qp_prev[l]) if adv == 0
                      else min(int(qp_prev[l]) + adv + i, m))
                self.hq_reports[i, l] = max(self.hq_reports[i, l], hq)
                if not self.byz_recv_drop[i]:
                    if not self.recv_has[i, k]:
                        self.recv_has[i, k] = True
                        if not self.bcast_done[i, k]:
                            self.bcast_q[i, k] = True
        for k in range(m):
            if (self.deliver_time[k] < 0
                    and (self.recv_has[:, k] & self.honest_r).any()):
                self.deliver_time[k] = t

        # (4) acks
        for j in range(n_r):
            if not alive_r[j]:
                continue
            self.ack_floor[j] = max(
                self.ack_floor[j],
                _quorum_prefix(self.hq_reports[j], self.st_s,
                               self.hq_thresh))
            eff = self.recv_has[j].copy()
            eff[:self.ack_floor[j]] = True
            cum, claim, missing = _claim_and_missing(eff, phi)
            if self.byz_ack_low[j]:
                cum, claim, missing = 0, np.zeros(m, bool), list(range(phi))
            elif self.byz_ack_advance[j] > 0:
                cum = min(cum + int(self.byz_ack_advance[j]), m)
                claim = np.arange(m) < cum
                missing = []
            l = (j + t) % n_s
            # stale replay (applied LAST, freezing whatever the other
            # lie masks produced): resend the previous ack to this
            # round's target verbatim — its last cum counter, the prefix
            # claim below it, and its previous complaint list. Truthful
            # but old: monotone claims cannot fabricate receipt, but the
            # frozen cum trips the duplicate-cum complaint below.
            stale = bool(self.byz_ack_stale[j])
            if stale:
                cum = max(int(self.last_cum[l, j]), 0)
                claim = np.arange(m) < cum
            self.known[l, j] |= claim
            newc = np.zeros(m, dtype=bool)
            if stale:
                newc[:] = complaint_prev[l, j]
            else:
                for k in missing:
                    if k < m:
                        newc[k] = True
            if self.last_cum[l, j] == cum and cum < m:
                newc[cum] = True
            self.repeat_c[l, j] |= self.complaint[l, j] & newc
            self.complaint[l, j] = newc
            self.last_cum[l, j] = cum

        # (5) QUACK bookkeeping
        for l in range(n_s):
            qk = self.quacked_at(l)
            newly = qk & (self.quack_time[l] < 0)
            self.quack_time[l, newly] = t

        self.cross_hist.append(len(wire))
        self.intra_hist.append(intra)
        self.resend_hist.append(len(resends))

    def frontier(self, base: int, win: int, t_next: int) -> int:
        """Shared §4.3 retirement rule over window ``[base, base+win)``."""
        lo, hi = base, base + win
        return gc_frontier(
            base=base, t_next=t_next, m=self.m,
            known=self.known[:, :, lo:hi], bcast_q=self.bcast_q[:, lo:hi],
            recv_has=self.recv_has[:, lo:hi], ack_floor=self.ack_floor,
            stakes_r=self.st_r, quack_thresh=self.quack_thresh,
            orig_sent=self.orig_sent[lo:hi], crash_r=self.crash_r,
            byz_ack_low=self.byz_ack_low)

    def retire(self, base: int, f: int) -> None:
        """Snapshot slots ``[base, base+f)`` at retirement time."""
        for k in range(base, base + f):
            # §4.3 safety: a retired slot must be physically held by at
            # least one replica of the receiver RSM — recv_has is ground
            # truth receipt, so a quorum of fabricated claims (the only
            # way to quack an unreceived message) is caught here even
            # when every truthful holder sits outside honest_r
            # (bcast-partial or later-crashing replicas).
            if not self.recv_has[:, k].any():
                self.retired_undelivered += 1
            # float32 like the step's stake sums (see gc_frontier)
            w_k = (self.known[:, :, k].astype(np.float32)
                   * self.st_r[None, :].astype(np.float32)).sum(axis=1)
            self.retired_margin = min(self.retired_margin,
                                      float(w_k.min()))
            self.retired_snaps.append((k, self.quack_time[:, k].copy(),
                                       self.deliver_time[k],
                                       self.retry[:, k].copy(),
                                       self.recv_has[:, k].copy()))

    def assert_retirement_safe(self) -> None:
        """A retired slot's outputs must never change again."""
        for (k, qt, dt, rt, rh) in self.retired_snaps:
            assert np.array_equal(qt, self.quack_time[:, k]), (
                f"retired slot {k}: quack_time changed after retirement")
            assert dt == self.deliver_time[k], (
                f"retired slot {k}: deliver_time changed after retirement")
            assert np.array_equal(rt, self.retry[:, k]), (
                f"retired slot {k}: retry changed after retirement")
            assert np.array_equal(rh, self.recv_has[:, k]), (
                f"retired slot {k}: recv_has changed after retirement")

    def result(self, frontiers: Optional[np.ndarray],
               windowed: bool) -> RefResult:
        return RefResult(
            quack_time=self.quack_time, deliver_time=self.deliver_time,
            retry=self.retry, recv_has=self.recv_has,
            cross_msgs=np.array(self.cross_hist),
            intra_msgs=np.array(self.intra_hist),
            resends=np.array(self.resend_hist),
            gc_frontiers=frontiers,
            retired_quack_margin=(self.retired_margin if windowed
                                  else None),
            retired_undelivered=(self.retired_undelivered if windowed
                                 else None),
            send_step=self.send_time.copy(),
            delivery_latency=np.where(
                self.deliver_time >= 0,
                self.deliver_time - self.send_time, -1))


def run_reference(spec: SimSpec, fail_schedule=None) -> RefResult:
    """Oracle run; ``fail_schedule(t)`` is consulted at chunk starts and
    swaps the failure state in force from round ``t`` on — the numpy twin
    of the engine's mid-stream ``FailArrays`` swap, so replayed-with-
    injection runs can be checked against a from-scratch oracle executing
    the merged schedule. Each entry may be a ``FailureScenario`` (mask
    swap only) or a full ``SimSpec`` (mask swap *plus* stake/threshold
    re-weighting — the reconfiguration primitive, mirroring the engine's
    ``fail_schedule`` returning ``spec_with_quorum`` specs)."""
    mac = _RefMachine(spec)

    # --- sliding-window mirror (windowed specs only) ----------------------
    win = spec.window_slots
    chunk = max(spec.chunk_steps, 1)
    base = 0
    bases = [0] if win else None
    dispatched_by = _max_msg_by_round(spec) if win else None

    for t in range(spec.steps):
        # (0) failure-schedule swap at chunk starts, exactly where the
        # engine rebuilds its stacked FailArrays.
        if fail_schedule is not None and t % chunk == 0:
            new_fails = fail_schedule(t)
            if new_fails is not None:
                if isinstance(new_fails, SimSpec):
                    mac.set_quorum(new_fails)
                    mac.set_failures(spec_failures(new_fails))
                else:
                    mac.set_failures(new_fails)
        # window mirror: adaptive overflow policy at chunk starts,
        # exactly where the windowed engine checks before a chunk.
        if win and t % chunk == 0:
            chunk_end = min(t + chunk, spec.steps) - 1
            need = int(dispatched_by[chunk_end])
            if need >= base + win:
                new_w = _widen_on_overflow(spec, win, base, need, chunk_end)
                # None => the engine migrates its state into the
                # dense layout (W = M) and keeps rotating; mirror by
                # widening the window to M and carrying the trajectory on.
                win = spec.m if new_w is None else new_w

        mac.step(t)

        # (6) window mirror: advance the GC frontier at chunk boundaries,
        # exactly where the windowed engine rotates its ring buffers
        # in-graph.
        t_next = t + 1
        if win and t_next % chunk == 0 and t_next < spec.steps:
            f = mac.frontier(base, win, t_next)
            mac.retire(base, f)
            base += f
            bases.append(base)

    mac.assert_retirement_safe()
    frontiers = np.asarray(bases, dtype=np.int64) if win else None
    return mac.result(frontiers, bool(win))
