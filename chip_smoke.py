#!/usr/bin/env python3
"""Drive the torch port of the PICSOU simulator on one CUDA card.

    python3 chip_smoke.py          # from any directory: the checkout's
                                   # src/ is put on sys.path

Phases, each of which raises on failure (exit code non-zero):

1. The card's name and power limit, as nvidia-smi reports them.
2. Build every CUDA kernel from ``src/repro_torch/kernels/csrc``, after
   removing every library left by an earlier build: one ``nvcc`` per
   source, all started together, each timed. For each library, the
   registers, stack, local (spill) and static shared memory of each of
   its kernels, as ``cuobjdump --dump-resource-usage`` reports them. Design
   checks: the bf16 attention library's SASS must hold ``HGMMA`` (wgmma on
   the tensor cores) and ``UTMALDG`` (TMA loads), the f32 attention
   library's tf32 ``HGMMA`` and ``UTMALDG`` and no ``LDL``/``STL``, and the
   RWKV6 library's ``UBLKCP`` or ``UTMALDG`` (bulk or TMA copies) and no
   ``LDL``/``STL`` (no spill of the register-blocked state), and the
   ``quack_scan`` library's ``UBLKCP`` (its rows staged by bulk copies) and
   ``UCGABAR_ARV``/``UCGABAR_WAIT`` (the cluster barriers around the
   prefix's min in distributed shared memory), or the script stops.
3. Kernel phase: ``quack_scan``'s CUDA result against its plain torch
   version on the card, both ``compute_lost`` settings, at the dense main
   path's shape (19, 19, 65536), ragged widths and R = 33 with random
   real stakes, in the lane form with B = 2 lanes of distinct real
   stakes and thresholds, and with the first unquacked column on each
   edge of the launch plan (column 0, the last column of CTA 0, the first
   of CTA 1, the last of a tile, W - 1, none) at W = 6016, 65536 and
   65531; mismatches must be 0. Device time per call at
   the dense shape and at the windowed shape (1, 19, 19, 6016) (CUDA
   events around a CUDA-graph replay that rotates over input sets
   totalling more than the 50 MB L2, so every call reads cold data), and
   at phase 8's lane shapes (3, 19, 19, 6016) and (6, 19, 19, 6016), the
   plain version's time the same way, the bytes bounds, and the launch
   floor: an empty kernel in the same harness, at one CTA and at the
   kernel's grid and cluster. Then what the launch plan rests on: the
   dense width on the staged and the vector path in turns, and the dense
   launch on 15 and 16 rows against 19.
4. Path phase: BFT f = 1, M = 1,024, a crashed sender and a Byzantine
   receiver, run on CUDA and on an explicitly requested CPU, densely and
   windowed (W = 256, 16-round chunks: it grows and migrates to dense),
   and two windowed specs of ``tests/test_windowed.py``: a tiny window
   that grows under a GC-stalling adversary, and one that migrates to
   the dense layout. Every output, metric, GC frontier trajectory and
   final width must be bit-identical, and the kernel must launch
   2 x steps times, plus once per rotating chunk when windowed (launches
   in chunk bodies that an overflow guard discarded are logged apart).
   Then the four scenarios (failure-free and the three above) as the
   lanes of one batch (``run_picsou_batch``) on the M = 1,024 link:
   dense, and windowed at superchunk K = 1 and K = 8, each on CUDA and
   on the CPU; every combination must agree lane by lane, and every lane
   with its single run. Each run must meet the dispatch contract
   (K = 1: one dispatch a chunk; without growth at most ceil(C / K) + 2;
   host syncs at most dispatches + 2, plus one per dense migration;
   every dispatch a CUDA-graph replay; dense: one replay per 32-round
   block). Every single run and every batch combination runs again with
   ``collect_metrics`` on, on CUDA and on the CPU: the outputs must equal
   the metrics-off run's, every ``ObsMetrics`` field the CPU run's, each
   lane's histogram the numpy histogram of its ``delivery_latency``, and
   dispatches, host syncs, captures, replays and kernel launches must be
   those of the metrics-off run.
5. Full-size phase: BFT f = 6 <-> f = 6 (n = 19, the paper's largest
   §6.1 network), window 4, phi 32, failure-free at M = 65,536 over 900
   rounds and with ``crash_fraction(19, 19, 0.3, seed=2)`` at M = 8,192
   over 8,192 rounds (the crash cell's depth, halved to pay for phase
   10, for phase 13 and again to keep the script inside its time on a
   slower host), through ``run_picsou``. Both
   runs must end fully delivered and fully quacked, with 2 x steps kernel
   launches and one graph replay per 32-round block each; failure-free
   exactly one cross copy per message and no resend, the crash run some
   resends. Each run logs its wall time (less its planning, ``build_spec``
   timed beforehand on the same specs), rounds/s, messages/s, the device
   time inside graph replays (CUDA events around each replay) against
   the wall, the host time of the dispatches that captured their
   program, and its peak device memory above what was allocated before.
5w. Windowed at full width: the same link with ``window_slots="auto"``
   (W = 6,016) and 32-round chunks. A failure-free stream of M = 524,288
   messages over ceil(M / 76) + 60 rounds, at K = 8 (the default), at
   K = 8 again with the first run's programs (the warm contract: it
   captures nothing, equals the first run bit for bit and logs both
   walls) and at K = 1, must end all delivered and quacked with one
   cross copy per message, no resend and the GC frontier at M, the runs
   bit for bit equal, each within the dispatch contract; its planning
   time, and per run the numbers of phase 5, are logged. The crash
   configuration of phase 5 (M = 8,192), windowed, must give every
   output and metric of phase 5's dense crash run bit for bit; its growth events and frontier
   trajectory are logged. Each run must launch the kernel 2 x steps
   times plus once per rotating chunk.
5s. The full-width sweep: ``run_picsou_batch`` of the same link at
   M = 131,072 over 1,785 rounds, W = 6,016, K = 8, with four lanes:
   failure-free, and receivers 0-5 acking ``byz_ack_low``,
   ``byz_ack_stale`` and ``byz_ack_advance`` of +1 (6 < 7 = quack_thresh
   stake, inside the quorum budget). Every lane must end all delivered
   and quacked and equal the same sweep at K = 1 bit for bit, lane 1 its
   single ``run_picsou``; both sweeps within the launch and dispatch
   contracts, with the numbers of phase 5.
5m. The metrics fabric at full width: ``python -m repro_torch.obs
   --selftest`` on the card, then with ``collect_metrics`` on, the long
   stream at K = 8 under a span tracer, the windowed crash run (it grows
   and migrates to dense), the four-lane sweep at K = 8 and the 900-round
   failure-free dense run. Each must equal its metrics-off run of phases
   5, 5w and 5s in every output, metric and window field; per lane the
   histogram must equal the numpy histogram of ``delivery_latency``,
   ``quack_events`` the count of ``quack_time >= 0``, ``resend_total``
   the sum of the resends, ``uncounted`` 0; and dispatches, host syncs,
   captures, replays and kernel launches must equal the metrics-off
   run's. Each logs its rounds/s and peak memory against the metrics-off
   run's; the long stream logs the tracer's span counts and its drain
   overlap ratio.
6. Where a graphed round's time goes: torch.profiler over a window of
   replays (started and stopped at chosen dispatches, after every
   capture) of the dense crash configuration (M = 8,192), of the
   failure-free windowed link at K = 8 (W = 6,016, and W = 65,536 on a
   131,072-message stream, wide enough for the launch-ahead path) and of
   the windowed crash configuration past its dense migration (W = M =
   8,192): kernels and kernel time per round, device busy
   share against the same window unprofiled and against the engine's
   full run, the host time of each replay, drain start and drain wait,
   and the replays launched ahead of an earlier drain. Then the cost of a chunk boundary: the failure-free link at
   K = 8 with 8, 16 and 32 rounds a chunk, the wall per round over four
   steady spans each. The dense and windowed K = 8 windows run again with
   ``collect_metrics`` on (the kernels the fabric adds a round), and each
   window logs ``quack_scan``'s in-round (L2-warm) µs a round.
7. Kernel-API phase (run right after phase 3, so that a fault in a
   kernel stops the script before the long runs): ``kernels.ops.
   flash_attention`` and ``kernels.ops.rwkv6_chunked`` at full model
   widths from ``src/repro/configs/``, TF32 off. Attention in bf16 at
   granite-8b's causal prefill (F1: B=1, H=32, KV=8, S=4096, D=128), a
   512-token prefill after a 3,584-token cache, end-aligned (F2), and
   mixtral-8x22b's sliding window 4096 at S=8192, H=48 (F3, checked on
   its last 512 query rows); in f32, F1's widths at S=2048 (F4) and F3's
   (F5, checked on its last 512 query rows). RWKV6 at rwkv6-7b's widths
   (H=64, D=64), B=2, T=4096, f32 (R1) and bf16 (R2), and a batched
   prefill of 512 heads, B=8, f32 (R3).
   Each shape runs once through the op with the launch counters at 0;
   F1-F3 must count on the bf16 route (``flash_attention_sm90.cu``), F4
   and F5 on the f32 route (``flash_attention_f32_sm90.cu``); every output
   must agree with the plain torch version on the card
   (allclose: attention bf16 atol 1e-5, rtol 1.6e-2, f32 atol = rtol =
   2e-6; RWKV6 1e-4), attention on four input sets. Controls show that
   the attention tolerance catches a wrong result: on the last 512 query
   rows, plain versions with one deliberate fault (P rounded to bf16, the
   oldest key or the oldest 64 keys of each row dropped, TF32 products in
   f32) must each put entries over it, and the same plain version with no
   fault none; so must each kernel's own contract: in bf16 P as two bf16
   halves (``kernels.ref.mha_split_p``), in f32 three TF32 passes
   (``kernels.ref.mha_split_tf32``). RWKV6 is checked on every
   input set it is timed on, each beside plain controls: the kernel's own
   arithmetic, the u bonus factored out (``kernels.ref.rwkv6_factored``),
   must meet 1e-4; the bonus dropped, y read from S_t after the update,
   and k·v rounded to bf16 must each break it. Then the kernel's device
   time (CUDA graph over input sets larger than the L2), the plain
   version's, SDPA's for attention, and the bound (f32: three TF32 passes
   at the TF32 peak, the old FMA design's ceiling beside it); the rate
   counted at 4 D FLOPs a pair, executed (bf16 6 D: two products for P·V;
   f32 12 D: three passes) and issued over the kernel's whole tiles; for
   f32 the SM clock and power under load; for RWKV6 the recurrent form's
   FP32 floor, 3 instructions per state entry and step on every f32 lane
   at the SM clock ``nvidia-smi`` gives as its maximum, and the SM clock
   and power draw it samples while the kernel runs back to back.

8. Topologies and the §6 applications (``repro_torch.topology``,
   ``repro_torch.apps``). 8a at the path size (BFT f = 1, M = 1,024,
   W = 256, 16-round chunks): a pair with a Byzantine receiver, a fanout
   to three backups with a crashed-receiver and a Byzantine-receiver
   link, a four-cluster chain with a crashed-receiver middle link, and a
   chain whose first link is GC-stalled, each at K = 1 and 8, metrics
   off and on, on CUDA and on the CPU, and through the numpy mirror
   ``run_topology_reference``: every link's outputs, round metrics,
   ``send_step``, ``delivery_latency``, frontiers, floors, final width
   and growth events bit-identical; with metrics each link's histogram
   the numpy histogram of its latency array; one dispatch per chunk,
   each a graph replay, one ``plan_floors`` span and one drain per
   chunk, and 2 x steps + rotating chunks ``quack_scan`` launches
   whatever the links. ``run_reported_topology``'s spans; a commit floor
   written in place between two replays of one captured program must
   change what it dispatches; both applications on the JAX tests'
   fixtures, CUDA == CPU == ``use_reference=True`` in every report
   field. 8b at full width (BFT f = 6, window 4, phi 32, W = 6,016,
   32-round chunks): a chain a-b-c-d at M = 131,072 (every link all
   delivered and quacked, each chained link's floors its upstream's
   frontiers and nothing sent before its upstream retired it, the first
   link == ``run_picsou`` of it; beside it the same links as a plain
   ``run_picsou_batch`` at K = 1, the difference being the floor
   boundary's cost); disaster recovery from a primary to three backups
   over 1,785 rounds (backup-1 loses 7 > f receivers at round 892,
   backup-2's receivers 0-5 drop, the primary crashes at round 1,575):
   phase 1 == ``run_picsou_batch`` of the three link scenarios bit for
   bit, the elected backup holds the longest prefix, the report
   converges; reconciliation of three clusters (six links) holding
   65,536 keys each, one link with a dropping receiver, to the LWW union
   computed on the host. Each logs its wall, rounds/s and messages/s,
   dispatches, host syncs, captures and their host s, device time
   inside replays, peak memory and its ``plan_floors`` spans.

9. Replay (``repro_torch.replay``) and the adversary palette
   (``repro_torch.adversary``). 9a at the path size (BFT f = 1,
   M = 1,024, W = 256, 16-round chunks), each item on CUDA and on the
   CPU, against the port's numpy oracles: a link that grows and migrates
   to dense, recorded (every checkpoint's state and inputs cuda == cpu,
   the float32 stakes bit for bit), replayed from every checkpoint (==
   the original, 0 captures); a crash, a heal and a drop schedule
   injected (== ``replay_oracle`` and the from-scratch run with the
   merged ``fail_schedule``); a chain recorded and replayed with its
   upstream senders crashed (== ``replay_topology_oracle``); three forks
   (each == its replay; a second fork set captures nothing);
   remove / join a receiver and a stake re-weight replayed == from round
   0; a ``RunTrace`` saved, loaded and resumed; a ``fail_schedule`` swap
   written between two replays of one captured program must change what
   it computes; disaster recovery with the crash injected by replay on
   the JAX tests' fixtures == the static report; every adversary kind on
   dense, windowed K = 1 and K = 8 == the oracle, retirement safe. 9b at
   full width: phase 5s's lane 0 (M = 131,072, 1,785 rounds, W = 6,016)
   recorded every 8 chunks, each checkpoint's host s and bytes from its
   ``checkpoint`` span; a replay from the middle checkpoint == the
   original with 0 captures; ``crash_fraction(19, 19, 0.3, seed=2)``
   injected there == the from-scratch CUDA run of that schedule; four
   forks as one 4-lane batch (baseline, that crash, receiver 18 removed,
   receivers 0-5 stale), each == its own replay, and a second fork set
   of the same shape capturing nothing. Every run's ``quack_scan``
   launches are 2 x rounds + rotating chunks from the round it starts at;
   they join the main path's count. The warm contract of the long stream
   (the same K = 8 run twice: captures N, then 0, and each wall) runs in
   phase 5w, where the stream runs.

10. The streaming service (``repro_torch.stream``, the windowed loop's
   horizon mode) and the runtime contracts (``repro_torch.analysis``).
   10a at the stream selftest's shape (BFT f = 1, window 4, phi 6,
   16-round chunks, K = 8): ``python -m repro_torch.stream --selftest``
   on the card; the selftest's 512-message session, a chained 3-link
   session and a palette attack (``selective_drop`` switched on at
   chunk 4, healed at chunk 16: a breach, then a recovery), each on CUDA
   and on the CPU, equal in the report, every live row (the JSON-lines
   stream), SLO events, sketch, ``ObsMetrics``, capacity, width, growth
   events, dispatches and host syncs, all delivered, with 2 x rounds +
   rotating chunks ``quack_scan`` launches; the dense fallback refused
   on the card with the CPU's message (``tests/test_stream.py``'s
   crashed stream); ``python -m repro_torch.analysis --check`` on the
   card (a K = 8 run with ``debug_checks`` under the sync debug mode:
   at most ceil(C/K) + 2 dispatches, 0 implicit transfers, then warm
   with 0 captures); a seeded ``.item()`` inside ``engine_guard`` must
   raise ``SanitizerError``. 10b at full width: BFT f = 6 both sides,
   window 4, phi 32, 32-round chunks, K = 8, ``window_slots="auto"``
   (W = 7,616), a diurnal link (``ArrivalProcess(kind="diurnal",
   rate=64, period=512, amplitude=0.5, seed=0)``) over 524,288
   messages (8,411 rounds) and 131,072 (2,275), each session cold under
   ``Measured`` and tracemalloc: all delivered, no problem, launches 2 x
   rounds + rotating chunks; at 524,288 a ``run_simulation`` of the
   identical spec after the session captures 0, issues the session's
   dispatches and host syncs, and its post-hoc ``RunReport`` validates
   with the live histogram and percentiles bit for bit. Flatness (P1
   for a resident stream): each session's peak device memory less what
   its cached program sets hold by design (the padded schedules, 12 x
   (M + W) bytes at each width, and the captured span programs' output
   buffers, k chunk queues each) equal at both horizons within
   ``FLAT_DEVICE_MIB``, and the 524,288 session's host peak inside
   ``run()`` under ``FLAT_HOST_SHARE`` of the batch run's. Each logs its
   wall, rounds/s and messages/s (under tracemalloc), captures and their
   host s, device time inside replays, peak device and host memory.
11. The cross-pod runtime (``repro_torch.crosspod``, ``launch.mesh``,
   ``optim``, ``checkpoint``, ``configs``) on the gradient tree of one
   full-width starcoder2-3b decoder layer (133,699,584 f32), the
   program cache emptied first. 11a: the production multi-pod mesh
   (pod 2, data 16, model 16) held on the card, the 32 (pod, data)
   positions each with a distinct block (``P(("pod", "data"))`` on dim
   0, 17.1 GB in): PICSOU == ATA, both == the f64 mean of the blocks,
   the ``P()`` case == its input, CUDA == the port on the CPU on the four
   smallest leaves, all within 1e-6, outputs on the card; device ms a
   sync for each schedule (CUDA events, median of 5), peak device
   memory, ``dcn_bytes_analytic``'s bytes. 11b: EF-int8 over the layer
   for 10 steps, q and scales (and the residuals) bit for bit against
   the CPU in every step, accumulated sent + residual == true within
   1e-4; ms a compress + decompress. 11c: three clipped AdamW steps
   with ``cosine_schedule`` against the CPU within 1e-6 of each leaf's
   largest magnitude, ``step`` exact; ms an update. 11d:
   ``CheckpointManager.save_async`` of (params, AdamW state) from the
   card (1.6 GB), ``wait``, ``restore_tree`` onto the card bit for bit,
   ``durable_frac`` 1.0, a corrupted shard refused with ``IOError``;
   host s and bytes. No kernel of this repo runs here: ``repro``
   computes all of it outside ``pl.pallas_call``.
12. The serving path (``repro_torch.models``, ``launch.serve``), prefill
   attention on the hand-written kernel. 12a: every config at
   ``.smoke()`` (f32), B 2, a 16-token prefill and two decode steps, on
   CUDA (the kernel route: the f32 kernel once an attention call of the
   forward and the prefill, none a decode step) against the CPU on the
   same weights (``SERVE_TOL``), and prefill / decode consistent with
   the forward (``tests/test_models_smoke.py``'s property). 12b:
   granite-8b at full width and depth (36 layers, 8,254,689,280 f32
   parameters from a seeded CUDA generator) serving B 4 x 512 prompt
   tokens -> 16 greedy tokens through ``launch.serve.generate``, twice
   (cold, warm): init s, prefill s, decode ms/step, tok/s, peak device
   memory, the bf16 kernel's launches (36 in the served run: one a
   prefill layer, none a decode step). The kernel on every layer's own
   q, k, v of a served prefill against an f64 oracle: no more entries
   over phase 7's bf16 tolerance than its plain version (whose f32
   scores, several hundred here, break it too where two keys nearly
   tie), fewer than the "P in bf16" control (SDPA logged). The
   last-position logits of the kernel route and of the plain route
   (``impl="scan"``, bf16) against an f32 oracle (the same weights,
   ``dtype="float32"``, scan, TF32 off), as max |difference| / max
   |logit|: the kernel route no further than the plain one, and two
   faulty controls (causal off; query head h reading KV head h % KV)
   further than the kernel route. A prefill and a decode step under
   ``torch.profiler`` (device busy, attention's share); the kernel at
   the model's shape (B 4, H 32, KV 8, S 512, D 128, causal) beside
   SDPA, its plain version and its bound. The twin: the served weights'
   first 2 layers (full width), f32, scan, B 1 x 128, CUDA against the
   CPU within 1e-4 of max |logit|, each beside an f64 run; the same
   depth drawn afresh at n_layers = 2 (std scale / sqrt(2)) is logged.
13. The training path (``repro_torch.launch.train``, ``launch.steps``,
   ``models.loss_fn``; attention's kernel route under autograd: the
   forward on the kernel, the backward the plain scan's gradient,
   recomputed one query block at a time). 13a: every config at
   ``.smoke()`` (f32, remat on), B 2 x 18 tokens: ``value_and_grad`` and
   two ``build_train_step`` steps (warmup 1, so that the second moves
   the weights) on CUDA against the CPU on the same weights (loss, every
   gradient leaf, and AdamW's m and v after the second step, each within
   1e-4 of the leaf's max or, where larger, twice the CPU's own f32
   distance from an f64 run of the same steps; the parameters logged),
   the card's AdamW update held: the CPU's moving-step update arguments
   (its gradients, the parameters and AdamW state of the step before)
   carried to the card through ``launch.steps.train_update``, the call
   ``build_train_step`` makes, give the CPU step's parameters, m and v
   within 1e-6 of a leaf's max (``TRAIN_UPDATE_TOL``), and the same
   update with beta2 0.999 must break that on the parameters and on v;
   the f32 kernel launched twice an attention layer of a stacked segment
   (the forward and remat's recompute) and once elsewhere a step; on the
   models' own q, k, v, dO (every attention call of a remat-off step)
   the kernel route's dQ, dK, dV against the scan route's within 1e-6 of
   each one's max (bit for bit counted), its output at most 4x as far
   from an f64 oracle as its plain version's (three TF32 passes keep 22
   bits; the plain version on q, k, v rounded to bf16 must break that
   on every f32 call), and a control, a backward recomputed with the
   causal mask off, over the limit on every causal call;
   ``python -m repro_torch.launch.train --arch granite-8b-smoke --steps
   6 --mesh 2x2x2 --mode ddp --sync picsou --compress --device cuda``
   (in process) with finite losses; a restart (checkpoints every 4
   steps, resumed after step 7 for 4 steps) within 2e-3 of an
   uninterrupted 12-step run. 13b: granite-8b at full width, 4 of 36
   layers (1,275,105,280 f32 parameters: 36 layers' training state, 16
   B a parameter, would be 132 GB), sequence 4,096, global batch 4
   (train_4k's 256 cut to one card), mesh 2x2x1, bf16 compute, remat
   on: 4 steps each of pjit, ddp PICSOU, ddp ATA and ddp PICSOU with
   ``--compress`` through ``launch.train.run``, each from the same
   seeded init: 8 bf16 kernel launches a step, finite losses, PICSOU ==
   ATA within 1e-4, pjit within 5e-2 of ddp, the compressed run within
   5e-2 of ddp and not equal to it; per mode the cold and warm
   step s, tokens/s, the model's product FLOPs as a share of 989
   TFLOP/s bf16, peak device memory. One warm ddp PICSOU step under
   ``torch.profiler``: GEMMs, the attention kernel and the ranges the
   port marks (the plain attention backward, AdamW, the sync) as shares
   of the kernel time, and device busy. Layer 0's own q, k, v, dO (bf16)
   through the 13a route check; the twin (the first layer, f32, scan,
   B 1 x 128: gradients CUDA against the CPU); the bf16 kernel at the
   step's shape (4, 32, 8, 4,096, 4,096, 128) beside SDPA and its
   bound. No checkpoint at full width (phase 11 times one).
14. The dry run (``launch/dryrun.py``'s count, ``StepBundle.lower()`` on
   ``meta`` tensors, ``roofline/``) on 13b's pjit step and 12b's served
   prefill: (a) the meta count of 13b's step (impl "scan", mesh 2x2x1)
   equals, exactly, ``torch.utils.flop_counter.FlopCounterMode`` over one
   real step of the same bundle on the card, a proof that the scaled
   meta run is the step; (b) ``roofline.model_flops`` <= the counted
   FLOPs, and the counted FLOPs over 13b's measured warm pjit step (and
   12b's warm prefill) within 989 TFLOP/s, the share printed; (c) the
   argument bytes a position within 13b's pjit and 12b's measured peak
   device memory.

Programs outlive runs (``repro_torch.core.graphs``): a second run of a
shape captures nothing. Every ``Measured`` run (phases 5, 5w, 5s, 5m, 8b,
10b's sessions)
empties the program cache first, so its wall, capture time and peak
memory are a cold run's, comparable with earlier PRs'; the phase-4 and
8a checks compare every counter but the captures across runs whose
layouts differ, and hold each run's captures to its traces and a warm
rerun's to 0.

The last lines are the ``kernels`` JSON line, and then
``{"ok": true, "device": {...}}``. Exits non-zero without printing a
result when there is no CUDA card or when the package is not beside it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s
# outside the tensor cores, dense bf16 and TF32 FLOP/s on the tensor cores
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
TF32_FLOPS = 494.7e12
L2_BYTES = 50e6
SHAPE = (19, 19, 65536)          # (n_s, n_r, M) of the full-size phase
# rounds of the full-size runs: failure-free completes at round 869. The
# crash runs (phases 5, 5w, 5m and 6's crash windows) stream CRASH_M
# messages, deterministic, over STEPS_CRASH rounds. Cut three times to keep
# the script inside its time: at M = 65,536 they completed at round 63,171
# of 64,000, at M = 32,768 at round 31,437 of 32,000, at M = 16,384 at
# round 16,004 of 16,384; at M = 8,192 they complete at round 7,928
STEPS_FREE = 900
CRASH_M = 8192
STEPS_CRASH = 8192
# the windowed engine at full width: default_window_slots(19, 19, 4, 32,
# 32) = 6,016 columns, 32-round chunks; the long stream sends 76 messages
# a round (19 senders x window 4) and ends 60 rounds after its last send
CHUNK = 32
WIN_SHAPE = (1, 19, 19, 6016)    # the windowed quorum launch (B, S, R, W)
TOPO_LANES = (3, 6)    # lanes (links) of phase 8's full-width topologies
M_LONG = 524_288
STEPS_LONG = -(-M_LONG // 76) + 60
# the full-width sweep: four lanes of the same link, M = 131,072 over
# ceil(M / 76) + 60 = 1,785 rounds (halved from 262,144 over 3,510 to keep
# the script inside its time; phases 8b and 9b run at the same depth)
SWEEP_M = 131_072
SWEEP_STEPS = -(-SWEEP_M // 76) + 60
# phase 8: the path-size topologies (BFT f = 1, M = 1,024, W = 256,
# 16-round chunks), then at full width (BFT f = 6, the sweep's M and
# rounds): a four-cluster chain, whose every hop lags its upstream by the
# rounds below; disaster recovery, the primary crashing at DR_CRASH and
# backup-1 losing 7 > f receivers at DR_LAG_AT; reconciliation of stores
# of RECON_M keys over streams of RECON_M messages
TOPO_SIM = dict(n_msgs=1024, steps=240, window_slots=256, chunk_steps=16)
# the chain's links complete at rounds 1,731, 1,767 and 1,799 (lags of 36
# and 32 rounds a hop; at M = 262,144: 3,456, 3,495 and 3,527), so 1,800
# rounds (ceil(M / 76) + 60 + 15) are the fewest at which the last hop
# completes. The primary crashes 210 rounds before the stream ends (about
# 210 x 76 messages unsent) and backup-1 loses its receivers half-way, as
# at 262,144 (rounds 3,300 and 1,755)
CHAIN_STEPS = SWEEP_STEPS + 15
DR_CRASH = SWEEP_STEPS - 210
DR_LAG_AT = SWEEP_STEPS // 2
RECON_M = 65_536
RECON_STEPS = -(-RECON_M // 76) + 60
# each kernel of the JSON line: its source, and the TPU kernel it replaces
CSRC = "src/repro_torch/kernels/csrc"
KERNEL_FILES = {
    "quack_scan": (f"{CSRC}/quack_scan.cu",
                   "src/repro/kernels/quack_scan.py:84"),
    "quack_scan_no_lost": (f"{CSRC}/quack_scan.cu",
                           "src/repro/kernels/quack_scan.py:84"),
    "flash_attention": (f"{CSRC}/flash_attention_sm90.cu",
                        "src/repro/kernels/flash_attention.py:72"),
    "flash_attention_f32": (f"{CSRC}/flash_attention_f32_sm90.cu",
                            "src/repro/kernels/flash_attention.py:72"),
    "rwkv6_chunked": (f"{CSRC}/rwkv6_scan.cu",
                      "src/repro/kernels/rwkv6_scan.py:63"),
}
# phase 7 shapes: (name, source, (B, H, KV, Sq, Skv, D), dtype, window,
# query rows checked against the plain version: None = all)
ATTN_SHAPES = [
    ("F1", "granite-8b, src/repro/configs/granite_8b.py:10-11",
     (1, 32, 8, 4096, 4096, 128), torch.bfloat16, 0, None),
    ("F2", "granite-8b, 512-token prefill after a 3,584-token cache",
     (1, 32, 8, 512, 4096, 128), torch.bfloat16, 0, None),
    ("F3", "mixtral-8x22b, src/repro/configs/mixtral_8x22b.py:11-14",
     (1, 48, 8, 8192, 8192, 128), torch.bfloat16, 4096, 512),
    ("F4", "granite-8b widths in f32", (1, 32, 8, 2048, 2048, 128),
     torch.float32, 0, None),
    ("F5", "mixtral-8x22b widths in f32, src/repro/configs/mixtral_8x22b.py"
     ":11-14", (1, 48, 8, 8192, 8192, 128), torch.float32, 4096, 512),
]
# attention tolerances (atol, rtol), as np.allclose applies them. bf16:
# a bf16 output step is at most 2**-7 of its value, so rtol is two steps;
# atol covers outputs near 0, where the order of the f32 sums shows. Both
# sit between the sound readings and the controls' (PERF.md). f32: the
# JAX tests' 2e-6.
ATTN_TOL = {torch.bfloat16: (1e-5, 1.6e-2), torch.float32: (2e-6, 2e-6)}
CHECK_SETS = 4        # input sets each attention shape is checked on
CONTROL_ROWS = 512    # query rows, the last of each shape, of the controls
# the faults of the controls; "none" is the control's own plain version,
# "P as two bf16 halves" the bf16 kernel's arithmetic (ref.mha_split_p)
# and "three TF32 passes" the f32 kernel's (ref.mha_split_tf32): these
# must pass. TF32 keeps a bf16 input exact, so one TF32 pass is an f32
# fault.
CONTROLS = {torch.bfloat16: ("none", "P as two bf16 halves", "P in bf16",
                             "oldest key dropped", "oldest 64 keys dropped"),
            torch.float32: ("none", "three TF32 passes", "P in bf16",
                            "oldest key dropped", "oldest 64 keys dropped",
                            "TF32 products")}
SOUND = ("none", "P as two bf16 halves", "three TF32 passes")
# the attention kernels' tiles (query rows a block, keys a tile): bf16
# 128 x 128; f32 64 x 64
ATTN_TILES = {torch.bfloat16: (128, 128), torch.float32: (64, 64)}
# (name, source, (B, H, T, D), dtype); chunk 128
RWKV_SHAPES = [
    ("R1", "rwkv6-7b, src/repro/configs/rwkv6_7b.py:10-12",
     (2, 64, 4096, 64), torch.float32),
    ("R2", "rwkv6-7b widths, bf16 inputs", (2, 64, 4096, 64),
     torch.bfloat16),
    ("R3", "rwkv6-7b widths, a batched prefill of 512 heads",
     (8, 64, 4096, 64), torch.float32),
]
RWKV_TOL = 1e-4
# the RWKV6 controls: "u bonus factored" is the kernel's arithmetic
# (ref.rwkv6_factored) and must meet the limit; each fault must break it
RWKV_CONTROLS = ("u bonus factored", "u bonus dropped",
                 "y read from S_t after the update", "k·v rounded to bf16")
RWKV_SOUND = ("u bonus factored",)
F32_LANES = 128      # f32 lanes of a Hopper SM


def log(msg: str) -> None:
    print(msg, flush=True)


def smi(query: str) -> str:
    """``nvidia-smi --query-gpu=<query> --format=csv,noheader`` of the first
    card."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()
    return out[0]


def card_line() -> str:
    return smi("name,power.limit")


# ------------------------------------------------------------ phase 3
def quack_inputs(s, r, w, gen, real_stakes, dev):
    claims = torch.rand((s, r, w), generator=gen, device=dev) < 0.7
    comps = torch.rand((s, r, w), generator=gen, device=dev) < 0.3
    claims[:, : r // 2 + 1, : w // 3] = True     # long quacked prefixes
    if real_stakes:
        stakes = torch.rand((r,), generator=gen, device=dev) + 0.5
    else:
        stakes = torch.ones((r,), device=dev)
    qthr = (stakes.sum() * 0.6).reshape(())
    dthr = (stakes.sum() * 0.3).reshape(())
    return claims, comps, stakes, qthr, dthr


def lane_inputs(b, s, r, w, gen, dev):
    """The lane form: B lanes, each with its own real stakes and its own
    thresholds (shares of its stake total spread over 0.45-0.65)."""
    claims = torch.rand((b, s, r, w), generator=gen, device=dev) < 0.7
    comps = torch.rand((b, s, r, w), generator=gen, device=dev) < 0.3
    claims[:, :, : r // 2 + 1, : w // 3] = True
    stakes = torch.rand((b, r), generator=gen, device=dev) + 0.5
    share = torch.linspace(0.45, 0.65, b, device=dev)
    return (claims, comps, stakes, stakes.sum(1) * share,
            stakes.sum(1) * (share - 0.25))


def compare(kernel_out, plain_out):
    """(mismatching entries, max |difference|) over all outputs."""
    bad, worst = 0, 0
    for k, p in zip(kernel_out, plain_out):
        if k is None or p is None:
            if not (k is None and p is None):
                raise AssertionError("one side returned no loss bitmap")
            continue
        if k.dtype != p.dtype or k.shape != p.shape:
            raise AssertionError(f"dtype/shape differ: {k.dtype}{k.shape} "
                                 f"vs {p.dtype}{p.shape}")
        d = (k.to(torch.int64) - p.to(torch.int64)).abs()
        bad += int((d != 0).sum())
        worst = max(worst, int(d.max()) if d.numel() else 0)
    return bad, worst


def graph_ms(fn, sets, calls_per_graph=16, replays=5, windows=5):
    """Device ms per call: CUDA events around ``replays`` replays of a
    CUDA graph of ``calls_per_graph`` calls rotating over ``sets`` (no
    host gaps), in ``windows`` timed windows. Returns the sorted
    per-window times; the median is the figure reported."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for a in sets:                       # warm up outside the graph
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls_per_graph):
            fn(*sets[i % len(sets)])
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / (replays * calls_per_graph))
    return sorted(times)


def bound_ms(s, r, w, compute_lost: bool, b: int = 1):
    """Least time for the work of ``b`` lanes: each input byte read once,
    each output byte written once, vs the f32 multiply-adds over the
    bitmaps."""
    maps = 2 if compute_lost else 1
    nbytes = b * (maps * s * r * w + 4 * r + 4 * maps + maps * s * w
                  + 4 * s)
    flops = b * maps * 2 * s * r * w
    t_bytes, t_ops = nbytes / HBM_BPS, flops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def edge_inputs(w, where, gen, dev, compute_lost):
    """One lane at (19, 19, w) whose rows 1.. are quacked up to the edge
    ``where`` of the kernel's launch plan and unquacked there (row 0 17
    columns later); returns (inputs, the edge's column)."""
    from repro_torch.kernels.quack_scan import plan_quack_launch
    plan = plan_quack_launch(1, 19, 19, w, True, compute_lost)
    pos = {"column 0": 0, "last of CTA 0": plan.cols - 1,
           "first of CTA 1": plan.cols, "last of a tile": plan.tile - 1,
           "W - 1": w - 1, "none": w}[where]
    a = lane_inputs(1, 19, 19, w, gen, dev)
    a[0][..., :pos] = True
    if pos < w:
        a[0][:, 1:, :, pos] = False
        a[0][:, 0, :, min(pos + 17, w - 1)] = False
    return a, pos


EDGES = ("column 0", "last of CTA 0", "first of CTA 1", "last of a tile",
         "W - 1", "none")


def launch_floor_ms(shape, compute_lost: bool):
    """Device ms of an empty kernel in ``graph_ms``'s harness: at one CTA
    of 32 threads, and at ``quack_scan``'s grid, cluster and threads for
    ``shape`` (B, S, R, W)."""
    import ctypes

    from repro_torch.kernels.build import load_library
    from repro_torch.kernels.quack_scan import plan_quack_launch
    fn = load_library("quack_scan").quack_scan_floor_launch
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    plan = plan_quack_launch(*shape, True, compute_lost)

    def empty(grid, cluster, threads):
        rc = fn(*grid, cluster, threads,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"empty kernel: CUDA error {rc}")

    return (median(graph_ms(empty, [((1, 1, 1), 1, 32)])),
            median(graph_ms(empty, [(plan.grid, plan.cluster,
                                     plan.threads)])))


def forced_plan(path: str):
    """``plan_quack_launch`` with its path replaced by ``path`` ("staged"
    or "vector"), the rest of the plan derived as the plan derives it."""
    import importlib
    kq = importlib.import_module("repro_torch.kernels.quack_scan")
    plan0 = kq.plan_quack_launch

    def up(x, m):
        return -(-x // m) * m

    def plan(b, s, r, w, aligned, compute_lost=True):
        base = plan0(b, s, r, w, aligned, compute_lost)
        if path == "vector":
            passes = -(-base.cols // (16 * 512))
            threads = up(-(-base.cols // (16 * passes)), 32)
            return dataclasses.replace(base, path=path, tile=16 * threads,
                                       stages=0, threads=threads,
                                       smem=up(4 * r, 16))
        maps = 2 if compute_lost else 1
        n = -(-base.cols // 1024)
        tile = up(-(-base.cols // n), 16)
        stages = min(-(-base.cols // tile), 4,
                     112 * 1024 // (maps * r * tile))
        return dataclasses.replace(
            base, path=path, tile=tile, stages=stages,
            threads=up(-(-tile // 4), 32),
            smem=16 * stages + up(4 * r, 16) + stages * maps * r * tile)
    return plan


def plan_evidence(dev) -> None:
    """Phase 3, continued: what the launch plan's choices rest on. At the
    grown windowed widths 12,032 and 24,064 and at the dense width, each
    path in turns (staged, vector, vector, staged), both ``compute_lost``
    settings; and the dense launch on 15 rows (120 CTAs, fewer than the
    132 SMs) and 16 against 19 (152 CTAs: some SMs run two)."""
    import importlib

    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import quack_reference
    kq = importlib.import_module("repro_torch.kernels.quack_scan")
    plan0 = kq.plan_quack_launch
    gen = torch.Generator(device=dev).manual_seed(3)
    try:
        for rows, w in ((19, 12032), (19, 24064), (19, SHAPE[2]),
                        (16, SHAPE[2]), (15, SHAPE[2])):
            shape = (1, rows, SHAPE[1], w)
            sets = input_sets(lane_inputs(*shape, gen, dev),
                              lambda: lane_inputs(*shape, gen, dev))
            for compute_lost in (True, False):
                def kern(*a):
                    return ops.quack_scan(*a, compute_lost=compute_lost)

                want = quack_reference(*sets[0], compute_lost=compute_lost)
                times = {}
                for path in (("staged", "vector", "vector", "staged")
                             if rows == SHAPE[0] else (None,)):
                    kq.plan_quack_launch = (forced_plan(path) if path
                                            else plan0)
                    if compare(kern(*sets[0]), want)[0]:
                        raise AssertionError(f"quack_scan on the {path} "
                                             f"path disagrees")
                    times.setdefault(path or plan0(
                        *shape, True, compute_lost).path, []).append(
                        median(graph_ms(kern, sets)) * 1e3)
                    kq.plan_quack_launch = plan0
                log(f"[kernel] quack_scan compute_lost={compute_lost} at "
                    f"{shape}, {8 * rows} CTAs: " + "; ".join(
                        f"{path} path {', '.join(f'{t:.2f}' for t in ts)} us"
                        for path, ts in times.items()))
            del sets
    finally:
        kq.plan_quack_launch = plan0


def kernel_phase(dev):
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import quack_reference

    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = [(SHAPE, False), (SHAPE, True), ((19, 19, 65531), True),
              ((5, 33, 4099), True), ((5, 33, 4096), True)]
    result = {}
    for compute_lost in (True, False):
        bad = worst = 0
        for (s, r, w), real in shapes:
            a = quack_inputs(s, r, w, gen, real, dev)
            got = ops.quack_scan(*a, compute_lost=compute_lost)
            want = quack_reference(*a, compute_lost=compute_lost)
            torch.cuda.synchronize()
            b, wd = compare(got, want)
            log(f"[kernel] quack_scan compute_lost={compute_lost} "
                f"(S,R,W)={(s, r, w)} real_stakes={real}: {b} mismatches "
                f"(tolerance 0: bool/int32 outputs, same f32 sum order)")
            bad += b
            worst = max(worst, wd)
        for shape in ((2,) + WIN_SHAPE[1:], (2, 5, 33, 4099)):
            a = lane_inputs(*shape, gen, dev)
            got = ops.quack_scan(*a, compute_lost=compute_lost)
            want = quack_reference(*a, compute_lost=compute_lost)
            torch.cuda.synchronize()
            b, wd = compare(got, want)
            log(f"[kernel] quack_scan compute_lost={compute_lost} lane form "
                f"(B,S,R,W)={shape}, per-lane real stakes and thresholds "
                f"{[round(float(x), 4) for x in a[3]]}: {b} mismatches "
                f"(tolerance 0)")
            bad += b
            worst = max(worst, wd)

        # the first unquacked column on each edge of the launch plan:
        # the windowed width, the dense one (8 tiles a CTA), ragged
        for w in (WIN_SHAPE[3], SHAPE[2], SHAPE[2] - 5):
            edge_bad = 0
            for where in EDGES:
                a, pos = edge_inputs(w, where, gen, dev, compute_lost)
                got = ops.quack_scan(*a, compute_lost=compute_lost)
                want = quack_reference(*a, compute_lost=compute_lost)
                torch.cuda.synchronize()
                b, wd = compare(got, want)
                if got[2][0, 1].item() != pos:
                    b += 1
                edge_bad += b
                worst = max(worst, wd)
            log(f"[kernel] quack_scan compute_lost={compute_lost} (1, 19, "
                f"19, {w}), first unquacked column at {', '.join(EDGES)} of "
                f"the launch: {edge_bad} mismatches (tolerance 0)")
            bad += edge_bad

        def kern(*a):
            return ops.quack_scan(*a, compute_lost=compute_lost)

        def plain(*a):
            return quack_reference(*a, compute_lost=compute_lost)

        # four input sets of 47.3 MB rotate, so no call finds its inputs
        # in the 50 MB L2; at the windowed shape (4.3 MB a lane) and at
        # phase 8's lane counts, as many sets as exceed it
        timed = {}
        shapes_timed = [("dense", (1,) + SHAPE, lambda: [
            quack_inputs(*SHAPE, gen, False, dev) for _ in range(4)])]
        for label, shape in (("windowed", WIN_SHAPE),) + tuple(
                (f"topology, {b} links", (b,) + WIN_SHAPE[1:])
                for b in TOPO_LANES):
            shapes_timed.append((label, shape, lambda shape=shape:
                                 input_sets(lane_inputs(*shape, gen, dev),
                                            lambda: lane_inputs(*shape, gen,
                                                                dev))))
        for label, shape, make_sets in shapes_timed:
            sets = make_sets()
            k_times = graph_ms(kern, sets)
            p_times = graph_ms(plain, sets)
            del sets
            bms, by, nbytes = bound_ms(*shape[1:], compute_lost, b=shape[0])
            ms, plain_ms = median(k_times), median(p_times)
            one_cta, floor = launch_floor_ms(shape, compute_lost)
            log(f"[kernel] quack_scan compute_lost={compute_lost} at {shape} "
                f"({label}): {ms * 1e3:.2f} us/call median of "
                f"{len(k_times)} windows (min {k_times[0] * 1e3:.2f}, max "
                f"{k_times[-1] * 1e3:.2f}); plain torch {plain_ms * 1e3:.2f}"
                f" us (min {p_times[0] * 1e3:.2f}, max "
                f"{p_times[-1] * 1e3:.2f}); bound {bms * 1e3:.2f} us by {by} "
                f"({nbytes / 1e6:.1f} MB), {bms / ms:.1%} of it; launch "
                f"floor (an empty kernel, same harness) {one_cta * 1e3:.2f} "
                f"us at one CTA, {floor * 1e3:.2f} us at the kernel's grid "
                f"and cluster; mismatches {bad}")
            timed[label] = (ms, plain_ms, bms, by, floor)
        if bad:
            raise AssertionError(f"quack_scan disagrees with its plain "
                                 f"version in {bad} entries")
        ms, plain_ms, bms, by, floor = timed["dense"]
        w_ms, w_plain, w_bms, _, w_floor = timed["windowed"]
        result[compute_lost] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                                    bound_by=by, mismatches=bad,
                                    max_abs_err=worst, floor_ms=floor,
                                    windowed_ms=w_ms,
                                    windowed_plain_ms=w_plain,
                                    windowed_bound_ms=w_bms,
                                    windowed_floor_ms=w_floor)
        for b in TOPO_LANES:
            t_ms, t_plain, t_bms, _, t_floor = timed[f"topology, {b} links"]
            result[compute_lost].update({
                f"lanes{b}_ms": t_ms, f"lanes{b}_plain_ms": t_plain,
                f"lanes{b}_bound_ms": t_bms, f"lanes{b}_floor_ms": t_floor})
    return result


# ------------------------------------------------------------ phase 7
def attn_inputs(shape, dtype, gen):
    b, h, kv, sq, skv, d = shape
    return tuple(torch.randn(s, generator=gen, device="cuda").to(dtype)
                 for s in ((b, h, sq, d), (b, kv, skv, d), (b, kv, skv, d)))


def rwkv_inputs(shape, dtype, gen):
    """As tests/test_kernels.py draws them: r, k, v, u normal (times 0.5
    in f32), the decay w in (0.45, 0.95)."""
    b, h, t, d = shape
    scale = 0.5 if dtype == torch.float32 else 1.0

    def normal(s):
        return torch.randn(s, generator=gen, device="cuda") * scale

    r, k, v = normal(shape), normal(shape), normal(shape)
    w = torch.sigmoid(torch.randn(shape, generator=gen, device="cuda"))
    return tuple(x.to(dtype) for x in (r, k, v, w * 0.5 + 0.45,
                                       normal((h, d))))


def nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def attn_pairs(sq: int, skv: int, window: int) -> int:
    """(query, key) pairs a causal head computes: its unmasked pairs; a
    row with none averages all Skv keys."""
    pos = skv - sq + np.arange(sq, dtype=np.int64)
    hi = np.minimum(pos, skv - 1)
    lo = np.maximum(pos - window + 1, 0) if window > 0 else 0
    n = np.maximum(hi - lo + 1, 0)
    return int(np.where(n > 0, n, skv).sum())


def attn_tiles(sq: int, skv: int, window: int, bq: int, bkv: int) -> int:
    """kv tiles an attention kernel visits for one causal head, summed
    over its ``bq``-row query blocks of ``bkv``-key tiles, by the kernels'
    skipping rule: a block with a row that sees no key visits every
    tile."""
    n = 0
    for q0 in range(0, sq, bq):
        lo, hi = skv - sq + q0, skv - sq + min(q0 + bq, sq) - 1
        t_lo, t_hi = 0, (skv - 1) // bkv
        if lo >= 0:
            t_hi = min(t_hi, hi // bkv)
            if window > 0:
                t_lo = max(0, lo - window + 1) // bkv
        n += t_hi - t_lo + 1
    return n


def attn_bound(shape, dtype, window):
    """Least time: 4 D FLOPs per computed pair (two products) on the
    tensor cores, bf16 at its peak, f32 in the three TF32 passes the 2e-6
    limit asks for at the TF32 peak, vs q, k, v read once and o written
    once. ``flops`` stays the count at 4 D a pair; for f32 ``fma_ms`` is
    the old FMA design's ceiling, the same FLOPs at the f32 FMA peak."""
    b, h, kv, sq, skv, d = shape
    size = torch.empty((), dtype=dtype).element_size()
    moved = size * (2 * b * h * sq * d + 2 * b * kv * skv * d)
    flops = 4 * d * attn_pairs(sq, skv, window) * b * h
    if dtype == torch.bfloat16:
        return _bound(moved, flops, BF16_FLOPS)
    out = _bound(moved, 3 * flops, TF32_FLOPS)
    out.update(flops=flops, fma_ms=flops / F32_FLOPS * 1e3)
    return out


def rwkv_bound(shape, dtype):
    """Least time: the f32 operations the recurrence needs per step, 5
    per state entry (r . S; S = w S + k v) and 5 D for the u bonus, which
    factors as y_j += v_j c with c = sum_i r_i u_i k_i, vs r, k, v, w, u
    read once and the f32 y written once."""
    b, h, t, d = shape
    size = torch.empty((), dtype=dtype).element_size()
    moved = size * (4 * b * h * t * d + h * d) + 4 * b * h * t * d
    return _bound(moved, 5 * (d * d + d) * t * b * h, F32_FLOPS)


def rwkv_floor_ms(shape, sms: int, mhz: float) -> float:
    """The recurrent form's FP32 floor: 3 f32 instructions per state entry
    and step (k_i v_j; w_i S + k v; the r_i S product of y) on every f32
    lane of the card at ``mhz``."""
    b, h, t, d = shape
    return 3 * b * h * t * d * d / (sms * F32_LANES * mhz * 1e6) * 1e3


def under_load(fn, seconds: float = 1.5):
    """(median SM clock in MHz, median power draw in W) as ``nvidia-smi``
    reports them while ``fn()`` runs back to back for ``seconds``; None
    where it gave no reading."""
    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            try:
                mhz, watts = smi("clocks.sm,power.draw").split(", ")
                samples.append((float(mhz.split()[0]),
                                float(watts.split()[0])))
            except (ValueError, subprocess.SubprocessError):
                return
            stop.wait(0.1)

    sampler = threading.Thread(target=sample)
    sampler.start()
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            fn()
            torch.cuda.synchronize()
    finally:
        stop.set()
        sampler.join()
    if not samples:
        return None
    return (median(sorted(m for m, _ in samples)),
            median(sorted(w for _, w in samples)))


def rwkv_control(r, k, v, w, u, fault):
    """Plain RWKV6 in the kernel's factored form with one deliberate fault:
    "u bonus dropped" leaves v_j q out of y; "y read from S_t after the
    update" reads y from the state that already holds k_t^T v_t; "k·v
    rounded to bf16" rounds each k_i v_j to bf16 before it enters the
    state. "u bonus factored" is ``ref.rwkv6_factored``, with no fault."""
    from repro_torch.kernels.ref import rwkv6_factored
    if fault == "u bonus factored":
        return rwkv6_factored(r, k, v, w, u)
    b, h, t, d = r.shape
    r, k, v, w = (x.float() for x in (r, k, v, w))
    uf = u.float()[None]
    S = torch.zeros((b, h, d, d), device=r.device)
    y = torch.empty((b, h, t, d), device=r.device)
    for i in range(t):
        kv = k[:, :, i, :, None] * v[:, :, i, None, :]
        if fault == "k·v rounded to bf16":
            kv = kv.bfloat16().float()
        q = (r[:, :, i] * uf * k[:, :, i]).sum(-1, keepdim=True)
        if fault == "u bonus dropped":
            q = torch.zeros_like(q)
        after = w[:, :, i, :, None] * S + kv
        read = after if fault == "y read from S_t after the update" else S
        y[:, :, i] = (torch.einsum("bhk,bhkv->bhv", r[:, :, i], read)
                      + v[:, :, i] * q)
        S = after
    return y


def _bound(moved, flops, peak):
    t_bytes, t_ops = moved / HBM_BPS, flops / peak
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3, moved=moved, flops=flops,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def over_tolerance(got, want, atol, rtol):
    """(entries outside atol, rtol, as np.allclose counts them, or not
    finite; max |difference|; largest share of the tolerance used), in
    f32."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    allowed = atol + rtol * w.abs()
    bad = (diff > allowed) | ~torch.isfinite(g)
    return int(bad.sum()), float(diff.max()), float((diff / allowed).max())


def attention_control(q, k, v, window, fault):
    """Plain causal attention for queries at the last positions of the
    keys, with one deliberate fault: "P in bf16" rounds the probabilities to
    bf16 before the product with v; "oldest key dropped" and "oldest 64
    keys dropped" mask the first unmasked keys of every row (the window
    moved in by one key or one tile); "TF32 products" lets both products
    use TF32 (one pass); "none" is the same computation without a fault;
    "P as two bf16 halves" is ``ref.mha_split_p``, the bf16 kernel's
    arithmetic, and "three TF32 passes" ``ref.mha_split_tf32``, the f32
    kernel's split (rounded to nearest, where the tensor cores
    truncate)."""
    if fault == "P as two bf16 halves":
        from repro_torch.kernels.ref import mha_split_p
        return mha_split_p(q, k, v, causal=True, window=window)
    if fault == "three TF32 passes":
        from repro_torch.kernels.ref import mha_split_tf32
        return mha_split_tf32(q, k, v, causal=True, window=window)
    b, h, sq, d = q.shape
    n_kv, skv = k.shape[1], k.shape[2]
    pos = skv - sq + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    lo = (pos - window + 1).clamp(min=0) if window > 0 else 0
    drop = {"oldest key dropped": 1, "oldest 64 keys dropped": 64}
    ok = (kpos <= pos) & (kpos >= lo + drop.get(fault, 0))
    torch.backends.cuda.matmul.allow_tf32 = fault == "TF32 products"
    try:
        qr = q.reshape(b, n_kv, h // n_kv, sq, d).float()
        s = torch.einsum("bkgqd,bksd->bkgqs", qr, k.float()) / math.sqrt(d)
        s = s.masked_fill(~ok, -1e30)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        denom = p.sum(-1, keepdim=True)
        if fault == "P in bf16":
            p = p.bfloat16().float()
        o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float()) / denom
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    return o.reshape(b, h, sq, d).to(q.dtype)


def median(times):
    return times[len(times) // 2]


def input_sets(first, make, least=2):
    """``first`` plus fresh sets, at least ``least`` in all, until together
    they exceed the L2."""
    n = max(least, math.ceil(1.25 * L2_BYTES / nbytes(first)))
    return [first] + [make() for _ in range(n - 1)]


def sdpa_fn(sq, skv, window, group):
    """One PyTorch call for the same attention (the yardstick; the port
    never calls it). Its ``is_causal`` is top-left aligned, so end-aligned
    or windowed shapes pass the mask, with k, v expanded to H heads
    beforehand (not timed)."""
    import torch.nn.functional as F

    if sq == skv and window == 0:
        return (lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)), lambda k: k
    pos = skv - sq + torch.arange(sq, device="cuda")[:, None]
    kpos = torch.arange(skv, device="cuda")[None, :]
    mask = kpos <= pos
    if window > 0:
        mask &= kpos > pos - window
    return (lambda q, k, v: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask)), lambda k: k.repeat_interleave(group, 1)


def api_phase(dev):
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.ref import mha_reference, rwkv6_reference
    from repro_torch.kernels.rwkv6_scan import rwkv6_chunked as rk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[api] torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}, "
        f"torch.backends.cudnn.allow_tf32 = "
        f"{torch.backends.cudnn.allow_tf32}")
    gen = torch.Generator(device=dev).manual_seed(12)
    attn = {n: attn_inputs(shp, dt, gen) for n, _, shp, dt, _, _ in
            ATTN_SHAPES}
    rwkv = {n: rwkv_inputs(shp, dt, gen) for n, _, shp, dt in RWKV_SHAPES}

    # the phase's path: every shape once through the public ops, counted
    # by route: bf16 on the wgmma kernel, f32 on the 3xTF32 wgmma kernel
    torch.cuda.synchronize()
    fa.launches = fa.launches_sm90 = fa.launches_f32 = rk.launches = 0
    out = {}
    for name, _, _, _, window, _ in ATTN_SHAPES:
        out[name] = ops.flash_attention(*attn[name], causal=True,
                                        window=window)
    for name, *_ in RWKV_SHAPES:
        out[name] = ops.rwkv6_chunked(*rwkv[name], chunk=128)
    torch.cuda.synchronize()
    launches = {"flash_attention": fa.launches_sm90,
                "flash_attention_f32": fa.launches_f32,
                "rwkv6_chunked": rk.launches}
    log(f"[api] launches in the phase's path: {launches} "
        f"({fa.launches} attention launches in all)")
    n_bf16 = sum(dt == torch.bfloat16 for *_, dt, _, _ in ATTN_SHAPES)
    if fa.launches != len(ATTN_SHAPES) or launches != {
            "flash_attention": n_bf16,
            "flash_attention_f32": len(ATTN_SHAPES) - n_bf16,
            "rwkv6_chunked": len(RWKV_SHAPES)}:
        raise AssertionError(f"api: expected one launch per shape on its "
                             f"dtype's route, got {launches}")

    result = {}
    for name, src, shape, dtype, window, rows in ATTN_SHAPES:
        b, h, kv, sq, skv, d = shape
        atol, rtol = ATTN_TOL[dtype]

        def plain(q, k, v, window=window):
            return mha_reference(q, k, v, causal=True, window=window)

        def kern(q, k, v, window=window):
            return ops.flash_attention(q, k, v, causal=True, window=window)

        def head(q, k, v, rows=rows):      # the query rows checked
            return (q if rows is None else q[:, :, -rows:].contiguous(),
                    k, v)

        checked = "all rows" if rows is None else f"last {rows} query rows"
        sets = input_sets(attn[name],
                          lambda: attn_inputs(shape, dtype, gen), CHECK_SETS)
        readings = []                    # the phase's output, then fresh
        for i, a in enumerate(sets[:CHECK_SETS]):
            got = out.pop(name) if i == 0 else kern(*a)
            got = got if rows is None else got[:, :, -rows:]
            readings.append(over_tolerance(got, plain(*head(*a)), atol,
                                           rtol))
            del got
        bad = sum(n for n, _, _ in readings)
        err = max(e for _, e, _ in readings)
        log(f"[api] flash_attention {name} vs plain on {CHECK_SETS} input "
            f"sets ({checked}), atol {atol:g} rtol {rtol:g}: entries over "
            f"tolerance {[n for n, _, _ in readings]}, max |err| "
            f"{[f'{e:.3e}' for _, e, _ in readings]}, largest share of the "
            f"tolerance used {[f'{u:.3f}' for _, _, u in readings]}")
        q, k, v = sets[0]
        q = q[:, :, -CONTROL_ROWS:].contiguous()
        want = plain(q, k, v)
        caught = {}
        for fault in CONTROLS[dtype]:
            n, e, u = over_tolerance(attention_control(q, k, v, window, fault),
                                     want, atol, rtol)
            caught[fault] = n
            log(f"[api] control {name} ({fault}, last {CONTROL_ROWS} query "
                f"rows): {n} entries over tolerance, max |err| {e:.3e}, "
                f"largest share of the tolerance used {u:.3f}")
        del q, k, v, want
        if any(caught[f] for f in caught if f in SOUND) or not all(
                caught[f] for f in caught if f not in SOUND):
            raise AssertionError(f"api: the {name} tolerance does not tell "
                                 f"the controls apart: {caught}")
        k_t = graph_ms(kern, sets, len(sets), replays=1, windows=3)
        p_t = graph_ms(plain, [head(*s) for s in sets], len(sets),
                       replays=1, windows=3)
        sdpa, expand = sdpa_fn(sq, skv, window, h // kv)
        l_t = graph_ms(sdpa, [(q, expand(k), expand(v)) for q, k, v in sets],
                       len(sets), replays=1, windows=3)
        load = (None if dtype == torch.bfloat16 else
                under_load(lambda: [kern(*a) for a in sets]))
        n_sets = len(sets)
        del sets
        torch.cuda.empty_cache()
        bnd = attn_bound(shape, dtype, window)
        ms = median(k_t)
        passes = 1.5 if dtype == torch.bfloat16 else 3.0
        bq, bkv = ATTN_TILES[dtype]
        issued = (4 * passes * d * bq * bkv
                  * attn_tiles(sq, skv, window, bq, bkv) * b * h)
        rate = (f"{bnd['flops'] / ms / 1e9:.2f} TFLOP/s counted (4 D a pair), "
                f"{passes * bnd['flops'] / ms / 1e9:.2f} executed "
                f"({4 * passes:g} D a pair), {issued / ms / 1e9:.2f} issued "
                f"over whole {bq} x {bkv} tiles ({issued / 1e9:.1f} GFLOP)")
        if dtype == torch.bfloat16:
            work = f"{bnd['flops'] / 1e9:.1f} GFLOP at {BF16_FLOPS / 1e12:g}"
        else:
            work = (f"3 TF32 passes of {bnd['flops'] / 1e9:.1f} GFLOP at "
                    f"{TF32_FLOPS / 1e12:g}")
        fma = ("" if dtype == torch.bfloat16 else
               f"; the FMA design's ceiling {bnd['fma_ms']:.4f} ms "
               f"({F32_FLOPS / 1e12:g} TFLOP/s f32); under load " + (
                   "the SM clock and power: not measured" if load is None
                   else f"the SM clock reads {load[0]:g} MHz at {load[1]:g} "
                   f"W (medians of nvidia-smi samples)"))
        log(f"[api] flash_attention {name} ({src}) (B,H,KV,Sq,Skv,D)="
            f"{shape} {str(dtype)[6:]} causal window={window}: {bad} "
            f"entries over tolerance ({checked}), max |err| {err:.3e}; "
            f"{ms:.4f} ms/call median of {len(k_t)} windows (min "
            f"{k_t[0]:.4f}, max {k_t[-1]:.4f}), {rate}; plain torch "
            f"{median(p_t):.4f} ms ({checked}); SDPA {median(l_t):.4f} ms "
            f"(all rows); bound {bnd['bound_ms']:.4f} ms by "
            f"{bnd['bound_by']} ({work} TFLOP/s, {bnd['moved'] / 1e6:.1f} "
            f"MB), {bnd['bound_ms'] / ms:.1%} of it{fma}; {n_sets} input "
            f"sets")
        result[name] = dict(ms=ms, plain_ms=median(p_t),
                            library_ms=median(l_t), mismatches=bad,
                            max_abs_err=err, **bnd)

    mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, src, shape, dtype in RWKV_SHAPES:
        sets = input_sets(rwkv[name], lambda: rwkv_inputs(shape, dtype, gen))
        readings = []
        for i, a in enumerate(sets):         # the phase's output, then fresh
            got = out.pop(name) if i == 0 else ops.rwkv6_chunked(*a,
                                                                 chunk=128)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            want, _ = rwkv6_reference(*a)
            end.record()
            end.synchronize()
            if i == 0:
                plain_ms = start.elapsed_time(end)
            readings.append(over_tolerance(got, want, RWKV_TOL, RWKV_TOL))
            del got
            caught = {}
            for fault in RWKV_CONTROLS:
                n, e, share = over_tolerance(rwkv_control(*a, fault), want,
                                             RWKV_TOL, RWKV_TOL)
                caught[fault] = n
                log(f"[api] control {name} set {i} ({fault}): {n} entries "
                    f"over tolerance {RWKV_TOL}, max |err| {e:.3e}, largest "
                    f"share of the tolerance used {share:.3f}")
            del want
            if any(caught[f] for f in RWKV_SOUND) or not all(
                    caught[f] for f in caught if f not in RWKV_SOUND):
                raise AssertionError(f"api: the {name} tolerance does not "
                                     f"tell the controls apart: {caught}")
        bad = sum(n for n, _, _ in readings)
        err = max(e for _, e, _ in readings)
        log(f"[api] rwkv6_chunked {name} vs plain on {len(sets)} input sets, "
            f"atol = rtol = {RWKV_TOL:g}: entries over tolerance "
            f"{[n for n, _, _ in readings]}, max |err| "
            f"{[f'{e:.3e}' for _, e, _ in readings]}, largest share of the "
            f"tolerance used {[f'{u:.3f}' for _, _, u in readings]}")
        k_t = graph_ms(lambda *a: ops.rwkv6_chunked(*a, chunk=128), sets,
                       2 * len(sets), replays=3, windows=5)
        load = under_load(
            lambda: [ops.rwkv6_chunked(*a, chunk=128) for a in sets])
        del sets
        torch.cuda.empty_cache()
        bnd = rwkv_bound(shape, dtype)
        floor = rwkv_floor_ms(shape, sms, mhz)
        ms = median(k_t)
        log(f"[api] rwkv6_chunked {name} ({src}) (B,H,T,D)={shape} "
            f"{str(dtype)[6:]}: {bad} entries over tolerance {RWKV_TOL}, "
            f"max |err| {err:.3e}; {ms:.4f} ms/call median of {len(k_t)} "
            f"windows (min {k_t[0]:.4f}, max {k_t[-1]:.4f}); plain torch "
            f"{plain_ms:.1f} ms (one call, CUDA events, a {shape[2]}-step "
            f"loop); bound {bnd['bound_ms']:.4f} ms by {bnd['bound_by']} "
            f"({bnd['flops'] / 1e9:.1f} GFLOP, {bnd['moved'] / 1e6:.1f} MB), "
            f"{bnd['bound_ms'] / ms:.1%} of it; FP32 floor {floor:.4f} ms (3 "
            f"instructions per entry-step, {sms} SMs x {F32_LANES} lanes at "
            f"{mhz:g} MHz), {floor / ms:.1%} of it; under load "
            + ("the SM clock and power: not measured" if load is None else
               f"the SM clock reads {load[0]:g} MHz at {load[1]:g} W "
               f"(medians of nvidia-smi samples), the floor at that clock "
               f"{floor * mhz / load[0]:.4f} ms"))
        result[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                            mismatches=bad, max_abs_err=err, **bnd)

    del attn, rwkv
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    bad = {n: r["mismatches"] for n, r in result.items() if r["mismatches"]}
    if bad:
        raise AssertionError(f"api: kernel disagrees with its plain version "
                             f"({bad} entries over tolerance)")
    entries = {}
    bf16 = [n for n, _, _, dt, _, _ in ATTN_SHAPES if dt == torch.bfloat16]
    for kernel, first, names in (
            ("flash_attention", "F1", bf16),
            ("flash_attention_f32", "F4",
             [n for n, *_ in ATTN_SHAPES if n not in bf16]),
            ("rwkv6_chunked", "R1", [n for n, *_ in RWKV_SHAPES])):
        e = {k: result[first][k] for k in ("ms", "plain_ms", "library_ms",
                                           "bound_ms", "bound_by")}
        e.update(launches=launches[kernel],
                 mismatches=sum(result[n]["mismatches"] for n in names),
                 max_abs_err=max(result[n]["max_abs_err"] for n in names))
        entries[kernel] = e
    return entries


# ------------------------------------------------------ phases 4 to 6
def _launches():
    from repro_torch.kernels.quack_scan import quack_scan
    return (quack_scan.launches, quack_scan.launches_no_lost,
            quack_scan.launches_skipped)


def _reset_launches():
    from repro_torch.kernels.quack_scan import quack_scan
    quack_scan.launches = 0
    quack_scan.launches_no_lost = 0
    quack_scan.launches_skipped = 0


def _check_launches(spec, what: str):
    """The launch contract: two launches a round (one without the loss
    quorum), and a windowed run one more without it per rotating chunk,
    its GC frontier (every chunk but the last rotates). Launches of chunk
    bodies that a span's overflow guard discarded are counted apart."""
    total, no_lost, skipped = _launches()
    steps = spec.steps
    chunks = -(-steps // spec.chunk_steps) if spec.window_slots else 0
    rotating = max(chunks - 1, 0)
    log(f"[{what}] quack_scan launches: {total} "
        f"({total - no_lost} with the loss quorum, {no_lost} without; "
        f"{steps} rounds, {rotating} rotating chunks; {skipped} more in "
        f"chunk bodies an overflow guard discarded)")
    if total != 2 * steps + rotating or no_lost != steps + rotating:
        raise AssertionError(
            f"{what}: {total} launches ({no_lost} without the loss quorum) "
            f"for {steps} rounds and {rotating} rotating chunks; expected "
            f"{2 * steps + rotating} ({steps + rotating})")


def _engine_counts():
    """(dispatches, host syncs, captures, replays) so far."""
    from repro_torch.core import graphs, simulator
    return (simulator.chunk_dispatch_count(), simulator.host_sync_count(),
            graphs.capture_count(), graphs.replay_count())


def _check_dispatches(spec, counts, what: str, events=()):
    """The dispatch contract of a windowed run at superchunk K, given its
    growth ``events``: exactly C dispatches at K = 1; without growth at
    most ceil(C / K) + 2 (a growth cuts a span, which is dispatched
    again); host syncs at most dispatches + 2, plus one per dense
    migration; and every dispatch a graph replay. A dense run: one
    replay per 32-round block."""
    from repro_torch.core.simulator import DENSE_BLOCK
    dispatches, syncs, captures, replays = counts
    if not spec.window_slots:
        blocks = -(-spec.steps // DENSE_BLOCK)
        log(f"[{what}] {replays} graph replays of {captures} captured "
            f"programs for {blocks} dense blocks")
        if replays != blocks or dispatches:
            raise AssertionError(f"{what}: {replays} replays for {blocks} "
                                 f"blocks")
        return
    chunks = -(-spec.steps // spec.chunk_steps)
    k = spec.superchunk
    ceiling = -(-chunks // k) + 2
    migrations = sum(e.dense_migration for e in events)
    log(f"[{what}] {dispatches} dispatches ({replays} graph replays of "
        f"{captures} captured programs), {syncs} host syncs for {chunks} "
        f"chunks at K = {k}"
        + ("" if events else f" (ceiling ceil(C/K)+2 = {ceiling})"))
    if ((k == 1 and dispatches != chunks)
            or (not events and dispatches > ceiling)
            or syncs > dispatches + 2 + migrations
            or replays != dispatches):
        raise AssertionError(f"{what}: dispatch contract broken")


def growth(res):
    """A result's growth events as (round, old W, new W, to dense)."""
    return [(e.step, e.old_w, e.new_w, e.dense_migration)
            for e in res.window_growth_events]


OUTPUT_FIELDS = ("quack_time", "deliver_time", "retry", "recv_has",
                 "send_step", "delivery_latency")


def _assert_same(a, b, what: str, window: bool = True):
    """Every output and metric of two results bit for bit, dtypes
    included; with ``window`` also the GC frontier trajectory, the final
    width and the growth events."""
    fields = OUTPUT_FIELDS + (("gc_frontiers",) if window else ())
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if x.dtype != y.dtype or not np.array_equal(x, y):
            raise AssertionError(f"{what}: the runs differ in {f}")
    for f in a.metrics._fields:
        x, y = getattr(a.metrics, f), getattr(b.metrics, f)
        if x.dtype != y.dtype or not np.array_equal(x, y):
            raise AssertionError(f"{what}: the runs differ in metric {f}")
    if window and (a.final_window_slots != b.final_window_slots
                   or a.window_growth_events != b.window_growth_events):
        raise AssertionError(f"{what}: the runs differ in their window")
    return len(fields) + len(a.metrics._fields)


OBS_FIELDS = ("latency_hist", "occupancy_hwm", "gc_lag_hwm", "quack_events",
              "loss_events", "resend_total", "uncounted", "per_chunk_hist")


def _obs_checks(res, what: str) -> str:
    """One lane's metrics against its own outputs: the histogram ==
    the numpy histogram of ``delivery_latency``, ``quack_events`` == the
    (sender, message) pairs quacked, ``resend_total`` == the resends of
    its round metrics, nothing uncounted. Returns a summary."""
    from repro_torch.obs.metrics import latency_histogram_np
    o = res.obs
    checks = {
        "latency_hist": np.array_equal(
            o.latency_hist, latency_histogram_np(res.delivery_latency)),
        "quack_events": o.quack_events == int((res.quack_time >= 0).sum()),
        "resend_total": o.resend_total == int(res.metrics.resends.sum()),
        "uncounted": o.uncounted == 0}
    bad = [name for name, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"{what}: metrics disagree with the outputs "
                             f"in {bad}")
    p = o.percentiles()
    return (f"{o.total_counted()} counted, p50/p95/p99 {p['p50']}/"
            f"{p['p95']}/{p['p99']} rounds, occupancy hwm "
            f"{o.occupancy_hwm}, gc lag hwm {o.gc_lag_hwm}, quack events "
            f"{o.quack_events}, loss events {o.loss_events}, resends "
            f"{o.resend_total}")


def _same_obs(a, b, what: str) -> None:
    """Two ``ObsMetrics`` field by field."""
    for f in OBS_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if (x is None) != (y is None) or (
                x is not None and not np.array_equal(x, y)):
            raise AssertionError(f"{what}: the metrics differ in {f}")


def _counters():
    """Engine counters and ``quack_scan``'s launch counters so far."""
    return _engine_counts() + _launches()


def _traces(first_uses: bool = False) -> int:
    """The engine's windowed trace count (programs a run used for the
    first time in their cached set), or with ``first_uses`` every
    program's first uses, dense blocks included."""
    from repro_torch.core import graphs, simulator
    return (graphs.first_use_count() if first_uses
            else simulator.chunk_trace_count())


def _captures_are_traces(what: str, moved, traces: int) -> None:
    """A run's captures are exactly the programs it used for the first
    time in their cached sets (its windowed traces; every first use for a
    dense run): nothing ran eagerly, and nothing was captured twice."""
    if moved[2] != traces:
        raise AssertionError(f"{what}: {moved[2]} captures for {traces} "
                             f"programs used for the first time")


def _metrics_twin(what: str, run, off_runs, off_moved) -> None:
    """Phase 4, metrics on: ``run(device)`` (a list of ``C3BRun``) with
    ``collect_metrics`` on, on CUDA and on the CPU. The CUDA run's
    outputs == the metrics-off CUDA runs ``off_runs``, its metrics == the
    CPU run's and its own outputs', and it moves every counter but the
    captures as the metrics-off run moved them (``off_moved``). Metrics
    are part of a program set's layout, so the two runs capture their
    own programs: each run's captures are its traces, and the metrics-on
    run, run again, captures nothing and moves every other counter as
    before (programs outlive runs)."""
    dense = not off_runs[0].spec.window_slots

    def counted():
        torch.cuda.synchronize()
        before, traces = _counters(), _traces(dense)
        out = run("cuda")
        torch.cuda.synchronize()
        return out, tuple(a - b for a, b in zip(_counters(), before)), \
            _traces(dense) - traces

    gpu, moved, traces = counted()
    _captures_are_traces(f"{what} metrics on", moved, traces)
    cpu = run("cpu")
    for b, (g, c, o) in enumerate(zip(gpu, cpu, off_runs)):
        lane = f"{what} metrics on, lane {b}"
        _assert_same(g.result, o.result, f"{lane} vs metrics off")
        _assert_same(g.result, c.result, f"{lane} cuda vs cpu")
        _same_obs(g.result.obs, c.result.obs, f"{lane} cuda vs cpu")
        _obs_checks(g.result, lane)
    if moved[:2] + moved[3:] != off_moved[:2] + off_moved[3:]:
        raise AssertionError(f"{what}: metrics on moved the counters "
                             f"{moved}, metrics off {off_moved}")
    warm, warm_moved, _ = counted()
    for b, (g, w) in enumerate(zip(gpu, warm)):
        _assert_same(w.result, g.result, f"{what} warm lane {b}")
        _same_obs(w.result.obs, g.result.obs, f"{what} warm lane {b}")
    if warm_moved[2] or warm_moved[:2] + warm_moved[3:] != \
            moved[:2] + moved[3:]:
        raise AssertionError(f"{what}: the warm run moved {warm_moved}, "
                             f"the cold run {moved}")
    log(f"[path] {what} with collect_metrics: == metrics off, cuda == cpu "
        f"in every ObsMetrics field of {len(gpu)} lanes, each == its "
        f"outputs; counters (dispatches, host syncs, captures, replays, "
        f"launches, without the loss quorum, skipped) {moved}, == metrics "
        f"off {off_moved} but for the captures; captures == traces "
        f"({traces}); run again: {warm_moved[2]} captures, the rest the "
        f"same; lane 0: {_obs_checks(gpu[0].result, what)}")


class Measured:
    """Runs ``fn`` as one measured run: the program cache emptied (unless
    ``cold`` is False: a cold run captures its programs, as every run did
    before programs outlived runs, so its wall, capture time and peak
    memory stay comparable with earlier PRs'), launch counts at 0 and
    peak memory reset just before it; afterwards its wall time, peak
    device memory
    above what was allocated before it, engine counters, the device time
    spent inside graph replays (CUDA events around each replay of a
    captured program, summed; the graphs' own gaps between kernels count
    as busy), and the host time of the dispatches that captured their
    program (warm-up, capture, first replay). ``plan_s``, the planning
    (``build_spec``) time of the same specs measured beforehand, is taken
    off the wall: the entry points plan inside the run."""

    def __init__(self, fn, plan_s: float = 0.0, cold: bool = True):
        from repro_torch.core import graphs
        torch.cuda.synchronize()
        if cold:
            graphs.clear_programs()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        spans = []
        captures = []
        run = graphs.Programs.run

        def timed(prog, key, body, t):
            if key not in prog:
                t0 = time.perf_counter()
                out = run(prog, key, body, t)
                captures.append(time.perf_counter() - t0)
                return out
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = run(prog, key, body, t)
            end.record()
            spans.append((start, end))
            return out

        before = _engine_counts()
        _reset_launches()
        graphs.Programs.run = timed
        t0 = time.perf_counter()
        try:
            self.result = fn()     # ends in a device->host copy
        finally:
            self.wall = time.perf_counter() - t0 - plan_s
            graphs.Programs.run = run
        torch.cuda.synchronize()
        self.launches = _launches()
        self.counts = tuple(a - b for a, b in zip(_engine_counts(), before))
        self.peak_mib = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
        self.held_mib = held / 2 ** 20
        self.graph_ms = sum(s.elapsed_time(e) for s, e in spans)
        self.capture_s = sum(captures)

    def line(self, steps: int, m: int) -> str:
        return (f"{self.wall:.3f} s wall, {steps / self.wall:.1f} rounds/s, "
                f"{m / self.wall:.1f} msgs/s; device inside graph replays "
                f"{self.graph_ms / 1e3:.3f} s "
                f"({self.graph_ms / 1e3 / self.wall:.1%} of the wall); "
                f"capturing {self.capture_s:.3f} s (dispatches that "
                f"captured their program); peak device memory of the run "
                f"{self.peak_mib:.1f} MiB (above {self.held_mib:.1f} MiB "
                f"allocated before it)")


def _path_batch(cfg, scenarios):
    """Phase 4, continued: the path checks' failure scenarios as the lanes
    of one batch on one link (M = 1,024, 200 rounds): dense, and windowed
    (W = 256, 16-round chunks) at K = 1 and K = 8, each on CUDA and on an
    explicitly requested CPU. Every combination agrees lane by lane, and
    every lane with its single run."""
    from repro_torch.core import SimConfig, run_picsou, run_picsou_batch
    sims = {"dense": SimConfig(n_msgs=1024, steps=200),
            "windowed K=1": SimConfig(n_msgs=1024, steps=200,
                                      window_slots=256, chunk_steps=16,
                                      superchunk=1),
            "windowed K=8": SimConfig(n_msgs=1024, steps=200,
                                      window_slots=256, chunk_steps=16,
                                      superchunk=8)}
    out = {}
    for name, sim in sims.items():
        torch.cuda.synchronize()
        _reset_launches()
        before = _counters()
        gpu = run_picsou_batch(cfg, cfg, sim, scenarios)
        torch.cuda.synchronize()
        moved = tuple(a - b for a, b in zip(_counters(), before))
        _check_launches(gpu[0].spec, f"path batch {name}")
        _check_dispatches(gpu[0].spec, moved[:4], f"path batch {name}",
                          gpu[0].result.window_growth_events)
        cpu = run_picsou_batch(cfg, cfg, sim, scenarios, device="cpu")
        for b, (g, c) in enumerate(zip(gpu, cpu)):
            _assert_same(g.result, c.result, f"path batch {name} lane {b}")
        on = dataclasses.replace(sim, collect_metrics=True)
        _metrics_twin(f"path batch {name}", lambda device: run_picsou_batch(
            cfg, cfg, on, scenarios, device=device), gpu, moved)
        out[name] = gpu
    n = 0
    for b, f in enumerate(scenarios):
        w1, w8, d = (out[name][b].result for name in
                     ("windowed K=1", "windowed K=8", "dense"))
        n = _assert_same(w1, w8, f"path batch lane {b}: K=1 vs K=8")
        _assert_same(w8, d, f"path batch lane {b}: windowed vs dense",
                     window=False)
        single = run_picsou(cfg, cfg, sims["windowed K=8"], f).result
        _assert_same(single, w8, f"path batch lane {b}: single run",
                     window=single.window_growth_events
                     == w8.window_growth_events)
        single = run_picsou(cfg, cfg, sims["dense"], f).result
        _assert_same(single, d, f"path batch lane {b}: single dense run")
    res = out["windowed K=8"][0].result
    log(f"[path] batch of {len(scenarios)} scenarios, M=1024, 200 rounds: "
        f"dense, windowed K=1 and K=8, each cuda == cpu lane by lane; K=1 "
        f"== K=8 ({n} fields), windowed == dense, every lane == its single "
        f"run; final W {res.final_window_slots}, growth {growth(res)}")


def path_phase():
    from repro_torch.core import (FailureScenario, RSMConfig, SimConfig,
                                  run_picsou)
    cfg = RSMConfig.bft(1)
    fails = FailureScenario(crash_s=(2, -1, -1, -1),
                            byz_recv_drop=(False, False, True, False))
    stall = dict(byz_bcast_partial=(True, False, False, False),
                 bcast_limit=2)
    runs = [
        ("dense", SimConfig(n_msgs=1024, steps=200), fails),
        ("windowed", SimConfig(n_msgs=1024, steps=200, window_slots=256,
                               chunk_steps=16), fails),
        ("windowed growth (gc_stall_adversary)",
         SimConfig(n_msgs=128, steps=128 // 4 + 80, window=1, phi=6,
                   window_slots=16, chunk_steps=8),
         FailureScenario(**stall)),
        ("windowed dense fallback",
         SimConfig(n_msgs=64, steps=200, window=1, phi=6, window_slots=16,
                   chunk_steps=8),
         FailureScenario(**stall, crash_r=(-1, 8, -1, -1))),
    ]
    for name, sim, f in runs:
        torch.cuda.synchronize()
        _reset_launches()
        before = _counters()
        gpu = run_picsou(cfg, cfg, sim, f)
        torch.cuda.synchronize()
        moved = tuple(a - b for a, b in zip(_counters(), before))
        _check_launches(gpu.spec, f"path {name}")
        cpu = run_picsou(cfg, cfg, sim, f, device="cpu")
        n = _assert_same(gpu.result, cpu.result, f"path {name}")
        res = gpu.result
        if name in ("dense", "windowed") and not (gpu.all_delivered
                                                  and gpu.all_quacked):
            raise AssertionError(f"path {name}: the run did not deliver "
                                 f"and quack all")
        if name != "dense" and not res.window_growth_events:
            raise AssertionError(f"path {name}: the window never grew")
        log(f"[path] {name}: M={sim.n_msgs} steps={sim.steps} W="
            f"{gpu.spec.window_slots or sim.n_msgs}: cuda == cpu bit for "
            f"bit ({n} fields); final W {res.final_window_slots}, growth "
            f"{growth(res)}, "
            f"frontier trajectory of {len(res.gc_frontiers)} ending at "
            f"{int(res.gc_frontiers[-1])}; resends/msg "
            f"{gpu.resends_per_msg:.4f}, completion round "
            f"{res.completion_step()}")
        on = dataclasses.replace(sim, collect_metrics=True)
        _metrics_twin(f"path {name}", lambda device: [run_picsou(
            cfg, cfg, on, f, device=device)], [gpu], moved)
    _path_batch(cfg, [FailureScenario.none(), fails,
                      FailureScenario(**stall),
                      FailureScenario(**stall, crash_r=(-1, 8, -1, -1))])


def _plan_s(sim, scenarios) -> float:
    """Seconds ``build_spec`` takes for these scenarios of the full-size
    link (the planning an entry point does inside its run)."""
    from repro_torch.core import RSMConfig, build_spec
    cfg = RSMConfig.bft(6)
    t0 = time.perf_counter()
    for f in scenarios:
        build_spec(cfg, cfg, sim, f)
    return time.perf_counter() - t0


def _full_run(name: str, sim, fails, plan_s=None, cold: bool = True):
    """One full-size run through ``run_picsou`` (``Measured``, its
    planning time taken off, cold unless ``cold`` is False); logs its
    numbers, checks the launch and dispatch contracts and that it
    delivered and quacked every message."""
    from repro_torch.core import RSMConfig, run_picsou
    cfg = RSMConfig.bft(6)
    if plan_s is None:
        plan_s = _plan_s(sim, [fails])
    run_m = Measured(lambda: run_picsou(cfg, cfg, sim, fails), plan_s,
                     cold=cold)
    run = run_m.result
    _check_launches(run.spec, name)
    res = run.result
    _check_dispatches(run.spec, run_m.counts, name,
                      res.window_growth_events)
    m, steps = sim.n_msgs, sim.steps
    log(f"[{name}] BFT f=6 <-> f=6, M={m}, steps={steps}, W="
        f"{run.spec.window_slots or m}, K={run.spec.superchunk}: "
        + run_m.line(steps, m)
        + f" (planning, {plan_s:.3f} s, taken off)"
        + f"; completion round {res.completion_step()}, delivery round "
        f"{res.delivery_step()}, cross copies/msg "
        f"{run.cross_copies_per_msg}, resends {res.total_resends()}")
    if not (run.all_delivered and run.all_quacked):
        raise AssertionError(f"{name}: not all delivered and quacked "
                             f"after {steps} rounds")
    if res.metrics.delivered.shape != (steps,) or \
            int(res.metrics.delivered[-1]) != m:
        raise AssertionError(f"{name}: delivered metric wrong")
    if fails.crash_s is None:
        if run.cross_copies_per_msg != 1.0 or res.total_resends():
            raise AssertionError(f"{name}: expected one cross copy per "
                                 f"message, no resends")
    elif res.total_resends() <= 0:
        raise AssertionError(f"{name}: expected resends")
    return run, run_m


def full_phase(steps_free: int, steps_crash: int):
    from repro_torch.core import FailureScenario, SimConfig
    crash = FailureScenario.crash_fraction(19, 19, 0.3, seed=2)
    launches = [0, 0]
    out = {}
    for name, fails, steps, m in (("failure-free", FailureScenario.none(),
                                   steps_free, SHAPE[2]),
                                  ("crash 0.3", crash, steps_crash,
                                   CRASH_M)):
        sim = SimConfig(n_msgs=m, steps=steps, window=4, phi=32)
        run, run_m = _full_run(f"full {name}", sim, fails)
        total, no_lost, _ = run_m.launches
        launches[0] += total - no_lost
        launches[1] += no_lost
        out[name] = (run.result, run_m.wall / steps * 1e3, run_m)
    return launches, out


def windowed_phase(dense_crash, steps_crash: int):
    """Phase 5w: the windowed engine at full width. Returns the launch
    counts, the unprofiled ms per round of the long stream at K = 8 and
    of the crash run, and those two runs (result, ``Measured``) for the
    metrics phase."""
    from repro_torch.core import (FailureScenario, RSMConfig, SimConfig,
                                  build_spec)
    cfg = RSMConfig.bft(6)
    launches = [0, 0]

    sim = SimConfig(n_msgs=M_LONG, steps=STEPS_LONG, window=4, phi=32,
                    window_slots="auto", chunk_steps=CHUNK)
    t0 = time.perf_counter()
    spec = build_spec(cfg, cfg, sim)
    plan_s = time.perf_counter() - t0
    ostep = np.asarray(spec.orig_step)
    log(f"[windowed long] planning (build_spec) {plan_s:.3f} s: W="
        f"{spec.window_slots}, last original send at round "
        f"{int(ostep.max())}, scan_state_nbytes {spec.scan_state_nbytes()}"
        f" (dense at this M: "
        f"{dataclasses.replace(spec, window_slots=0).scan_state_nbytes()})")
    long = {}
    # K = 8 cold, the same run again warm (phase 9b's warm contract: the
    # programs outlive the run), then K = 1 cold
    for k, cold in ((8, True), ("8 warm", False), (1, True)):
        run, run_m = _full_run(f"windowed long K={k}", dataclasses.replace(
            sim, superchunk=8 if k == "8 warm" else k),
            FailureScenario.none(), plan_s, cold=cold)
        res = run.result
        if int(res.gc_frontiers[-1]) != M_LONG or res.window_growth_events:
            raise AssertionError(f"windowed long: frontier ends at "
                                 f"{int(res.gc_frontiers[-1])}, growth "
                                 f"{res.window_growth_events}")
        total, no_lost, _ = run_m.launches
        launches[0] += total - no_lost
        launches[1] += no_lost
        long[k] = (res, run_m.wall / STEPS_LONG * 1e3, run_m)
        del run
    cold_m, warm_m = long[8][2], long["8 warm"][2]
    n = _assert_same(long["8 warm"][0], long[8][0],
                     "windowed long K=8 warm vs cold")
    if warm_m.counts[2] or cold_m.counts[2] <= 0 or (
            warm_m.counts[:2] + warm_m.counts[3:]
            != cold_m.counts[:2] + cold_m.counts[3:]):
        raise AssertionError(f"windowed long warm contract: cold "
                             f"{cold_m.counts}, warm {warm_m.counts}")
    log(f"[windowed long] warm contract: the same K=8 run twice in a row, "
        f"== bit for bit ({n} fields); captures {cold_m.counts[2]}, then "
        f"{warm_m.counts[2]}; wall {cold_m.wall:.3f} s cold (capturing "
        f"{cold_m.capture_s:.3f} s), {warm_m.wall:.3f} s warm "
        f"({cold_m.wall - warm_m.wall:+.3f} s, "
        f"{STEPS_LONG / cold_m.wall:.1f} -> {STEPS_LONG / warm_m.wall:.1f}"
        f" rounds/s); peak memory {cold_m.peak_mib:.1f} MiB cold, "
        f"{warm_m.peak_mib:.1f} MiB warm (above {warm_m.held_mib:.1f} MiB "
        f"held, the cached programs' included)")
    del long["8 warm"]
    n = _assert_same(long[8][0], long[1][0], "windowed long K=8 vs K=1")
    res = long[8][0]
    log(f"[windowed long] K=8 == K=1 bit for bit ({n} fields); final W "
        f"{res.final_window_slots}, frontier trajectory of "
        f"{len(res.gc_frontiers)} ending at {int(res.gc_frontiers[-1])}")
    long_ms = long[8][1]
    kept = {"long": (long[8][0], long[8][2])}
    del long, res

    sim = SimConfig(n_msgs=CRASH_M, steps=steps_crash, window=4, phi=32,
                    window_slots="auto", chunk_steps=CHUNK)
    run, run_m = _full_run("windowed crash 0.3", sim,
                           FailureScenario.crash_fraction(19, 19, 0.3,
                                                          seed=2))
    res = run.result
    n = _assert_same(res, dense_crash, "windowed crash vs dense crash",
                     window=False)
    events = res.window_growth_events
    log(f"[windowed crash 0.3] == phase 5's dense crash run bit for bit "
        f"({n} fields); growth events {growth(res)}; migrated to dense: "
        f"{any(e.dense_migration for e in events)}; "
        f"final W {res.final_window_slots}; frontier trajectory of "
        f"{len(res.gc_frontiers)} ending at {int(res.gc_frontiers[-1])}")
    total, no_lost, _ = run_m.launches
    launches[0] += total - no_lost
    launches[1] += no_lost
    kept["crash"] = (res, run_m)
    return launches, long_ms, run_m.wall / steps_crash * 1e3, kept


def sweep_scenarios():
    """The sweep's lanes: (name, FailureScenario) of the failure-free link
    and of receivers 0-5 acking low, stale and +1."""
    from repro_torch.core import FailureScenario
    liars = (True,) * 6 + (False,) * 13
    return [("failure-free", FailureScenario.none()),
            ("byz_ack_low on 0-5", FailureScenario(byz_ack_low=liars)),
            ("byz_ack_stale on 0-5", FailureScenario(byz_ack_stale=liars)),
            ("byz_ack_advance +1 on 0-5", FailureScenario(
                byz_ack_advance=(1,) * 6 + (0,) * 13))]


def sweep_phase():
    """Phase 5s: the full-width sweep of four receiver-side Byzantine ack
    behaviours inside the quorum budget, as the lanes of one batch.
    Returns its launch counts, and the K = 8 sweep's results and
    ``Measured`` for the metrics phase."""
    from repro_torch.core import (RSMConfig, SimConfig, run_picsou,
                                  run_picsou_batch)
    from repro_torch.core.simulator import retire_safety_stakes_ok
    cfg = RSMConfig.bft(6)
    scenarios = sweep_scenarios()
    fails = [f for _, f in scenarios]
    sim = SimConfig(n_msgs=SWEEP_M, steps=SWEEP_STEPS, window=4, phi=32,
                    window_slots="auto", chunk_steps=CHUNK, superchunk=8)
    sweeps = {}
    plan_s = _plan_s(sim, fails)
    for k in (8, 1):
        run_m = Measured(lambda: run_picsou_batch(
            cfg, cfg, dataclasses.replace(sim, superchunk=k), fails), plan_s)
        runs = run_m.result
        spec = runs[0].spec
        what = f"sweep K={k}"
        _check_launches(spec, what)
        _check_dispatches(spec, run_m.counts, what,
                          runs[0].result.window_growth_events)
        log(f"[{what}] B={len(runs)} lanes, BFT f=6 <-> f=6, M={SWEEP_M}, "
            f"steps={SWEEP_STEPS}, W={spec.window_slots}: "
            + run_m.line(SWEEP_STEPS, SWEEP_M * len(runs))
            + f" (planning, {plan_s:.3f} s, taken off)"
            + f"; captures {run_m.counts[2]}, dispatches "
            f"{run_m.counts[0]}")
        sweeps[k] = (runs, run_m)
    for b, ((name, _), r8, r1) in enumerate(zip(scenarios, sweeps[8][0],
                                                sweeps[1][0])):
        if not (r8.all_delivered and r8.all_quacked):
            raise AssertionError(f"sweep lane {b} ({name}): not all "
                                 f"delivered and quacked")
        n = _assert_same(r8.result, r1.result, f"sweep lane {b}: K=8 vs "
                         f"K=1")
        res = r8.result
        log(f"[sweep] lane {b} ({name}, retire_safety_stakes_ok "
            f"{retire_safety_stakes_ok(r8.spec)}): K=8 == K=1 ({n} fields);"
            f" completion round {res.completion_step()}, delivery round "
            f"{res.delivery_step()}, cross copies/msg "
            f"{r8.cross_copies_per_msg}, resends {res.total_resends()}, "
            f"growth {growth(res)}, frontier ends at "
            f"{int(res.gc_frontiers[-1])}")
    single = run_picsou(cfg, cfg, sim, fails[1]).result
    lane = sweeps[8][0][1].result
    n = _assert_same(single, lane, "sweep lane 1 vs its single run",
                     window=single.window_growth_events
                     == lane.window_growth_events)
    log(f"[sweep] lane 1 == a single run_picsou of its scenario at K=8 "
        f"({n} fields)")
    total, no_lost, _ = sweeps[8][1].launches
    return [total - no_lost, no_lost], sweeps[8]


def _on_against_off(what: str, on, on_m, off, off_m, steps: int,
                    msgs: int, window: bool = True) -> None:
    """Phase 5m: a metrics-on run (``on``: its results, ``on_m`` its
    ``Measured``) against the same run with metrics off from phases 5,
    5w and 5s: equal outputs, every lane's metrics equal to its own
    outputs, the same counters; logs the cost in rounds/s and memory."""
    for b, (x, y) in enumerate(zip(on, off)):
        lane = f"{what} lane {b}"
        n = _assert_same(x, y, f"{lane}: metrics on vs off", window=window)
        log(f"[metrics {what}] lane {b}: == metrics off ({n} fields); "
            f"{_obs_checks(x, lane)}")
    if on_m.counts != off_m.counts or on_m.launches != off_m.launches:
        raise AssertionError(
            f"{what}: metrics on moved (dispatches, host syncs, captures, "
            f"replays) {on_m.counts} and launches {on_m.launches}, metrics "
            f"off {off_m.counts} and {off_m.launches}")
    rate_on, rate_off = steps / on_m.wall, steps / off_m.wall
    log(f"[metrics {what}] counters == metrics off: (dispatches, host "
        f"syncs, captures, replays) {on_m.counts}, launches "
        f"{on_m.launches}; metrics on {on_m.wall:.3f} s, {rate_on:.1f} "
        f"rounds/s, {msgs / on_m.wall:.1f} msgs/s, capturing "
        f"{on_m.capture_s:.3f} s, peak {on_m.peak_mib:.1f} MiB; metrics "
        f"off {off_m.wall:.3f} s, {rate_off:.1f} rounds/s, capturing "
        f"{off_m.capture_s:.3f} s, peak {off_m.peak_mib:.1f} MiB; cost "
        f"{1 - rate_on / rate_off:.2%} of the rounds/s, "
        f"{on_m.peak_mib - off_m.peak_mib:+.2f} MiB; device inside graph "
        f"replays {on_m.graph_ms / 1e3:.3f} s on, "
        f"{off_m.graph_ms / 1e3:.3f} s off "
        f"({on_m.graph_ms / off_m.graph_ms - 1:+.2%})")


def selftest_on_card() -> None:
    """``python -m repro_torch.obs --selftest`` on the card, its
    artifacts in a temporary directory."""
    import tempfile

    from repro_torch.obs.__main__ import main as obs_main
    with tempfile.TemporaryDirectory() as out:
        rc = obs_main(["--selftest", "--out", out])
    if rc:
        raise AssertionError(f"repro_torch.obs --selftest exited {rc}")


def metrics_phase(dense_free, kept: dict, sweep_off) -> list:
    """Phase 5m: the selftest, then the full-width runs with
    ``collect_metrics`` on against their metrics-off runs (``dense_free``
    and ``kept`` hold (result, ``Measured``) of phases 5 and 5w,
    ``sweep_off`` (runs, ``Measured``) of 5s). Returns the launch
    counts."""
    from repro_torch.core import (FailureScenario, RSMConfig, SimConfig,
                                  run_picsou_batch)
    from repro_torch.obs.tracer import SpanTracer, tracing
    selftest_on_card()
    cfg = RSMConfig.bft(6)
    launches = [0, 0]

    def count(run_m):
        total, no_lost, _ = run_m.launches
        launches[0] += total - no_lost
        launches[1] += no_lost

    sim = SimConfig(n_msgs=M_LONG, steps=STEPS_LONG, window=4, phi=32,
                    window_slots="auto", chunk_steps=CHUNK, superchunk=8,
                    collect_metrics=True)
    plan_s = _plan_s(sim, [FailureScenario.none()])
    tracer = SpanTracer()
    with tracing(tracer):
        run, run_m = _full_run("metrics long K=8", sim,
                               FailureScenario.none(), plan_s)
    off, off_m = kept.pop("long")
    _on_against_off("long K=8", [run.result], run_m, [off], off_m,
                    STEPS_LONG, M_LONG)
    spans = {name: tracer.count(name) for name in sorted(set(
        tracer.names()))}
    log(f"[metrics long K=8] tracer spans {spans}; drain_overlap_ratio "
        f"{tracer.drain_overlap_ratio():.4f} (no_drains "
        f"{tracer.no_drains()}); drain_wait "
        f"{tracer.total_ns('drain_wait') / 1e9:.3f} s of "
        f"{tracer.total_ns('run') / 1e9:.3f} s in run")
    count(run_m)
    del run, off

    crash = FailureScenario.crash_fraction(19, 19, 0.3, seed=2)
    sim = SimConfig(n_msgs=CRASH_M, steps=STEPS_CRASH, window=4, phi=32,
                    window_slots="auto", chunk_steps=CHUNK,
                    collect_metrics=True)
    run, run_m = _full_run("metrics windowed crash 0.3", sim, crash)
    off, off_m = kept.pop("crash")
    _on_against_off("windowed crash 0.3", [run.result], run_m, [off],
                    off_m, STEPS_CRASH, CRASH_M)
    count(run_m)
    del run, off

    off_runs, off_m = sweep_off
    fails = [f for _, f in sweep_scenarios()]
    sim = SimConfig(n_msgs=SWEEP_M, steps=SWEEP_STEPS, window=4, phi=32,
                    window_slots="auto", chunk_steps=CHUNK, superchunk=8,
                    collect_metrics=True)
    run_m = Measured(lambda: run_picsou_batch(cfg, cfg, sim, fails),
                     _plan_s(sim, fails))
    runs = run_m.result
    _check_launches(runs[0].spec, "metrics sweep K=8")
    _check_dispatches(runs[0].spec, run_m.counts, "metrics sweep K=8",
                      runs[0].result.window_growth_events)
    _on_against_off("sweep K=8", [r.result for r in runs], run_m,
                    [r.result for r in off_runs], off_m, SWEEP_STEPS,
                    SWEEP_M * len(runs))
    count(run_m)
    del runs

    sim = SimConfig(n_msgs=SHAPE[2], steps=STEPS_FREE, window=4, phi=32,
                    collect_metrics=True)
    run, run_m = _full_run("metrics full failure-free", sim,
                           FailureScenario.none())
    off, off_m = dense_free
    _on_against_off("full failure-free", [run.result], run_m, [off], off_m,
                    STEPS_FREE, SHAPE[2], window=False)
    count(run_m)
    return launches


class DispatchWindow:
    """Marks dispatches ``first`` .. ``last`` (counted from 0) of one run:
    synchronises and stamps the host clock as dispatch ``first`` starts
    and as dispatch ``last`` starts (and starts / stops ``prof`` there),
    records each dispatch's first round, and inside the window the host
    time of each replay (``Programs.run``), each drain start and each
    drain wait, and how many replays were launched while an earlier
    drain was still unwaited (the launch-ahead path). Pick a window that
    holds replays only: a program is captured at its first dispatch."""

    def __init__(self, first: int, last: int, prof=None):
        self.first, self.last, self.prof = first, last, prof
        self.rounds = []
        self.stamps = {}
        self.host = {"replay": [], "drain start": [], "drain wait": []}
        self.undrained = 0
        self.ahead = 0

    def __enter__(self):
        from repro_torch.core import graphs, snapshot
        self._saved = (graphs.Programs.run, snapshot.PinnedDrain.start,
                       snapshot.PinnedDrain.wait)
        run, start, wait = self._saved

        def inside():
            return self.first in self.stamps and self.last not in \
                self.stamps

        def timed(name, fn):
            def wrapped(*args):
                self.undrained += {"drain start": 1,
                                   "drain wait": -1}.get(name, 0)
                if not inside():
                    return fn(*args)
                if name == "replay" and self.undrained:
                    self.ahead += 1
                t0 = time.perf_counter()
                out = fn(*args)
                self.host[name].append(time.perf_counter() - t0)
                return out
            return wrapped

        def marked(prog, key, body, t):
            n = len(self.rounds)
            self.rounds.append(t)
            if n in (self.first, self.last):
                torch.cuda.synchronize()
                self.stamps[n] = time.perf_counter()
                if self.prof is not None:
                    (self.prof.start if n == self.first
                     else self.prof.stop)()
            return timed("replay", run)(prog, key, body, t)

        graphs.Programs.run = marked
        snapshot.PinnedDrain.start = timed("drain start", start)
        snapshot.PinnedDrain.wait = timed("drain wait", wait)
        return self

    def __exit__(self, *exc):
        from repro_torch.core import graphs, snapshot
        (graphs.Programs.run, snapshot.PinnedDrain.start,
         snapshot.PinnedDrain.wait) = self._saved

    def window_rounds(self) -> int:
        return self.rounds[self.last] - self.rounds[self.first]

    def wall_per_round(self) -> float:
        return ((self.stamps[self.last] - self.stamps[self.first])
                / self.window_rounds())


def profile_window(label: str, spec, first: int, last: int,
                   run_round_ms: float, w: int = 0) -> tuple:
    """Where a graphed round's time goes: dispatches ``first`` ..
    ``last`` of a run of ``spec``, timed unprofiled, then under
    torch.profiler started and stopped at the same dispatches. Device busy
    share = kernel time per round over the unprofiled window's wall per
    round, and over that of the engine's full run (``run_round_ms``);
    the host µs of each replay, drain start and drain wait in the
    window; ``quack_scan``'s kernels' µs a round in the window (their
    inputs warm in the L2, as the round leaves them). Returns the
    window's kernels a round and kernel ms a round (0, 0 when the
    profiler saw no kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import run_simulation
    with DispatchWindow(first, last) as plain:
        run_simulation(spec)
    plain_ms = plain.wall_per_round() * 1e3
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with DispatchWindow(first, last, prof) as under:
        run_simulation(spec)
    rounds = under.window_rounds()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / rounds
    host = ", ".join(
        f"{name} {np.mean(v) * 1e6:.1f} us x {len(v)}"
        for name, v in plain.host.items() if v)
    log(f"[profile {label}] dispatches {first}-{last - 1}, rounds "
        f"{plain.rounds[first]}-{plain.rounds[last] - 1}, W="
        f"{w or spec.window_slots or spec.m}, K={spec.superchunk}: "
        f"{plain_ms:.4f} ms/round unprofiled ({1e3 / plain_ms:.1f} "
        f"rounds/s); host per call in the window: {host}; replays "
        f"launched ahead of an earlier drain: {plain.ahead} of "
        f"{len(plain.host['replay'])}")
    if busy_ms <= 0:
        log(f"[profile {label}] device time per round: not measured (the "
            f"profiler saw no kernels)")
        return 0.0, 0.0
    per_round = sum(e.count for e in kernels) / rounds
    log(f"[profile {label}] {busy_ms:.4f} ms/round of kernels on the "
        f"device, {per_round:.1f} kernels/round; {under.wall_per_round() * 1e3:.4f} ms/round under "
        f"the profiler; device busy {busy_ms / plain_ms:.1%} of the "
        f"unprofiled window, {busy_ms / run_round_ms:.1%} of the engine's "
        f"full run ({run_round_ms:.4f} ms/round)")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        log(f"[profile {label}]   {e.self_device_time_total / rounds:9.2f} "
            f"us/round {e.count / rounds:5.1f} launches/round  "
            f"{e.key[:90]}")
    for e in kernels:
        if "quack_scan" in e.key:
            log(f"[profile {label}] quack_scan in the round (L2 warm): "
                f"{e.self_device_time_total / rounds:.2f} us/round, "
                f"{e.count / rounds:.2f} launches/round, "
                f"{e.self_device_time_total / e.count:.2f} us/launch  "
                f"{e.key[:90]}")
    return per_round, busy_ms


def profile_phase(dense_round_ms: float, long_round_ms: float,
                  w_crash_ms: float) -> None:
    """Phase 6: the graphed dense round, the graphed windowed round at
    K = 8 and the windowed crash run past its dense migration, each over
    a window of replays; then the chunk-boundary cost."""
    from repro_torch.core import (FailureScenario, RSMConfig, SimConfig,
                                  build_spec, run_simulation)
    cfg = RSMConfig.bft(6)
    crash = FailureScenario.crash_fraction(19, 19, 0.3, seed=2)
    spec = build_spec(cfg, cfg, SimConfig(
        n_msgs=CRASH_M, steps=7 * 32 + 1, window=4, phi=32), crash)
    added = {"dense": [profile_window("dense", spec, 1, 7, dense_round_ms)]}
    spec = dataclasses.replace(spec, collect_metrics=True)
    added["dense"].append(profile_window("dense, metrics on", spec, 1, 7,
                                         dense_round_ms))
    spec = build_spec(cfg, cfg, SimConfig(
        n_msgs=SHAPE[2], steps=3 * 8 * CHUNK + 1, window=4, phi=32,
        window_slots="auto", chunk_steps=CHUNK, superchunk=8))
    added["windowed K=8"] = [profile_window("windowed K=8", spec, 1, 3,
                                            long_round_ms)]
    spec = dataclasses.replace(spec, collect_metrics=True)
    added["windowed K=8"].append(profile_window(
        "windowed K=8, metrics on", spec, 1, 3, long_round_ms))
    for label, ((k_off, ms_off), (k_on, ms_on)) in added.items():
        log(f"[profile {label}] the metrics fabric adds "
            f"{k_on - k_off:.1f} kernels and "
            f"{(ms_on - ms_off) * 1e3:.2f} us of kernel time a round "
            f"({k_off:.1f} -> {k_on:.1f} kernels, {ms_off:.4f} -> "
            f"{ms_on:.4f} ms)")
    # the launch-ahead bound holds only when the window covers two
    # spans' dispatches (2 x 8 x 32 rounds x 76 messages) above the
    # frontier the host saw before the last drain: at W = 65,536 (on a
    # stream of 131,072), not at 6,016
    spec = build_spec(cfg, cfg, SimConfig(
        n_msgs=SHAPE[2] * 2, steps=3 * 8 * CHUNK + 1, window=4, phi=32,
        window_slots=SHAPE[2], chunk_steps=CHUNK, superchunk=8))
    profile_window("windowed K=8, W=65536", spec, 1, 3, long_round_ms)

    def plan(steps):
        return build_spec(cfg, cfg, SimConfig(
            n_msgs=CRASH_M, steps=steps, window=4, phi=32,
            window_slots="auto", chunk_steps=CHUNK), crash)

    events = run_simulation(plan(1024)).window_growth_events
    migrated = [e.step for e in events if e.dense_migration]
    if not migrated:
        raise AssertionError("profile: the crash run did not migrate")
    # the run migrates at the boundary of the chunk whose last round the
    # event names, and captures its first span at W = M there; the window
    # is the two spans after that one
    t_mig = migrated[0] - CHUNK + 1
    spec = plan(t_mig + 4 * 8 * CHUNK + 1)
    with DispatchWindow(0, 0) as probe:
        run_simulation(spec)
    first = len(probe.rounds) - probe.rounds[::-1].index(t_mig)
    profile_window("windowed after migration", spec, first, first + 2,
                   w_crash_ms, w=spec.m)
    chunk_cost()


def chunk_cost(spans: int = 4) -> None:
    """The cost of a chunk boundary in the graphed engine: the
    failure-free link windowed at W = 6,016, K = 8, with 8, 16 and 32
    rounds a chunk; the wall per round over ``spans`` steady spans (a
    window of replays), and the slope of wall time over the number of
    chunk boundaries."""
    from repro_torch.core import RSMConfig, SimConfig, build_spec
    from repro_torch.core import run_simulation
    cfg = RSMConfig.bft(6)
    per_round = {}
    for c in (8, 16, 32):
        spec = build_spec(cfg, cfg, SimConfig(
            n_msgs=SHAPE[2], steps=(spans + 2) * 8 * c + 1, window=4,
            phi=32, window_slots=WIN_SHAPE[3], chunk_steps=c))
        with DispatchWindow(1, 1 + spans) as win:
            res = run_simulation(spec)
        if res.window_growth_events:
            raise AssertionError(f"chunk cost: the window grew at {c} "
                                 f"rounds a chunk")
        per_round[c] = win.wall_per_round()
    # wall/round = a + b / c: b is the cost of one chunk boundary
    b = (per_round[8] - per_round[32]) / (1 / 8 - 1 / 32)
    log(f"[profile chunks] K=8, W={WIN_SHAPE[3]}, {spans} steady spans: "
        + ", ".join(f"{c}-round chunks {v * 1e3:.4f} ms/round"
                    for c, v in per_round.items())
        + f"; a chunk boundary costs {b * 1e3:.3f} ms (slope from 32- to "
        f"8-round chunks), a round without it "
        f"{(per_round[32] - b / 32) * 1e3:.4f} ms")


# ------------------------------------------------------------ phase 8
def _same_topology(a, b, what: str, engine: bool = True) -> int:
    """Two topology runs link by link: every output, ``send_step``,
    ``delivery_latency``, the frontier and commit-floor trajectories; two
    engine runs also every round metric, dtype, the final width and the
    growth events (``_assert_same``). Returns the fields compared."""
    if list(a.links) != list(b.links):
        raise AssertionError(f"{what}: the runs have other links")
    n = 0
    for name in a.links:
        x, y = a[name], b[name]
        if not np.array_equal(x.commit_floors, y.commit_floors):
            raise AssertionError(f"{what} {name}: the commit floors differ")
        if engine:
            n += _assert_same(x.result, y.result, f"{what} {name}")
            continue
        for f in OUTPUT_FIELDS + ("gc_frontiers",):
            if not np.array_equal(getattr(x.result, f),
                                  getattr(y.result, f)):
                raise AssertionError(f"{what} {name}: the runs differ in "
                                     f"{f}")
            n += 1
    return n


def _session_launches(sessions):
    """The launch contract of topology sessions run chunk at a time: per
    session 2 x rounds + rotating chunks (one launch covers every
    link), and rounds + rotating chunks without the loss quorum."""
    total = no_lost = 0
    for res in sessions:
        steps, c = res.topology.sim.steps, res.topology.sim.chunk_steps
        rotating = -(-steps // c) - 1
        total += 2 * steps + rotating
        no_lost += steps + rotating
    return total, no_lost


def _check_topology_counts(sessions, moved, tracer, what: str) -> str:
    """A topology run's contract: one dispatch per chunk (a floor callback
    fuses nothing), each a graph replay and each drained once (host syncs
    = dispatches + the final flush + one per dense migration), one
    ``plan_floors`` span per chunk, and the launches of
    ``_session_launches`` with none discarded."""
    dispatches, syncs, captures, replays, total, no_lost, skipped = moved
    chunks = sum(-(-r.topology.sim.steps // r.topology.sim.chunk_steps)
                 for r in sessions)
    migrations = sum(
        sum(e.dense_migration for e in
            next(iter(r.links.values())).result.window_growth_events)
        for r in sessions)
    want_total, want_no_lost = _session_launches(sessions)
    spans = tracer.count("plan_floors")
    line = (f"{dispatches} dispatches ({replays} graph replays of "
            f"{captures} captured programs), {syncs} host syncs, {spans} "
            f"plan_floors spans for {chunks} chunks; quack_scan launches "
            f"{total} ({no_lost} without the loss quorum, {skipped} "
            f"discarded)")
    if (dispatches != chunks or replays != dispatches or spans != chunks
            or syncs != dispatches + len(sessions) + migrations
            or total != want_total or no_lost != want_no_lost or skipped):
        raise AssertionError(f"{what}: contract broken: {line}; expected "
                             f"{want_total} ({want_no_lost}) launches")
    return line


def topology_fixtures(sim):
    """Phase 8a's topologies on the path-size link: a pair with a
    Byzantine receiver, a fanout to three backups with a crashed-receiver
    and a Byzantine-receiver link, a four-cluster chain with a crashed-
    receiver middle link, and a chain whose first link is GC-stalled
    (``tests/test_topology.py``'s fault shapes)."""
    from repro_torch.core import FailureScenario, RSMConfig
    from repro_torch.topology import Topology
    cfg = RSMConfig.bft(1)
    byz = FailureScenario(byz_recv_drop=(True, False, False, False))
    crash = FailureScenario(crash_r=(2, 2, -1, -1))
    stall = FailureScenario(byz_bcast_partial=(True, False, False, False),
                            bcast_limit=2)
    return {
        "pair, Byzantine receiver": Topology.pair(
            "a", "b", cfg, sim, failures_ab=byz),
        "fanout to three backups": Topology.fanout(
            "p", ["b0", "b1", "b2"], cfg, sim,
            failures={"b1": crash, "b2": byz}),
        "chain a-b-c-d, crashed middle link": Topology.chain(
            ["a", "b", "c", "d"], cfg, sim, failures={"b->c": crash}),
        "chain a-b-c, GC-stalled first link": Topology.chain(
            ["a", "b", "c"], cfg, sim, failures={"a->b": stall}),
    }


def _traced(fn):
    """(``fn()``, counters moved, its ``SpanTracer``)."""
    from repro_torch.obs.tracer import SpanTracer, tracing
    tracer = SpanTracer()
    torch.cuda.synchronize()
    before = _counters()
    with tracing(tracer):
        out = fn()
    torch.cuda.synchronize()
    return out, tuple(a - b for a, b in zip(_counters(), before)), tracer


def _topology_path(name: str, base) -> None:
    """One phase-8a fixture at K = 1 and 8, metrics off and on, on CUDA
    and on the CPU, against the numpy mirror."""
    from repro_torch.topology import run_topology, run_topology_reference
    ref = run_topology_reference(base)
    runs = {}
    for k in (1, 8):
        for collect in (False, True):
            topo = dataclasses.replace(base, sim=dataclasses.replace(
                base.sim, superchunk=k, collect_metrics=collect))
            what = f"topology {name} K={k} metrics {collect}"
            traces = _traces()
            gpu, moved, tracer = _traced(lambda: run_topology(topo))
            _captures_are_traces(what, moved, _traces() - traces)
            line = _check_topology_counts([gpu], moved, tracer, what)
            cpu = run_topology(topo, device="cpu")
            n = _same_topology(gpu, cpu, f"{what} cuda vs cpu")
            _same_topology(gpu, ref, f"{what} vs the numpy mirror",
                           engine=False)
            if collect:
                for lname, lr in gpu.links.items():
                    _same_obs(lr.result.obs, cpu[lname].result.obs,
                              f"{what} {lname} cuda vs cpu")
                    _obs_checks(lr.result, f"{what} {lname}")
            runs[(k, collect)] = (gpu, moved)
    # a floor callback runs K = 1 programs whatever the superchunk, which
    # is not part of a program set's layout: the K = 8 runs find their
    # programs captured by the K = 1 runs; metrics on are their own sets
    first, moved = runs[(1, False)]
    for key, (res, m) in runs.items():
        _same_topology(res, first, f"topology {name} {key} vs K=1 off")
        if m[:2] + m[3:] != moved[:2] + moved[3:] or (
                key[0] == 8 and m[2]):
            raise AssertionError(f"topology {name} {key}: counters {m}, "
                                 f"K=1 metrics off {moved}")
    res0 = next(iter(first.links.values())).result
    log(f"[topology path] {name}: {len(first.links)} links, cuda == cpu "
        f"({n} fields) == numpy mirror, K=1 == K=8, metrics on == off "
        f"(each link's histogram == its latency array's), same counters "
        f"but the captures (captures == traces; K=8 runs: 0); "
        f"{line}; delivered prefixes {first.delivered_prefixes()}, "
        f"floors of the last link "
        f"{first[base.link_names[-1]].commit_floors[:6].tolist()}..., "
        f"final W {res0.final_window_slots}, growth {growth(res0)}")


def _floor_in_place() -> None:
    """The captured chunk programs read the commit floor from a tensor the
    loop rewrites in place: a floor held at 0 for three chunks and opened
    to M before the fourth makes the same captured program dispatch."""
    from repro_torch.core import RSMConfig, SimConfig, build_spec, graphs
    from repro_torch.core.simulator import _run_windowed_batch
    cfg = RSMConfig.bft(1)
    spec = build_spec(cfg, cfg, SimConfig(n_msgs=256, steps=80,
                                          window_slots=256, chunk_steps=8))
    opens = 24

    def floors(t, bases):
        return np.full(1, 0 if t < opens else spec.m, dtype=np.int64)

    graphs.clear_programs()          # cold: the run captures its two
    before = (graphs.capture_count(), graphs.replay_count())
    gpu = _run_windowed_batch([spec], torch.device("cuda"), floors)[0]
    captures, replays = (a - b for a, b in zip(
        (graphs.capture_count(), graphs.replay_count()), before))
    cpu = _run_windowed_batch([spec], torch.device("cpu"), floors)[0]
    _assert_same(gpu, cpu, "floor in place cuda vs cpu")
    cross = gpu.metrics.cross_msgs
    ostep = np.asarray(spec.orig_step)
    want = np.where(ostep < spec.steps, np.maximum(ostep, opens), -1)
    if (captures != 2 or replays != spec.steps // 8
            or cross[:opens].sum() or not cross[opens:opens + 8].sum()
            or not np.array_equal(gpu.send_step, want)
            or not (gpu.deliver_time >= 0).all()):
        raise AssertionError(
            f"floor in place: {captures} captures, {replays} replays, "
            f"{int(cross[:opens].sum())} copies before round {opens}, "
            f"{int(cross[opens:opens + 8].sum())} in the chunk after")
    log(f"[topology path] a floor written in place between two replays of "
        f"one captured program: {captures} programs captured, {replays} "
        f"replays; 0 copies crossed before round {opens}, "
        f"{int(cross[opens:opens + 8].sum())} in the next chunk; send_step "
        f"== max(schedule round, {opens}); == the CPU run")


# the JAX tests' application fixtures (tests/test_apps.py), rebuilt here:
# the script imports nothing of the JAX package
def _app_fixtures():
    from repro_torch.core import FailureScenario, SimConfig
    laggy = FailureScenario(crash_r=(2, 2, -1, -1))
    byz = FailureScenario(byz_recv_drop=(True, False, False, False))
    dr_sim = SimConfig(n_msgs=32, steps=80, window=1, phi=6,
                       window_slots=24, chunk_steps=4)
    dr = [("clean_no_crash", None, {}),
          ("crash_late", 10, {"backup-1": laggy}),
          ("crash_early_truncates", 3, {"backup-1": laggy}),
          ("three_backups", 6, {"backup-1": laggy, "backup-2": byz})]

    def two_way():
        return {"a": {k: (k * 10, 1) for k in range(12)} | {50: (7, 5)},
                "b": {k: (k * 10, 1) for k in range(6)} | {50: (1, 1),
                                                           60: (9, 2)}}

    def three_way():
        return {"a": {k: (k, 2) for k in range(8)},
                "b": {k: (k + 1, 1) for k in range(8)} | {20: (4, 4)},
                "c": {30: (5, 1)}}

    rsim = SimConfig(n_msgs=16, steps=60, window=1, phi=6, window_slots=16,
                     chunk_steps=4)
    recon = [("two_way", two_way, rsim, {}),
             ("three_way", three_way, rsim, {}),
             ("two_way_byz_link", two_way, rsim, {"a->b": byz}),
             ("three_way_small_stream", three_way, dataclasses.replace(
                 rsim, n_msgs=4, steps=40, window_slots=4), {})]
    return dr_sim, dr, recon


def _apps_path() -> None:
    """Both applications on the JAX tests' fixtures: CUDA == CPU ==
    ``use_reference=True`` in every report field and every link."""
    from repro_torch.apps import run_disaster_recovery, run_reconciliation
    from repro_torch.core import RSMConfig
    cfg = RSMConfig.bft(1)
    dr_sim, dr, recon = _app_fixtures()
    for name, crash_at, fails in dr:
        kw = dict(backups=sorted({"backup-0", "backup-1"} | set(fails)),
                  crash_at=crash_at, backup_failures=fails)
        gpu = run_disaster_recovery(cfg, cfg, dr_sim, **kw)
        cpu = run_disaster_recovery(cfg, cfg, dr_sim, device="cpu", **kw)
        ref = run_disaster_recovery(cfg, cfg, dr_sim, use_reference=True,
                                    **kw)
        for other, label in ((cpu, "cpu"), (ref, "numpy mirror")):
            if (gpu.elected != other.elected
                    or gpu.phase1_prefixes != other.phase1_prefixes
                    or gpu.final_prefixes != other.final_prefixes
                    or gpu.converged != other.converged
                    or not np.array_equal(gpu.recovered_log,
                                          other.recovered_log)):
                raise AssertionError(f"disaster recovery {name}: cuda != "
                                     f"{label}")
            for p in ("phase1", "phase2"):
                a, b = getattr(gpu, p), getattr(other, p)
                if (a is None) != (b is None):
                    raise AssertionError(f"disaster recovery {name} {p}")
                if a is not None:
                    _same_topology(a, b, f"disaster recovery {name} {p} "
                                   f"vs {label}", engine=label == "cpu")
        if not gpu.converged:
            raise AssertionError(f"disaster recovery {name}: not converged")
        log(f"[apps path] disaster recovery {name}: cuda == cpu == numpy "
            f"mirror; elected {gpu.elected}, phase-1 prefixes "
            f"{gpu.phase1_prefixes}, recovered {gpu.recovered_entries}, "
            f"converged")
    for name, mk, sim, fails in recon:
        reps = [run_reconciliation(cfg, mk(), sim, failures=fails),
                run_reconciliation(cfg, mk(), sim, failures=fails,
                                   device="cpu"),
                run_reconciliation(cfg, mk(), sim, failures=fails,
                                   use_reference=True)]
        gpu = reps[0]
        for other, label in zip(reps[1:], ("cpu", "numpy mirror")):
            if (gpu.rounds != other.rounds or gpu.stores != other.stores
                    or gpu.exchanged != other.exchanged
                    or gpu.converged != other.converged
                    or len(gpu.sessions) != len(other.sessions)):
                raise AssertionError(f"reconciliation {name}: cuda != "
                                     f"{label}")
            for a, b in zip(gpu.sessions, other.sessions):
                _same_topology(a, b, f"reconciliation {name} vs {label}",
                               engine=label == "cpu")
        if not gpu.converged:
            raise AssertionError(f"reconciliation {name}: not converged")
        log(f"[apps path] reconciliation {name}: cuda == cpu == numpy "
            f"mirror; {gpu.rounds} rounds, {gpu.exchanged} entries "
            f"exchanged, converged")


def topology_path_phase() -> None:
    """Phase 8a at the path size (BFT f = 1, M = 1,024, W = 256)."""
    from repro_torch.core import SimConfig
    from repro_torch.obs.report import run_reported_topology
    for name, topo in topology_fixtures(SimConfig(**TOPO_SIM)).items():
        _topology_path(name, topo)
    topo = topology_fixtures(SimConfig(**TOPO_SIM))[
        "chain a-b-c-d, crashed middle link"]
    _, report = run_reported_topology(topo)
    names = {e["name"] for e in report.chrome_trace["traceEvents"]}
    problems = report.validate()
    if not {"run_topology", "plan_floors", "run"} <= names or problems:
        raise AssertionError(f"run_reported_topology: spans {names}, "
                             f"problems {problems}")
    log(f"[topology path] run_reported_topology on the chain: lanes "
        f"{report.lane_names}, spans {sorted(names)}, the report validates;"
        f" meta {report.meta}")
    _floor_in_place()
    _apps_path()


def _measured_line(run_m, rounds: int, msgs: int, tracer) -> str:
    """``Measured.line`` with the engine's counters and the
    ``plan_floors`` spans."""
    dispatches, syncs, captures, replays = run_m.counts
    return (run_m.line(rounds, msgs)
            + f"; {dispatches} dispatches, {syncs} host syncs, {captures} "
            f"captures; {tracer.count('plan_floors')} plan_floors spans, "
            f"{tracer.total_ns('plan_floors') / 1e9:.4f} s on the host")


def _measured_traced(fn, plan_s: float = 0.0):
    """``Measured`` of ``fn`` under a ``SpanTracer``; (Measured, tracer)."""
    from repro_torch.obs.tracer import SpanTracer, tracing
    tracer = SpanTracer()

    def run():
        with tracing(tracer):
            return fn()
    return Measured(run, plan_s), tracer


def _count_launches(launches, run_m, sessions, what: str) -> None:
    """Check a measured run's launches against ``_session_launches`` and
    add them to the main path's counts."""
    total, no_lost, skipped = run_m.launches
    want = _session_launches(sessions)
    if (total, no_lost) != want or skipped:
        raise AssertionError(f"{what}: launches {(total, no_lost)}, "
                             f"expected {want}")
    launches[0] += total - no_lost
    launches[1] += no_lost


def _chain_full(cfg, launches) -> None:
    """Phase 8b: the four-cluster chain at full width."""
    from repro_torch.core import SimConfig, run_picsou
    from repro_torch.core.simulator import _run_windowed_batch
    from repro_torch.topology import Topology, link_specs, run_topology
    from repro_torch.topology.engine import FloorPlanner, _floor_plan
    sim = SimConfig(n_msgs=SWEEP_M, steps=CHAIN_STEPS, window=4, phi=32,
                    window_slots="auto", chunk_steps=CHUNK)
    topo = Topology.chain(["a", "b", "c", "d"], cfg, sim)
    t0 = time.perf_counter()
    specs = link_specs(topo)
    plan_s = time.perf_counter() - t0
    run_m, tracer = _measured_traced(lambda: run_topology(topo), plan_s)
    res = run_m.result
    _count_launches(launches, run_m, [res], "chain")
    _check_topology_counts([res], run_m.counts + run_m.launches, tracer,
                           "chain")
    done, lags = [], []
    for i, name in enumerate(topo.link_names):
        lr = res[name]
        r = lr.result
        if not ((r.deliver_time >= 0).all() and (r.quack_time >= 0).all()):
            raise AssertionError(f"chain {name}: not all delivered and "
                                 f"quacked in {CHAIN_STEPS} rounds")
        done.append(r.completion_step())
        if i:
            up = res[topo.link_names[i - 1]]
            if not np.array_equal(lr.commit_floors, up.result.gc_frontiers[
                    :len(lr.commit_floors)]):
                raise AssertionError(f"chain {name}: its floors are not "
                                     f"its upstream's frontiers")
            # no message goes out before the chunk at which its upstream
            # had retired it
            opened = np.searchsorted(lr.commit_floors, np.arange(SWEEP_M),
                                     side="right")
            sent = r.send_step >= 0
            if (r.send_step[sent] < opened[sent] * CHUNK).any():
                raise AssertionError(f"chain {name}: a message was sent "
                                     f"before its upstream retired it")
            lags.append(done[i] - done[i - 1])
    log(f"[chain] BFT f=6 <-> f=6, four clusters, three links, M={SWEEP_M},"
        f" steps={CHAIN_STEPS}, W={specs[0].window_slots}: "
        + _measured_line(run_m, CHAIN_STEPS, SWEEP_M * len(specs), tracer)
        + f" (planning, {plan_s:.3f} s, taken off); completion rounds "
        f"{done}, lag per hop {lags} rounds; every link all delivered and "
        f"quacked; floors == upstream frontiers; nothing sent before its "
        f"upstream retired it; growth "
        f"{growth(res[topo.link_names[0]].result)}")
    if done[-1] + 1 != CHAIN_STEPS:
        log(f"[chain] note: the last hop completes at round {done[-1]}; "
            f"the smallest steps would be {done[-1] + 1}")
    first = res[topo.link_names[0]].result
    floors_last = res[topo.link_names[-1]].commit_floors
    # the floor boundary's cost: the engine loop alone on the same link
    # specs at K = 1 (planned once, outside the timing), chained and
    # unchained, in turns
    dev = torch.device("cuda")
    k1 = [dataclasses.replace(s, superchunk=1) for s in specs]
    loops = {"chained": [], "plain": []}
    for kind in ("chained", "plain", "plain", "chained"):
        planner = (FloorPlanner(_floor_plan(topo), len(k1), SWEEP_M)
                   if kind == "chained" else None)
        m = Measured(lambda: _run_windowed_batch(k1, dev, planner))
        for i, name in enumerate(topo.link_names):
            if kind == "chained" or i == 0:
                _assert_same(m.result[i], res[name].result,
                             f"chain loop {kind} {name}")
        m.result = None
        loops[kind].append(m)
        log(f"[chain] the engine loop, {kind}, run {len(loops[kind])}: "
            + m.line(CHAIN_STEPS, SWEEP_M * len(k1))
            + f"; dispatches {m.counts[0]}, host syncs {m.counts[1]}")
    del res
    chunks = -(-CHAIN_STEPS // CHUNK)
    wall = {k: sum(m.wall for m in v) / 2 for k, v in loops.items()}
    busy = {k: sum(m.graph_ms for m in v) / 2e3 for k, v in loops.items()}
    log(f"[chain] the floor boundary (drain, callback, in-place copy, "
        f"send_step update), chained against plain loops at K=1, mean of "
        f"two runs each: wall {wall['chained']:.3f} s against "
        f"{wall['plain']:.3f} s, "
        f"{(wall['chained'] - wall['plain']) / chunks * 1e3:.3f} ms a chunk"
        f" ({(wall['chained'] - wall['plain']) / CHAIN_STEPS * 1e3:.4f} ms"
        f" a round, {wall['chained'] / wall['plain'] - 1:+.2%}); device "
        f"time inside replays {busy['chained']:.3f} s against "
        f"{busy['plain']:.3f} s")
    single = run_picsou(cfg, cfg, dataclasses.replace(sim, superchunk=1))
    n = _assert_same(first, single.result, "chain first link vs run_picsou",
                     window=single.spec.window_slots > 0
                     and first.window_growth_events
                     == single.result.window_growth_events)
    log(f"[chain] the unchained first link == run_picsou of the same link "
        f"({n} fields); the last link's floors start "
        f"{floors_last[:4].tolist()}")


def _dr_full(cfg, launches) -> None:
    """Phase 8b: disaster recovery at full width."""
    from repro_torch.apps import run_disaster_recovery
    from repro_torch.apps.disaster_recovery import _with_primary_crash
    from repro_torch.core import (FailureScenario, SimConfig,
                                  run_picsou_batch)
    sim = SimConfig(n_msgs=SWEEP_M, steps=SWEEP_STEPS, window=4, phi=32,
                    window_slots="auto", chunk_steps=CHUNK)
    backups = ["backup-0", "backup-1", "backup-2"]
    fails = {"backup-1": FailureScenario(crash_r=(DR_LAG_AT,) * 7
                                         + (-1,) * 12),
             "backup-2": FailureScenario(byz_recv_drop=(True,) * 6
                                         + (False,) * 13)}
    plan_s = _plan_s(sim, [FailureScenario.none()] * 3)
    run_m, tracer = _measured_traced(lambda: run_disaster_recovery(
        cfg, cfg, sim, backups=backups, crash_at=DR_CRASH,
        backup_failures=fails), plan_s)
    rep = run_m.result
    sessions = [rep.phase1] + ([rep.phase2] if rep.phase2 else [])
    _count_launches(launches, run_m, sessions, "disaster recovery")
    _check_topology_counts(sessions, run_m.counts + run_m.launches, tracer,
                           "disaster recovery")
    rounds = sum(r.topology.sim.steps for r in sessions)
    msgs = sum(r.topology.sim.n_msgs * len(r.links) for r in sessions)
    if not rep.converged or rep.phase1_prefixes[rep.elected] != max(
            rep.phase1_prefixes.values()):
        raise AssertionError(f"disaster recovery: elected {rep.elected}, "
                             f"prefixes {rep.phase1_prefixes}, converged "
                             f"{rep.converged}")
    p1 = rep.phase1[f"primary->{backups[0]}"].result
    log(f"[disaster recovery] primary -> {len(backups)} backups, BFT f=6, "
        f"M={SWEEP_M}, {SWEEP_STEPS} rounds, the primary crashes at round "
        f"{DR_CRASH}, backup-1 loses 7 receivers at round {DR_LAG_AT}, "
        f"backup-2's receivers 0-5 drop: "
        + _measured_line(run_m, rounds, msgs, tracer)
        + f" (both phases, {rounds} rounds; planning of phase 1, "
        f"{plan_s:.3f} s, taken off); elected {rep.elected}, phase-1 "
        f"prefixes {rep.phase1_prefixes}, final {rep.final_prefixes}, "
        f"recovered {rep.recovered_entries}, converged; phase 1 growth "
        f"{growth(p1)}, phase 2 "
        + (f"{rep.phase2.topology.sim.steps} rounds over "
           f"{rep.phase2.topology.sim.n_msgs} messages, growth "
           f"{growth(next(iter(rep.phase2.links.values())).result)}"
           if rep.phase2 else "not needed"))
    scen = [_with_primary_crash(fails.get(b, FailureScenario.none()),
                                cfg.n, DR_CRASH) for b in backups]
    batch = run_picsou_batch(cfg, cfg, dataclasses.replace(
        sim, superchunk=1), scen)
    n = 0
    for b, run in zip(backups, batch):
        n += _assert_same(rep.phase1[f"primary->{b}"].result, run.result,
                          f"disaster recovery phase 1 {b} vs "
                          f"run_picsou_batch",
                          window=run.spec.window_slots > 0)
    log(f"[disaster recovery] phase 1 == run_picsou_batch of the three link"
        f" scenarios bit for bit ({n} fields)")


def recon_stores(n: int):
    """``tests/test_apps.py``'s three-way divergence at n keys a store:
    a holds keys [0, n) at version 2; b the lower half of them at
    version 1 and n / 2 keys of its own at version 4; c n keys of its
    own."""
    half = n // 2
    return {"a": {k: (k, 2) for k in range(n)},
            "b": ({k: (k + 1, 1) for k in range(half)}
                  | {n + k: (4, 4) for k in range(half)}),
            "c": {2 * n + k: (5, 1) for k in range(n)}}


def _recon_full(cfg, launches) -> None:
    """Phase 8b: reconciliation of three f = 6 clusters at full width."""
    from repro_torch.apps import lww_merge, run_reconciliation
    from repro_torch.core import FailureScenario, SimConfig
    sim = SimConfig(n_msgs=RECON_M, steps=RECON_STEPS, window=4, phi=32,
                    window_slots="auto", chunk_steps=CHUNK)
    stores = recon_stores(RECON_M)
    expect: dict = {}
    for s in stores.values():
        lww_merge(expect, [(k, v, ver) for k, (v, ver) in s.items()])
    fails = {"a->b": FailureScenario(byz_recv_drop=(True,) + (False,) * 18)}
    run_m, tracer = _measured_traced(lambda: run_reconciliation(
        cfg, stores, sim, failures=fails))
    rep = run_m.result
    _count_launches(launches, run_m, rep.sessions, "reconciliation")
    _check_topology_counts(rep.sessions, run_m.counts + run_m.launches,
                           tracer, "reconciliation")
    if not rep.converged or any(s != expect for s in rep.stores.values()):
        same = [s == expect for s in rep.stores.values()]
        raise AssertionError(f"reconciliation: converged {rep.converged}, "
                             f"stores equal to the LWW union {same}")
    rounds = sum(r.topology.sim.steps for r in rep.sessions)
    log(f"[reconciliation] three BFT f=6 clusters, six links, stores of "
        f"{RECON_M} keys, M={RECON_M}, {RECON_STEPS} rounds a session, "
        f"receiver 0 of a->b drops: "
        + _measured_line(run_m, rounds, RECON_M * 6 * len(rep.sessions),
                         tracer)
        + f" (planning inside); {rep.rounds} reconciliation rounds, "
        f"{rep.exchanged} entries exchanged, every store == the LWW union "
        f"({len(expect)} keys) computed on the host")


def topology_full_phase() -> list:
    """Phase 8b at full width; returns the main path's launch counts."""
    from repro_torch.core import RSMConfig
    cfg = RSMConfig.bft(6)
    launches = [0, 0]
    for part in (_chain_full, _dr_full, _recon_full):
        t0 = time.perf_counter()
        part(cfg, launches)
        gc.collect()
        log(f"[time] {part.__name__[1:]} {time.perf_counter() - t0:.1f} s")
    return launches


# ------------------------------------------------------------ phase 9
# phase 9a: the path-size link of phase 4 (BFT f = 1, M = 1,024, W = 256,
# 16-round chunks); the adversary sweep runs ADV_STEPS rounds (the numpy
# oracle's cost grows with them); phase 9b: phase 5s's lane 0 at full
# width, recorded every REPLAY_EVERY chunks
REPLAY_SIM = dict(n_msgs=1024, steps=120, window_slots=256, chunk_steps=16)
ADV_STEPS = 120
REPLAY_EVERY = 8
RESULT_FIELDS = ("quack_time", "deliver_time", "retry", "recv_has")


def _counted(fn, launches, expect=None, what: str = ""):
    """``fn()`` with ``quack_scan``'s counters at 0 just before it; its
    launches are added to ``launches`` (the main path's) and, given
    ``expect`` (total, without the loss quorum), must equal it with none
    discarded. Returns (result, (captures, replays), launches)."""
    from repro_torch.core import graphs
    torch.cuda.synchronize()
    _reset_launches()
    before = (graphs.capture_count(), graphs.replay_count())
    out = fn()
    torch.cuda.synchronize()
    total, no_lost, skipped = _launches()
    launches[0] += total - no_lost
    launches[1] += no_lost
    if expect is not None and ((total, no_lost) != expect or skipped):
        raise AssertionError(f"{what}: launches {(total, no_lost)} "
                             f"({skipped} discarded), expected {expect}")
    moved = tuple(a - b for a, b in zip(
        (graphs.capture_count(), graphs.replay_count()), before))
    return out, moved, (total, no_lost)


def _from(spec, t: int, lanes_runs: int = 1):
    """The launch contract of ``lanes_runs`` windowed runs of ``spec``
    from chunk boundary ``t``: two launches a round (one without the loss
    quorum) and one more without it per rotating chunk, whatever the
    lanes."""
    rounds = spec.steps - t
    rotating = -(-rounds // spec.chunk_steps) - 1
    return (lanes_runs * (2 * rounds + rotating),
            lanes_runs * (rounds + rotating))


def _same_results(a, b, what: str, frontiers: bool = True) -> int:
    """What the replay contract holds equal: the outputs, every round
    metric and (``frontiers``) the frontier trajectory, final width and
    growth events. (``send_step`` is not part of it: from the round-0
    checkpoint the JAX package's resume, and so the port's, reports
    none; ROADMAP.md queue 3.)"""
    n = 0
    for f in RESULT_FIELDS + (("gc_frontiers",) if frontiers else ()):
        x, y = getattr(a, f), getattr(b, f)
        if x.dtype != y.dtype or not np.array_equal(x, y):
            raise AssertionError(f"{what}: the runs differ in {f}")
        n += 1
    for f in a.metrics._fields:
        if not np.array_equal(getattr(a.metrics, f),
                              getattr(b.metrics, f)):
            raise AssertionError(f"{what}: the runs differ in metric {f}")
        n += 1
    if frontiers and (a.final_window_slots != b.final_window_slots
                      or a.window_growth_events != b.window_growth_events):
        raise AssertionError(f"{what}: the runs differ in their window")
    return n


def _same_as_oracle(res, ref, what: str, frontiers: bool = True) -> None:
    """An engine result against the port's numpy oracle (``RefResult``):
    every output, the wire metrics and the frontier trajectory."""
    for f in RESULT_FIELDS:
        if not np.array_equal(getattr(res, f), getattr(ref, f)):
            raise AssertionError(f"{what}: differs from the oracle in {f}")
    for f in ("cross_msgs", "intra_msgs", "resends"):
        if not np.array_equal(getattr(res.metrics, f), getattr(ref, f)):
            raise AssertionError(f"{what}: differs from the oracle in "
                                 f"metric {f}")
    if frontiers and not np.array_equal(res.gc_frontiers, ref.gc_frontiers):
        raise AssertionError(f"{what}: differs from the oracle in its "
                             f"frontiers")


def _replay_link(launches) -> None:
    """9a, one link: record the path phase's growing windowed link on
    CUDA and on the CPU (the checkpoints field by field, the stakes bit
    for bit), replay from every checkpoint (across the growth and the
    dense migration) with no capture, and injected replays (a crash, a
    heal, a drop schedule) against the oracle and the from-scratch run
    of the merged schedule."""
    from repro_torch.core import (FailureScenario, RSMConfig, SimConfig,
                                  build_spec, graphs)
    from repro_torch.core.simulator import _run_windowed_batch
    from repro_torch.replay import (Injection, record_simulation, replay,
                                    replay_oracle)
    from repro_torch.replay.replay import (_normalize_injections,
                                           build_fail_schedule)
    cfg = RSMConfig.bft(1)
    sim = SimConfig(**REPLAY_SIM)
    dev = torch.device("cuda")
    grows = FailureScenario(crash_s=(2, -1, -1, -1),
                            byz_recv_drop=(False, False, True, False))
    spec = build_spec(cfg, cfg, sim, grows)
    graphs.clear_programs()
    (res, trace), moved, _ = _counted(lambda: record_simulation(spec),
                                      launches, _from(spec, 0), "record")
    cres, ctrace = record_simulation(spec, device="cpu")
    _assert_same(res, cres, "recorded cuda vs cpu")
    for c, cc in zip(trace.checkpoints, ctrace.checkpoints):
        for part in ("state", "fails"):
            for f, x in getattr(c, part)._asdict().items():
                y = getattr(getattr(cc, part), f)
                if x.dtype != y.dtype or not np.array_equal(x, y):
                    raise AssertionError(f"checkpoint {c.t}: {part}.{f} "
                                         f"cuda != cpu")
    widths = sorted({int(c.window_slots) for c in trace.checkpoints})
    if len(widths) < 3 or not res.window_growth_events[-1].dense_migration:
        raise AssertionError(f"9a: the link should grow and migrate; "
                             f"checkpoint widths {widths}")
    _same_as_oracle(res, replay_oracle(trace), "recorded link")
    captures = graphs.capture_count()
    for t in trace.boundaries().tolist():
        rr, _, _ = _counted(lambda: replay(trace, t), launches,
                            _from(spec, t), f"replay from {t}")
        _same_results(rr[0], res, f"replay from {t}")
        _assert_same(rr[0], replay(ctrace, t, device="cpu")[0],
                     f"replay from {t} cuda vs cpu")
    if graphs.capture_count() != captures:
        raise AssertionError("9a: a replay captured a program")
    log(f"[replay path] link M={spec.m}, W={spec.window_slots}, "
        f"{spec.chunk_steps}-round chunks: recorded on cuda == cpu "
        f"(every checkpoint's state and inputs bit for bit), == the numpy "
        f"oracle; {moved[0]} programs captured; {len(trace.checkpoints)} "
        f"checkpoints at widths {widths}; the replay from each == the "
        f"original (across growth {growth(res)}), == its cpu replay, 0 "
        f"captures")

    free = build_spec(cfg, cfg, sim)
    part = build_spec(cfg, cfg, sim, FailureScenario(
        byz_recv_drop=(True, False, False, False)))
    drops = FailureScenario(drop_pair=tuple(
        tuple(l == 1 and j in (0, 2) for j in range(4)) for l in range(4)))
    cases = [("crash", free, [Injection(32, FailureScenario(
                 crash_s=(-1, 32, -1, -1)))]),
             ("heal", part, [Injection(32, FailureScenario.none())]),
             ("drop schedule", free, [Injection(32, drops),
                                      Injection(96, FailureScenario.none())])]
    for name, base, inj in cases:
        (orig, tr), _, _ = _counted(lambda: record_simulation(base),
                                    launches, _from(base, 0))
        (ri,), _, _ = _counted(lambda: replay(tr, 32, inj), launches,
                               _from(base, 32), f"injected {name}")
        _same_as_oracle(ri, replay_oracle(tr, inj), f"injected {name}")
        schedule, _ = build_fail_schedule(tr, _normalize_injections(tr, inj))
        scratch, _, _ = _counted(lambda: _run_windowed_batch(
            [base], dev, fail_schedule=schedule), launches, _from(base, 0))
        _assert_same(ri, scratch[0], f"injected {name} vs from scratch")
        _assert_same(ri, replay(tr, 32, inj, device="cpu")[0],
                     f"injected {name} cuda vs cpu")
        if all(np.array_equal(getattr(ri, f), getattr(orig, f))
               for f in RESULT_FIELDS):
            raise AssertionError(f"injected {name}: changed nothing")
        log(f"[replay path] injected {name} at round 32: == the numpy "
            f"oracle of the merged schedule, == the from-scratch run with "
            f"that fail_schedule, == cpu; resends "
            f"{orig.total_resends()} -> {ri.total_resends()}, delivery "
            f"round {orig.delivery_step()} -> {ri.delivery_step()}")


def _replay_topology_and_forks(launches) -> None:
    """9a: a chain recorded and replayed with an injection against the
    topology oracle; three forks, each == its own replay; a trace saved,
    loaded and resumed; reconfigurations replayed bit for bit."""
    import tempfile

    from repro_torch.adversary import (join_receiver, remove_receiver,
                                       stale_ackers)
    from repro_torch.core import (FailureScenario, RSMConfig, SimConfig,
                                  build_spec)
    from repro_torch.core.simulator import spec_with_quorum
    from repro_torch.replay import (ForkSpec, Injection, RunTrace,
                                    fork_whatif, record_simulation,
                                    record_topology, replay,
                                    replay_topology, replay_topology_oracle)
    from repro_torch.topology import Topology
    cfg = RSMConfig.bft(1)
    sim = SimConfig(**REPLAY_SIM)
    topo = Topology.chain(["a", "b", "c"], cfg, SimConfig(**TOPO_SIM))
    (r0, trace), _, _ = _counted(lambda: record_topology(topo), launches)
    inj = {"a->b": [Injection(48, FailureScenario(crash_s=(48,) * 4))]}
    ri, _, _ = _counted(lambda: replay_topology(trace, 48, inj), launches)
    ref = replay_topology_oracle(trace, inj)
    _same_topology(ri, ref, "chain injected replay vs oracle", engine=False)
    _same_topology(ri, replay_topology(trace, 48, inj, device="cpu"),
                   "chain injected replay cuda vs cpu")
    rr = replay_topology(trace, 48)
    _same_topology(rr, r0, "chain unchanged replay vs original")
    if ri["b->c"].delivered_prefix() >= r0["b->c"].delivered_prefix():
        raise AssertionError("chain: the upstream crash cut nothing")
    log(f"[replay path] chain a-b-c: replay with the upstream link's "
        f"senders crashed at 48 == replay_topology_oracle == cpu (floors "
        f"included); delivered prefix of b->c {r0['b->c'].delivered_prefix()}"
        f" -> {ri['b->c'].delivered_prefix()}; unchanged replay == original")

    free = build_spec(cfg, cfg, sim)
    (res, tr), _, _ = _counted(lambda: record_simulation(free), launches)
    forks = [ForkSpec("baseline"),
             ForkSpec("crash", [Injection(32, FailureScenario(
                 crash_s=(-1, 32, -1, -1)))]),
             ForkSpec("stale", [Injection(48, stale_ackers(4, (1, 2)))])]
    report, _, _ = _counted(lambda: fork_whatif(tr, 32, forks), launches,
                            _from(free, 32), "fork")
    for fs in forks:
        solo = replay(tr, 32, fs.injections)[0]
        _same_results(report[fs.name].results[0], solo,
                      f"fork {fs.name} vs its replay", frontiers=False)
    again, _, _ = _counted(lambda: fork_whatif(tr, 48, [
        ForkSpec("x", [Injection(48, FailureScenario(
            crash_s=(48, -1, -1, -1)))]), ForkSpec("y"),
        ForkSpec("z", [Injection(64, stale_ackers(4, (3,)))])]), launches)
    if again.chunk_traces:
        raise AssertionError(f"a second fork set of the same shape "
                             f"captured {again.chunk_traces} programs")
    log(f"[replay path] fork_whatif of 3 forks from round 32: each fork "
        f"== its replay; chunk_traces {report.chunk_traces} cold, "
        f"{again.chunk_traces} for a second set; rows {report.rows()}")

    reconfigs = [
        ("remove receiver 3", free, [remove_receiver(
            4, 3, 32, stakes_r=(1.0,) * 4, quack_thresh=2.0,
            dup_thresh=2.0)]),
        ("join receiver 3", spec_with_quorum(
            build_spec(cfg, cfg, sim, FailureScenario(
                crash_r=(-1, -1, -1, 0))), stakes_r=(1.0, 1.0, 1.0, 0.0)),
         [join_receiver(4, 3, 48, stakes_r=(1.0,) * 4, quack_thresh=2.0,
                        dup_thresh=2.0)]),
        ("stake re-weight", free, [Injection(
            32, stakes_r=(1.5, 1.0, 1.0, 0.75), quack_thresh=2.25)])]
    for name, base, inj in reconfigs:
        (_, tr), _, _ = _counted(lambda: record_simulation(base), launches)
        at = inj[0].at_step
        ri, _, _ = _counted(lambda: replay(tr, at, inj), launches)
        scratch, _, _ = _counted(lambda: replay(tr, 0, inj), launches)
        _same_results(ri[0], scratch[0], f"{name} vs from scratch")
        _assert_same(ri[0], replay(tr, at, inj, device="cpu")[0],
                     f"{name} cuda vs cpu")
    names = ", ".join(name for name, _, _ in reconfigs)
    log(f"[replay path] reconfigurations ({names}) replayed from their "
        f"boundary == from round 0 == cpu")

    with tempfile.TemporaryDirectory() as out:
        path = f"{out}/trace.npz"
        tr.save(path)
        loaded = RunTrace.load(path)
    for c, cl in zip(tr.checkpoints, loaded.checkpoints):
        for part in ("state", "fails"):
            for f, x in getattr(c, part)._asdict().items():
                y = getattr(getattr(cl, part), f)
                if x.dtype != y.dtype or not np.array_equal(x, y):
                    raise AssertionError(f"trace round trip: {part}.{f}")
    inj = reconfigs[-1][2]
    _assert_same(replay(loaded, 32, inj)[0], replay(tr, 32, inj)[0],
                 "loaded trace resumed")
    log("[replay path] RunTrace save -> load -> resume: every checkpoint "
        "bit for bit (float32 stakes included), the resumed run == the "
        "in-memory trace's")


def _swap_in_place(launches) -> None:
    """A fail_schedule swap written between two replays of one captured
    program must change what it computes."""
    from repro_torch.core import (FailureScenario, RSMConfig, SimConfig,
                                  build_spec, graphs)
    from repro_torch.core.simulator import (_run_windowed_batch,
                                            spec_with_failures)
    cfg = RSMConfig.bft(1)
    spec = build_spec(cfg, cfg, SimConfig(n_msgs=256, steps=120, window=1,
                                          window_slots=256, chunk_steps=8))
    crashed = spec_with_failures(spec, FailureScenario(crash_s=(24,) * 4))

    def schedule(t):
        return [crashed] if t == 24 else None

    graphs.clear_programs()
    gpu, (captures, replays), _ = _counted(lambda: _run_windowed_batch(
        [spec], torch.device("cuda"), fail_schedule=schedule), launches,
        _from(spec, 0), "swap in place")
    gpu = gpu[0]
    cpu = _run_windowed_batch([spec], torch.device("cpu"),
                              fail_schedule=schedule)[0]
    _assert_same(gpu, cpu, "swap in place cuda vs cpu")
    cross = gpu.metrics.cross_msgs
    if (captures != 2 or replays != spec.steps // 8
            or not cross[16:24].sum() or cross[24:].sum()):
        raise AssertionError(f"swap in place: {captures} captures, "
                             f"{replays} replays, copies after the swap "
                             f"{int(cross[24:].sum())}")
    log(f"[replay path] a fail_schedule swap written in place between two "
        f"replays of one captured program: {captures} programs captured, "
        f"{replays} replays; {int(cross[16:24].sum())} copies in the chunk "
        f"before round 24, 0 after (every sender crashed); == the CPU run")


def _replay_apps_and_adversaries(launches) -> None:
    """9a: disaster recovery with the crash injected by replay on the JAX
    tests' fixtures == the static report; every adversary kind on dense,
    windowed K = 1 and K = 8 == the numpy oracle."""
    from repro_torch.adversary import (ADVERSARY_KINDS, adversary_scenario,
                                       assert_safe_retirement,
                                       quorum_budget)
    from repro_torch.apps import run_disaster_recovery
    from repro_torch.core import RSMConfig, SimConfig, build_spec
    from repro_torch.core.refsim import run_reference
    from repro_torch.core.simulator import run_simulation
    cfg = RSMConfig.bft(1)
    dr_sim, dr, _ = _app_fixtures()
    for name, crash_at, fails in dr:
        if crash_at is None:
            continue
        kw = dict(backups=sorted({"backup-0", "backup-1"} | set(fails)),
                  crash_at=crash_at, backup_failures=fails)
        static = run_disaster_recovery(cfg, cfg, dr_sim, **kw)
        inj, _, _ = _counted(lambda: run_disaster_recovery(
            cfg, cfg, dr_sim, inject_via_replay=True, **kw), launches)
        cpu = run_disaster_recovery(cfg, cfg, dr_sim, inject_via_replay=True,
                                    device="cpu", **kw)
        for other, label in ((static, "static"), (cpu, "cpu")):
            if (inj.elected != other.elected
                    or inj.phase1_prefixes != other.phase1_prefixes
                    or inj.final_prefixes != other.final_prefixes
                    or inj.converged != other.converged
                    or not np.array_equal(inj.recovered_log,
                                          other.recovered_log)):
                raise AssertionError(f"disaster recovery {name} injected "
                                     f"!= {label}")
        _same_topology(inj.phase1, cpu.phase1, f"dr {name} injected cpu")
        log(f"[replay path] disaster recovery {name}: the crash injected at "
            f"round {inj.injected_at} by replay == the static report == "
            f"cpu; elected {inj.elected}, prefixes {inj.phase1_prefixes}")
    paths = {"dense": dict(n_msgs=1024, steps=ADV_STEPS),
             "windowed K=1": dict(REPLAY_SIM, steps=ADV_STEPS,
                                  superchunk=1),
             "windowed K=8": dict(REPLAY_SIM, steps=ADV_STEPS,
                                  superchunk=8)}
    for kind in ADVERSARY_KINDS:
        sc = adversary_scenario(kind, 4, 4, seed=0)
        ref = run_reference(build_spec(cfg, cfg, SimConfig(
            **paths["windowed K=1"]), sc))
        if ref.retired_undelivered:
            raise AssertionError(f"{kind}: the oracle retired an "
                                 f"undelivered message")
        for path, kw in paths.items():
            spec = build_spec(cfg, cfg, SimConfig(**kw), sc)
            res, _, _ = _counted(lambda: run_simulation(spec), launches)
            _same_as_oracle(res, ref, f"{kind} {path}",
                            frontiers=path != "dense")
            if path != "dense" and quorum_budget(spec).provable:
                assert_safe_retirement(spec, res)
            if path == "windowed K=8":
                _assert_same(res, run_simulation(spec, device="cpu"),
                             f"{kind} {path} cuda vs cpu")
        log(f"[replay path] adversary {kind}: dense, windowed K=1 and K=8 "
            f"== the numpy oracle ({ADV_STEPS} rounds), K=8 == cpu; "
            f"retirement safe")


def replay_path_phase() -> list:
    """Phase 9a; returns the main path's launch counts."""
    launches = [0, 0]
    _replay_link(launches)
    _replay_topology_and_forks(launches)
    _swap_in_place(launches)
    _replay_apps_and_adversaries(launches)
    return launches


def replay_full_phase(f: int = 6, m: int = SWEEP_M,
                      steps: int = SWEEP_STEPS) -> list:
    """Phase 9b at full width: phase 5s's lane 0 (BFT ``f``, ``m``
    messages over ``steps`` rounds) recorded every ``REPLAY_EVERY``
    chunks; a replay from the middle checkpoint == the original with 0
    captures; the crash injected there == the from-scratch run of that
    schedule; four forks from there as one batch, each == its own
    replay, and a second fork set of the same shape capturing nothing.
    Returns the main path's launch counts."""
    from repro_torch.adversary import remove_receiver, stale_ackers
    from repro_torch.core import (FailureScenario, RSMConfig, SimConfig,
                                  build_spec, graphs)
    from repro_torch.core.simulator import (_run_windowed_batch,
                                            spec_with_failures)
    from repro_torch.obs.tracer import SpanTracer, tracing
    from repro_torch.replay import (ForkSpec, Injection, fork_whatif,
                                    record_simulation, replay)
    cfg = RSMConfig.bft(f)
    reps = cfg.n                          # replicas a side
    launches = [0, 0]
    sim = SimConfig(n_msgs=m, steps=steps, window=4, phi=32,
                    window_slots="auto", chunk_steps=CHUNK)
    spec = build_spec(cfg, cfg, sim)
    graphs.clear_programs()
    tracer = SpanTracer()
    t0 = time.perf_counter()
    with tracing(tracer):
        (res, trace), moved, _ = _counted(
            lambda: record_simulation(spec, every=REPLAY_EVERY), launches,
            _from(spec, 0), "9b record")
    wall = time.perf_counter() - t0
    spans = [s for s in tracer.spans if s.name == "checkpoint"]
    ck_s = [s.dur_ns / 1e9 for s in spans]
    ck_b = [s.args["nbytes"] for s in spans]
    if not (res.deliver_time >= 0).all():
        raise AssertionError("9b: the recorded run did not deliver all")
    log(f"[replay full] BFT f={f} <-> f={f}, M={m}, {steps} rounds, "
        f"W={spec.window_slots}, {CHUNK}-round chunks, recorded every "
        f"{REPLAY_EVERY} chunks: {wall:.3f} s wall ({steps / wall:.1f}"
        f" rounds/s, K=1 programs), {moved[0]} captures; "
        f"{len(spans)} checkpoints, host s each median "
        f"{np.median(ck_s):.4f} (min {min(ck_s):.4f}, max {max(ck_s):.4f},"
        f" total {sum(ck_s):.3f}), {ck_b[0]} bytes each "
        f"({ck_b[0] / 2 ** 20:.1f} MiB; {sum(ck_b) / 2 ** 20:.1f} MiB in "
        f"all)")
    mid = int(trace.boundaries()[len(trace.checkpoints) // 2])
    t0 = time.perf_counter()
    rr, (captures, _), _ = _counted(lambda: replay(trace, mid), launches,
                                    _from(spec, mid), "9b replay")
    wall = time.perf_counter() - t0
    n = _assert_same(rr[0], res, "9b replay from the middle")
    if captures:
        raise AssertionError(f"9b: the replay captured {captures} programs")
    log(f"[replay full] replay from round {mid} == the original bit for "
        f"bit ({n} fields), 0 captures, {wall:.3f} s wall "
        f"({(steps - mid) / wall:.1f} rounds/s)")

    crash = FailureScenario.crash_fraction(reps, reps, 0.3, seed=2,
                                           at_step=mid)
    inj = [Injection(mid, crash)]
    t0 = time.perf_counter()
    ri, (captures, _), _ = _counted(lambda: replay(trace, mid, inj),
                                    launches, _from(spec, mid), "9b inject")
    wall = time.perf_counter() - t0
    crashed = spec_with_failures(spec, crash)

    def schedule(t):
        return [crashed] if t == mid else None

    scratch, _, _ = _counted(lambda: _run_windowed_batch(
        [spec], torch.device("cuda"), fail_schedule=schedule), launches,
        _from(spec, 0), "9b from scratch")
    n = _assert_same(ri[0], scratch[0], "9b injected vs from scratch")
    log(f"[replay full] crash_fraction(0.3, seed=2) injected at round {mid}: "
        f"== the from-scratch run with that fail_schedule ({n} fields); "
        f"{wall:.3f} s wall, {captures} captures (growth "
        f"{growth(ri[0])}); resends {ri[0].total_resends()}, delivered "
        f"{int((ri[0].deliver_time >= 0).sum())} of {m}")

    liars = tuple(range(cfg.u))           # receivers 0-5 at f = 6
    forks = [ForkSpec("baseline"), ForkSpec("crash", inj),
             ForkSpec(f"remove receiver {reps - 1}", [remove_receiver(
                 reps, reps - 1, mid, stakes_r=spec.stakes_r,
                 quack_thresh=spec.quack_thresh,
                 dup_thresh=spec.dup_thresh)]),
             ForkSpec(f"stale 0-{cfg.u - 1}", [Injection(
                 mid, stale_ackers(reps, liars))])]
    t0 = time.perf_counter()
    report, _, _ = _counted(lambda: fork_whatif(trace, mid, forks),
                            launches, _from(spec, mid), "9b fork")
    fork_wall = time.perf_counter() - t0
    for fs in forks:
        solo = ri[0] if fs.name == "crash" else replay(
            trace, mid, fs.injections)[0]
        _same_results(report[fs.name].results[0], solo,
                      f"9b fork {fs.name} vs its replay", frontiers=False)
    widths = {e.new_w for e in report.forks[0].results[0]
              .window_growth_events if e.step >= mid}
    forks2 = [ForkSpec("baseline"), ForkSpec("crash", inj),
              ForkSpec("remove receiver 0", [remove_receiver(
                  reps, 0, mid, stakes_r=spec.stakes_r,
                  quack_thresh=spec.quack_thresh,
                  dup_thresh=spec.dup_thresh)]),
              ForkSpec("stake re-weight", [Injection(
                  mid, stakes_r=(2.0,) + (1.0,) * (reps - 1),
                  quack_thresh=spec.quack_thresh + 1)])]
    t0 = time.perf_counter()
    again, _, _ = _counted(lambda: fork_whatif(trace, mid, forks2),
                           launches, _from(spec, mid), "9b fork again")
    again_wall = time.perf_counter() - t0
    if report.chunk_traces > len(widths) + 2 or again.chunk_traces:
        raise AssertionError(f"9b forks: {report.chunk_traces} captures "
                             f"cold over {len(widths) + 1} widths, "
                             f"{again.chunk_traces} for the second set")
    rows = {r["fork"]: (r["delivered"], r["resends"], r["delivery_step"])
            for r in report.rows()}
    log(f"[replay full] fork_whatif of 4 forks from round {mid} as one "
        f"4-lane batch: each fork == its own replay; {fork_wall:.3f} s "
        f"wall; chunk_traces {report.chunk_traces} cold (the crash fork "
        f"grows the shared window through {sorted(widths)}: a rotating "
        f"program a width and the final chunk), {again.chunk_traces} for a "
        f"second set of the same shape ({again_wall:.3f} s); (delivered, "
        f"resends, delivery round) {rows}")
    return launches


# ----------------------------------------------------------- phase 10
# phase 10a at the stream selftest's shape (BFT f = 1, window 4, phi 6,
# 16-round chunks, K = 8); phase 10b at full width: BFT f = 6 both sides,
# window 4, phi 32, 32-round chunks, K = 8, window_slots="auto"
# (stream_window_slots: W = 7,616 at both horizons), a diurnal link of 64
# messages a round on average, swinging by half over 512 rounds (peak
# 133 a round), over two horizons
STREAM_PROCESS = dict(kind="diurnal", rate=64.0, period=512, amplitude=0.5,
                      seed=0)
STREAM_HORIZONS = (524_288, 131_072)
# P1 for a resident stream: the session's peak device memory less what
# its cached program sets hold by design, equal at both horizons within
# FLAT_DEVICE_MIB; the session's host peak inside run() under
# FLAT_HOST_SHARE of the batch run's on the same spec. By design: each
# set's padded schedule, 12 bytes a message and a window slot at its
# width (O(M)), and its captured span programs' output buffers, k chunk
# queues each (O(K * W)). The peak falls in a capture: the warm-up of the
# horizon's tail span (its rotating chunks mod K: 6 at 524,288, 7 at
# 131,072) holds that span's chunk queues beside the buffers of the
# programs captured before it, so the peak follows the tail by one chunk
# queue a chunk (1.27 MiB at W = 7,616), and taking off every program's
# buffers takes that off (tools/stream_memory_trace.py traces it)
FLAT_DEVICE_MIB = 1.0
FLAT_HOST_SHARE = 1 / 8


def _stream_report(res) -> dict:
    """A session's report without its trace count (a first use in a
    cached set: it depends on what ran before, dispatches do not)."""
    d = res.to_json_dict()
    d["counters"] = {k: v for k, v in d["counters"].items()
                     if k != "traces"}
    return d


def _same_sessions(a, b, rows, what: str) -> None:
    """Two sessions' results agree in their report, every live row (their
    JSON-lines streams ``rows``), SLO events, sketch, ``ObsMetrics``,
    capacity, width, growth events, dispatches and host syncs."""
    checks = {
        "report": _stream_report(a) == _stream_report(b),
        "live rows": rows[0].read_text() == rows[1].read_text(),
        "slo events": [e.to_dict() for e in a.slo_events]
        == [e.to_dict() for e in b.slo_events],
        "sketch": np.array_equal(a.sketch.hist, b.sketch.hist),
        "obs": [o.to_dict() for o in a.obs] == [o.to_dict() for o in b.obs],
        "capacity": a.capacity == b.capacity,
        "width": a.final_window_slots == b.final_window_slots,
        "growth": [dataclasses.asdict(e) for e in a.growth_events]
        == [dataclasses.asdict(e) for e in b.growth_events],
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad or a.problems or b.problems:
        raise AssertionError(f"{what}: differ in {bad}; problems "
                             f"{a.problems} / {b.problems}")


def _path_session(device, out: Path, name: str, fail_schedule=None,
                  **cfg):
    """The stream selftest's session (BFT f = 1, window 4, phi 6, 16-round
    chunks, K = 8, constant 4 a round, 512 messages) on ``device``, its
    live rows in ``out``; (session, result)."""
    from repro_torch.core import RSMConfig, SimConfig
    from repro_torch.stream import StreamConfig, StreamSession
    b = RSMConfig.bft(1)
    sim = SimConfig(**{**dict(window=4, phi=6, window_slots="auto",
                              chunk_steps=16, superchunk=8),
                       **cfg.pop("sim", {})})
    cfg.setdefault("horizon", 512)
    sess = StreamSession(b, b, sim, StreamConfig(
        jsonl_path=str(out / f"{name}-{device}.jsonl"), **cfg),
        device=device)
    chunk = sess.spec.chunk_steps
    sched = None if fail_schedule is None else {
        int(t) * chunk: f for t, f in fail_schedule.items()}
    return sess, sess.run(fail_schedule=sched)


def stream_path_phase() -> list:
    """Phase 10a; returns the main path's launch counts."""
    import tempfile

    from repro_torch.adversary import streaming_attack
    from repro_torch.analysis import SanitizerError, engine_guard
    from repro_torch.analysis.__main__ import main as analysis_main
    from repro_torch.core import FailureScenario, RSMConfig, SimConfig
    from repro_torch.core.simulator import (_run_windowed_batch,
                                            spec_with_failures)
    from repro_torch.obs.live import SLOConfig
    from repro_torch.stream import ArrivalProcess, build_stream_spec
    from repro_torch.stream.__main__ import main as stream_main
    launches = [0, 0]
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        rc, _, _ = _counted(lambda: stream_main(
            ["--selftest", "--out", str(out / "selftest")]), launches)
        if rc:
            raise AssertionError(f"repro_torch.stream --selftest exited "
                                 f"{rc}")
        log("[stream path] python -m repro_torch.stream --selftest on the "
            "card: exit 0 (live == post-hoc RunReport, stream dispatches "
            "== batch dispatches, all delivered, quiet watchdogs, trace "
            "schema)")

        cases = [
            ("session", {}, None),
            ("chained", dict(horizon=256, links=3, chained=True), None),
            ("attack", dict(horizon=1024, utilization=0.5, report_every=2,
                            slo=SLOConfig(p99_latency_rounds=24,
                                          resend_rate=0.25,
                                          frontier_stall_chunks=2),
                            sim=dict(window=2, phi=3)),
             {4: streaming_attack("selective_drop", 4, 4),
              16: FailureScenario.none()}),
        ]
        for name, cfg, sched in cases:
            res = {}
            for dev in ("cuda", "cpu"):
                kw = dict(cfg, sim=dict(cfg.get("sim", {})))
                if dev == "cuda":
                    (sess, res[dev]), _, got = _counted(
                        lambda: _path_session(dev, out, name, sched, **kw),
                        launches)
                else:
                    sess, res[dev] = _path_session(dev, out, name, sched,
                                                   **kw)
            links = sess.config.links
            # one launch serves every lane
            if got != _from(sess.spec, 0):
                raise AssertionError(f"stream path {name}: launches {got},"
                                     f" expected {_from(sess.spec, 0)}")
            _same_sessions(res["cuda"], res["cpu"],
                           [out / f"{name}-{d}.jsonl" for d in ("cuda",
                                                                "cpu")],
                           f"stream path {name} cuda vs cpu")
            r = res["cuda"]
            if r.delivered != sess.spec.m * links:
                raise AssertionError(f"stream path {name}: delivered "
                                     f"{r.delivered}")
            events = [(e.kind, e.t, e.recovered) for e in r.slo_events]
            if sched is not None:
                chunk = sess.spec.chunk_steps
                breach = [e for e in r.slo_events if not e.recovered]
                if not breach or not any(e.recovered for e in r.slo_events) \
                        or min(e.t for e in breach) < 4 * chunk:
                    raise AssertionError(f"stream path {name}: SLO events "
                                         f"{events}")
            log(f"[stream path] {name} ({links} lane(s), M={sess.spec.m}, "
                f"{r.rounds} rounds, W={r.final_window_slots}): CUDA == CPU"
                f" in the report, {r.live.total_rows} live rows, SLO events"
                f", sketch, ObsMetrics, capacity, width, growth; "
                f"{r.counters['dispatches']} dispatches, "
                f"{r.counters['syncs']} host syncs; delivered "
                f"{r.delivered}; percentiles {r.percentiles()}; SLO events "
                f"{events}")

        # the dense fallback refused on the card, with the CPU's message
        crash = FailureScenario.crash_fraction(4, 4, 0.25, seed=3,
                                               at_step=8)
        b = RSMConfig.bft(1)
        spec = build_stream_spec(b, b, SimConfig(
            window=1, phi=6, window_slots="auto", chunk_steps=8,
            superchunk=8), ArrivalProcess(), 192)
        spec = spec_with_failures(spec, crash)
        msgs = {}
        for dev in ("cuda", "cpu"):
            try:
                _run_windowed_batch([spec], torch.device(dev),
                                    drain_sink=_RefuseSink())
            except RuntimeError as e:
                msgs[dev] = str(e)
            else:
                raise AssertionError(f"stream path: the dense fallback ran"
                                     f" on {dev}")
        if "window overflow" not in msgs["cuda"] or \
                msgs["cuda"] != msgs["cpu"]:
            raise AssertionError(f"stream path: refusal {msgs}")
        log(f"[stream path] dense fallback refused on the card as on the "
            f"CPU: {msgs['cuda'][:160]}...")

        # the runtime contracts on the card
        report = out / "ANALYSIS.json"
        rc, _, _ = _counted(lambda: analysis_main(
            ["--check", "--json", str(report)]), launches)
        sec = json.loads(report.read_text())["sanitizer"]
        if rc or not sec["ok"] or sec["warm"]["recompiles"] or \
                sec["cold"]["transfers"] or sec["warm"]["transfers"]:
            raise AssertionError(f"repro_torch.analysis --check: rc {rc}, "
                                 f"{sec}")
        log(f"[stream path] python -m repro_torch.analysis --check on the "
            f"card (debug_checks, M={sec['shape']['m']}, "
            f"W={sec['shape']['window_slots']}, K=8): cold "
            f"{sec['cold']['dispatches']} dispatches (contract "
            f"{sec['cold']['contract']['max_dispatches']}), "
            f"{sec['cold']['host_syncs']} host syncs, "
            f"{sec['cold']['recompiles']} captures, 0 implicit transfers; "
            f"warm {sec['warm']['dispatches']} dispatches, "
            f"{sec['warm']['recompiles']} captures, 0 implicit transfers")
    x = torch.arange(4, device="cuda")
    try:
        with engine_guard():
            x.sum().item()
    except SanitizerError as e:
        log(f"[stream path] a seeded .item() inside engine_guard on the "
            f"card: SanitizerError ({str(e).splitlines()[0][:100]})")
    else:
        raise AssertionError("engine_guard let a seeded .item() through")
    if torch.cuda.get_sync_debug_mode() != 0:
        raise AssertionError("the sync debug mode outlived the guard")
    return launches


class _RefuseSink:
    """A horizon-mode sink for the refusal check: it must see no final
    call."""

    def on_chunk(self, *args) -> None:
        pass

    def on_final(self, *args) -> None:
        raise AssertionError("the refused session reached its final flush")


def _by_design() -> tuple:
    """What the cached program sets hold by design, in bytes: (their
    padded schedules, their captured programs' output buffers)."""
    from repro_torch.core import graphs
    sets = graphs.cached_sets()
    return (sum(t.numel() * t.element_size() for ps in sets
                for t in ps.keep[1].sched),
            sum(ps.output_nbytes() for ps in sets))


def _stream_full_session(horizon: int, launches):
    """One cold 10b session under ``Measured`` and tracemalloc; (session,
    result, Measured, host peak bytes, ``_by_design()`` after it)."""
    import tracemalloc

    from repro_torch.core import RSMConfig, SimConfig
    from repro_torch.obs.tracer import SpanTracer
    from repro_torch.stream import ArrivalProcess, StreamConfig, StreamSession
    cfg = RSMConfig.bft(6)
    sim = SimConfig(window=4, phi=32, window_slots="auto", chunk_steps=CHUNK,
                    superchunk=8)
    t0 = time.perf_counter()
    sess = StreamSession(cfg, cfg, sim, StreamConfig(
        horizon=horizon, process=ArrivalProcess(**STREAM_PROCESS)))
    plan_s = time.perf_counter() - t0
    tracer = SpanTracer()
    host = [0]

    def run():
        tracemalloc.start()
        try:
            return sess.run(tracer=tracer)
        finally:
            host[0] = tracemalloc.get_traced_memory()[1]
            tracemalloc.stop()

    run_m = Measured(run)
    held = _by_design()
    res, spec = run_m.result, sess.spec
    _count_full(launches, run_m, spec, f"stream {horizon}")
    if res.problems or res.delivered != horizon or res.retired != horizon:
        raise AssertionError(f"stream {horizon}: delivered {res.delivered},"
                             f" retired {res.retired}, problems "
                             f"{res.problems}")
    log(f"[stream {horizon}] BFT f=6 <-> f=6, diurnal "
        f"{STREAM_PROCESS}: {len(sess.arrivals)} loaded rounds + "
        f"{spec.steps - len(sess.arrivals)} drain = {spec.steps} rounds, "
        f"W={spec.window_slots} (final {res.final_window_slots}, growth "
        f"{[(e.step, e.old_w, e.new_w) for e in res.growth_events]}); "
        f"planning (the session's build_stream_spec) {plan_s:.3f} s, "
        f"outside the run; under tracemalloc: "
        + run_m.line(spec.steps, horizon)
        + f"; {run_m.counts[0]} dispatches, {run_m.counts[1]} host syncs, "
        f"{run_m.counts[2]} captures; host peak inside run() "
        f"{host[0] / 2 ** 20:.3f} MiB; {res.counters['chunks_drained']} "
        f"chunks drained, {res.live.total_rows} live rows; percentiles "
        f"{res.percentiles()}; {tracer.count('drain_wait')} drain waits, "
        f"drain overlap {tracer.drain_overlap_ratio():.4f}")
    return sess, res, run_m, host[0], held


def _count_full(launches, run_m, spec, what: str) -> None:
    """A measured windowed run's launches: 2 x rounds + rotating chunks,
    none discarded; added to the main path's."""
    total, no_lost, skipped = run_m.launches
    if (total, no_lost) != _from(spec, 0) or skipped:
        raise AssertionError(f"{what}: launches {(total, no_lost)} "
                             f"({skipped} discarded), expected "
                             f"{_from(spec, 0)}")
    launches[0] += total - no_lost
    launches[1] += no_lost


def stream_full_phase() -> list:
    """Phase 10b; returns the main path's launch counts."""
    import tracemalloc

    from repro_torch.core import run_simulation
    from repro_torch.obs.report import report_from_results
    from repro_torch.obs.tracer import SpanTracer, tracing
    launches = [0, 0]
    t_start = time.perf_counter()
    sess, res, run_m, host, held = _stream_full_session(STREAM_HORIZONS[0],
                                                        launches)
    spec = sess.spec
    batch_tracer = SpanTracer()
    batch_host = [0]

    def batch_run():
        tracemalloc.start()
        try:
            with tracing(batch_tracer):
                return run_simulation(spec)
        finally:
            batch_host[0] = tracemalloc.get_traced_memory()[1]
            tracemalloc.stop()

    batch_m = Measured(batch_run, cold=False)
    _count_full(launches, batch_m, spec, "stream batch")
    report = report_from_results([batch_m.result], batch_tracer,
                                 lane_names=["link"])
    problems = report.validate()
    post = report.obs["link"]
    live = np.asarray(res.sketch.lane_sum(), dtype=np.int64)
    if problems or not np.array_equal(
            live, np.asarray(post.latency_hist, dtype=np.int64)) or \
            res.percentiles() != post.percentiles():
        raise AssertionError(f"stream: live {res.percentiles()} vs post-hoc"
                             f" {post.percentiles()}; {problems}")
    if batch_m.counts[2] or batch_m.counts[:2] != (
            res.counters["dispatches"], res.counters["syncs"]) or \
            run_m.counts[:2] != batch_m.counts[:2]:
        raise AssertionError(f"stream: session counts {run_m.counts}, "
                             f"batch {batch_m.counts}")
    log(f"[stream batch] run_simulation of the identical spec after the "
        f"session, under tracemalloc: "
        + batch_m.line(spec.steps, spec.m)
        + f"; {batch_m.counts[2]} captures, {batch_m.counts[0]} dispatches"
        f" == the session's {run_m.counts[0]}; host peak "
        f"{batch_host[0] / 2 ** 20:.3f} MiB; the post-hoc RunReport "
        f"validates and its histogram and percentiles "
        f"{post.percentiles()} == the live ones bit for bit")
    del batch_m, report
    peaks = {STREAM_HORIZONS[0]: (run_m.peak_mib, held, res)}
    sess2, res2, run2, host2, held2 = _stream_full_session(
        STREAM_HORIZONS[1], launches)
    peaks[STREAM_HORIZONS[1]] = (run2.peak_mib, held2, res2)
    mib = 2 ** 20
    flat = {h: p - (sched + outs) / mib
            for h, (p, (sched, outs), _) in peaks.items()}
    spread = max(flat.values()) - min(flat.values())
    log(f"[stream flat] device: peak less the padded schedules and the "
        f"span programs' output buffers "
        + ", ".join(f"{h}: {p:.4f} - {sched / mib:.4f} - {outs / mib:.4f} "
                    f"= {flat[h]:.4f} MiB (final W {r.final_window_slots})"
                    for h, (p, (sched, outs), r) in peaks.items())
        + f"; spread {spread:.4f} MiB (limit {FLAT_DEVICE_MIB} MiB; less "
        f"the schedules alone: "
        + ", ".join(f"{p - sched / mib:.4f}"
                    for p, (sched, _), _ in peaks.values())
        + f" MiB); host: the session's peak inside run() "
        f"{host / mib:.3f} MiB at {STREAM_HORIZONS[0]} and "
        f"{host2 / mib:.3f} MiB at {STREAM_HORIZONS[1]}, the batch run's "
        f"{batch_host[0] / mib:.3f} MiB ({host / batch_host[0]:.4f} of it; "
        f"limit {FLAT_HOST_SHARE:.3f}); 10b "
        f"{time.perf_counter() - t_start:.1f} s")
    if spread > FLAT_DEVICE_MIB or host >= FLAT_HOST_SHARE * batch_host[0]:
        raise AssertionError("stream: device or host memory not flat")
    return launches


# ----------------------------------------------------------- phase 11
# the cross-pod runtime on the gradient tree of one full-width
# starcoder2-3b decoder layer (src/repro/configs/starcoder2_3b.py), over
# the production multi-pod mesh (pod 2, data 16, model 16) held on the
# card: 32 (pod, data) positions, each with its own block of every leaf
XP_ARCH = "starcoder2-3b"
XP_MESH = ((2, 16, 16), ("pod", "data", "model"))
# sync: both schedules sum 32 f32 blocks of magnitude < 6 in their own
# order; the same limit for the optimizer, relative to a leaf's largest
# magnitude; EF-int8 as tests/test_crosspod.py holds it
XP_TOL = 1e-6
XP_EF_TOL = 1e-4
XP_EF_STEPS = 10      # 20 until its CPU twin's 34 s were cut for time
XP_ADAMW_STEPS = 3
XP_REPEATS = 5
XP_SMALL = ("ln1", "ln2", "attn/wk", "attn/wv")   # the four smallest
XP_COLS = 1 << 22      # columns of the f64 mean checked at a time


def layer_shapes(cfg) -> dict:
    """One dense decoder layer's parameter (and gradient) leaves by key
    path, as ``src/repro/models/blocks.py:61-78,440-447`` define them."""
    d, hd, f = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    h, kv = cfg.n_heads, cfg.n_kv_heads
    return {"ln1": (d,), "ln2": (d,), "attn/wq": (d, h, hd),
            "attn/wk": (d, kv, hd), "attn/wv": (d, kv, hd),
            "attn/wo": (h, hd, d), "mlp/wi": (d, f), "mlp/wg": (d, f),
            "mlp/wo": (f, d)}


def nest(flat: dict) -> dict:
    """{"a/b": x} -> {"a": {"b": x}}."""
    out: dict = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def flat_keys(tree) -> dict:
    from repro_torch.tree_util import tree_flatten_with_path
    return dict(tree_flatten_with_path(tree)[0])


def events_ms(fn, repeats: int):
    """``fn()`` ``repeats`` times, each between CUDA events; (times in
    call order, the last result). The previous result is dropped before
    each call."""
    times, out = [], None
    for _ in range(repeats):
        out = None
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times, out


def _on_device(tree, dev, what: str) -> None:
    bad = [k for k, t in flat_keys(tree).items() if t.device.type != dev.type]
    if bad:
        raise AssertionError(f"{what}: {bad} left the card")


def _sync_phase(dev, shapes: dict) -> None:
    """11a: PICSOU against ATA at (2, 16, 16), each position's block
    distinct, against the f64 mean, the ``P()`` case, the CPU."""
    from repro_torch.crosspod import (ata_cross_pod_sync, dcn_bytes_analytic,
                                      picsou_cross_pod_sync)
    from repro_torch.launch.mesh import P, make_mesh, make_production_mesh
    mesh = make_production_mesh(multi_pod=True)
    pos = mesh.shape["pod"] * mesh.shape["data"]
    spec = P(("pod", "data"))
    gen = torch.Generator(device=dev).manual_seed(11)
    grads = nest({k: torch.randn((pos * s[0],) + s[1:], generator=gen,
                                 device=dev) for k, s in shapes.items()})
    n_local = sum(math.prod(s) for s in shapes.values())
    in_bytes = 4 * pos * n_local
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    outs, times = {}, {}
    fns = {"picsou": picsou_cross_pod_sync, "ata": ata_cross_pod_sync}
    for name, fn in fns.items():
        times[name], outs[name] = events_ms(
            lambda: fn(grads, mesh, spec), 1 + XP_REPEATS)
        _on_device(outs[name], dev, f"sync {name}")
    peak = torch.cuda.max_memory_allocated()
    g, p, a = (flat_keys(t) for t in (grads, outs["picsou"], outs["ata"]))
    worst = dict.fromkeys(("picsou - mean", "ata - mean", "picsou - ata"),
                          0.0)
    for k, x in g.items():
        if p[k].shape != x.shape or a[k].shape != x.shape or \
                p[k].dtype != x.dtype or a[k].dtype != x.dtype:
            raise AssertionError(f"sync {k}: {p[k].shape} {a[k].shape} "
                                 f"against {x.shape}")
        xb, pb, ab = (t.view(pos, -1) for t in (x, p[k], a[k]))
        for c0 in range(0, xb.shape[1], XP_COLS):
            cols = slice(c0, c0 + XP_COLS)
            mean = xb[:, cols].double().mean(0)
            pc, ac = pb[:, cols].double(), ab[:, cols].double()
            for key, err in (("picsou - mean", pc - mean),
                             ("ata - mean", ac - mean),
                             ("picsou - ata", pc - ac)):
                worst[key] = max(worst[key], err.abs().max().item())
            del pc, ac, mean
    # the port on the CPU, on the four smallest leaves
    cpu_mesh = make_mesh(*XP_MESH, device="cpu")
    small = nest({k: g[k].cpu() for k in XP_SMALL})
    cpu_err = 0.0
    for name, fn in fns.items():
        got, want = flat_keys(fn(small, cpu_mesh, spec)), flat_keys(
            outs[name])
        for k in XP_SMALL:
            cpu_err = max(cpu_err,
                          (got[k] - want[k].cpu()).abs().max().item())
    del outs, p, a, want
    # P(): every position holds the whole leaf; the mean is the leaf
    rep = nest({k: g[k][:s[0]] for k, s in shapes.items()})
    rep_err = 0.0
    for name, fn in fns.items():
        got = flat_keys(fn(rep, mesh))
        _on_device(got, dev, f"sync {name} P()")
        for k, x in flat_keys(rep).items():
            rep_err = max(rep_err, (got[k] - x).abs().max().item())
    del grads, g, rep, got
    moved = 2 * in_bytes
    bound = moved / HBM_BPS * 1e3
    for name in fns:
        t = sorted(times[name][1:])
        dcn = dcn_bytes_analytic(4 * n_local, mesh.shape, name)
        log(f"[crosspod sync] {name} over {mesh.shape}, P(('pod', 'data')) "
            f"on dim 0 (32 distinct blocks, {in_bytes / 1e9:.3f} GB in): "
            f"{median(t):.3f} ms a sync (CUDA events, median of "
            f"{XP_REPEATS}; {t[0]:.3f}..{t[-1]:.3f}; first call "
            f"{times[name][0]:.3f} ms); {moved / median(t) / 1e6:.1f} GB/s"
            f" of the {moved / 1e9:.3f} GB read and written (bound "
            f"{bound:.3f} ms at 3.35 TB/s); the slow-link bytes it stands "
            f"for, per chip (dcn_bytes_analytic of {4 * n_local} B): "
            f"{dcn['dcn_per_chip']:.1f} across pods, "
            f"{dcn['ici_per_chip']:.1f} within, reduction "
            f"{dcn['dcn_reduction']:.1f}x")
    log(f"[crosspod sync] peak device memory {(peak - held) / 2 ** 30:.3f} "
        f"GiB above the {held / 2 ** 30:.3f} GiB of input (both outputs "
        f"held); max |err|: "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + f", P() against its input {rep_err:.3e}, CUDA against the CPU on "
        f"{', '.join(XP_SMALL)} {cpu_err:.3e} (limit {XP_TOL:g})")
    if max(max(worst.values()), rep_err, cpu_err) > XP_TOL:
        raise AssertionError("crosspod sync: over the limit")


def _compression_phase(dev, shapes: dict) -> None:
    """11b: EF-int8 over the layer for XP_EF_STEPS steps, CUDA against the port on
    the CPU on the same gradients."""
    from repro_torch.crosspod import ef_int8_compress, ef_int8_decompress
    gen = torch.Generator(device=dev).manual_seed(12)
    base = {k: torch.randn(s, generator=gen, device=dev) * 0.01
            for k, s in shapes.items()}
    res_d = {k: torch.zeros_like(x) for k, x in base.items()}
    res_h = {k: torch.zeros(x.shape) for k, x in base.items()}
    sent = {k: torch.zeros_like(x) for k, x in base.items()}
    true = {k: torch.zeros_like(x) for k, x in base.items()}
    times, cpu_s, mism = [], 0.0, 0
    for step in range(XP_EF_STEPS):
        grads = {k: x * (1 + 0.1 * step) for k, x in base.items()}
        packed, deq = {}, {}
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        for k, gk in grads.items():
            packed[k], res_d[k] = ef_int8_compress(gk, res_d[k])
            deq[k] = ef_int8_decompress(packed[k], gk.shape)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        t0 = time.perf_counter()
        for k, gk in grads.items():
            sent[k] += deq[k]
            true[k] += gk
            (q, s, pad), res_h[k] = ef_int8_compress(gk.cpu(), res_h[k])
            qd, sd, padd = packed[k]
            if pad != padd or qd.device.type != dev.type or \
                    not torch.equal(q, qd.cpu()) or \
                    not torch.equal(s, sd.cpu()):
                mism += 1
        cpu_s += time.perf_counter() - t0
    res_same = all(torch.equal(res_h[k], res_d[k].cpu()) for k in base)
    acc = max((sent[k] + res_d[k] - true[k]).abs().max().item()
              for k in base)
    n = sum(x.numel() for x in base.values())
    t = sorted(times)
    log(f"[crosspod ef-int8] {XP_EF_STEPS} steps over the layer "
        f"({n} f32, blocks of 256): {median(t):.3f} ms a compress + "
        f"decompress of every leaf (CUDA events, median of {XP_EF_STEPS}; "
        f"{t[0]:.3f}..{t[-1]:.3f}); q and scales == the port on the CPU in "
        f"every step and leaf: {mism} mismatches; residuals bit for bit: "
        f"{res_same}; accumulated sent + residual - true {acc:.3e} (limit "
        f"{XP_EF_TOL:g}); the CPU twin and the copies {cpu_s:.1f} s")
    if mism or not res_same or acc >= XP_EF_TOL:
        raise AssertionError("crosspod ef-int8: CUDA and CPU differ")


def _leaf_err(got, want) -> float:
    """max |got - want| over the leaf's largest |want|, on ``got``'s
    device."""
    want = want.to(got.device, torch.float64)
    return ((got.double() - want).abs().max()
            / want.abs().max().clamp_min(1e-30)).item()


def _optimizer_phase(dev, shapes: dict):
    """11c: AdamW with the cosine schedule, three steps over the layer's
    parameters, CUDA against the port on the CPU. Returns the card's
    (params, state)."""
    from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                                   cosine_schedule)
    from repro_torch.tree_util import tree_map
    gen = torch.Generator(device=dev).manual_seed(13)
    cfg = AdamWConfig()
    params_d = nest({k: torch.randn(s, generator=gen, device=dev) * 0.02
                     for k, s in shapes.items()})
    params_h = tree_map(lambda t: t.cpu(), params_d)
    st_d, st_h = adamw_init(params_d), adamw_init(params_h)
    times, worst = [], 0.0
    for _ in range(XP_ADAMW_STEPS):
        g_d = nest({k: torch.randn(s, generator=gen, device=dev) * 1e-3
                    for k, s in shapes.items()})
        g_h = tree_map(lambda t: t.cpu(), g_d)
        lr_d = cosine_schedule(st_d.step, 1, 10 * XP_ADAMW_STEPS)
        lr_h = cosine_schedule(st_h.step, 1, 10 * XP_ADAMW_STEPS)
        t, (params_d, st_d) = events_ms(
            lambda: adamw_update(cfg, g_d, params_d, st_d, lr_d), 1)
        times += t
        params_h, st_h = adamw_update(cfg, g_h, params_h, st_h, lr_h)
        if int(st_d.step) != int(st_h.step):
            raise AssertionError("adamw: step differs")
        for tree_d, tree_h in ((params_d, params_h), (st_d.m, st_h.m),
                               (st_d.v, st_h.v)):
            _on_device(tree_d, dev, "adamw")
            hd = flat_keys(tree_h)
            for k, x in flat_keys(tree_d).items():
                worst = max(worst, _leaf_err(x, hd[k]))
    log(f"[crosspod adamw] {XP_ADAMW_STEPS} adamw_update steps with "
        f"cosine_schedule over the layer's parameters (clipped: grad norm "
        f"> 1): {median(sorted(times)):.3f} ms an update (CUDA events, "
        f"median of {XP_ADAMW_STEPS}; {', '.join(f'{x:.3f}' for x in times)}"
        f"); step {int(st_d.step)} == the CPU's; max |CUDA - CPU| over a "
        f"leaf's largest |value| {worst:.3e} (limit {XP_TOL:g})")
    if worst > XP_TOL:
        raise AssertionError("adamw: CUDA and CPU differ")
    return params_d, st_d


def _checkpoint_phase(dev, params, opt) -> None:
    """11d: ``CheckpointManager.save_async`` of (params, AdamW state)
    from the card, ``wait``, ``restore_tree`` onto the card bit for bit,
    and a corrupted shard refused."""
    import tempfile

    from repro_torch.checkpoint import CheckpointManager, restore_tree
    from repro_torch.tree_util import tree_leaves, tree_map
    tree = (params, opt)
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(tree))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        mgr = CheckpointManager(d, n_shards=4)
        t0 = time.perf_counter()
        mgr.save_async(1, tree)
        copy_s = time.perf_counter() - t0
        mgr.wait(timeout=600)
        write_s = time.perf_counter() - t0 - copy_s
        res = mgr.result(1)
        mgr.close()
        step_dir = Path(d) / "step_00000001"
        disk = sum(f.stat().st_size for f in step_dir.iterdir())
        template = tree_map(torch.empty_like, tree)
        t0 = time.perf_counter()
        out, step = restore_tree(template, d)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        same = all(a.device.type == dev.type and a.dtype == b.dtype
                   and torch.equal(a, b)
                   for a, b in zip(tree_leaves(out), tree_leaves(tree)))
        del out
        with open(step_dir / "shard_0000.npz", "r+b") as f:
            f.seek(30)
            f.write(b"\x00\x01\x02")
        try:
            restore_tree(template, d)
            refused = False
        except IOError:
            refused = True
    frac = res["replication"]["durable_frac"] if res else None
    log(f"[crosspod checkpoint] (params, AdamW state) from the card, "
        f"{nbytes / 1e9:.3f} GB in {len(tree_leaves(tree))} leaves, 4 "
        f"shards: save_async {copy_s:.3f} s host (the copy off the card), "
        f"wait {write_s:.3f} s (npz + sha256 + rename), {disk / 1e9:.3f} GB"
        f" on disk, restore_tree onto the card {restore_s:.3f} s "
        f"({nbytes / restore_s / 1e9:.2f} GB/s); step {step}, bit for bit "
        f"on CUDA: {same}; durable_frac {frac}; a corrupted shard raises "
        f"IOError: {refused}")
    if not (same and step == 1 and frac == 1.0 and refused):
        raise AssertionError("checkpoint: round trip or replication failed")


def crosspod_phase(dev) -> None:
    """Phase 11: the cross-pod runtime (``repro_torch.crosspod``,
    ``launch.mesh``, ``optim``, ``checkpoint``) on a full-width layer."""
    from repro_torch import configs
    from repro_torch.core import graphs
    graphs.clear_programs()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = configs.get_config(XP_ARCH)
    shapes = layer_shapes(cfg)
    log(f"[crosspod] {XP_ARCH} layer ({cfg.d_model} wide, {cfg.n_heads} "
        f"heads, {cfg.n_kv_heads} kv, d_ff {cfg.d_ff}): "
        f"{sum(math.prod(s) for s in shapes.values())} parameters; mesh "
        f"{dict(zip(XP_MESH[1], XP_MESH[0]))} on one card")
    for name, fn in (("11a sync", _sync_phase),
                     ("11b ef-int8", _compression_phase)):
        t0 = time.perf_counter()
        fn(dev, shapes)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[time] {name} {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    params, opt = _optimizer_phase(dev, shapes)
    log(f"[time] 11c adamw {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _checkpoint_phase(dev, params, opt)
    log(f"[time] 11d checkpoint {time.perf_counter() - t0:.1f} s")
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phase 12
# phase 12, the serving path. 12a: every config at .smoke() (f32, two
# layers), SERVE_SMOKE = (batch, prompt tokens), two decode steps after
# it, CUDA on the kernel route against the CPU on the same weights (MoE
# at capacity 8, as tests/test_models_smoke.py, so that nothing drops).
# 12b: granite-8b at full width and depth, SERVE_SHAPE = (batch, prompt
# tokens, tokens generated), through launch.serve.generate; its CPU twin
# at full width cut to SERVE_TWIN = (layers, batch, tokens)
SERVE_ARCH = "granite-8b"
SERVE_SEED = 24
SERVE_SMOKE = (2, 16)
SERVE_SHAPE = (4, 512, 16)
SERVE_TWIN = (2, 1, 128)
# CUDA against the CPU, max |difference| over max |CPU value|: 1e-4, and
# 1e-3 for whisper-small, whose f32 smoke encoder is ill-conditioned (the
# CPU tests hold the port to the JAX package at the same limits); the
# twin 1e-4 of max |logit|; prefill / decode consistency at the JAX
# test's atol = rtol = 2e-2
SERVE_TOL = {"whisper-small": 1e-3}
SERVE_DEFAULT_TOL = 1e-4
SERVE_TWIN_TOL = 1e-4
SERVE_CONSISTENCY = 2e-2
# the faulty attention of 12b's controls: each must read further from
# the f32 oracle than the kernel route does
SERVE_CONTROLS = ("causal off", "kv head h % KV")


def attention_calls(cfg) -> int:
    """Attention calls in one prefill (the encoder's included): one a
    block, two a decoder block (self and cross), none an RWKV block."""
    from repro_torch.models.model import encoder_plan, layer_plan
    per = {"rwkv": 0, "dec": 2}
    return sum(s.count * per.get(s.kind, 1)
               for s in layer_plan(cfg) + encoder_plan(cfg))


def _zero_attention_counts():
    from repro_torch.kernels.flash_attention import flash_attention as fa
    fa.launches = fa.launches_sm90 = fa.launches_f32 = 0


def _attention_counts() -> dict:
    from repro_torch.kernels.flash_attention import flash_attention as fa
    return {"all": fa.launches, "sm90": fa.launches_sm90,
            "f32": fa.launches_f32}


def _rel_err(got, want) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max()
                 / want.abs().max().clamp(min=1e-30))


def _served(params, cfg, tokens, memory, impl=None) -> dict:
    """The forward over every token, prefill over all but the last two
    (caches for two more; rings of the window when every layer has one)
    and two decode steps: {"full", "last", "caches" (leaves), "steps"}."""
    from repro_torch.models import blocks
    from repro_torch.models import model as M
    from repro_torch.tree_util import tree_leaves
    s = tokens.shape[1] - 2
    rings = all(blocks.window_for(cfg, g.kind) for g in M.layer_plan(cfg))
    mem = (M.encode(params, cfg, memory, impl=impl)
           if cfg.family == "encdec" else memory)
    full, _ = M.forward(params, cfg, tokens, memory=mem, impl=impl)
    last, caches = M.prefill(params, cfg, tokens[:, :s], memory=memory,
                             impl=impl, cache_len=None if rings else s + 2)
    out = {"full": full, "last": last, "caches": tree_leaves(caches),
           "steps": []}
    for i in range(2):
        logits, caches = M.decode_step(params, cfg, caches,
                                       tokens[:, s + i:s + i + 1], s + i)
        out["steps"].append(logits)
    return out


def serve_smoke_phase(dev) -> int:
    """12a. Returns the f32 attention kernel's launches on CUDA."""
    from repro_torch.configs import get_config, list_configs
    from repro_torch.models import model as M
    from repro_torch.tree_util import tree_map

    b, s = SERVE_SMOKE
    launched = 0
    for i, arch in enumerate(list_configs()):
        cfg = get_config(arch).smoke()
        if cfg.family == "moe":
            cfg = dataclasses.replace(cfg, capacity_factor=8.0)
        params = M.init_model(cfg, SERVE_SEED + i, device="cpu")
        rng = np.random.default_rng(SERVE_SEED + i)
        tokens = torch.from_numpy(
            rng.integers(0, cfg.vocab, (b, s + 2)).astype(np.int32))
        memory = None
        if cfg.family in ("encdec", "vlm"):
            n = cfg.encoder_seq if cfg.family == "encdec" else cfg.vision_seq
            memory = torch.from_numpy(rng.standard_normal(
                (b, n, cfg.d_model)).astype(np.float32))
        cpu = _served(params, cfg, tokens, memory)

        def cuda(x):
            return None if x is None else x.to(dev)

        _zero_attention_counts()
        gpu = _served(tree_map(cuda, params), cfg, cuda(tokens),
                      cuda(memory))
        torch.cuda.synchronize()
        counts = _attention_counts()
        want = 2 * attention_calls(cfg)        # the forward and prefill
        if counts != {"all": want, "sm90": 0, "f32": want}:
            raise AssertionError(f"serve 12a {arch}: attention launches "
                                 f"{counts}, expected {want} on the f32 "
                                 f"kernel (once an attention call of the "
                                 f"forward and the prefill, none a decode "
                                 f"step)")
        launched += counts["f32"]
        errs = {"forward": _rel_err(gpu["full"], cpu["full"]),
                "prefill": _rel_err(gpu["last"], cpu["last"]),
                "caches": max((_rel_err(g, c) for g, c in
                               zip(gpu["caches"], cpu["caches"])),
                              default=0.0),
                "decode": max(_rel_err(g, c) for g, c in
                              zip(gpu["steps"], cpu["steps"]))}
        tol = SERVE_TOL.get(arch, SERVE_DEFAULT_TOL)
        full = gpu["full"].float().cpu()
        gaps = [(gpu["last"][:, 0], full[:, s - 1])] + [
            (st[:, 0], full[:, s + j]) for j, st in enumerate(gpu["steps"])]
        consistent = all(torch.allclose(a.float().cpu(), w,
                                        atol=SERVE_CONSISTENCY,
                                        rtol=SERVE_CONSISTENCY)
                         for a, w in gaps)
        log(f"[serve 12a] {cfg.name} ({cfg.family}): CUDA vs CPU "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f" (limit {tol:g} of max |CPU|); {counts['f32']} f32 "
            f"attention launches; prefill / decode consistent with the "
            f"forward within {SERVE_CONSISTENCY:g}: {consistent}")
        if max(errs.values()) > tol or not consistent:
            raise AssertionError(f"serve 12a {cfg.name}: CUDA != CPU "
                                 f"({errs}) or prefill / decode "
                                 f"inconsistent ({consistent})")
    return launched


@contextlib.contextmanager
def model_attention(wrap):
    """The model's attention (``models.blocks.attention``) replaced by
    ``wrap(real attention)`` inside the block."""
    from repro_torch.models import blocks
    real = blocks.attention
    blocks.attention = wrap(real)
    try:
        yield
    finally:
        blocks.attention = real


def faulty(fault: str):
    """A wrapper with one fault: "causal off" drops the causal mask; "kv
    head h % KV" lets query head h read KV head h % KV in place of
    h // (H/KV)."""
    def wrap(real):
        def wrong(q, k, v, *, causal=True, **kw):
            if fault == "causal off":
                causal = False
            else:
                heads = torch.arange(q.shape[2], device=q.device) % k.shape[2]
                k, v = k[:, :, heads], v[:, :, heads]
            return real(q, k, v, causal=causal, **kw)
        return wrong
    return wrap


def recording(calls: list):
    """A wrapper that keeps every call's (q, k, v, causal, window)."""
    def wrap(real):
        def kept(q, k, v, *, causal=True, window=0, **kw):
            calls.append((q, k, v, causal, window))
            return real(q, k, v, causal=causal, window=window, **kw)
        return kept
    return wrap


def device_profile(label: str, fn) -> str:
    """``fn()`` once under torch.profiler: its kernels' device time against
    its wall (busy share), and the attention kernel's share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    if total <= 0:
        return f"{label}: device time not measured (no kernels seen)"
    attn = [e for e in kernels if "flash_attention" in e.key]
    attn_ms = sum(e.self_device_time_total for e in attn) / 1e3
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"[serve 12b] {label}: {e.self_device_time_total / 1e3:9.3f} ms"
            f" {e.count:5d} launches  {e.key[:80]}")
    launches = sum(e.count for e in kernels)
    return (f"{label}: {total:.3f} ms of kernels ({launches} launches) in "
            f"{wall * 1e3:.3f} ms under the profiler "
            f"({total / wall / 1e3:.1%} busy); attention "
            f"{sum(e.count for e in attn)} launches, {attn_ms:.3f} ms, "
            f"{attn_ms / total:.2%} of the kernel time")


def check_model_attention(calls) -> None:
    """The bf16 kernel on every attention call of a served prefill, its
    own q, k, v, against an f64 oracle (``mha_reference`` on the inputs
    in f64) beside its plain version (``mha_reference``: f32 scores,
    output in bf16), the "P in bf16" control and SDPA: entries
    over phase 7's bf16 tolerance, summed over the calls. The kernel must
    have no more than its plain version, and the "P in bf16" control more
    than the kernel. (Scores reach several hundred here, so rows whose
    two best keys nearly tie turn an f32 score's rounding into more than
    that tolerance: the plain version, held to the f64 oracle, breaks it
    too.)"""
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import mha_reference
    atol, rtol = ATTN_TOL[torch.bfloat16]
    names = ("kernel", "plain version", "control: P in bf16", "SDPA")
    over = dict.fromkeys(names, 0)
    worst = dict.fromkeys(names, 0.0)
    for q, k, v, causal, window in calls:
        q, k, v = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        want = mha_reference(q.double(), k.double(), v.double(),
                             causal=causal, window=window)
        outs = {"kernel": ops.flash_attention(q, k, v, causal=causal,
                                              window=window),
                "plain version": mha_reference(q, k, v, causal=causal,
                                               window=window),
                "control: P in bf16": attention_control(q, k, v, window,
                                                        "P in bf16")}
        if causal and not window:
            outs["SDPA"] = F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)
        for name, got in outs.items():
            diff = (got.double() - want).abs()
            over[name] += int((diff > atol + rtol * want.abs()).sum())
            worst[name] = max(worst[name], float(diff.max()))
        del want, outs
    log(f"[serve 12b] attention on the served prefill's own q, k, v "
        f"({len(calls)} calls, q {tuple(calls[0][0].shape)} each) against "
        f"an f64 oracle, entries over atol {atol:g} rtol {rtol:g} (max "
        f"|err|): " + ", ".join(f"{n} {over[n]} ({worst[n]:.3e})"
                                for n in names))
    if over["kernel"] > over["plain version"] or not (
            over["control: P in bf16"] > over["kernel"]):
        raise AssertionError(f"serve 12b: on the model's inputs the kernel "
                             f"must read no further from the f64 oracle "
                             f"than its plain version, and the control "
                             f"further: {over}")


def _model_shape_attention(cfg, dev) -> dict:
    """The bf16 kernel at the model's prefill shape, beside its plain
    version, SDPA and its bound."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import mha_reference
    b, plen, _ = SERVE_SHAPE
    h, kv = cfg.n_heads, cfg.n_kv_heads
    shape = (b, h, kv, plen, plen, cfg.resolved_head_dim)
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED)
    sets = input_sets(attn_inputs(shape, torch.bfloat16, gen),
                      lambda: attn_inputs(shape, torch.bfloat16, gen))
    k_t = graph_ms(lambda q, k, v: ops.flash_attention(q, k, v,
                                                       causal=True), sets)
    p_t = graph_ms(lambda q, k, v: mha_reference(q, k, v, causal=True),
                   sets, len(sets), replays=1, windows=3)
    sdpa, expand = sdpa_fn(plen, plen, 0, h // kv)
    l_t = graph_ms(sdpa, [(q, expand(k), expand(v)) for q, k, v in sets])
    bnd = attn_bound(shape, torch.bfloat16, 0)
    ms = median(k_t)
    log(f"[serve 12b] flash_attention at the model's prefill shape "
        f"(B,H,KV,Sq,Skv,D)={shape} bf16 causal: {ms * 1e3:.2f} us/call "
        f"median of {len(k_t)} windows (min {k_t[0] * 1e3:.2f}, max "
        f"{k_t[-1] * 1e3:.2f}); SDPA {median(l_t) * 1e3:.2f} us; plain "
        f"torch {median(p_t) * 1e3:.2f} us; bound {bnd['bound_ms'] * 1e3:.2f}"
        f" us by {bnd['bound_by']} ({bnd['flops'] / 1e9:.2f} GFLOP, "
        f"{bnd['moved'] / 1e6:.1f} MB), {bnd['bound_ms'] / ms:.1%} of it; "
        f"{len(sets)} input sets")
    del sets
    return dict(model_ms=ms, model_library_ms=median(l_t),
                model_plain_ms=median(p_t), model_bound_ms=bnd["bound_ms"])


def _twin(cfg, params, toks, what: str) -> float:
    """The forward on CUDA and on the CPU (f32, scan) on the same weights,
    each beside an f64 run on CUDA; returns max |CUDA - CPU| / max
    |logit|."""
    from repro_torch.models import model as M
    from repro_torch.tree_util import tree_map
    dev = next(iter(params["embed"].values())).device
    t0 = time.perf_counter()
    gpu = M.forward(params, cfg, toks.to(dev), impl="scan")[0].cpu()
    t1 = time.perf_counter()
    f64 = M.forward(tree_map(lambda a: a.double(), params),
                    dataclasses.replace(cfg, dtype="float64"), toks.to(dev),
                    impl="scan")[0].cpu()
    t2 = time.perf_counter()
    cpu = M.forward(tree_map(lambda a: a.cpu(), params), cfg, toks,
                    impl="scan")[0]
    t3 = time.perf_counter()
    err = _rel_err(gpu, cpu)
    log(f"[serve 12b] twin ({what}): {cfg.name} at full width, "
        f"{cfg.n_layers} layers, f32, impl scan, B {toks.shape[0]} x "
        f"{toks.shape[1]}: CUDA vs CPU max |difference| / max |logit| "
        f"{err:.3e} (limit {SERVE_TWIN_TOL:g}); against f64: CUDA "
        f"{_rel_err(gpu, f64):.3e}, CPU {_rel_err(cpu, f64):.3e}; max "
        f"|logit| {float(cpu.abs().max()):.4f}; CUDA {t1 - t0:.3f} s, f64 "
        f"{t2 - t1:.3f} s, CPU with the copy {t3 - t2:.3f} s")
    return err


def serve_full_phase(dev) -> dict:
    """12b. Returns the bf16 attention kernel's launches in the served
    run and its numbers at the model's shape."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models.params import count_params
    from repro_torch.tree_util import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    cfg = get_config(SERVE_ARCH)
    b, plen, n_gen = SERVE_SHAPE
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = M.init_model(
        cfg, torch.Generator(device=dev).manual_seed(SERVE_SEED), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = count_params(M.model_defs(cfg))
    log(f"[serve 12b] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads} heads ({cfg.n_kv_heads} kv, head "
        f"{cfg.resolved_head_dim}), d_ff {cfg.d_ff}, vocab {cfg.vocab}: "
        f"{n:,} parameters in {cfg.param_dtype} "
        f"({torch.cuda.memory_allocated() - held:,} bytes on the card), "
        f"compute {cfg.dtype}; init {init_s:.3f} s (seeded CUDA "
        f"generator); {held:,} bytes held before")
    data = SyntheticTokens(vocab=cfg.vocab, seq_len=plen, global_batch=b,
                           seed=3)
    prompts = torch.from_numpy(data.batch_at(0)["tokens"]).to(dev)
    layers = attention_calls(cfg)

    # the main path: counts zeroed just before, read just after
    _zero_attention_counts()
    out = serve.generate(params, cfg, prompts, n_gen)
    counts = _attention_counts()
    peak = torch.cuda.max_memory_allocated()
    if counts != {"all": layers, "sm90": layers, "f32": 0}:
        raise AssertionError(f"serve 12b: attention launches {counts} in "
                             f"the served run, expected {layers} on the "
                             f"bf16 kernel (one a layer of the prefill, "
                             f"none a decode step)")
    if out.tokens.shape != (b, n_gen + 1) or not (
            (out.tokens >= 0) & (out.tokens < cfg.vocab)).all():
        raise AssertionError(f"serve 12b: tokens {out.tokens.shape} out of "
                             f"shape or range")
    log(f"[serve 12b] served B {b} x {plen} -> {n_gen} tokens (cold): "
        f"prefill {out.prefill_s:.4f} s, decode {out.steady_s * 1e3:.3f} "
        f"ms/step (steps 2-{n_gen}; first {out.step_s[0] * 1e3:.3f} ms), "
        f"{b / out.steady_s:.1f} tok/s aggregate; peak device memory "
        f"{peak:,} bytes ({peak / 2**30:.2f} GiB); flash_attention "
        f"launches {counts['sm90']} in the run ({layers} layers: "
        f"{counts['sm90'] / layers:g} a prefill layer, 0 a decode step)")
    warm = serve.generate(params, cfg, prompts, n_gen)
    measured = dict(prefill_s=warm.prefill_s, peak=peak)
    if not np.array_equal(warm.tokens, out.tokens):
        raise AssertionError("serve 12b: a second run gave other tokens")
    log(f"[serve 12b] again (warm): prefill {warm.prefill_s:.4f} s, decode "
        f"{warm.steady_s * 1e3:.3f} ms/step, {b / warm.steady_s:.1f} tok/s "
        f"aggregate; the same tokens")

    def last_logits(c, impl=None):
        return M.prefill(params, c, prompts, impl=impl)[0][:, -1].float()

    calls = []
    _zero_attention_counts()
    with model_attention(recording(calls)):
        kern = last_logits(cfg)
    torch.cuda.synchronize()
    if _attention_counts()["sm90"] != layers or len(calls) != layers:
        raise AssertionError("serve 12b: the kernel-route prefill did not "
                             "launch the kernel once a layer")
    check_model_attention(calls)
    del calls
    plain = last_logits(cfg, "scan")
    oracle = last_logits(dataclasses.replace(cfg, dtype="float32"), "scan")

    def err(x):
        return float((x - oracle).abs().max() / oracle.abs().max())

    errs = {"kernel route": err(kern), "plain route (scan, bf16)":
            err(plain)}
    for fault in SERVE_CONTROLS:
        with model_attention(faulty(fault)):
            errs[f"control: {fault}"] = err(last_logits(cfg))
    log(f"[serve 12b] last-position logits against the f32 oracle (the "
        f"same weights, dtype float32, impl scan, TF32 off; max |logit| "
        f"{float(oracle.abs().max()):.4f}), max |difference| / max "
        f"|logit|: " + ", ".join(f"{k} {v:.4e}" for k, v in errs.items())
        + f"; argmax agreement with the oracle: kernel "
        f"{int((kern.argmax(-1) == oracle.argmax(-1)).sum())}/{b}, plain "
        f"{int((plain.argmax(-1) == oracle.argmax(-1)).sum())}/{b}")
    k_err = errs["kernel route"]
    if k_err > errs["plain route (scan, bf16)"] or not all(
            errs[f"control: {f}"] > k_err for f in SERVE_CONTROLS):
        raise AssertionError(f"serve 12b: the kernel route must read no "
                             f"further from the f32 oracle than the plain "
                             f"route, and every control further: {errs}")
    del kern, plain, oracle
    log("[serve 12b] " + device_profile(
        "prefill", lambda: M.prefill(params, cfg, prompts,
                                     cache_len=plen + n_gen)))
    _, caches = M.prefill(params, cfg, prompts, cache_len=plen + n_gen)
    tok = prompts[:, -1:]
    log("[serve 12b] " + device_profile(
        "decode step", lambda: M.decode_step(params, cfg, caches, tok,
                                             plen)))
    twin_p = tree_map(lambda a: a[:SERVE_TWIN[0]].clone(),
                      params["segments"][0])
    twin_p = {"embed": params["embed"], "segments": [twin_p]}
    del params, caches
    gc.collect()
    torch.cuda.empty_cache()
    row = _model_shape_attention(cfg, dev)

    # the twin: the served weights' first layers (full width, SERVE_TWIN's
    # depth), f32, plain, CUDA vs CPU; then the same depth drawn afresh
    # at n_layers = 2, whose stacked leaves' std is scale / sqrt(2)
    layers2, b2, s2 = SERVE_TWIN
    cfg2 = dataclasses.replace(cfg, n_layers=layers2, dtype="float32")
    toks = torch.from_numpy(SyntheticTokens(
        vocab=cfg.vocab, seq_len=s2, global_batch=b2,
        seed=3).batch_at(0)["tokens"])
    twin = _twin(cfg2, twin_p, toks, "the served weights' first layers")
    del twin_p
    gc.collect()
    torch.cuda.empty_cache()
    drawn = M.init_model(
        cfg2, torch.Generator(device=dev).manual_seed(SERVE_SEED + 1), dev)
    _twin(cfg2, drawn, toks, "drawn afresh at n_layers = 2 (std scale / "
          "sqrt(2)), logged, not held to the limit")
    del drawn
    gc.collect()
    torch.cuda.empty_cache()
    if not twin <= SERVE_TWIN_TOL:
        raise AssertionError(f"serve 12b twin: CUDA != CPU ({twin:.3e})")
    return dict(model=row, launches=counts["sm90"], measured=measured)


def serve_phase(dev) -> dict:
    """Phase 12: returns the attention launches of its runs by kernel and
    the bf16 kernel's numbers at the model's shape."""
    t0 = time.perf_counter()
    f32 = serve_smoke_phase(dev)
    log(f"[time] 12a serving, every family {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    full = serve_full_phase(dev)
    log(f"[time] 12b serving {SERVE_ARCH} {time.perf_counter() - t0:.1f} s")
    return dict(full, launches_f32=f32)


# ------------------------------------------------------------ phase 13
# phase 13, the training path. 13a: every config at .smoke() (f32, remat
# on; MoE at capacity 8 so that nothing drops), TRAIN_SMOKE = (batch,
# tokens): two build_train_step steps on CUDA (attention on the f32
# kernel; warmup 1, so that the second step moves the weights) against
# the CPU on the same weights; the kernel route's dQ, dK,
# dV on the model's own q, k, v, dO against the scan route's; the
# launcher on CUDA (ddp, PICSOU, EF-int8, a (2, 2, 2) mesh) and a
# restart. 13b: granite-8b at full width, its depth cut to TRAIN_LAYERS
# of 36 (the training state of 36 layers, 16 B a parameter, is 132 GB),
# sequence TRAIN_SEQ (train_4k), global batch TRAIN_BATCH (train_4k's
# 256 cut to one card), on the mesh TRAIN_MESH, TRAIN_STEPS steps of each
# mode from one seeded init; its twin, the first layer in f32 at
# TRAIN_TWIN = (batch, tokens), CUDA against the CPU
TRAIN_ARCH_FULL = "granite-8b"
TRAIN_SEED = 25
TRAIN_SMOKE = (2, 18)
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 4, 4096, 4, 4
TRAIN_MESH = "2x2x1"
TRAIN_TWIN = (1, 128)
# CUDA against the CPU, max |difference| over the leaf's max |CPU value|:
# for the gradients, and for m and v after the second step (they carry
# the step), each 1e-4 or where larger twice the CPU's own f32 distance
# from an f64 run of the same steps (two f32 runs, each that far from
# f64: the smoke models' conditioning, near one-hot softmaxes); v, which
# holds squares, at least twice m's limit. The parameters after the
# second step are logged beside that limit, not held: AdamW moves an
# entry whose gradient is f32 noise (a zero-init leaf such as rwkv6's w0
# or qwen2's key bias) by up to lr on either device, whatever its size;
# the card's update itself is held on the CPU's inputs (below). The
# kernel route's dQ, dK, dV against the scan route's: 1e-6 of each
# one's max; a backward
# recomputed with the causal mask off must break it; its outputs at most
# TRAIN_OUT_RATIO times as far from an f64 oracle as the plain version's
# (max |difference| / max |oracle|). At the models' scores (hundreds) the
# rounding of a score alone moves outputs past phase 7's tolerance
# (breaches logged for both), and the f32 kernel's three TF32 passes keep
# 22 bits of a product against f32's 24: up to 4x the plain version's
# error, by design. On every f32 call the plain version on q, k, v
# rounded to bf16 (a forward of lower precision) must break that ratio;
# on q, k, v truncated to 20 mantissa bits its ratio is logged.
# Losses: PICSOU against ATA 1e-4, pjit against ddp 5e-2 (the JAX tests'
# tests/test_system.py), ddp with EF-int8 against ddp without 5e-2 and
# above 0 (the compressor ran; int8 moves each gradient entry by at most
# max |leaf| / 254 a step, error feedback carrying the rest forward), a
# restart against the uninterrupted run 2e-3
# The card's AdamW update on the CPU's own moving-step inputs (carried
# across): parameters, m and v within 1e-6 of a leaf's largest |CPU
# value|, phase 11c's limit (elementwise f32 arithmetic beside one global
# norm summed in another order); the same update with beta2 0.999 for
# 0.95 must break it on the parameters and on v
TRAIN_UPDATE_TOL = 1e-6
TRAIN_UPDATE_FAULT_B2 = 0.999
TRAIN_TOL = 1e-4
TRAIN_GRAD_TOL = 1e-6
TRAIN_SYNC_TOL = 1e-4
TRAIN_MODE_TOL = 5e-2
TRAIN_RESTART_TOL = 2e-3
TRAIN_OUT_RATIO = 4
TRAIN_MODES = {"pjit": dict(mode="pjit"),
               "ddp picsou": dict(mode="ddp", sync="picsou"),
               "ddp ata": dict(mode="ddp", sync="ata"),
               "ddp picsou compress": dict(mode="ddp", sync="picsou",
                                           compress=True)}
# the step's device ranges the port marks (torch.profiler.record_function)
TRAIN_RANGES = ("attention.scan_backward", "train.adamw", "train.sync",
                "train.ef_int8", "train.value_and_grad")


def train_launches(cfg) -> int:
    """Attention kernel launches of one training step: once an attention
    call, twice in a layer of a stacked segment under remat (its forward
    runs again in the backward)."""
    from repro_torch.models.model import encoder_plan, layer_plan
    per = {"rwkv": 0, "dec": 2}
    return sum(s.count * per.get(s.kind, 1)
               * (2 if cfg.remat and s.count > 1 else 1)
               for s in layer_plan(cfg) + encoder_plan(cfg))


def _rel64(got, want) -> float:
    """max |got - want| / max |want| in f64, on ``want``'s device."""
    want = want.detach().double()
    got = got.detach().to(want.device).double()
    return float((got - want).abs().max() / want.abs().max().clamp(
        min=1e-300))


def _train_args(**kw):
    import argparse
    base = dict(arch="granite-8b-smoke", steps=TRAIN_STEPS, seq=32, batch=8,
                mesh="2x2", mode="pjit", sync="picsou", compress=False,
                ckpt_dir="", ckpt_every=10, restore=False, seed=TRAIN_SEED,
                lr=3e-4, layers=0, device="cuda")
    base.update(kw)
    return argparse.Namespace(**base)


def _smoke_train_inputs(cfg, i: int, dev):
    b, s = TRAIN_SMOKE
    rng = np.random.default_rng(TRAIN_SEED + i)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (b, s)).astype(np.int32))}
    if cfg.family in ("encdec", "vlm"):
        n = cfg.encoder_seq if cfg.family == "encdec" else cfg.vision_seq
        batch["frames" if cfg.family == "encdec" else "memory"] = (
            torch.from_numpy(rng.standard_normal(
                (b, n, cfg.d_model)).astype(np.float32)))
    return {k: v.to(dev) for k, v in batch.items()}


@contextlib.contextmanager
def recording_update(calls: list):
    """``launch.steps.train_update``, the update ``build_train_step``'s
    step makes after its gradients, keeping each call's arguments."""
    from repro_torch.launch import steps
    real = steps.train_update

    def kept(*args):
        calls.append(args)
        return real(*args)
    steps.train_update = kept
    try:
        yield
    finally:
        steps.train_update = real


def _train_steps_on(cfg, params, batch, dev, counted: list, moving=None):
    """value_and_grad, then two build_train_step steps from a fresh AdamW
    state with warmup 1 (the lr scale is 0 at step 0 and whole at step 1),
    on ``dev``: (loss, {"grads", "params", "m", "v": leaves}). The steps'
    attention launches are appended to ``counted``, and the arguments of
    the second (moving) step's update to ``moving`` when given."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import steps
    from repro_torch.optim import adamw_init
    from repro_torch.tree_util import tree_leaves, tree_map
    p = tree_map(lambda a: a.to(dev), params)
    b = {k: v.to(dev) for k, v in batch.items()}
    (loss, _), grads = steps.value_and_grad(p, cfg, b)
    tokens = b["tokens"]
    bundle = steps.build_train_step(
        cfg, tmesh.parse_mesh("1x1", dev),
        ShapeSpec("train", tokens.shape[1], tokens.shape[0], "train"),
        warmup=1, total_steps=10)
    _zero_attention_counts()
    p1, s1, _ = bundle(p, adamw_init(p), b)
    with recording_update([] if moving is None else moving):
        p2, s2, _ = bundle(p1, s1, b)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    counted.append(_attention_counts())
    return float(loss), {"grads": tree_leaves(grads),
                         "params": tree_leaves(p2), "m": tree_leaves(s2.m),
                         "v": tree_leaves(s2.v)}


def card_update(args, dev, **faults) -> dict:
    """``train_update`` on ``dev`` on the arguments ``args`` of a recorded
    call (carried there), its config changed by ``faults``:
    {"params", "m", "v": leaves}."""
    from repro_torch.launch import steps
    from repro_torch.tree_util import tree_leaves, tree_map
    opt_cfg, grads, params, state, warmup, total = args
    p, s = steps.train_update(
        dataclasses.replace(opt_cfg, **faults),
        *(tree_map(lambda a: a.to(dev), t) for t in (grads, params, state)),
        warmup, total)
    return {"params": tree_leaves(p), "m": tree_leaves(s.m),
            "v": tree_leaves(s.v)}


def hold_update(args, want: dict, dev, what: str) -> str:
    """The card's AdamW update in the training step, held: the CPU's
    moving step's update arguments (its gradients, the parameters and
    AdamW state of the step before) carried to the card through the same
    call, and the parameters, m and v, leaf by leaf, within
    TRAIN_UPDATE_TOL of the leaf's largest |CPU value| of the CPU step's
    own. The control, the update with beta2 = TRAIN_UPDATE_FAULT_B2, must
    break the limit on the parameters and on v."""
    errs = {}
    for label, faults in (("update", {}),
                          ("control", dict(b2=TRAIN_UPDATE_FAULT_B2))):
        got = card_update(args, dev, **faults)
        errs[label] = {key: max(_rel64(g, w) for g, w in zip(got[key],
                                                              want[key]))
                       for key in ("params", "m", "v")}
    if max(errs["update"].values()) > TRAIN_UPDATE_TOL or not min(
            errs["control"]["params"], errs["control"]["v"]) > \
            TRAIN_UPDATE_TOL:
        raise AssertionError(f"train 13a {what}: the card's AdamW update "
                             f"must hold the CPU's within "
                             f"{TRAIN_UPDATE_TOL:g} and its control break "
                             f"it on the parameters and v: {errs}")
    return (", ".join(f"{k} {e:.3e}" for k, e in errs["update"].items())
            + f" (limit {TRAIN_UPDATE_TOL:g}); control beta2 "
            f"{TRAIN_UPDATE_FAULT_B2}: "
            + ", ".join(f"{k} {e:.3e}" for k, e in errs["control"].items()))


def recording_grads(calls: list):
    """A wrapper of the model's attention that keeps every call's q, k, v,
    masks and blocks and, through a hook on its output, its output
    gradient dO."""
    def wrap(real):
        def kept(q, k, v, *, causal=True, window=0, **kw):
            out = real(q, k, v, causal=causal, window=window, **kw)
            entry = dict(q=q.detach(), k=k.detach(), v=v.detach(),
                         causal=causal, window=window,
                         blocks=dict(block_q=kw.get("block_q", 512),
                                     block_kv=kw.get("block_kv", 1024)))
            calls.append(entry)
            if out.requires_grad:
                out.register_hook(
                    lambda g, e=entry: e.__setitem__("do", g.detach()))
            return out
        return kept
    return wrap


def check_route_grads(calls, what: str) -> dict:
    """On each recorded call's own q, k, v, dO: the kernel route's dQ, dK,
    dV (its forward on the kernel, counted apart from the main path)
    against the scan route's, within TRAIN_GRAD_TOL of each one's max;
    its output at most TRAIN_OUT_RATIO times as far from an f64 oracle as
    the plain version's (entries over phase 7's tolerance logged for both:
    the
    models' scores are large enough that the plain version's own f32
    rounding breaks it); and the faulty control, a backward recomputed
    with the causal mask off, on every causal call, which must break the
    limit."""
    from repro_torch.kernels.ref import mha_reference
    from repro_torch.models.attention import attention, scan_backward
    out = dict(calls=0, exact=0, worst=0.0, over=0, plain_over=0,
               out_err=0.0, plain_err=0.0, ratio=0.0, control=[],
               low_ratio=[], trunc_ratio=[])
    for c in calls:
        if "do" not in c:
            continue
        q, k, v, do = c["q"], c["k"], c["v"], c["do"]
        kw = dict(causal=c["causal"], window=c["window"], **c["blocks"])
        grads, outs = {}, {}
        for impl in (None, "scan"):
            xs = [x.clone().requires_grad_() for x in (q, k, v)]
            outs[impl] = attention(*xs, impl=impl, **kw)
            grads[impl] = torch.autograd.grad(outs[impl], xs, do)
        errs = [_rel64(a, b) for a, b in zip(grads[None], grads["scan"])]
        out["calls"] += 1
        out["exact"] += all(torch.equal(a, b) for a, b in
                            zip(grads[None], grads["scan"]))
        out["worst"] = max(out["worst"], max(errs))
        atol, rtol = ATTN_TOL[q.dtype]
        qkv = [x.transpose(1, 2) for x in (q, k, v)]
        mask = dict(causal=c["causal"], window=c["window"])
        want = mha_reference(*(x.double() for x in qkv), **mask)
        lim = atol + rtol * want.abs()
        errs = {}
        for key, got in (("over", outs[None].detach().transpose(1, 2)),
                         ("plain_over", mha_reference(*qkv, **mask))):
            diff = (got.double() - want).abs()
            out[key] += int((diff > lim).sum())
            errs[key] = float(diff.max() / want.abs().max())
        out["out_err"] = max(out["out_err"], errs["over"])
        out["plain_err"] = max(out["plain_err"], errs["plain_over"])
        out["ratio"] = max(out["ratio"], errs["over"] / max(
            errs["plain_over"], 1e-12))
        if q.dtype == torch.float32:
            # controls: q, k, v rounded to bf16 (must break the ratio),
            # and truncated to 20 of f32's 23 mantissa bits (logged: how
            # fine a loss of precision the ratio resolves)
            for key, cut in (("low_ratio", lambda x: x.to(torch.bfloat16)
                              .float()),
                             ("trunc_ratio", lambda x: (x.view(torch.int32)
                                                        & ~7).view(
                                                            torch.float32))):
                low = mha_reference(*(cut(x) for x in qkv), **mask)
                out[key].append(float(
                    (low.double() - want).abs().max() / want.abs().max())
                    / max(errs["plain_over"], 1e-12))
        if c["causal"]:
            bad = scan_backward(q, k, v, do, **dict(kw, causal=False))
            out["control"].append(max(_rel64(a, b) for a, b in
                                      zip(bad, grads["scan"])))
        del grads, outs
    if not out["calls"] or not out["control"] or out["worst"] > \
            TRAIN_GRAD_TOL or out["ratio"] > TRAIN_OUT_RATIO or not min(
                out["control"]) > TRAIN_GRAD_TOL or not all(
                    r > TRAIN_OUT_RATIO for r in out["low_ratio"]):
        raise AssertionError(f"train {what}: the kernel route's gradients "
                             f"must be the scan route's within "
                             f"{TRAIN_GRAD_TOL:g}, its outputs at most "
                             f"{TRAIN_OUT_RATIO}x as far from f64 as the "
                             f"plain version's, and every control break "
                             f"its limit: {out}")
    return out


def train_smoke_phase(dev) -> int:
    """13a. Returns the f32 attention kernel's launches in its main-path
    runs (the train steps and the launcher's)."""
    import tempfile

    from repro_torch.configs import get_config, list_configs
    from repro_torch.launch import steps, train
    from repro_torch.models import model as M
    from repro_torch.tree_util import tree_map
    cpu = torch.device("cpu")
    t_start = time.perf_counter()
    launched = 0
    route = dict(calls=0, exact=0, worst=0.0, over=0, plain_over=0,
                 ratio=0.0, control=[], low_ratio=[], trunc_ratio=[])
    bad = {}
    for i, arch in enumerate(list_configs()):
        cfg = dataclasses.replace(get_config(arch).smoke(), remat=True)
        if cfg.family == "moe":
            cfg = dataclasses.replace(cfg, capacity_factor=8.0)
        params = M.init_model(cfg, TRAIN_SEED + i, device="cpu")
        batch = _smoke_train_inputs(cfg, i, cpu)
        counted, moving = [], []
        loss_c, want_c = _train_steps_on(cfg, params, batch, cpu, counted,
                                         moving)
        loss_g, got_g = _train_steps_on(cfg, params, batch, dev, counted)
        want = 2 * train_launches(cfg)
        if counted[-1] != {"all": want, "sm90": 0, "f32": want}:
            raise AssertionError(f"train 13a {arch}: attention launches "
                                 f"{counted[-1]} in two steps, expected "
                                 f"{want} on the f32 kernel")
        launched += want
        # (remat off: the same values, one forward less)
        _, want64 = _train_steps_on(
            dataclasses.replace(cfg, dtype="float64", remat=False),
            tree_map(lambda a: a.double(), params),
            {k: v if k == "tokens" else v.double() for k, v in batch.items()},
            cpu, [])
        errs = {"loss": (abs(loss_g - loss_c) / abs(loss_c), TRAIN_TOL)}
        for key, leaves in want_c.items():
            own = max(_rel64(a, b) for a, b in zip(leaves, want64[key]))
            errs[key] = (max(_rel64(a, b) for a, b in zip(got_g[key],
                                                         leaves)),
                         max(TRAIN_TOL, 2 * own))
        # v holds squares: an error of a gradient entry doubles there
        errs["v"] = (errs["v"][0], max(errs["v"][1], 2 * errs["m"][1]))
        update = hold_update(moving[0], want_c, dev, arch)
        # the model's own attention calls, remat off so that each output
        # is the one the backward differentiates
        calls = []
        with model_attention(recording_grads(calls)):
            steps.value_and_grad(
                tree_map(lambda a: a.to(dev), params),
                dataclasses.replace(cfg, remat=False),
                {k: v.to(dev) for k, v in batch.items()})
        got = check_route_grads(calls, arch) if calls else None
        if got:
            for key in ("calls", "exact", "over", "plain_over"):
                route[key] += got[key]
            route["worst"] = max(route["worst"], got["worst"])
            route["ratio"] = max(route["ratio"], got["ratio"])
            route["control"] += got["control"]
            route["low_ratio"] += got["low_ratio"]
            route["trunc_ratio"] += got["trunc_ratio"]
        log(f"[train 13a] {cfg.name} ({cfg.family}): CUDA vs CPU after "
            f"two steps (limit: 1e-4 or twice the CPU's f32 distance from "
            f"f64) " + ", ".join(f"{k} {e:.3e} ({'logged, ' * (k == 'params')}"
                                 f"limit {t:.3g})"
                                 for k, (e, t) in errs.items())
            + f"; the card's AdamW update on the CPU's moving-step "
            f"inputs against the CPU's: {update}"
            + f"; {want} f32 attention launches in two steps"
            + (f"; kernel route vs scan route on {got['calls']} calls' own "
               f"q, k, v, dO: max {got['worst']:.3e}, {got['exact']} bit "
               f"for bit" if got else ""))
        if any(e > t for k, (e, t) in errs.items() if k != "params"):
            bad[arch] = errs
    if bad:
        raise AssertionError(f"train 13a: CUDA != CPU: {bad}")
    log(f"[train 13a] kernel route's dQ, dK, dV against the scan route's "
        f"on the models' own q, k, v, dO: {route['calls']} calls, "
        f"{route['exact']} bit for bit (the backward replays the scan one "
        f"query block at a time, summing dK, dV in the order autograd "
        f"does), max {route['worst']:.3e} of each one's max (limit "
        f"{TRAIN_GRAD_TOL:g}); outputs against an f64 oracle: the kernel's "
        f"max |difference| at most {route['ratio']:.3f}x the plain "
        f"version's on a call (limit {TRAIN_OUT_RATIO}; the plain version "
        f"on q, k, v rounded to bf16, the control: "
        f"{min(route['low_ratio']):.1f}x to {max(route['low_ratio']):.1f}x "
        f"on {len(route['low_ratio'])} calls, every one over the limit; "
        f"on q, k, v truncated to 20 mantissa bits, logged: "
        f"{min(route['trunc_ratio']):.2f}x to "
        f"{max(route['trunc_ratio']):.2f}x, median "
        f"{median(sorted(route['trunc_ratio'])):.2f}x), "
        f"entries over phase 7's f32 "
        f"tolerance: kernel {route['over']}, plain version "
        f"{route['plain_over']}; control (backward "
        f"with the causal mask off) on {len(route['control'])} causal "
        f"calls: min {min(route['control']):.3e}, every one over the limit")

    log(f"[time] 13a every config {time.perf_counter() - t_start:.1f} s")
    # the launcher, as a user runs it: ddp, PICSOU, EF-int8, (2, 2, 2)
    argv = ["--arch", "granite-8b-smoke", "--steps", "6", "--mesh", "2x2x2",
            "--mode", "ddp", "--sync", "picsou", "--compress", "--seq",
            "32", "--device", "cuda"]
    _zero_attention_counts()
    losses = train.main(argv)
    torch.cuda.synchronize()
    n = _attention_counts()["f32"]
    cfg = get_config("granite-8b-smoke")
    if not all(math.isfinite(x) for x in losses) or n != 6 * \
            train_launches(cfg):
        raise AssertionError(f"train 13a: launcher losses {losses}, "
                             f"{n} launches")
    launched += n
    log(f"[train 13a] python -m repro_torch.launch.train "
        f"{' '.join(argv)}: ce {', '.join(f'{x:.4f}' for x in losses)} "
        f"(finite), {n} f32 attention launches, "
        f"{np.median(losses.step_s[1:]) * 1e3:.1f} ms a warm step")
    # a restart: checkpoints every 4 steps, resumed after step 7, against
    # an uninterrupted 12-step run
    kw = dict(arch="starcoder2-3b-smoke", seq=32, mesh="2x2",
              ckpt_every=4)
    cfg = get_config("starcoder2-3b-smoke")
    with tempfile.TemporaryDirectory() as ckpt:
        _zero_attention_counts()
        train.run(_train_args(steps=8, ckpt_dir=ckpt, **kw))
        ref = train.run(_train_args(steps=12, **kw))
        resumed = train.run(_train_args(steps=4, ckpt_dir=ckpt,
                                        restore=True, **kw))
        torch.cuda.synchronize()
        n = _attention_counts()["f32"]
    gaps = [abs(a - b) for a, b in zip(ref[8:12], resumed)]
    log(f"[train 13a] restart after the step-7 checkpoint: steps 8-11 "
        f"{', '.join(f'{x:.5f}' for x in resumed)} against "
        f"{', '.join(f'{x:.5f}' for x in ref[8:12])} uninterrupted, max "
        f"gap {max(gaps):.3e} (limit {TRAIN_RESTART_TOL:g}); {n} f32 "
        f"attention launches")
    if len(resumed) != 4 or max(gaps) >= TRAIN_RESTART_TOL or n != 24 * \
            train_launches(cfg):
        raise AssertionError(f"train 13a: restart {resumed} vs "
                             f"{ref[8:12]}, {n} launches")
    return launched + n


def _model_flops(cfg, b: int, s: int) -> dict:
    """Product FLOPs of one training step: 6 per token and matmul
    parameter (forward 2, backward 4: every projection, the MLP and the
    unembedding; the embedding is a gather), and causal attention's two
    products, 2 * B * H * S^2 * D forward and twice that backward a
    layer. ``executed`` adds what this step computes beyond the model:
    remat's second forward of every layer, and the scan's backward, which
    recomputes the whole scan and computes masked blocks too."""
    from repro_torch.models import model as M
    from repro_torch.models.params import count_params
    n = count_params(M.model_defs(cfg))
    layer = n - 2 * cfg.vocab * cfg.d_model - cfg.d_model     # embed, ln_f
    layer_mm = layer - 2 * cfg.n_layers * cfg.d_model          # norms
    matmul = layer_mm + cfg.vocab * cfg.d_model                # + unembed
    t = b * s
    hd, h = cfg.resolved_head_dim, cfg.n_heads
    attn_fwd = 2 * b * h * s * s * hd                          # causal half
    model = 6 * matmul * t + 3 * attn_fwd * cfg.n_layers
    executed = (6 * matmul * t + 2 * layer_mm * t
                + cfg.n_layers * (2 + 6) * attn_fwd)
    return dict(params=n, matmul=matmul, model=model, executed=executed)


def train_profile(step) -> str:
    """``step()`` once under torch.profiler: kernel time against the wall
    (busy), and the shares of the kernel time of the GEMMs, the attention
    kernel, and the ranges the port marks (the plain attention backward,
    AdamW, the sync, EF-int8)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.key not in TRAIN_RANGES]
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    if total <= 0:
        return "device time not measured (no kernels seen)"

    def ms(pick):
        return sum(e.self_device_time_total for e in kernels
                   if pick(e.key)) / 1e3

    gemm = ms(lambda k: re.search(r"gemm|xmma|nvjet|cutlass", k, re.I)
              is not None and "flash_attention" not in k)
    attn = ms(lambda k: "flash_attention" in k)
    ranges = {e.key: e.device_time_total / 1e3 for e in events
              if e.key in TRAIN_RANGES and e.device_type == DeviceType.CPU}
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[train 13b] profile: {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:5d} launches  {e.key[:80]}")
    parts = [f"GEMMs {gemm:.3f} ms ({gemm / total:.1%})",
             f"the attention kernel {attn:.3f} ms ({attn / total:.2%})"]
    parts += [f"{name} {ranges[name]:.3f} ms ({ranges[name] / total:.1%})"
              if name in ranges else f"{name} not measured"
              for name in TRAIN_RANGES[:4]]
    launches = sum(e.count for e in kernels)
    return (f"{total:.3f} ms of kernels ({launches} launches) in "
            f"{wall * 1e3:.3f} ms under the profiler ({total / wall / 1e3:.1%}"
            f" busy): " + ", ".join(parts) + " (ranges hold the kernels "
            f"launched inside them, GEMMs included)")


def _train_shape_attention(cfg, dev) -> dict:
    """The bf16 kernel at the training step's shape, beside SDPA and its
    bound (the plain version's scores at this shape take 8.6 GB a call:
    not timed here; phase 7 times it at F1)."""
    from repro_torch.kernels import ops
    shape = (TRAIN_BATCH, cfg.n_heads, cfg.n_kv_heads, TRAIN_SEQ, TRAIN_SEQ,
             cfg.resolved_head_dim)
    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    sets = input_sets(attn_inputs(shape, torch.bfloat16, gen),
                      lambda: attn_inputs(shape, torch.bfloat16, gen))
    k_t = graph_ms(lambda q, k, v: ops.flash_attention(q, k, v,
                                                       causal=True),
                   sets, calls_per_graph=4, windows=3)
    sdpa, expand = sdpa_fn(TRAIN_SEQ, TRAIN_SEQ, 0, 1)
    l_t = graph_ms(sdpa, sets, calls_per_graph=4, windows=3)
    bnd = attn_bound(shape, torch.bfloat16, 0)
    ms = median(k_t)
    log(f"[train 13b] flash_attention at the training step's shape "
        f"(B,H,KV,Sq,Skv,D)={shape} bf16 causal: {ms:.4f} ms/call median "
        f"of {len(k_t)} windows (min {k_t[0]:.4f}, max {k_t[-1]:.4f}); "
        f"SDPA {median(l_t):.4f} ms; bound {bnd['bound_ms']:.4f} ms by "
        f"{bnd['bound_by']} ({bnd['flops'] / 1e12:.3f} TFLOP, "
        f"{bnd['moved'] / 1e6:.1f} MB), {bnd['bound_ms'] / ms:.1%} of it; "
        f"{len(sets)} input sets")
    del sets
    return dict(train_ms=ms, train_library_ms=median(l_t),
                train_bound_ms=bnd["bound_ms"])


def _train_twin(cfg, params, dev) -> None:
    """The first layer at full width in f32, scan, B x tokens of
    TRAIN_TWIN: value and grad on CUDA against the CPU, each leaf within
    TRAIN_TOL of its max, or within twice the CPU's own f32 distance from
    an f64 run (on CUDA) where that is larger."""
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch import steps
    from repro_torch.tree_util import tree_leaves, tree_map
    b, s = TRAIN_TWIN
    cfg1 = dataclasses.replace(cfg, n_layers=1, dtype="float32")
    twin = {"embed": params["embed"],
            "segments": [tree_map(lambda a: a[0], params["segments"][0])]}
    toks = torch.from_numpy(SyntheticTokens(
        vocab=cfg.vocab, seq_len=s, global_batch=b,
        seed=17).batch_at(0)["tokens"])
    t0 = time.perf_counter()
    (l_g, _), g_g = steps.value_and_grad(twin, cfg1, {"tokens": toks.to(dev)},
                                         impl="scan")
    g_g = tree_leaves(g_g)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    (_, _), g64 = steps.value_and_grad(
        tree_map(lambda a: a.double(), twin),
        dataclasses.replace(cfg1, dtype="float64"),
        {"tokens": toks.to(dev)}, impl="scan")
    g64 = tree_leaves(g64)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    (l_c, _), g_c = steps.value_and_grad(
        tree_map(lambda a: a.cpu(), twin), cfg1, {"tokens": toks},
        impl="scan")
    g_c = [g.to(dev) for g in tree_leaves(g_c)]       # compared on the card
    t3 = time.perf_counter()
    err = max(_rel64(a, b) for a, b in zip(g_g, g_c))
    own = max(_rel64(a, b) for a, b in zip(g_c, g64))
    tol = max(TRAIN_TOL, 2 * own)
    log(f"[train 13b] twin: the first layer at full width, f32, impl scan, "
        f"B {b} x {s}: loss CUDA {float(l_g):.6f}, CPU {float(l_c):.6f}; "
        f"gradients CUDA vs CPU max {err:.3e} of each leaf's max (limit "
        f"{tol:.3g}: 1e-4 or twice the CPU's f32 distance from f64); "
        f"against "
        f"f64: CPU {own:.3e}, CUDA "
        f"{max(_rel64(a, b) for a, b in zip(g_g, g64)):.3e}; CUDA "
        f"{t1 - t0:.3f} s, f64 {t2 - t1:.3f} s, CPU with the copy "
        f"{t3 - t2:.3f} s")
    if err > tol:
        raise AssertionError(f"train 13b twin: CUDA != CPU ({err:.3e})")


def train_full_phase(dev) -> dict:
    """13b. Returns the bf16 attention kernel's launches in the training
    runs and its numbers at the training shape."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import steps, train
    from repro_torch.models import model as M
    from repro_torch.optim import adamw_init

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(TRAIN_ARCH_FULL),
                              n_layers=TRAIN_LAYERS)
    flops = _model_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    per_step = train_launches(cfg)
    log(f"[train 13b] {cfg.name}: d {cfg.d_model}, {cfg.n_heads} heads "
        f"({cfg.n_kv_heads} kv, head {cfg.resolved_head_dim}), d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}, {TRAIN_LAYERS} of 36 layers: "
        f"{flops['params']:,} {cfg.param_dtype} parameters, compute "
        f"{cfg.dtype}, remat {cfg.remat}; B {TRAIN_BATCH} x {TRAIN_SEQ} = "
        f"{tokens:,} tokens a step, mesh {TRAIN_MESH}; product FLOPs a "
        f"step: model {flops['model'] / 1e12:.2f} TFLOP, executed "
        f"{flops['executed'] / 1e12:.2f} TFLOP (remat's second forward, "
        f"the scan backward's recompute and masked blocks)")
    common = dict(arch=TRAIN_ARCH_FULL, layers=TRAIN_LAYERS, seq=TRAIN_SEQ,
                  batch=TRAIN_BATCH, mesh=TRAIN_MESH, steps=TRAIN_STEPS)
    runs, launched, measured = {}, 0, {}
    t_modes = time.perf_counter()
    for name, kw in TRAIN_MODES.items():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        _zero_attention_counts()
        t0 = time.perf_counter()
        losses = train.run(_train_args(**common, **kw))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _attention_counts()
        peak = torch.cuda.max_memory_allocated() - held
        want = TRAIN_STEPS * per_step
        if counts != {"all": want, "sm90": want, "f32": 0} or not all(
                math.isfinite(x) for x in losses):
            raise AssertionError(f"train 13b {name}: launches {counts} "
                                 f"(expected {want} on the bf16 kernel) or "
                                 f"losses {list(losses)}")
        launched += want
        warm = float(np.median(losses.step_s[1:]))
        log(f"[train 13b] {name}: ce {', '.join(f'{x:.5f}' for x in losses)}"
            f"; step {losses.step_s[0]:.4f} s cold, {warm:.4f} s warm "
            f"(median of steps 2-{TRAIN_STEPS}), {tokens / warm:,.0f} "
            f"tokens/s, model FLOPs {flops['model'] / warm / BF16_FLOPS:.1%}"
            f" of 989 TFLOP/s bf16 (executed "
            f"{flops['executed'] / warm / BF16_FLOPS:.1%}); peak device "
            f"memory {peak:,} bytes ({peak / 2**30:.2f} GiB) above "
            f"{held:,} held; {counts['sm90']} bf16 attention launches "
            f"({per_step} a step: {TRAIN_LAYERS} layers, forward and remat "
            f"recompute); run {wall:.2f} s with init")
        runs[name] = losses
        measured[name] = dict(step_s=warm, peak=peak)
    log(f"[time] 13b four modes {time.perf_counter() - t_modes:.1f} s")
    gaps = {"ddp picsou vs ddp ata": max(
                abs(a - b) for a, b in zip(runs["ddp picsou"],
                                           runs["ddp ata"])),
            "pjit vs ddp picsou": max(
                abs(a - b) for a, b in zip(runs["pjit"], runs["ddp picsou"])),
            "ddp picsou compress vs ddp picsou": max(
                abs(a - b) for a, b in zip(runs["ddp picsou compress"],
                                           runs["ddp picsou"]))}
    log(f"[train 13b] losses: " + ", ".join(f"{k} {v:.3e}"
                                            for k, v in gaps.items())
        + f" (limits {TRAIN_SYNC_TOL:g}, {TRAIN_MODE_TOL:g}, and "
        f"{TRAIN_MODE_TOL:g} with the compressed run's gap above 0)")
    if gaps["ddp picsou vs ddp ata"] >= TRAIN_SYNC_TOL or \
            gaps["pjit vs ddp picsou"] >= TRAIN_MODE_TOL or not \
            0 < gaps["ddp picsou compress vs ddp picsou"] < TRAIN_MODE_TOL:
        raise AssertionError(f"train 13b: modes disagree: {gaps}")

    # one warm ddp PICSOU step under the profiler, then the model's own
    # attention calls (remat off) for the route check on layer 0's
    gc.collect()
    torch.cuda.empty_cache()
    shape = ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    params = M.init_model(cfg, TRAIN_SEED, dev)
    args = _train_args(**common, **TRAIN_MODES["ddp picsou"])
    step = train.make_step(args, cfg, tmesh.parse_mesh(TRAIN_MESH, dev),
                           shape, params)
    data = SyntheticTokens(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                           global_batch=TRAIN_BATCH, seed=17)
    batch = {"tokens": torch.from_numpy(data.batch_at(0)["tokens"]).to(dev)}
    state = [params, adamw_init(params)]

    def one():
        state[0], state[1], _ = step(state[0], state[1], batch)

    t0 = time.perf_counter()
    one()
    t1 = time.perf_counter()
    log("[train 13b] ddp picsou step under torch.profiler: "
        + train_profile(one))
    log(f"[time] 13b warm-up step {t1 - t0:.1f} s, profiled step with the "
        f"profiler's processing {time.perf_counter() - t1:.1f} s")
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    calls = []
    t0 = time.perf_counter()
    with model_attention(recording_grads(calls)):
        steps.value_and_grad(params, dataclasses.replace(cfg, remat=False),
                             batch)
    first = check_route_grads(calls[:1], "13b layer 0 (bf16)")
    log(f"[time] 13b route check {time.perf_counter() - t0:.1f} s")
    log(f"[train 13b] kernel route vs scan route on layer 0's own q, k, v, "
        f"dO (bf16, {tuple(calls[0]['q'].shape)}): max {first['worst']:.3e}"
        f" of each one's max, bit for bit: {bool(first['exact'])}; output "
        f"against an f64 oracle: max |difference| / max |oracle| kernel "
        f"{first['out_err']:.3e}, plain version {first['plain_err']:.3e}, "
        f"entries over phase 7's bf16 tolerance kernel {first['over']}, "
        f"plain version {first['plain_over']}; control (causal off) "
        f"{first['control'][0]:.3e}")
    del calls
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _train_twin(cfg, params, dev)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    row = _train_shape_attention(cfg, dev)
    log(f"[time] 13b twin {t1 - t0:.1f} s, kernel at the step's shape "
        f"{time.perf_counter() - t1:.1f} s")
    return dict(train=row, launches=launched, measured=measured)


def train_phase(dev) -> dict:
    """Phase 13: the attention launches of its runs by kernel, and the
    bf16 kernel's numbers at the training shape."""
    t0 = time.perf_counter()
    f32 = train_smoke_phase(dev)
    log(f"[time] 13a training, every family {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    full = train_full_phase(dev)
    log(f"[time] 13b training {TRAIN_ARCH_FULL} {time.perf_counter() - t0:.1f}"
        f" s")
    return dict(full, launches_f32=f32)


# ------------------------------------------------------------ phase 14
# phase 14, the dry run: StepBundle.lower() counts a step on meta
# tensors (roofline.count: FlopCounterMode's formulas, uniform loops as
# trip count x one iteration). (a) holds that count of 13b's step to
# FlopCounterMode over one real step of the same bundle on the card
# (impl "scan": the kernel's FLOPs are no aten op's); (b) and (c) hold
# the counts of 13b's step and 12b's prefill to their measured times and
# peaks (phases 12b and 13b run them; nothing is timed again here).
DRYRUN_SERVE_MESH = "1x1"          # 12b serves on the card, no mesh


def _count_line(what: str, low, mf: float, step_s: float, peak: int):
    share = low.flops / step_s / BF16_FLOPS
    tflop = low.flops / 1e12
    log(f"[dryrun 14] {what}: counted {low.flops:,} FLOPs ({tflop:.3f} "
        f"TFLOP; model_flops {mf / 1e12:.3f} TFLOP, useful "
        f"{mf / low.flops:.3f}), {low.bytes:,} bytes moved unfused "
        f"({low.bytes / 1e9:.2f} GB), counted in {low.host_s:.2f} s on the "
        f"host; over the measured warm {step_s:.4f} s: "
        f"{low.flops / step_s / 1e12:.1f} TFLOP/s, {share:.1%} of 989 "
        f"TFLOP/s bf16; argument bytes a position "
        f"{low.argument_bytes:,.0f} ({low.argument_bytes / 2**30:.2f} GiB) "
        f"against the measured peak {peak:,} ({peak / 2**30:.2f} GiB)")
    if not (mf <= low.flops and share <= 1.0
            and low.argument_bytes <= peak):
        raise AssertionError(f"dryrun 14 {what}: model_flops {mf:.4e} <= "
                             f"counted {low.flops:.4e}, share {share:.3f} "
                             f"<= 1 and argument bytes "
                             f"{low.argument_bytes:.4e} <= peak {peak:,} "
                             f"must all hold")


def dryrun_phase(dev, served: dict, trained: dict) -> None:
    """14 (a)-(c): see the module docstring."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.optim import adamw_init
    from repro_torch.roofline import model_flops

    cfg = dataclasses.replace(get_config(TRAIN_ARCH_FULL),
                              n_layers=TRAIN_LAYERS)
    shape = ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    low = steps.build_train_step(cfg, tmesh.parse_mesh(TRAIN_MESH, "meta"),
                                 shape, impl="scan").lower()

    # (a) one real step of the same bundle on the card, counted
    torch.backends.cuda.matmul.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    bundle = steps.build_train_step(cfg, tmesh.parse_mesh(TRAIN_MESH, dev),
                                    shape, impl="scan")
    params = M.init_model(cfg, TRAIN_SEED, dev)
    batch = {"tokens": torch.from_numpy(SyntheticTokens(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        seed=17).batch_at(0)["tokens"]).to(dev)}
    opt = adamw_init(params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc:
        _, _, metrics = bundle(params, opt, batch)
        loss = float(metrics["loss"])
    real_s = time.perf_counter() - t0
    real = int(fc.get_total_flops())
    real_peak = torch.cuda.max_memory_allocated()
    del params, opt, bundle, metrics
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[dryrun 14] (a) 13b's pjit step ({cfg.name}, {TRAIN_LAYERS} "
        f"layers, B {TRAIN_BATCH} x {TRAIN_SEQ}, mesh {TRAIN_MESH}, impl "
        f"scan): meta count {low.flops:,} FLOPs in {low.host_s:.2f} s on "
        f"the host; FlopCounterMode over one real step on the card "
        f"{real:,} FLOPs (loss {loss:.5f}, {real_s:.2f} s with the "
        f"counter, peak {real_peak / 2**30:.2f} GiB); equal: "
        f"{real == low.flops}")
    if real != low.flops or not math.isfinite(loss):
        raise AssertionError(f"dryrun 14 (a): the meta count {low.flops:,} "
                             f"is not the real step's {real:,} (loss "
                             f"{loss})")

    # (b), (c) against the times and peaks phases 13b and 12b measured
    pjit = trained["measured"]["pjit"]
    _count_line("(b, c) 13b pjit step", low, model_flops(cfg, shape),
                pjit["step_s"], pjit["peak"])
    s_cfg = get_config(SERVE_ARCH)
    b, plen, _ = SERVE_SHAPE
    p_shape = ShapeSpec("prefill", plen, b, "prefill")
    p_low = steps.build_prefill_step(
        s_cfg, tmesh.parse_mesh(DRYRUN_SERVE_MESH, "meta"), p_shape).lower()
    _count_line(f"(b, c) 12b prefill ({s_cfg.name}, B {b} x {plen})", p_low,
                model_flops(s_cfg, p_shape), served["measured"]["prefill_s"],
                served["measured"]["peak"])


def build_all() -> dict:
    """Phase 2: every source, one nvcc each, all started together. Returns
    {source name: library path}."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import build

    for stale in build.BUILD_DIR.glob("lib*-*.so"):
        stale.unlink()                       # build from source, always

    def timed(name):
        t0 = time.perf_counter()
        lib = build.build(name)
        return lib, time.perf_counter() - t0

    t0 = time.perf_counter()
    libs = {}
    with ThreadPoolExecutor(len(build.KERNELS)) as pool:
        jobs = [(name, pool.submit(timed, name)) for name in build.KERNELS]
        for name, job in jobs:
            libs[name], sec = job.result()
            log(f"[build] {libs[name].name} built with nvcc in {sec:.2f} s")
    log(f"[build] {len(jobs)} kernels in {time.perf_counter() - t0:.2f} s "
        f"wall")
    return libs


def cuobjdump(*args) -> str:
    """The output of the toolkit's cuobjdump (beside nvcc)."""
    from repro_torch.kernels import build
    tool = Path(build.nvcc()).parent / "cuobjdump"
    return subprocess.run([str(tool), *map(str, args)], capture_output=True,
                          text=True, check=True, timeout=120).stdout


def kernel_name(mangled: str) -> str:
    """``name[template arguments]`` of a mangled ``*_kernel`` symbol, the
    arguments left mangled (``Li128E`` is the int 128)."""
    for i in range(len(mangled)):
        for j in range(i + 1, min(i + 3, len(mangled)) + 1):
            if not mangled[i:j].isdigit():
                break
            ident = mangled[j:j + int(mangled[i:j])]
            if ident.endswith("_kernel") and ident.isidentifier():
                args = re.match(r"I(.*?)EEv", mangled[j + len(ident):])
                return f"{ident}[{args.group(1)}]" if args else ident
    return mangled


def inspect_builds(libs: dict) -> None:
    """Phase 2, continued: each kernel's resources, and the design checks
    of the attention, RWKV6 and QUACK libraries."""
    for name, lib in libs.items():
        kernel = None
        for line in cuobjdump("--dump-resource-usage", lib).splitlines():
            line = line.strip()
            if line.startswith("Function "):
                kernel = kernel_name(line[len("Function "):].rstrip(":"))
            elif kernel and line.startswith("REG:"):
                res = dict(re.findall(r"(\w+):(\d+)", line))
                log(f"[build] {name}: {kernel}: {res['REG']} registers, "
                    f"stack {res['STACK']} B, local (spills) {res['LOCAL']}"
                    f" B, static shared {res['SHARED']} B")
                kernel = None
    sass = cuobjdump("-sass", libs["flash_attention_sm90"])
    ops = {op: len(re.findall(rf"\b{op}\b", sass))
           for op in ("HGMMA", "UTMALDG", "LDL", "STL")}
    log(f"[build] flash_attention_sm90 SASS: {ops['HGMMA']} HGMMA, "
        f"{ops['UTMALDG']} UTMALDG, {ops['LDL']} LDL and {ops['STL']} STL "
        f"(local loads and stores)")
    if not (ops["HGMMA"] and ops["UTMALDG"]):
        raise AssertionError("flash_attention_sm90: no HGMMA or UTMALDG in "
                             "its SASS; the bf16 path is not on wgmma and "
                             "TMA")
    sass = cuobjdump("-sass", libs["flash_attention_f32_sm90"])
    ops = {op: len(re.findall(rf"\b{op}\b", sass))
           for op in ("UTMALDG", "LDL", "STL")}
    tf32 = len(re.findall(r"\bHGMMA\.\S*\.TF32\b", sass))
    log(f"[build] flash_attention_f32_sm90 SASS: {tf32} tf32 HGMMA, "
        f"{ops['UTMALDG']} UTMALDG, {ops['LDL']} LDL and {ops['STL']} STL")
    if not (tf32 and ops["UTMALDG"]) or ops["LDL"] or ops["STL"]:
        raise AssertionError("flash_attention_f32_sm90: its SASS needs tf32 "
                             "HGMMA and UTMALDG and no local loads or stores "
                             "(LDL, STL: spilled accumulators)")
    sass = cuobjdump("-sass", libs["rwkv6_scan"])
    ops = {op: len(re.findall(rf"\b{op}\b", sass))
           for op in ("UBLKCP", "UTMALDG", "LDL", "STL")}
    log(f"[build] rwkv6_scan SASS: {ops['UBLKCP']} UBLKCP, {ops['UTMALDG']} "
        f"UTMALDG, {ops['LDL']} LDL and {ops['STL']} STL")
    if not (ops["UBLKCP"] or ops["UTMALDG"]) or ops["LDL"] or ops["STL"]:
        raise AssertionError("rwkv6_scan: its SASS needs bulk or TMA copies "
                             "(UBLKCP or UTMALDG) and no local loads or "
                             "stores (LDL, STL: a spilled state)")
    sass = cuobjdump("-sass", libs["quack_scan"])
    ops = {op: len(re.findall(rf"\b{op}\b", sass))
           for op in ("UBLKCP", "UCGABAR_ARV", "UCGABAR_WAIT", "LDL", "STL")}
    log(f"[build] quack_scan SASS: {ops['UBLKCP']} UBLKCP, "
        f"{ops['UCGABAR_ARV']} UCGABAR_ARV and {ops['UCGABAR_WAIT']} "
        f"UCGABAR_WAIT (cluster barrier), {ops['LDL']} LDL and {ops['STL']} "
        f"STL")
    if not (ops["UBLKCP"] and ops["UCGABAR_ARV"] and ops["UCGABAR_WAIT"]) \
            or ops["LDL"] or ops["STL"]:
        raise AssertionError("quack_scan: its SASS needs bulk copies "
                             "(UBLKCP), the cluster barrier (UCGABAR_ARV, "
                             "UCGABAR_WAIT) and no local loads or stores")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one card",
              file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no package beside the script ({ROOT / 'src'} "
              f"holds no repro_torch); run it from a checkout",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    log(f"[card] {card}")
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    inspect_builds(build_all())
    kern = kernel_phase(dev)
    plan_evidence(dev)
    t0 = time.perf_counter()
    api = api_phase(dev)
    log(f"[time] kernel-API phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    path_phase()
    log(f"[time] path phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches, full = full_phase(STEPS_FREE, STEPS_CRASH)
    log(f"[time] full-size phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    w_launches, w_round_ms, w_crash_ms, kept = windowed_phase(
        full["crash 0.3"][0], STEPS_CRASH)
    log(f"[time] windowed phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    s_launches, sweep_off = sweep_phase()
    log(f"[time] sweep phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    free = full["failure-free"]
    m_launches = metrics_phase((free[0], free[2]), kept, sweep_off)
    log(f"[time] metrics phase {time.perf_counter() - t0:.1f} s")
    dense_ms = full["crash 0.3"][1]
    del full, kept, sweep_off, free
    # the windowed profile's full-run comparator is the long stream at
    # K = 8, at W = 6,016 for its whole run (the crash run migrates)
    t0 = time.perf_counter()
    profile_phase(dense_ms, w_round_ms, w_crash_ms)
    log(f"[time] profile phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    topology_path_phase()
    log(f"[time] topology path phase {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    t_launches = topology_full_phase()
    log(f"[time] topology full-width phase {time.perf_counter() - t1:.1f} s"
        f"; phase 8 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    r_launches = replay_path_phase()
    log(f"[time] replay path phase {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    f_launches = replay_full_phase()
    log(f"[time] replay full-width phase {time.perf_counter() - t1:.1f} s"
        f"; phase 9 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sp_launches = stream_path_phase()
    log(f"[time] stream path phase {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    sf_launches = stream_full_phase()
    log(f"[time] stream full-width phase {time.perf_counter() - t1:.1f} s"
        f"; phase 10 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    crosspod_phase(dev)
    log(f"[time] cross-pod phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    served = serve_phase(dev)
    log(f"[time] serving phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    trained = train_phase(dev)
    log(f"[time] training phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dryrun_phase(dev, served, trained)
    log(f"[time] dry-run phase {time.perf_counter() - t0:.1f} s")

    # the main path's launches: the full-size runs, dense and windowed,
    # the sweep, the same runs with metrics on, the full-width topologies
    # and applications, the recorded, replayed and forked runs, and the
    # streaming sessions with their batch run; the attention kernels',
    # phase 7's path, phase 12's served runs (bf16: 12b's, f32: 12a's)
    # and phase 13's training runs (bf16: 13b's, f32: 13a's)
    main = [launches, w_launches, s_launches, m_launches, t_launches,
            r_launches, f_launches, sp_launches, sf_launches]
    rows = [("quack_scan", dict(kern[True], launches=sum(
                 x[0] for x in main), library_ms=None)),
            ("quack_scan_no_lost", dict(kern[False], launches=sum(
                x[1] for x in main), library_ms=None)),
            ("flash_attention", dict(
                api["flash_attention"], **served["model"], **trained["train"],
                launches=api["flash_attention"]["launches"]
                + served["launches"] + trained["launches"])),
            ("flash_attention_f32", dict(
                api["flash_attention_f32"],
                launches=api["flash_attention_f32"]["launches"]
                + served["launches_f32"] + trained["launches_f32"])),
            ("rwkv6_chunked", api["rwkv6_chunked"])]
    entries = []
    for name, k in rows:
        source, replaces = KERNEL_FILES[name]
        entries.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=k["launches"], max_abs_err=k["max_abs_err"],
            mismatches=k["mismatches"], ms=k["ms"], plain_ms=k["plain_ms"],
            bound_ms=k["bound_ms"], bound_by=k["bound_by"],
            library_ms=k["library_ms"],
            **{key: k[key] for key in k if key.startswith(
                ("windowed_", "lanes", "floor_", "model_", "train_"))}))
    if any(e["launches"] <= 0 for e in entries):
        raise AssertionError("a kernel of the main path never launched")
    log(f"[time] whole run {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
