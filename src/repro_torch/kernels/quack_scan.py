"""QUACK aggregation on the GPU: the wrapper of ``csrc/quack_scan.cu``.

Every round, every sender folds R receiver claim/complaint bitmaps over a
W-message window into stake-weighted quorum decisions (§4.1/§4.2), for B
independent lanes (simulated links) at once:

    quacked[b,s,w] = sum_r stakes[b,r] * claims[b,s,r,w] >= quack_thresh[b]
    lost[b,s,w]    = sum_r stakes[b,r] * complaints[b,s,r,w] >= dup_thresh[b]
                     & ~quacked[b,s,w]
    prefix[b,s]    = length of the contiguous quacked prefix

The reference's (S, R, W) / (R,) / () form is the B = 1 case of the same
launch. The kernel is CUDA C++ for Hopper, built with ``nvcc`` into a
library with a plain C interface at first use (``kernels.build``) and
launched on PyTorch's current stream as one cluster launch, whose shape
``plan_quack_launch`` picks on the host. Its plain torch version is
``kernels.ref.quack_reference``; ``kernels.ops.quack_scan`` picks between
the two by the device of the tensors.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from .build import load_library
from .checks import check_tensor, require_cuda

__all__ = ["quack_scan", "plan_quack_launch", "QuackPlan", "PATHS"]

# stakes are staged in shared memory beside the rows, 48 KB of them at most
_MAX_R = 48 * 1024 // 4
_MAX_S = 65535             # the grid's y extent
_MAX_B = 65535             # the grid's z extent
_MAX_TILE = 1024           # staged columns a tile: 256 threads x 4 columns
_MIN_TILE = 128            # one warp's staged columns
_MAX_CLUSTER = 8           # the portable cluster size
_MAX_STAGES = 4
_STAGE_BYTES = 112 * 1024  # staged rows a CTA, so that two CTAs fit a SM
_VECTOR_THREADS = 512      # 16 columns a thread on the vector path
_VECTOR_COLS = 2048        # columns a CTA from which it runs (no loss quorum)
PATHS = ("bytes", "vector", "staged")   # the C entry's path numbers


@dataclass(frozen=True)
class QuackPlan:
    """One launch of ``csrc/quack_scan.cu``: grid (cluster, S, B), one
    thread-block cluster per (b, s) row; CTA k of a cluster owns columns
    [k * cols, min(W, (k + 1) * cols)) and walks them in tiles of ``tile``
    columns. ``path``: "staged" (``stages`` shared-memory stages of bulk
    copies, each (2 if compute_lost else 1) x R rows of ``tile`` bytes, 4
    columns a thread), "vector" (16-byte loads from global memory, 16
    columns a thread) or "bytes" (byte loads, 4 columns a thread); stages
    is 0 outside "staged". ``smem``: the dynamic shared memory, in
    bytes."""
    path: str
    cluster: int
    cols: int
    tile: int
    stages: int
    threads: int
    smem: int
    grid: tuple


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def plan_quack_launch(b: int, s: int, r: int, w: int, aligned: bool,
                      compute_lost: bool = True) -> QuackPlan:
    """The launch of one call at (B, S, R, W). ``aligned``: every bitmap
    pointer lies on a 16-byte boundary; the staged and vector paths need
    that and W % 16 == 0, and take the bytes path otherwise.

    A row is split into C = 8 CTAs (fewer where a CTA would get less than
    one warp's 128 columns), each owning a multiple of 16 columns. The
    staged path runs with the loss quorum, and without it below 2,048
    columns a CTA: at W = 6,016 8 CTAs of 752 columns in one stage, all in
    flight at once; a CTA's tiles are as even as 1,024 columns a tile
    allow, and as many stages rotate as there are tiles, up to 4, within
    112 KB of rows so that two CTAs fit on a SM (densely 8 tiles in two
    stages). Without the loss quorum from 2,048 columns a CTA (W >= 16,384
    at C = 8) the vector path runs, up to 512 threads of 16 columns in
    even passes (densely one pass of 8 x 8,192), which the card measured
    faster there (PERF.md). Where the rows of a tile of min(128,
    cols) columns do not fit in the stage budget (R above ~220 with the
    loss quorum), the bytes path runs.
    """
    maps = 2 if compute_lost else 1
    cluster = _MAX_CLUSTER
    while cluster > 1 and cluster * _MIN_TILE > w:
        cluster //= 2
    cols = _up(-(-w // cluster), 16)
    fit = _STAGE_BYTES // (maps * r) // 16 * 16
    vectors = aligned and w % 16 == 0
    stages = 0
    if vectors and not compute_lost and cols >= _VECTOR_COLS:
        path = "vector"
        passes = -(-cols // (16 * _VECTOR_THREADS))
        threads = _up(-(-cols // (16 * passes)), 32)
        tile = 16 * threads
    else:
        n_tiles = -(-cols // _MAX_TILE)
        tile = _up(-(-cols // n_tiles), 16)
        if vectors and fit >= min(cols, _MIN_TILE):
            path = "staged"
            tile = min(tile, fit)
            stages = min(-(-cols // tile), _MAX_STAGES,
                         _STAGE_BYTES // (maps * r * tile))
        else:
            path = "bytes"
        threads = _up(-(-tile // 4), 32)
    smem = 16 * stages + _up(4 * r, 16) + stages * maps * r * tile
    return QuackPlan(path=path, cluster=cluster, cols=cols, tile=tile,
                     stages=stages, threads=threads, smem=smem,
                     grid=(cluster, s, b))


@functools.cache
def _entry():
    fn = load_library("quack_scan").quack_scan_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 12
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def quack_scan(claims: torch.Tensor, complaints, stakes: torch.Tensor,
               quack_thresh: torch.Tensor, dup_thresh, *,
               compute_lost: bool = True):
    """Launch the CUDA kernel. All tensors lie on one CUDA device.

    Lane form: claims/complaints (B,S,R,W) bool, contiguous; stakes (B,R)
    float32; quack_thresh/dup_thresh (B,) float32 tensors, read on the
    device (no host sync). Returns ``(quacked (B,S,W) bool, lost (B,S,W)
    bool, prefix (B,S) int32)``. The reference's form, claims (S,R,W),
    stakes (R,) and () thresholds, runs as one lane and returns (S,W) /
    (S,) outputs. ``compute_lost=False`` never reads ``complaints`` or
    ``dup_thresh`` (either may be ``None``) and returns ``lost=None``.
    Any W is accepted; the kernel masks the ragged edge.
    """
    require_cuda("quack_scan", claims)
    if claims.dim() == 3:                 # one lane, the reference's form
        def lane(t):
            return None if t is None else t.unsqueeze(0)

        quacked, lost, prefix = quack_scan(
            lane(claims), lane(complaints), lane(stakes), lane(quack_thresh),
            lane(dup_thresh), compute_lost=compute_lost)
        return quacked[0], None if lost is None else lost[0], prefix[0]
    if claims.dim() != 4:
        raise ValueError(f"quack_scan: claims must be (B,S,R,W) or (S,R,W), "
                         f"got shape {tuple(claims.shape)}")
    b, s, r, w = claims.shape
    if not (0 < b <= _MAX_B and 0 < s <= _MAX_S and 0 < r <= _MAX_R
            and 0 < w < 2 ** 31):
        raise ValueError(f"quack_scan: unsupported shape (B,S,R,W)="
                         f"{(b, s, r, w)}")
    dev = claims.device
    check = functools.partial(check_tensor, "quack_scan")
    check("claims", claims, torch.bool, (b, s, r, w), dev)
    check("stakes", stakes, torch.float32, (b, r), dev)
    check("quack_thresh", quack_thresh, torch.float32, (b,), dev)
    if compute_lost:
        check("complaints", complaints, torch.bool, (b, s, r, w), dev)
        check("dup_thresh", dup_thresh, torch.float32, (b,), dev)

    quacked = torch.empty((b, s, w), dtype=torch.bool, device=dev)
    lost = (torch.empty((b, s, w), dtype=torch.bool, device=dev)
            if compute_lost else None)
    prefix = torch.empty((b, s), dtype=torch.int32, device=dev)
    vecs = [claims, quacked] + ([complaints, lost] if compute_lost else [])
    plan = plan_quack_launch(b, s, r, w,
                             all(t.data_ptr() % 16 == 0 for t in vecs),
                             compute_lost)

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _entry()(
            claims.data_ptr(),
            complaints.data_ptr() if compute_lost else None,
            stakes.data_ptr(), quack_thresh.data_ptr(),
            dup_thresh.data_ptr() if compute_lost else None,
            quacked.data_ptr(), lost.data_ptr() if compute_lost else None,
            prefix.data_ptr(), b, s, r, w, int(compute_lost),
            PATHS.index(plan.path), plan.cluster,
            plan.cols, plan.tile, plan.stages, plan.threads, plan.smem,
            stream)
    if rc != 0:
        raise RuntimeError(f"quack_scan: kernel launch failed with CUDA "
                           f"error {rc}")
    quack_scan.launches += 1
    if not compute_lost:
        quack_scan.launches_no_lost += 1
    return quacked, lost, prefix


# launches of the kernel, all variants / the compute_lost=False variant;
# launches_skipped: launches of a captured span's chunk bodies that its
# overflow guard discarded, taken back from the two others
# (``core.graphs.Programs.discount``)
quack_scan.launches = 0
quack_scan.launches_no_lost = 0
quack_scan.launches_skipped = 0
