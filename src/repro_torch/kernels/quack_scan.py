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
launched on PyTorch's current stream. Its plain torch version is
``kernels.ref.quack_reference``; ``kernels.ops.quack_scan`` picks between
the two by the device of the tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import load_library
from .checks import check_tensor, require_cuda

__all__ = ["quack_scan"]

# stakes are staged in the kernel's (default, 48 KB) shared memory
_MAX_R = 48 * 1024 // 4
_MAX_S = 65535             # the grid's y extent
_MAX_B = 65535             # the grid's z extent


@functools.cache
def _entry():
    fn = load_library("quack_scan").quack_scan_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
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
    prefix = torch.full((b, s), w, dtype=torch.int32, device=dev)
    vecs = [claims, quacked] + ([complaints, lost] if compute_lost else [])
    vec16 = w % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in vecs)

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _entry()(
            claims.data_ptr(),
            complaints.data_ptr() if compute_lost else None,
            stakes.data_ptr(), quack_thresh.data_ptr(),
            dup_thresh.data_ptr() if compute_lost else None,
            quacked.data_ptr(), lost.data_ptr() if compute_lost else None,
            prefix.data_ptr(), b, s, r, w, int(compute_lost), int(vec16),
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
