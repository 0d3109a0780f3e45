"""Window-layout invariants of the simulator's state, and moving it.

Which ``SimState`` fields are window-indexed, what a fresh (never-touched)
slot holds, and each field's shape at window width ``w``: the single
source of truth for state initialisation, the windowed engine's ring
rotation refills, adaptive growth and dense-layout migration. Beside it,
the host<->device moves of a whole state tree and the width migration.

Everything here works structurally on ``NamedTuple`` state trees
(``_fields`` / ``_replace``), so it depends on nothing of the simulator.
``PinnedDrain`` is the windowed engine's per-dispatch drain, which
overlaps the device's next dispatch. ``repro_torch.replay`` serialises
checkpoints with ``state_to_arrays`` / ``state_from_arrays``.

``to_host`` and ``PinnedDrain`` are the sanctioned routes by which device
data reaches the host: each marks its extent with ``explicit()``, which
the runtime sanitizer (``repro_torch.analysis.sanitizer``) reads, so a
tensor read anywhere else inside a guarded region is an implicit
transfer.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["WINDOW_FILLS", "window_shapes", "to_host", "host_state",
           "device_state", "pad_window", "PinnedDrain", "state_to_arrays",
           "state_from_arrays", "explicit", "explicit_depth"]

# window-indexed SimState fields -> neutral fill for a fresh slot
WINDOW_FILLS = dict(recv_has=False, bcast_q=False, bcast_done=False,
                    orig_sent=False, known=False, complaint=False,
                    repeat_c=False, retry=0, quack_time=-1, deliver_time=-1)


def window_shapes(n_s: int, n_r: int, w: int) -> dict:
    """Window-indexed SimState field -> shape at window width ``w``."""
    return dict(recv_has=(n_r, w), bcast_q=(n_r, w), bcast_done=(n_r, w),
                orig_sent=(w,), known=(n_s, n_r, w),
                complaint=(n_s, n_r, w), repeat_c=(n_s, n_r, w),
                retry=(n_s, w), quack_time=(n_s, w), deliver_time=(w,))


# The sanitizer's view of the sanctioned routes: how deep this thread is
# in explicit moves, and how many guards hold the card's sync debug mode
# at "error" (``torch.cuda.set_sync_debug_mode`` is process-wide).
_TLS = threading.local()
SYNC_GUARDS = [0]


def explicit_depth() -> int:
    """How many ``explicit()`` extents this thread is inside."""
    return getattr(_TLS, "depth", 0)


@contextlib.contextmanager
def explicit() -> Iterator[None]:
    """Mark the extent as an explicit move between host and device.

    The sanitizer counts no tensor read inside it. While a guard holds
    the card's sync debug mode, the mode is lowered to 0 for the extent
    and restored after it. Besides the device->host routes of this
    module, the engine marks its uploads (host->device copies, which the
    card's sync debug mode cannot tell from reads) and the capture of a
    program (the CUDA graph API synchronises the device)."""
    _TLS.depth = explicit_depth() + 1
    mode = None
    if SYNC_GUARDS[0]:
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        _TLS.depth -= 1
        if mode is not None:
            torch.cuda.set_sync_debug_mode(mode)


def _check_dtypes(tensors: Sequence[torch.Tensor]) -> None:
    for t in tensors:
        if t.dtype not in (torch.int32, torch.bool):
            raise TypeError(f"drains take int32/bool tensors, got "
                            f"{t.dtype}")


def to_host(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Bring int32/bool/float32 tensors to numpy in ONE device->host copy
    (flattened into one int32 buffer and split back, dtypes kept).

    float32 moves as its bits (``view(torch.int32)``), so it comes back
    bit for bit; any other dtype raises ``TypeError``.
    """
    for t in tensors:
        if t.dtype not in (torch.int32, torch.bool, torch.float32):
            raise TypeError(f"to_host takes int32/bool/float32 tensors, "
                            f"got {t.dtype}")
    with explicit():
        flat = torch.cat([
            (t.view(torch.int32) if t.dtype == torch.float32 else t)
            .reshape(-1).to(torch.int32) for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        n = t.numel()
        a = flat[at:at + n].reshape(tuple(t.shape))
        if t.dtype == torch.bool:
            a = a.astype(bool)
        elif t.dtype == torch.float32:
            a = a.view(np.float32)
        out.append(a)
        at += n
    return out


def host_state(state):
    """A state tree of int32/bool/float32 tensors as the same tree of
    numpy arrays, in one device->host copy, every bit kept."""
    return type(state)(*to_host(list(state)))


def device_state(state, device):
    """Push a host-side state tree onto ``device`` (exact: every leaf is
    int32/bool/float32, so the round trip keeps every bit)."""
    return type(state)(*(torch.as_tensor(np.asarray(x), device=device)
                         for x in state))


def pad_window(state, new_w: int):
    """Migrate a state tree to a wider window, keeping the live columns.

    Window-indexed leaves gain fresh-fill tail slots; per-replica state,
    ``base`` and leading (lane) axes are untouched, so the migrated state
    resumes the identical protocol at the wider width. Works on trees of
    tensors and of numpy arrays alike.
    """
    w = state.deliver_time.shape[-1]

    def pad(a, fill):
        if isinstance(a, np.ndarray):
            ext = np.full(a.shape[:-1] + (new_w - w,), fill, dtype=a.dtype)
            return np.concatenate([a, ext], axis=-1)
        ext = torch.full(a.shape[:-1] + (new_w - w,), fill, dtype=a.dtype,
                         device=a.device)
        return torch.cat([a, ext], dim=-1)

    return state._replace(
        **{name: pad(getattr(state, name), fill)
           for name, fill in WINDOW_FILLS.items()})


def state_to_arrays(state, prefix: str = "") -> Dict[str, np.ndarray]:
    """Flatten a state ``NamedTuple`` into named numpy arrays (npz-ready)."""
    return {f"{prefix}{name}": np.asarray(getattr(state, name))
            for name in state._fields}


def state_from_arrays(cls, arrays, prefix: str = "", defaults=None):
    """Rebuild a state ``NamedTuple`` of type ``cls`` from named arrays.

    ``defaults`` maps field name -> array for fields absent from
    ``arrays``: the shim for traces written before a field existed (e.g.
    ``FailArrays`` without the adversary masks or the stakes). A field
    missing from both raises ``KeyError``: zero-filling protocol state
    would corrupt a resume.
    """
    defaults = defaults or {}

    def get(name):
        key = f"{prefix}{name}"
        if key in arrays:
            return np.asarray(arrays[key])
        return np.asarray(defaults[name])

    return cls(**{name: get(name) for name in cls._fields})


class PinnedDrain:
    """Device->host drains that overlap the device's next work.

    On a CUDA device ``start`` enqueues one non-blocking copy per tensor
    on the current stream (so behind the program that wrote them and
    ahead of the next one, which may rewrite them) into one of two pinned
    host buffers, used in turn, and records an event after the copies;
    ``wait`` blocks on that event and returns numpy views of the buffer.
    A buffer is written again two calls of ``start`` later: fold a drain, or
    copy what it keeps, before starting the one after next. On the CPU
    the tensors are on the host already: ``wait`` returns their numpy
    views. int32/bool tensors only (``TypeError`` otherwise).
    """

    def __init__(self, device: torch.device):
        self._cuda = device.type == "cuda"
        self._bufs: List[Optional[torch.Tensor]] = [None, None]
        self._next = 0

    def start(self, tensors: Sequence[torch.Tensor]):
        """Start draining ``tensors``; returns the handle ``wait`` takes."""
        _check_dtypes(tensors)
        if not self._cuda:
            with explicit():
                return [t.numpy() for t in tensors]
        nbytes = sum(t.numel() * t.element_size() for t in tensors)
        buf = self._bufs[self._next]
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            self._bufs[self._next] = buf
        self._next ^= 1
        views: List[Optional[torch.Tensor]] = [None] * len(tensors)
        at = 0
        # int32 first, so that every int32 view starts 4-byte aligned
        for i in sorted(range(len(tensors)),
                        key=lambda i: -tensors[i].element_size()):
            t = tensors[i]
            n = t.numel() * t.element_size()
            host = buf[at:at + n].view(t.dtype).view(t.shape)
            host.copy_(t, non_blocking=True)
            views[i] = host
            at += n
        event = torch.cuda.Event()
        event.record()
        return event, views

    def wait(self, handle) -> List[np.ndarray]:
        """Block until a drain has landed; its arrays, dtypes kept."""
        if not self._cuda:
            return handle
        event, views = handle
        with explicit():
            event.synchronize()
            return [v.numpy() for v in views]
