"""Captured programs: the simulator's chunk, superchunk and dense-block
bodies as CUDA graphs, kept across runs.

The JAX package compiles each of these bodies once with ``jax.jit`` and
keeps the compiled programs in ``functools.lru_cache(maxsize=64)``
caches, so a second run of a shape compiles nothing. Here a body is
plain PyTorch, ``body(state, t0) -> (new_state, outputs)``, and the
programs of one state layout live in a ``Programs`` set, keyed within
the set as the JAX package keys its programs (window width, rounds a
chunk, chunks a span, rotation):

- on a CUDA device each body is captured once into a
  ``torch.cuda.CUDAGraph`` over static buffers: the carried state, the
  round number ``t0`` and whatever else the body reads (kept alive by the
  set). The captured body ends by copying its new state into the state
  buffers, so replays chain with no host work; a dispatch costs the host
  one ``fill_`` of ``t0`` and one graph launch instead of one launch per
  kernel. There is no fallback: a capture that fails raises.
- on the CPU the same body runs eagerly, and nothing is captured.

**Lifetime.** Sets outlive runs: ``program_set(key, build)`` keeps up to
``CACHE_SETS`` of them in a process-wide cache, one per state layout (the
simulator's key: device, lanes, the shape-and-schedule part of the spec,
window width, metrics), and evicts the least recently used one by count
only. A run that takes a set copies its initial (or resumed, padded or
migrated) state into the set's buffers with ``Programs.load``, and its
per-lane inputs into the tensors the set keeps, in place: a graph reads
them by address, so they are never rebound. When a window grows or
migrates, the run takes the set of the new layout; the old width's set
stays cached, as the JAX package keeps every width compiled.
``clear_programs`` empties the cache (the counterpart of
``jax.clear_caches()``), dropping every graph with its memory pool.

A capture executes nothing, so the body is first run once on clones of
the state (its warm-up: it loads the kernels' modules and allocates the
matrix products' workspaces at these shapes) and the result thrown away.
Warm-ups and captures run on one side stream per device: cuBLAS keeps a
workspace per stream for the life of the process.
The graphs of one set share one memory pool, which lives as long as the
set.

The carried state is a ``NamedTuple`` of tensors, or a tuple of them
(the simulator's ``(SimState, MetricsCarry)`` when it collects metrics).

Launch accounting: the kernel wrapper's counters
(``kernels.quack_scan.quack_scan.launches`` / ``launches_no_lost``) move
only while Python runs the wrapper. A capture records the launches its
body makes (and restores the counters the warm-up and the capture moved);
every replay adds them, and ``discount`` takes back those of chunk bodies
whose results a span's overflow guard discarded.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Dict, Hashable, List, Tuple

import numpy as np
import torch

from ..kernels.quack_scan import quack_scan as _quack_scan
from .snapshot import explicit

__all__ = ["Programs", "program_set", "clear_programs", "cached_sets",
           "CACHE_SETS", "capture_count", "replay_count", "first_use_count"]

# the kernel wrapper's launch counters a replay must move
_COUNTERS = ("launches", "launches_no_lost")
_CAPTURES = [0]
_REPLAYS = [0]
_FIRST_USES = [0]
_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}
# sets kept across runs, least recently used first
CACHE_SETS = 16
_SETS: "OrderedDict[Hashable, Programs]" = OrderedDict()


def capture_count() -> int:
    """Programs captured into CUDA graphs so far."""
    return _CAPTURES[0]


def replay_count() -> int:
    """CUDA graph replays so far (one per dispatch on a CUDA device)."""
    return _REPLAYS[0]


def first_use_count() -> int:
    """Programs run for the first time in their set so far: a capture on
    a CUDA device, the first eager call on the CPU."""
    return _FIRST_USES[0]


def program_set(key: Hashable, build: Callable[[], "Programs"]
                ) -> "Programs":
    """The cached set of layout ``key``, or ``build()``'s, cached. The
    cache holds ``CACHE_SETS`` sets and drops the least recently used
    one beyond that (a run that still holds it keeps using it)."""
    ps = _SETS.get(key)
    if ps is not None:
        _SETS.move_to_end(key)
        return ps
    ps = _SETS[key] = build()
    while len(_SETS) > CACHE_SETS:
        _SETS.popitem(last=False)
    return ps


def cached_sets() -> List["Programs"]:
    """The cached sets, least recently used first."""
    return list(_SETS.values())


def clear_programs() -> None:
    """Empty the cache: every cached set drops its graphs (and so their
    memory pools); the next run of any shape captures again."""
    for ps in _SETS.values():
        ps.release()
    _SETS.clear()


@dataclasses.dataclass(eq=False)
class _Captured:
    key: Hashable
    graph: torch.cuda.CUDAGraph
    outputs: List[torch.Tensor]       # written by every replay
    launches: Dict[str, int]          # kernel launches a replay makes


def _counts() -> Dict[str, int]:
    return {name: getattr(_quack_scan, name) for name in _COUNTERS}


def _add_counts(delta: Dict[str, int], times: int = 1) -> None:
    for name, n in delta.items():
        setattr(_quack_scan, name, getattr(_quack_scan, name) + n * times)


Body = Callable[[tuple, torch.Tensor], Tuple[tuple, List[torch.Tensor]]]


def _leaves(state) -> List[torch.Tensor]:
    """The leaves of a state tree (tuples and ``NamedTuple``s of tensors
    or numpy arrays), in order."""
    if isinstance(state, (torch.Tensor, np.ndarray)):
        return [state]
    return [leaf for part in state for leaf in _leaves(part)]


def copy_into(dst, src) -> None:
    """Copy the leaves of tree ``src`` (tensors or numpy arrays) into
    those of tree ``dst``, in place (an explicit move: an upload is no
    host read)."""
    dst, src = _leaves(dst), _leaves(src)
    if len(dst) != len(src):
        raise ValueError(f"copy_into: {len(src)} leaves into {len(dst)}")
    with explicit():
        for d, x in zip(dst, src):
            d.copy_(x if isinstance(x, torch.Tensor)
                    else torch.from_numpy(np.array(x)))


def _clone(state):
    """A state tree with every tensor cloned."""
    if isinstance(state, torch.Tensor):
        return state.clone()
    parts = [_clone(part) for part in state]
    return type(state)(*parts) if hasattr(state, "_fields") else \
        type(state)(parts)


class Programs:
    """The programs of one state layout, kept across runs.

    ``state`` is the carried state (a tree of tensors); on a CUDA device
    its tensors are the static buffers every replay reads and
    rewrites, and they must not alias each other. ``keep`` holds the other
    tensors the bodies read (per-lane inputs, constants): a graph reads
    them by address, so they live as long as the set, and a run writes
    its own values into them in place.
    """

    def __init__(self, state, device: torch.device, keep=()):
        self.state = state
        self.keep = keep
        self._cuda = device.type == "cuda"
        self._progs: Dict[Hashable, _Captured] = {}
        if self._cuda:
            self._t0 = torch.zeros((), dtype=torch.int32, device=device)
            self._pool = torch.cuda.graph_pool_handle()
            if device not in _STREAMS:
                _STREAMS[device] = torch.cuda.Stream(device)
            self._stream = _STREAMS[device]

    def __contains__(self, key: Hashable) -> bool:
        return key in self._progs

    def load(self, state) -> None:
        """Copy ``state`` (a tree of the set's structure, of tensors or
        numpy arrays) into the state buffers, in place and in stream
        order: the graphs keep reading the same addresses."""
        copy_into(self.state, state)

    def run(self, key: Hashable, body: Body, t: int) -> List[torch.Tensor]:
        """Run program ``key`` (``body``, captured at its first use on a
        CUDA device) from round ``t``; the new state replaces ``state``.
        Returns the body's outputs. On a CUDA device these are the
        graph's own output buffers, rewritten by the next replay: read
        them (in stream order) before the next ``run``."""
        if not self._cuda:
            if key not in self._progs:
                self._progs[key] = None
                _FIRST_USES[0] += 1
            self.state, outputs = body(self.state,
                                       torch.tensor(t, dtype=torch.int32))
            return outputs
        # before a capture too: its warm-up runs at this round (the set's
        # last round, from another run, may lie past this program's span)
        self._t0.fill_(t)
        prog = self._progs.get(key)
        if prog is None:
            prog = self._progs[key] = self._capture(key, body)
        prog.graph.replay()
        _REPLAYS[0] += 1
        _add_counts(prog.launches)
        return prog.outputs

    def discount(self, key: Hashable, chunks: int, of: int) -> None:
        """Take back the kernel launches of ``chunks`` of the ``of`` equal
        chunk bodies of program ``key``'s last replay, whose results its
        overflow guard discarded; they count on
        ``quack_scan.launches_skipped`` instead."""
        if not self._cuda or not chunks:
            return
        per_chunk = {name: n // of
                     for name, n in self._progs[key].launches.items()}
        _add_counts(per_chunk, -chunks)
        _quack_scan.launches_skipped += per_chunk["launches"] * chunks

    def output_nbytes(self) -> int:
        """Bytes of the captured programs' output buffers, which the set
        holds for every replay to rewrite (0 on the CPU, where a call
        returns new tensors)."""
        return sum(t.untyped_storage().nbytes()
                   for prog in self._progs.values() if prog is not None
                   for t in prog.outputs)

    def release(self) -> None:
        """Drop every captured graph (and so its memory pool);
        ``clear_programs`` does this for every cached set."""
        self._progs.clear()

    @explicit()
    def _capture(self, key: Hashable, body: Body) -> _Captured:
        # explicit: building a program is no host read, and the CUDA
        # graph API synchronises the device
        before = _counts()
        stream = self._stream
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            body(_clone(self.state), self._t0)    # warm-up, thrown away
        torch.cuda.current_stream().wait_stream(stream)
        warm = _counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=stream):
            new, outputs = body(self.state, self._t0)
            for dst, src in zip(_leaves(self.state), _leaves(new)):
                if src is not dst:
                    dst.copy_(src)
        launches = {name: n - warm[name] for name, n in _counts().items()}
        _add_counts({name: before[name] - n
                     for name, n in _counts().items()})
        _CAPTURES[0] += 1
        _FIRST_USES[0] += 1
        return _Captured(key, graph, list(outputs), launches)
