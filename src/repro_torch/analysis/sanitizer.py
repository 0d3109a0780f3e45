"""Runtime dispatch/transfer sanitizer for the windowed engine.

The sanitizer runs *alongside* real executions and checks what actually
happened: how many dispatches the engine issued, how often the host
waited for the device, whether any tensor reached the host outside the
sanctioned routes, and whether a warm path captured a program it should
have reused.

The declarative contract:

    a windowed run of C chunks at fusion K issues
        <= ceil(C / K) + 2 dispatches,
    with 0 implicit device->host transfers and
         0 recompilations on a warm (replay resume) path.

Usage::

    from repro_torch.analysis import dispatch_contract, sanitized

    with sanitized(dispatch_contract(spec)) as report:
        run_simulation(spec)
    # raises SanitizerError on violation; `report` holds the deltas

What the counters mean in this package: a *recompile* is a move of
``simulator.chunk_trace_count()`` (a program captured into a CUDA graph
on the card, its first use in its cached set on the CPU); *dispatches*
and *host syncs* are ``chunk_dispatch_count()`` / ``host_sync_count()``.

Implicit-transfer detection. The sanctioned routes are
``core.snapshot.to_host`` and ``core.snapshot.PinnedDrain``; each marks
its extent with ``snapshot.explicit()`` (so do the engine's uploads and
program captures, which are no host reads). Two mechanisms:

- on the card, ``torch.cuda.set_sync_debug_mode("error")`` for the
  region, lowered inside explicit extents: any other synchronising
  operation (``.item()``, ``.cpu()``, a blocking copy) raises, and the
  sanitizer turns that into a recorded transfer and a ``SanitizerError``.
  The mode is process-wide, so an explicit extent in one thread lowers
  it for every thread;
- everywhere (on the CPU it is the only one that bites, since a CPU
  tensor is host memory already), an interposition on the routes by
  which a tensor silently becomes host data: ``np.asarray`` /
  ``np.array`` of a tensor, ``Tensor.numpy``, ``.item``, ``.tolist``,
  ``.cpu`` and ``__bool__`` / ``__int__`` / ``__float__`` /
  ``__index__``. A conversion outside an explicit extent of its thread
  is recorded. Interposition is refcounted and thread-aware, so nested
  sanitizers (a test's ``sanitized`` around the engine's own
  ``debug_checks`` guard) each see every event.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..core import snapshot

__all__ = ["DispatchContract", "SanitizerError", "SanitizerReport",
           "dispatch_bound", "dispatch_contract", "sanitized",
           "engine_guard"]


class SanitizerError(RuntimeError):
    """A sanitized execution violated its dispatch/transfer contract."""


def dispatch_bound(steps: int, chunk_steps: int, k: int) -> int:
    """The contract ceiling ``ceil(C/K) + 2`` for a windowed run.

    C = ceil(steps / chunk_steps) chunks; fusion K collapses full-rate
    interior chunks ~K per dispatch; the +2 covers the unfused final
    chunk and one span truncated at the stream tail. Dense runs
    (``chunk_steps <= 0``) are a single dispatch, same slack.
    """
    if chunk_steps is None or chunk_steps <= 0:
        return 3
    n_chunks = -(-max(steps, 1) // chunk_steps)
    return -(-n_chunks // max(k or 1, 1)) + 2


@dataclasses.dataclass(frozen=True)
class DispatchContract:
    """Ceilings a sanitized execution must respect.

    ``None`` disables the corresponding check. ``sync_slack`` bounds
    host syncs relative to *observed* dispatches (each dispatch may
    drain once; +slack for the final flush and checkpoint reads).
    """

    max_dispatches: Optional[int] = None
    max_recompiles: Optional[int] = None     # 0 == warm-path contract
    max_transfers: Optional[int] = 0
    sync_slack: Optional[int] = 2
    label: str = ""


def dispatch_contract(spec: Any, *, warm: bool = False,
                      label: str = "") -> DispatchContract:
    """Contract for one engine run of ``spec`` (SimSpec or SimConfig —
    anything with ``steps`` / ``chunk_steps`` / ``superchunk``)."""
    bound = dispatch_bound(int(getattr(spec, "steps", 0) or 0),
                           int(getattr(spec, "chunk_steps", 0) or 0),
                           int(getattr(spec, "superchunk", 1) or 1))
    return DispatchContract(
        max_dispatches=bound,
        max_recompiles=0 if warm else None,
        max_transfers=0, sync_slack=2,
        label=label or f"dispatch<=ceil(C/K)+2={bound}")


@dataclasses.dataclass
class SanitizerReport:
    """Deltas observed inside one ``sanitized`` region."""

    contract: Optional[DispatchContract] = None
    dispatches: int = 0
    host_syncs: int = 0
    recompiles: int = 0
    transfers: Tuple[str, ...] = ()
    closed: bool = False

    def violations(self) -> List[str]:
        c = self.contract
        out = []
        if c is None:
            return out
        if (c.max_dispatches is not None
                and self.dispatches > c.max_dispatches):
            out.append(f"{self.dispatches} dispatches > contract "
                       f"{c.max_dispatches} ({c.label})")
        if (c.max_recompiles is not None
                and self.recompiles > c.max_recompiles):
            out.append(f"{self.recompiles} recompilations > contract "
                       f"{c.max_recompiles} (warm path must reuse "
                       f"captured chunk programs)")
        if (c.max_transfers is not None
                and len(self.transfers) > c.max_transfers):
            out.append(f"{len(self.transfers)} implicit device->host "
                       f"transfers (want <= {c.max_transfers}): "
                       + "; ".join(self.transfers[:4]))
        if (c.sync_slack is not None
                and self.host_syncs > self.dispatches + c.sync_slack):
            out.append(f"{self.host_syncs} host syncs > dispatches "
                       f"({self.dispatches}) + {c.sync_slack}")
        return out

    @property
    def ok(self) -> bool:
        return not self.violations()

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["transfers"] = list(self.transfers)
        d["violations"] = self.violations()
        d["ok"] = self.ok
        return d


# ---------------------------------------------------------------------------
# implicit-transfer interposition (refcounted, multi-collector)

_LOCK = threading.Lock()
_INSTALLS = 0
_COLLECTORS: List[List[str]] = []
_SAVED: dict = {}
_SYNC_MODE: List[Any] = [None]     # the card's mode before the first guard
# the tensor methods by which a tensor becomes host data
_METHODS = ("numpy", "item", "tolist", "cpu", "__bool__", "__int__",
            "__float__", "__index__")
# the text of the error the card's sync debug mode raises
_SYNC_ERROR = "synchronizing CUDA operation"


def _record_desc(desc: str) -> None:
    with _LOCK:
        for sink in _COLLECTORS:
            sink.append(desc)


def _record(kind: str, x: torch.Tensor) -> None:
    if snapshot.explicit_depth() > 0:
        return
    _record_desc(f"{kind} on torch.Tensor shape={tuple(x.shape)} "
                 f"dtype={x.dtype} device={x.device} (use "
                 f"snapshot.to_host)")


def _install() -> List[str]:
    """Register a collector; patch numpy and the tensor methods (and arm
    the card's sync debug mode) on first use."""
    global _INSTALLS
    sink: List[str] = []
    with _LOCK:
        _COLLECTORS.append(sink)
        _INSTALLS += 1
        if _INSTALLS > 1:
            return sink
        _SAVED["np.asarray"] = np.asarray
        _SAVED["np.array"] = np.array
        for name in _METHODS:
            _SAVED[name] = torch.Tensor.__dict__.get(name)
    orig_asarray, orig_array = _SAVED["np.asarray"], _SAVED["np.array"]

    def via_numpy(name, orig):
        def convert(a, *args, **kwargs):
            if not isinstance(a, torch.Tensor):
                return orig(a, *args, **kwargs)
            _record(name, a)
            with snapshot.explicit():     # counted once, here
                return orig(a, *args, **kwargs)
        return convert

    def via_method(name):
        orig = getattr(torch.Tensor, name)

        def method(self, *args, **kwargs):
            _record(f"Tensor.{name}", self)
            return orig(self, *args, **kwargs)
        return method

    np.asarray = via_numpy("np.asarray", orig_asarray)
    np.array = via_numpy("np.array", orig_array)
    for name in _METHODS:
        setattr(torch.Tensor, name, via_method(name))
    if torch.cuda.is_available():
        _SYNC_MODE[0] = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        snapshot.SYNC_GUARDS[0] += 1
    return sink


def _uninstall(sink: List[str]) -> None:
    global _INSTALLS
    with _LOCK:
        # by identity: two empty collectors compare equal
        del _COLLECTORS[next(i for i, c in enumerate(_COLLECTORS)
                             if c is sink)]
        _INSTALLS -= 1
        if _INSTALLS:
            return
        np.asarray = _SAVED["np.asarray"]
        np.array = _SAVED["np.array"]
        for name in _METHODS:
            if _SAVED[name] is None:
                delattr(torch.Tensor, name)
            else:
                setattr(torch.Tensor, name, _SAVED[name])
        if _SYNC_MODE[0] is not None:
            snapshot.SYNC_GUARDS[0] -= 1
            torch.cuda.set_sync_debug_mode(_SYNC_MODE[0])
            _SYNC_MODE[0] = None


@contextlib.contextmanager
def _card_syncs() -> Iterator[None]:
    """Turn the error the card's sync debug mode raises into a recorded
    transfer and a ``SanitizerError``."""
    try:
        yield
    except RuntimeError as e:
        if isinstance(e, SanitizerError) or _SYNC_ERROR not in str(e):
            raise
        desc = (f"a synchronizing CUDA operation outside the sanctioned "
                f"routes (use snapshot.to_host): {str(e).strip()}")
        _record_desc(desc)
        raise SanitizerError("implicit device->host transfer: "
                             + desc) from e


def _counters():
    # lazy: the simulator imports this module from its own debug_checks
    # guard
    from ..core import simulator as sim
    return (sim.chunk_dispatch_count(), sim.host_sync_count(),
            sim.chunk_trace_count())


@contextlib.contextmanager
def sanitized(contract: Optional[DispatchContract] = None, *,
              check: bool = True) -> Iterator[SanitizerReport]:
    """Run the body under the dispatch/transfer sanitizer.

    Yields a :class:`SanitizerReport` whose fields are filled in when
    the block exits; with ``check`` (default) a violated contract
    raises :class:`SanitizerError`. On the card the sync debug mode
    raises at the offending operation itself (as a ``SanitizerError``).
    """
    report = SanitizerReport(contract=contract)
    d0, s0, t0 = _counters()
    sink = _install()
    try:
        with _card_syncs():
            yield report
    finally:
        _uninstall(sink)
        d1, s1, t1 = _counters()
        report.dispatches = d1 - d0
        report.host_syncs = s1 - s0
        report.recompiles = t1 - t0
        report.transfers = tuple(sink)
        report.closed = True
    if check:
        problems = report.violations()
        if problems:
            raise SanitizerError(
                "sanitizer contract violated:\n  - "
                + "\n  - ".join(problems))


@contextlib.contextmanager
def engine_guard() -> Iterator[None]:
    """The engine's own ``debug_checks`` hook: transfer checking only.

    Wrapped around ``_run_windowed_batch`` when
    ``SimConfig.debug_checks`` is set — any implicit device->host
    materialization inside the drain/checkpoint path raises, with no
    dispatch ceiling (callers compose their own :func:`sanitized` for
    that).
    """
    sink = _install()
    try:
        with _card_syncs():
            yield
    finally:
        _uninstall(sink)
    if sink:
        raise SanitizerError(
            "implicit device->host transfer inside the windowed "
            "engine:\n  - " + "\n  - ".join(sink[:8]))
