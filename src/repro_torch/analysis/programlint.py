"""Captured-program auditor: the counterpart of ``repro.analysis.jaxprlint``.

``astlint`` reasons about source text; this pass reasons about what the
engine's programs really run. On a CUDA device each of them is captured
into a CUDA graph (``core.graphs.Programs``), after a warm-up on clones
of the state. The auditor builds the dense, chunk, final-chunk and
superchunk programs with the constructors the loop itself calls
(``simulator._dense_block``, ``simulator._span_program``), at a tiny
shape, runs each once on clones of its state, as the capture's warm-up
does, under a ``TorchDispatchMode`` that records every aten op with its
operands and outputs, and checks:

* **host syncs**: the ops of ``BANNED_OPS`` (``_local_scalar_dense``,
  ``nonzero``, ``masked_select``, ``is_nonzero``, ``equal``, the
  ``unique`` family), ``repeat_interleave`` of a tensor of repeats
  without ``output_size``, and any copy to another device. Each of them
  waits for the device, so the capture fails on the card, while the CPU
  runs it silently;
* **widenings**: any float64 / complex128 tensor; any int64 tensor that
  a dtype conversion made and that is used other than as an index
  operand (``gather``, ``scatter*``, ``index_select``, ``index``,
  ``index_put``, ``take_along_dim``, where torch requires int64), views
  and integer arithmetic on the way there included; any int64 leaf in
  the carried state or the outputs. The engine is int32 / bool /
  float32 end to end, as the reference is;
* on the card only: any CPU operand of more than 0 dimensions (a copy
  inside the capture), and ``quack_scan``'s launches, read from the
  wrapper's counters, which must be 2 x rounds plus one a rotating
  chunk.

Reported as information, as ``jaxprlint`` reports donation on the CPU:
the bytes of each argument, and the copy-back bytes, the state leaves a
body returns as new tensors, which the capture copies into the state
buffers on every replay (the port's counterpart of donation).

Beside the engine's eight, ``audit_decode`` audits the model zoo's decode
step, the body ``launch.steps.decode`` captures (``decode_body``, on a
smoke model's prefill caches), under the rules that apply to a model
step: host syncs, CPU operands on the card, and copy-back bytes, which
must be 0 (the body writes every cache leaf in place: the JAX step's
donated caches). Two engine rules do not apply there. The widening rule
holds the simulator to int32 / bool / float32 end to end, as the JAX
engine is; a model step computes in its config's dtype (float64 for the
checks' oracles) and routes MoE tokens with torch's int64 ``topk`` /
``argsort`` indices, the JAX model's int32 having no torch index
counterpart, so its widenings are reported, not held. The launch rule
counts ``quack_scan``, which a model step never calls; its decode
attention is plain torch, as the JAX package's is.

``audit_engine`` returns a JSON-ready dict (the ``jaxpr`` section of
``ANALYSIS.json``, under the JAX report's name); the CLI fails
``--check`` when any audited program is not clean. ``estimate_dispatches``
is the loop's span arithmetic, from which the sanitizer's contract
(``ceil(C/K) + 2``) is derived.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["ProgramAudit", "audit_callable", "audit_engine",
           "audit_decode", "decode_control", "DECODE_INT_POS",
           "estimate_dispatches", "BANNED_OPS"]

# aten ops (overload packets) that wait for the device
BANNED_OPS = ("_local_scalar_dense", "nonzero", "nonzero_static",
              "masked_select", "is_nonzero", "equal", "_unique", "_unique2",
              "unique_dim", "unique_consecutive", "unique_dim_consecutive")
_WIDE = (torch.float64, torch.complex128)
# op -> positions of its index operands (torch requires int64 there)
_INDEX_ARGS = {"gather": (2,), "scatter": (2,), "scatter_": (2,),
               "scatter_add": (2,), "scatter_add_": (2,),
               "scatter_reduce": (2,), "scatter_reduce_": (2,),
               "index_select": (2,), "index_add": (2,), "index_add_": (2,),
               "index_copy": (2,), "index_copy_": (2,), "index_fill": (2,),
               "index_fill_": (2,), "index": (1,), "index_put": (1,),
               "index_put_": (1,), "_index_put_impl_": (1,), "take": (1,),
               "take_along_dim": (1,)}
_INDEX_KWARGS = ("index", "indices")
# views and integer arithmetic an index may pass through on its way
_PASS_OPS = {"view", "_unsafe_view", "reshape", "expand", "unsqueeze",
             "squeeze", "slice", "select", "permute", "transpose", "t",
             "alias", "clone", "detach", "flatten", "unflatten", "cat",
             "stack", "add", "add_", "sub", "sub_", "mul", "mul_",
             "remainder", "fmod", "floor_divide", "div", "neg", "clamp",
             "clamp_min", "clamp_max", "minimum", "maximum", "abs",
             "where", "lift_fresh", "broadcast_to", "expand_as"}


@dataclasses.dataclass
class ProgramAudit:
    """The audit of one captured program's run."""

    name: str
    device: str
    n_ops: int
    ops: Tuple[str, ...]
    host_syncs: Tuple[str, ...]            # banned ops and device copies
    widenings: Tuple[str, ...]
    cpu_operands: Tuple[str, ...]          # on the card: CPU operands
    arg_bytes: Tuple[int, ...]             # the state, t0
    copy_back_bytes: int                   # state leaves returned anew
    launches: Optional[int] = None         # quack_scan (on the card)
    launches_no_lost: Optional[int] = None  # of them, without the loss
    expected_launches: Optional[int] = None  # quorum
    hold_widenings: bool = True            # False: reported only
    max_copy_back: Optional[int] = None    # bytes a replay may copy back

    @property
    def ok(self) -> bool:
        """Clean: no host sync, no widening (where held), no CPU operand
        on the card, the launches the formula gives, and no more
        copy-back bytes than allowed."""
        return not self.violations()

    def violations(self) -> List[str]:
        out = [f"{self.name}: host sync {s}" for s in self.host_syncs]
        if self.hold_widenings:
            out += [f"{self.name}: widening {w}" for w in self.widenings]
        out += [f"{self.name}: CPU operand {c} on {self.device}"
                for c in self.cpu_operands]
        if (self.expected_launches is not None
                and self.launches != self.expected_launches):
            out.append(f"{self.name}: quack_scan launches {self.launches}, "
                       f"expected {self.expected_launches}")
        if (self.max_copy_back is not None
                and self.copy_back_bytes > self.max_copy_back):
            out.append(f"{self.name}: copy-back {self.copy_back_bytes} B a "
                       f"replay, allowed {self.max_copy_back}")
        return out

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["ok"] = self.ok
        d["ops"] = sorted(set(self.ops))
        return d


def _tensors(x) -> List[Tuple[Any, torch.Tensor]]:
    """(position path, tensor) of every tensor in an argument tree."""
    if isinstance(x, torch.Tensor):
        return [((), x)]
    if isinstance(x, (list, tuple)):
        return [((i,) + p, t) for i, e in enumerate(x)
                for p, t in _tensors(e)]
    return []


class _Recorder(TorchDispatchMode):
    """Records every aten op a body runs, and what the audit checks."""

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # the recorder never runs under torch.compile: left unwrapped, its
        # first use imports no torch._dynamo (seconds of import). A private
        # hook, checked against torch 2.11; should a later torch drop it,
        # chip_smoke.py phase 10a fails on its time budget
        return False

    def __init__(self, device: torch.device):
        super().__init__()
        self.device = device
        self.ops: List[str] = []
        self.host_syncs: List[str] = []
        self.widenings: List[str] = []
        self.cpu_operands: List[str] = []
        self._made64: Dict[int, str] = {}   # id -> where a conversion made
        self._alive: List[torch.Tensor] = []  # keeps the ids unique

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        self.ops.append(name)
        ins = _tensors(list(args)) + [((k,) + p, t) for k, v in kwargs.items()
                                       for p, t in _tensors(v)]
        outs = [t for _, t in _tensors(out)]
        self._host_sync(name, func, kwargs, ins, outs)
        if self.device.type == "cuda":
            for _, t in ins:
                if t.device.type == "cpu" and t.dim() > 0:
                    self.cpu_operands.append(
                        f"{tuple(t.shape)} {t.dtype} to aten.{name}")
        self._widening(name, ins, outs)
        return out

    def _host_sync(self, name, func, kwargs, ins, outs) -> None:
        if name in BANNED_OPS:
            self.host_syncs.append(f"aten.{name}")
        elif (name == "repeat_interleave"
              and func._overloadname in ("Tensor", "self_Tensor")
              and kwargs.get("output_size") is None):
            self.host_syncs.append("aten.repeat_interleave (tensor repeats,"
                                   " no output_size)")
        elif name in ("_to_copy", "copy_", "copy") and ins and outs:
            src = ins[1][1] if name in ("copy_", "copy") and len(ins) > 1 \
                else ins[0][1]
            if src.device != outs[0].device:
                self.host_syncs.append(f"aten.{name} {src.device} -> "
                                       f"{outs[0].device}")

    def _widening(self, name, ins, outs) -> None:
        for t in outs:
            if t.dtype in _WIDE:
                self.widenings.append(f"{t.dtype} from aten.{name}")
        made = [(p, t) for p, t in ins if id(t) in self._made64]
        if name in ("_to_copy", "copy_") and outs and \
                outs[0].dtype == torch.int64:
            src = ins[1][1] if name == "copy_" else ins[0][1]
            if src.dtype != torch.int64:
                self._mark(outs[0], f"{src.dtype}->int64 (aten.{name})")
                return
        if not made:
            return
        index_pos = _INDEX_ARGS.get(name, ())
        for path, t in made:
            if path[:1] and (path[0] in index_pos
                             or path[0] in _INDEX_KWARGS):
                continue
            if name in _PASS_OPS and outs and all(
                    o.dtype == torch.int64 for o in outs):
                for o in outs:
                    self._mark(o, self._made64[id(t)])
                continue
            self.widenings.append(f"{self._made64[id(t)]} used by "
                                  f"aten.{name}")

    def _mark(self, t: torch.Tensor, where: str) -> None:
        self._made64[id(t)] = where
        self._alive.append(t)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _launch_counts() -> Tuple[int, int]:
    """``quack_scan``'s launches: all, and without the loss quorum."""
    from ..kernels.quack_scan import quack_scan
    return quack_scan.launches, quack_scan.launches_no_lost


def audit_callable(body, state, name: str, device=None, *, t: int = 0,
                   expected_launches: Optional[int] = None) -> ProgramAudit:
    """Run ``body(state, t0)`` once on clones of ``state``, as a capture's
    warm-up does, and audit what it ran. ``device``: where ``state``
    lies (default: its first leaf's device). ``expected_launches``: the
    ``quack_scan`` launches the body must make, checked on the card."""
    from ..core.graphs import _clone, _leaves
    leaves = _leaves(state)
    dev = torch.device(device) if device is not None else (
        leaves[0].device if leaves else torch.device("cpu"))
    carry = _clone(state)
    t0 = torch.full((), t, dtype=torch.int32, device=dev)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
    before = _launch_counts()
    rec = _Recorder(dev)
    with rec:
        new, outputs = body(carry, t0)
    launches = [a - b for a, b in zip(_launch_counts(), before)] if cuda \
        else [None, None]
    inputs = {id(x) for x in _leaves(carry)}
    new_leaves = _leaves(new)
    widenings = list(rec.widenings)
    for kind, tensors in (("state", new_leaves),
                          ("output", _leaves(outputs))):
        for i, x in enumerate(tensors):
            if x.dtype == torch.int64 or x.dtype in _WIDE:
                widenings.append(f"{x.dtype} {kind} leaf {i} "
                                 f"{tuple(x.shape)}")
    return ProgramAudit(
        name=name, device=str(dev), n_ops=len(rec.ops), ops=tuple(rec.ops),
        host_syncs=tuple(rec.host_syncs), widenings=tuple(widenings),
        cpu_operands=tuple(rec.cpu_operands),
        arg_bytes=(_nbytes(leaves), _nbytes([t0])),
        copy_back_bytes=_nbytes([x for x in new_leaves
                                 if id(x) not in inputs]),
        launches=launches[0], launches_no_lost=launches[1],
        expected_launches=expected_launches if cuda else None)


# the model step audited: the served model (granite-8b) at smoke size,
# (batch, prompt tokens) of its prefill
DECODE_ARCH = "granite-8b-smoke"
DECODE_SHAPE = (2, 8)


def audit_decode(device=None, body=None) -> ProgramAudit:
    """Audit the model zoo's decode step on ``device`` (default: CUDA;
    raises if it is absent): ``launch.steps.decode_body``, the body
    ``launch.steps.decode`` captures, run once on clones of the caches a
    prefill of ``DECODE_SHAPE`` gives (the attention scan, room for two
    more tokens), at the next position, on ``DECODE_ARCH``'s weights
    from seed 0. ``body``: a builder with ``decode_body``'s arguments to
    audit in its place (``decode_control``). Held: host syncs, CPU
    operands on the card, 0 copy-back bytes; widenings reported only
    (the module docstring says why)."""
    from ..configs import get_config
    from ..core.simulator import _resolve_device
    from ..launch.steps import decode_body
    from ..models import model as M
    from ..tree_util import tree_flatten
    dev = _resolve_device(device)
    cfg = get_config(DECODE_ARCH)
    batch, prompt = DECODE_SHAPE
    with torch.no_grad():
        params = M.init_model(cfg, 0, dev)
        tokens = (torch.arange(batch * prompt, dtype=torch.int32,
                               device=dev) % cfg.vocab).reshape(batch,
                                                                prompt)
        _, caches = M.prefill(params, cfg, tokens, impl="scan",
                              cache_len=prompt + 2)
        leaves, treedef = tree_flatten(caches)
        build = decode_body if body is None else body
        audit = audit_callable(build(params, cfg, treedef,
                                     tokens[:, -1:].clone()),
                               tuple(leaves), "decode", dev, t=prompt)
    return dataclasses.replace(audit, hold_widenings=False, max_copy_back=0)


# the seeded control of the decode step's audit: a decode body that reads
# the position on the host, what a capture of the decode step cannot do
DECODE_INT_POS = """
from repro_torch.launch.steps import decode_body

def _build(params, cfg, treedef, token):
    inner = decode_body(params, cfg, treedef, token)

    def body(state, t0):
        return inner(state, int(t0))
    return body

def step(progs, params, cfg, treedef, token, pos):
    return progs.run("decode", _build(params, cfg, treedef, token), pos)
"""


def decode_control(device=None) -> Tuple[List[str], ProgramAudit]:
    """``DECODE_INT_POS`` through both passes: (the linter's rules on its
    source, ``audit_decode`` of its body on ``device``). Both must flag
    the host read."""
    from .astlint import lint_source
    scope: Dict[str, Any] = {}
    exec(compile(DECODE_INT_POS, "control_decode.py", "exec"), scope)
    rules = [f.rule for f in lint_source(DECODE_INT_POS, "control_decode.py")]
    return rules, audit_decode(device, body=scope["_build"])


def estimate_dispatches(steps: int, chunk_steps: int, k: int) -> int:
    """Device dispatches the windowed host loop issues for this plan.

    Replicates ``_run_windowed_batch_impl``'s span arithmetic exactly
    (fusion capped at K, broken at the final/partial chunk), assuming
    no mandatory host boundary fires mid-run — the clean-pipeline
    number the sanitizer contract is measured against.
    """
    c_full = max(chunk_steps, 1)
    t, n = 0, 0
    while t < steps:
        c = min(c_full, steps - t)
        last = t + c >= steps
        span = 1
        if not last and c == c_full:
            span = max(1, min(max(k, 1), (steps - t - 1) // c_full))
        n += 1
        t += span * c
    return n


def _tiny_spec(m: int = 64, window_slots: int = 16, chunk_steps: int = 4,
               superchunk: int = 8):
    from ..core import RSMConfig, SimConfig
    from ..core.simulator import build_spec
    rsm = RSMConfig.bft(1)
    sim = SimConfig(n_msgs=m, steps=m // 4 + 24, window=1, phi=6,
                    window_slots=window_slots, chunk_steps=chunk_steps,
                    superchunk=superchunk)
    return build_spec(rsm, rsm, sim)


def _inputs(spec, w: int, device, collect: bool):
    """A program's state, ``FailArrays`` and ``_Plan`` at width ``w``:
    what ``simulator._layout_set`` builds for a set, one lane."""
    from ..core.simulator import _carry, _fail_arrays, _init_state, _plan
    from ..obs.metrics import init_metrics_carry
    state = _carry(_init_state(spec, w, device, 1),
                   init_metrics_carry(w, device, 1) if collect else None)
    return state, _fail_arrays([spec], device), _plan(spec, w, device)


def _write_needs(spec, plan, c: int, k: int) -> None:
    """A span's overflow-guard needs from round 0, as the loop writes
    them (``_load_needs``); a plan shorter than the span is padded with
    M, as the JAX auditor pads."""
    from ..core.simulator import _load_needs, _max_msg_by_round
    by = _max_msg_by_round(spec)
    if k * c <= len(by):
        _load_needs(plan, by, 0, c, k)
        return
    needs = np.full(k, spec.m, dtype=np.int32)
    got = np.minimum(by[c - 1::c][:k], spec.m)
    needs[:len(got)] = got
    plan.needs[k] = torch.tensor(needs, dtype=torch.int32,
                                 device=plan.sched[0].device)


def audit_engine(m: int = 64, window_slots: int = 16, chunk_steps: int = 4,
                 superchunk: int = 8, device=None) -> Dict[str, Any]:
    """Audit the engine's real programs at a tiny windowed shape, on
    ``device`` (default: CUDA; raises if it is absent).

    Programs audited, under the JAX auditor's names (the constructors
    the loop calls: the audit cannot drift from the implementation):

    * ``dense``        — a dense block of ``min(DENSE_BLOCK, steps)``
                         rounds over the whole stream (``_dense_block``);
    * ``chunk``        — one rotating windowed chunk
                         (``_span_program`` with k = 1). This is ALSO the
                         replay resume / injection program and the
                         chained-topology program (commit floors are
                         tensors it reads);
    * ``chunk_final``  — the unrotated final chunk;
    * ``superchunk``   — K chunk bodies in one program, the pipelined
                         hot path;
    * ``chunk_obs`` / ``superchunk_obs`` — the same programs with the
                         metrics fabric on (carry ``(SimState,
                         MetricsCarry)``);
    * ``chunk_stream`` / ``superchunk_stream`` — the horizon-mode
                         programs at a ``repro_torch.stream`` spec.
    """
    import dataclasses as dc

    from ..core.simulator import (DENSE_BLOCK, _dense_block, _resolve_device,
                                  _span_program)

    dev = _resolve_device(device)
    spec = _tiny_spec(m, window_slots, chunk_steps, superchunk)
    w, c, k = spec.window_slots, spec.chunk_steps, spec.superchunk
    audits: List[ProgramAudit] = []

    def span(name, sp, w, c, k, rotate, collect):
        state, fail, plan = _inputs(sp, w, dev, collect)
        _write_needs(sp, plan, c, k)
        audits.append(audit_callable(
            _span_program(sp, fail, plan, c, k, rotate, w), state, name,
            dev, expected_launches=k * (2 * c + int(rotate))))

    c_dense = min(DENSE_BLOCK, spec.steps)
    state, fail, plan = _inputs(spec, spec.m, dev, False)
    audits.append(audit_callable(
        _dense_block(spec, fail, plan, c_dense), state, "dense", dev,
        expected_launches=2 * c_dense))
    span("chunk", spec, w, c, 1, True, False)
    span("chunk_final", spec, w, c, 1, False, False)
    span("superchunk", spec, w, c, k, True, False)
    mspec = dc.replace(spec, collect_metrics=True)
    span("chunk_obs", mspec, w, c, 1, True, True)
    span("superchunk_obs", mspec, w, c, k, True, True)

    # horizon-mode (streaming-session) programs: the same constructors at
    # a stream spec (arrival-driven schedule, load-sized window, metrics)
    from ..core import RSMConfig, SimConfig
    from ..stream.workload import ArrivalProcess, build_stream_spec
    sspec = build_stream_spec(
        RSMConfig.bft(1), RSMConfig.bft(1),
        SimConfig(window=1, phi=6, window_slots="auto",
                  chunk_steps=chunk_steps, superchunk=superchunk),
        ArrivalProcess(kind="constant", rate=4.0), horizon=m)
    sw, s_c, s_k = sspec.window_slots, sspec.chunk_steps, sspec.superchunk
    span("chunk_stream", sspec, sw, s_c, 1, True, True)
    span("superchunk_stream", sspec, sw, s_c, s_k, True, True)

    n_chunks = -(-spec.steps // c)
    estimates = [dict(steps=spec.steps, chunk_steps=c, k=kk,
                      n_chunks=n_chunks,
                      dispatches=estimate_dispatches(spec.steps, c, kk),
                      contract_bound=-(-n_chunks // kk) + 2)
                 for kk in sorted({1, 2, k, 8})]
    violations = [v for a in audits for v in a.violations()]
    return {
        "shape": dict(m=spec.m, steps=spec.steps, window_slots=w,
                      chunk_steps=c, superchunk=k, device=str(dev)),
        "programs": [a.to_dict() for a in audits],
        "dispatch_estimates": estimates,
        "violations": violations,
        "ok": not violations,
    }
