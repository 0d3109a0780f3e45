"""Counting a step without running it: FLOPs, bytes moved, and the trip
count of a uniform loop.

The JAX package's dry run reads XLA's optimized HLO
(``repro.roofline.hlo_cost``): the dot FLOPs, the HBM bytes of every
top-level op, and each while loop's body scaled by its known trip count.
The port runs eager, so its counterpart counts the aten ops that a step
dispatches on ``meta`` tensors (shapes and dtypes, nothing allocated):

* FLOPs: the formulas of ``torch.utils.flop_counter`` (FlopCounterMode's
  own), which count a matrix product as 2·M·N·K, as ``hlo_cost`` counts
  a dot. The model zoo reaches no other op those formulas cover.
* bytes: each op's tensor inputs, read once, and outputs, written once.
  Views and ops that return no tensor move nothing and are skipped, as
  ``hlo_cost`` skips parameters, tuples and bitcasts. Eager writes every
  op's output to memory, so these are the bytes an unfused step moves.
* loops: ``loop`` runs a uniform loop (the layers of a stacked segment,
  the time steps of a recurrence, the blocks of the attention scan).
  Under a ``Counter(scale_loops=True)`` it runs the first iteration, one
  middle iteration counted ``n - 2`` times, and the last, so that a
  full-size step finishes in seconds; otherwise, and always when no
  counter runs, it runs all ``n`` iterations, as the model always has.

Under autograd the middle iteration runs inside ``_Middle``, whose
backward differentiates that iteration alone, counted ``n - 2`` times,
and adds the ``n - 3`` accumulations the engine would make of a shared
tensor's gradients across the middle iterations. The first and the last
iterations run inline because they differ from the others: the first
starts from a carry without gradients, the last gets no gradient for a
carry the step drops. The scaled count equals the unscaled count
(``tests/test_torch_roofline.py`` holds both at every smoke config).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

__all__ = ["Counter", "loop"]

aten = torch.ops.aten

# ops that return a tensor and move no bytes (views are found by schema)
_MOVES_NOTHING = {
    aten.detach.default, aten.alias.default, aten._unsafe_view.default,
    aten.lift_fresh.default, aten.empty.memory_format,
    aten.empty_strided.default, aten.empty_like.default,
    aten.new_empty.default, aten.new_empty_strided.default,
}

_ACTIVE: List["Counter"] = []


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _moves_nothing(func, out) -> bool:
    if func.is_view or func in _MOVES_NOTHING:
        return True
    return not any(isinstance(t, torch.Tensor) for t in tree_leaves(out))


class Counter(TorchDispatchMode):
    """Counts the FLOPs and bytes of the aten ops run inside it (forward
    and backward), each op times the trip counts of the scaled loops it
    sits in."""

    def __init__(self, scale_loops: bool = True):
        super().__init__()
        self.scale_loops = scale_loops
        self.flops = 0
        self.bytes = 0
        self.factor = 1

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out)) \
                * self.factor
        if not _moves_nothing(func, out):
            self.bytes += (_nbytes((args, kwargs)) + _nbytes(out)) \
                * self.factor
        return out

    @contextlib.contextmanager
    def times(self, n: int):
        """Count what runs inside ``n`` times over."""
        before = self.factor
        self.factor = before * n
        try:
            yield
        finally:
            self.factor = before


def _active() -> Optional[Counter]:
    """The innermost running counter, if any."""
    return _ACTIVE[-1] if _ACTIVE else None


# ------------------------------------------------------------- outputs
def _stack(ys: List[Any], dim: int):
    """The iterations' outputs stacked on ``dim``: None, a tensor, or a
    dict of tensors (stacked key by key)."""
    y = ys[0]
    if y is None:
        return None
    if isinstance(y, dict):
        return {k: torch.stack([t[k] for t in ys], dim=dim) for k in y}
    return torch.stack(ys, dim=dim)


def _leaves(y) -> List[torch.Tensor]:
    if y is None:
        return []
    return list(y.values()) if isinstance(y, dict) else [y]


def _rebuild(like, leaves):
    if like is None:
        return None
    if isinstance(like, dict):
        return dict(zip(like, leaves))
    return leaves[0]


def _expand(t: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """``t`` as ``n`` identical iterations on a new ``dim`` (a view)."""
    t = t.unsqueeze(dim)
    shape = list(t.shape)
    shape[dim] = n
    return t.expand(shape)


def _join(y0, ymid, ylast, dim: int):
    """The first, the middle (already ``n - 2`` on ``dim``) and the last
    iterations' outputs as one stack: the same bytes as stacking all n."""
    if y0 is None:
        return None
    parts = zip(_leaves(y0), _leaves(ymid), _leaves(ylast))
    return _rebuild(y0, [torch.cat([a.unsqueeze(dim), m, z.unsqueeze(dim)],
                                   dim=dim) for a, m, z in parts])


# ---------------------------------------------------------------- loops
def loop(n: int, body: Callable, carry: Tuple[torch.Tensor, ...],
         shared: Sequence[Any] = (), dim: int = 0):
    """``for i in range(n): carry, y = body(i, carry, shared)``; returns
    (carry, the ys stacked on ``dim``). ``carry`` is a tuple of tensors;
    ``shared`` holds every other tensor the body reads that may need a
    gradient (the body indexes it, ``shared[k][i]``, itself); ``y`` is
    None, a tensor or a dict of tensors. Every iteration must do the same
    work whatever ``i``: a scaling counter runs only three of them."""
    counter = _active()
    if counter is None or not counter.scale_loops or n <= 2:
        ys = []
        for i in range(n):
            carry, y = body(i, carry, shared)
            ys.append(y)
        return carry, _stack(ys, dim)
    carry, y0 = body(0, carry, shared)
    carry, ymid = _middle(counter, n - 2, body, carry, shared, dim)
    carry, ylast = body(n - 1, carry, shared)
    return carry, _join(y0, ymid, ylast, dim)


def _middle(counter: Counter, reps: int, body, carry, shared, dim: int):
    tensors = [t for t in list(carry) + list(shared)
               if isinstance(t, torch.Tensor)]
    if not (torch.is_grad_enabled() and any(t.requires_grad
                                            for t in tensors)):
        with counter.times(reps):
            carry, y = body(1, carry, shared)
        return carry, _rebuild(y, [_expand(t, reps, dim)
                                   for t in _leaves(y)])
    info: Dict[str, Any] = {}
    outs = _Middle.apply((counter, reps, body, len(carry), dim, info),
                         *carry, *shared)
    k = len(carry)
    return tuple(outs[:k]), _rebuild(info["y"], list(outs[k:]))


def _keep(t):
    return t


class _Middle(torch.autograd.Function):
    """The middle iterations of a scaled loop under autograd: one
    iteration (index 1) on detached inputs, its graph kept, counted
    ``reps`` times forward and backward."""

    @staticmethod
    def forward(ctx, spec, *flat):
        counter, reps, body, n_carry, dim, info = spec
        ctx.set_materialize_grads(False)
        ins = [x.detach().requires_grad_(x.requires_grad)
               if isinstance(x, torch.Tensor) else x for x in flat]
        # the kept graph saves its own tensors: were they an enclosing
        # checkpoint's, every backward call here would recompute its
        # whole region once more
        with torch.enable_grad(), counter.times(reps), \
                torch.autograd.graph.saved_tensors_hooks(_keep, _keep):
            carry, y = body(1, tuple(ins[:n_carry]), tuple(ins[n_carry:]))
        info["y"] = y
        outs = list(carry) + _leaves(y)
        ctx.graph = (ins, outs)
        ctx.spec = (counter, reps, n_carry, dim)
        res = tuple([c.detach() for c in carry]
                    + [_expand(t.detach(), reps, dim) for t in _leaves(y)])
        # an output without a gradient inside has none outside either
        ctx.mark_non_differentiable(*[r for r, o in zip(res, outs)
                                      if not o.requires_grad])
        return res

    @staticmethod
    def backward(ctx, *grads):
        ins, outs = ctx.graph
        counter, reps, n_carry, dim = ctx.spec
        pairs = []
        for k, (o, g) in enumerate(zip(outs, grads)):
            if g is None or not o.requires_grad:
                continue
            # one iteration's output gradient of the n - 2 stacked
            pairs.append((o, g.select(dim, 0) if k >= n_carry else g))
        want = [k for k, x in enumerate(ins)
                if isinstance(x, torch.Tensor) and x.requires_grad
                and ctx.needs_input_grad[k + 1]]
        got: List[Optional[torch.Tensor]] = [None] * len(ins)
        if pairs and want:
            with counter.times(reps):
                gs = torch.autograd.grad([o for o, _ in pairs],
                                         [ins[k] for k in want],
                                         [g for _, g in pairs],
                                         allow_unused=True)
            for k, g in zip(want, gs):
                got[k] = g
            # the engine sums a shared tensor's reps gradients: reps - 1
            # adds, made once here and counted reps - 1 times
            with counter.times(reps - 1):
                for k in want:
                    if k >= n_carry and got[k] is not None:
                        got[k] + got[k]
        ctx.graph = None
        return (None,) + tuple(got)
