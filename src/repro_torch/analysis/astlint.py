"""Capture-discipline AST linter for the port's engine: the counterpart of
``repro.analysis.astlint``.

On a CUDA device every chunk, superchunk and dense block of the engine
is captured into a CUDA graph (``core.graphs.Programs``) and replayed
once a dispatch. A host read inside such a body (``.item()``,
``np.asarray`` of a tensor, a Python ``if`` on a tensor) fails the
capture on the card; on the CPU, where the same body runs eagerly, it
passes silently. A Python scalar carried in the state is frozen into the
graph at capture, and every replay reads it stale. This linter finds
those hazards statically, without importing anything.

Capture contexts:

* the ``body`` argument of a ``Programs.run(key, body, t)`` call, given
  directly or as a call to a builder (``_dense_block(...)``,
  ``_span_program(...)``): every function nested in the builder is a
  context;
* the statements inside a ``with torch.cuda.graph(...)`` block;
* everything those reach: calls by module-local name, as in the JAX
  linter, and also calls through the package's imports (``from .quack
  import stake_quorum_bitmap``, ``from . import scheduler as sched``),
  since the bodies built in ``core/simulator.py`` call into
  ``core/quack.py``, ``core/gc.py``, ``obs/metrics.py`` and the kernel
  wrappers. A function defined inside a context is a context too.

Rules (each finding carries its rule ID and a fix-it hint, and
``# analysis: ignore[rule-id]`` on the flagged line suppresses it; the
port's baseline file, ``baseline.txt`` beside this module, in the JAX
package's format, grandfathers findings by fingerprint):

``host-sync``
    ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()`` /
    ``.to("cpu")``; ``float()`` / ``int()`` / ``bool()`` or
    ``np.asarray()`` / ``np.array()`` of a tensor value;
    ``torch.nonzero`` / ``.nonzero()``, ``torch.unique``,
    ``masked_select``, ``torch.equal`` in a capture context.
``tensor-branch``
    A Python ``if`` / ``while`` / ``assert`` or conditional expression
    whose test reads a tensor value: a parameter or local of the
    context, or one closed over from its builder (a tensor the builder
    was given is read on the host all the same). A builder's parameters
    annotated with a static type, and reads of metadata, are fine.
``import-time-tensor``
    A tensor factory (``torch.tensor``, ``torch.zeros``, ...) or a
    ``torch.cuda.*`` call at module or class scope: it allocates (and
    may initialise CUDA) as an import side effect.
``static-in-state``
    A ``NamedTuple`` built in a capture context that declares ``int`` /
    ``float`` / ``bool`` / ``str`` fields (a capture freezes them), or a
    frozen dataclass or hashed class (a program key) that declares
    tensor fields.

Metadata is not a value: ``.shape``, ``.ndim``, ``.dtype``, ``.device``,
``.numel()``, ``.dim()``, ``.size()``, ``.data_ptr()``, ``len()``,
``isinstance()``, identity tests (``is None``), comparisons with string
literals and a string literal's membership (``"bq" in p``, a parameter
dict's keys), and parameters annotated with a static type (``int``,
``bool``, ``str``, ``float``, ``torch.dtype``, a frozen dataclass) are
read without a host sync.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = ["Finding", "RULES", "JAX_RULES", "lint_source", "lint_paths",
           "lint_tree", "load_baseline", "partition", "DEFAULT_BASELINE"]

# rule-id -> (summary, fix-it hint)
RULES: Dict[str, Tuple[str, str]] = {
    "host-sync": (
        "host read of a tensor value inside a capture context",
        "keep the value on the device (torch ops, torch.where) and read "
        "it in the host loop's drain (snapshot.to_host / PinnedDrain); a "
        "capture cannot wait for the device",
    ),
    "tensor-branch": (
        "Python control flow on a tensor value inside a capture context",
        "select on the device (torch.where, a mask) instead of branching; "
        "branch only on the builder's Python values or on metadata",
    ),
    "import-time-tensor": (
        "tensor factory or torch.cuda call at module import time",
        "use a Python constant, or build the tensor inside the function "
        "that needs it: an import-time tensor allocates (and may "
        "initialise CUDA) before the caller picks a device",
    ),
    "static-in-state": (
        "Python scalar in captured state, or tensor in a program key",
        "a NamedTuple built inside a capture holds tensors only (a "
        "capture freezes Python scalars into the graph); a frozen "
        "program key holds hashable Python values only",
    ),
}

# the JAX linter's rules -> (the port's rule, or None, and why)
JAX_RULES: Dict[str, Tuple[Optional[str], str]] = {
    "host-sync": ("host-sync", "the same hazard: a host read fails the "
                  "capture on the card"),
    "tracer-branch": ("tensor-branch", "a Python branch on a tensor is a "
                      "host read; the JAX tracer's error becomes a failed "
                      "capture"),
    "import-time-jnp": ("import-time-tensor", "a tensor factory or "
                        "torch.cuda call at import allocates or initialises "
                        "CUDA before the caller picks a device"),
    "pytree-fields": ("static-in-state", "a Python scalar in captured "
                      "state is frozen at capture; a program key holds "
                      "hashable values only"),
    "missing-donate": (None, "donation is built into the port's "
                       "structure: the capture copies the new state into "
                       "the state buffers (core/graphs.py, Programs."
                       "_capture); its counterpart is the program "
                       "auditor's copy-back bytes"),
}

DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "baseline.txt")

_IGNORE_RE = re.compile(r"#\s*analysis:\s*ignore\[([a-z\-,\s]+)\]")

_STATIC, _LIST, _VALUE = 0, 1, 2       # kinds of an expression, ordered

# reads of a tensor's metadata: no host sync
_META_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
               "requires_grad", "is_leaf", "itemsize"}
_META_METHODS = {"numel", "dim", "size", "data_ptr", "element_size",
                 "is_contiguous", "nelement", "stride", "storage_offset",
                 "get_device", "is_floating_point", "is_complex"}
_STATIC_BUILTINS = {"len", "isinstance", "issubclass", "hasattr", "type",
                    "callable", "id", "getattr", "repr", "str"}
_STATIC_ANNOT = {"int", "float", "bool", "str", "bytes", "complex", "None",
                 "torch.dtype", "torch.device", "dtype", "device"}
_TENSOR_ANNOT = ("torch.Tensor", "Tensor", "np.ndarray", "ndarray",
                 "numpy.ndarray")
_SCALAR_ANNOT = {"int", "float", "bool", "str", "bytes"}
# torch calls whose result is a Python object, not a tensor
_TORCH_STATIC = {"torch.device", "torch.promote_types", "torch.finfo",
                 "torch.iinfo", "torch.is_tensor", "torch.get_default_dtype",
                 "torch.cuda.is_available", "torch.cuda.current_stream",
                 "torch.cuda.device_count", "torch.is_grad_enabled"}
_FACTORIES = {"tensor", "as_tensor", "asarray", "from_numpy", "zeros",
              "ones", "full", "empty", "arange", "linspace", "logspace",
              "eye", "rand", "randn", "randint", "randperm", "zeros_like",
              "ones_like", "full_like", "empty_like", "rand_like",
              "randn_like", "randint_like", "empty_strided",
              "scalar_tensor", "tril_indices", "triu_indices"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_SYNC_OPS = {"nonzero", "unique", "masked_select", "equal", "argwhere"}
_NP = ("np", "numpy", "onp")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint finding: rule ID + location + hint + stable fingerprint."""

    rule: str
    path: str
    line: int
    col: int
    symbol: str          # enclosing function qualname, or flagged name
    message: str

    @property
    def hint(self) -> str:
        return RULES[self.rule][1]

    def fingerprint(self) -> str:
        """Line-number-free identity used by the baseline file."""
        return f"{self.rule}::{self.path}::{self.symbol}"

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: [{self.rule}] "
                f"{self.message}\n    hint: {self.hint}")


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted name of a call target ('torch.cuda.graph')."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _names(target: ast.AST) -> Iterable[ast.Name]:
    for n in ast.walk(target):
        if isinstance(n, ast.Name):
            yield n


class _Scope:
    """One function (or module, or ``torch.cuda.graph`` block) scope."""

    def __init__(self, node, parent: Optional["_Scope"], qualname: str,
                 module: "_ModuleLinter"):
        self.node = node
        self.parent = parent
        self.qualname = qualname
        self.module = module
        self.defs: Dict[str, "_Scope"] = {}
        self.locals: Set[str] = set()
        self.is_ctx = False
        self._kinds: Optional[Dict[str, int]] = None

    def resolve(self, name: str) -> Optional["_Scope"]:
        scope: Optional[_Scope] = self
        while scope is not None:
            if name in scope.defs:
                return scope.defs[name]
            scope = scope.parent
        return self.module.imported(name)

    def nested(self) -> Iterable["_Scope"]:
        stack = list(self.defs.values())
        while stack:
            s = stack.pop()
            yield s
            stack.extend(s.defs.values())


def _bound_names(nodes) -> Set[str]:
    """The names that ``nodes`` bind, not looking into nested defs and
    lambdas (whose names are their own locals)."""
    out: Set[str] = set()
    stack = list(nodes)
    while stack:
        sub = stack.pop()
        if not isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
            stack.extend(ast.iter_child_nodes(sub))
        if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(sub.name)
        elif isinstance(sub, ast.Assign):
            for tgt in sub.targets:
                out.update(n.id for n in _names(tgt))
        elif isinstance(sub, (ast.AnnAssign, ast.AugAssign, ast.For,
                              ast.comprehension, ast.NamedExpr)):
            out.update(n.id for n in _names(sub.target))
        elif isinstance(sub, ast.withitem) and sub.optional_vars:
            out.update(n.id for n in _names(sub.optional_vars))
    return out


def _own_nodes(root, skip) -> Iterable[ast.AST]:
    """Nodes under ``root`` (its body statements for a ``with``), not
    descending into the nodes of ``skip`` (nested defs)."""
    stack = (list(root.body) if isinstance(root, ast.With)
             else list(ast.iter_child_nodes(root)))
    while stack:
        node = stack.pop()
        if node in skip:
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


class _ModuleLinter:
    def __init__(self, tree: ast.Module, src: str, path: str, modname: str,
                 project: "_Project"):
        self.tree = tree
        self.path = path
        self.modname = modname
        self.project = project
        self.lines = src.splitlines()
        self.findings: List[Finding] = []
        self.module = _Scope(tree, None, "<module>", self)
        self.classes: Dict[str, ast.ClassDef] = {}
        self.regions: List[_Scope] = []
        # local name -> (module, attribute or None for a module alias)
        self.imports: Dict[str, Tuple[str, Optional[str]]] = {}
        self._index_scopes(tree, self.module, "")
        self._index_imports()

    # -- index ---------------------------------------------------------------
    def _index_scopes(self, node: ast.AST, scope: _Scope, cls: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                prefix = (f"{scope.qualname}." if scope is not self.module
                          else "") + (f"{cls}." if cls else "")
                sub = _Scope(child, scope, prefix + child.name, self)
                if not cls:       # methods resolve through their class only
                    scope.defs[child.name] = sub
                else:
                    scope.defs.setdefault(f"{cls}.{child.name}", sub)
                self._collect_locals(child, sub)
                self._index_scopes(child, sub, "")
            elif isinstance(child, ast.ClassDef):
                if scope is self.module:
                    self.classes[child.name] = child
                self._index_scopes(child, scope, child.name)
            else:
                self._index_scopes(child, scope, cls)

    @staticmethod
    def _collect_locals(fn, scope: _Scope) -> None:
        args = fn.args
        for a in (args.posonlyargs + args.args + args.kwonlyargs
                  + ([args.vararg] if args.vararg else [])
                  + ([args.kwarg] if args.kwarg else [])):
            scope.locals.add(a.arg)
        scope.locals |= _bound_names(ast.iter_child_nodes(fn))

    def _index_imports(self) -> None:
        pkg = self.modname.rsplit(".", 1)[0] if not self.is_package \
            else self.modname
        for node in ast.walk(self.tree):
            if isinstance(node, ast.ImportFrom):
                if node.level:
                    parts = pkg.split(".")
                    if node.level - 1 > len(parts) - 1:
                        continue
                    base = ".".join(parts[:len(parts) - (node.level - 1)])
                    mod = f"{base}.{node.module}" if node.module else base
                else:
                    mod = node.module or ""
                for alias in node.names:
                    local = alias.asname or alias.name
                    if f"{mod}.{alias.name}" in self.project.modules:
                        self.imports[local] = (f"{mod}.{alias.name}", None)
                    else:
                        self.imports[local] = (mod, alias.name)
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.asname:
                        self.imports[alias.asname] = (alias.name, None)

    @property
    def is_package(self) -> bool:
        return os.path.basename(self.path) == "__init__.py"

    def _origin(self, name: str) -> Optional[Tuple["_ModuleLinter", str]]:
        """The module that defines ``name`` as seen from this one, and its
        name there, followed through imports and re-exports (``__init__``
        modules)."""
        mod_l: _ModuleLinter = self
        seen = set()
        while name not in mod_l.module.defs and name not in mod_l.classes:
            ref = mod_l.imports.get(name)
            if ref is None or ref[1] is None or ref in seen:
                return None
            seen.add(ref)
            mod_l = self.project.modules.get(ref[0])
            if mod_l is None:
                return None
            name = ref[1]
        return mod_l, name

    def imported(self, name: str) -> Optional[_Scope]:
        """The module-level function ``name`` stands for here."""
        found = self._origin(name)
        return None if found is None else found[0].module.defs.get(found[1])

    def imported_class(self, name: str) -> Optional[Tuple["_ModuleLinter",
                                                          ast.ClassDef]]:
        """The class ``name`` stands for here, with its module."""
        found = self._origin(name)
        if found is None or found[1] not in found[0].classes:
            return None
        return found[0], found[0].classes[found[1]]

    def module_alias(self, name: str) -> Optional["_ModuleLinter"]:
        ref = self.imports.get(name)
        if ref is None or ref[1] is not None:
            return None
        return self.project.modules.get(ref[0])

    # -- scopes --------------------------------------------------------------
    def all_scopes(self) -> Iterable[_Scope]:
        yield self.module
        yield from self.module.nested()
        yield from self.regions

    def _scopes_of_nodes(self):
        """(node, innermost enclosing scope) for every node."""
        out = []
        stack: List[Tuple[ast.AST, _Scope]] = [(self.tree, self.module)]
        by_node = {id(s.node): s for s in self.module.nested()}
        while stack:
            node, scope = stack.pop()
            for child in ast.iter_child_nodes(node):
                sub = by_node.get(id(child), scope) if isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef)) else scope
                out.append((child, sub))
                stack.append((child, sub))
        return out

    # -- capture contexts ----------------------------------------------------
    def mark_roots(self) -> None:
        for node, scope in self._scopes_of_nodes():
            if isinstance(node, ast.Call):
                self._mark_run_body(node, scope)
            elif isinstance(node, ast.With) and any(
                    isinstance(it.context_expr, ast.Call)
                    and _dotted(it.context_expr.func).endswith("cuda.graph")
                    for it in node.items):
                region = _Scope(node, scope, scope.qualname, self)
                region.locals = _bound_names(node.body)
                region.is_ctx = True
                self.regions.append(region)

    def _mark_run_body(self, call: ast.Call, scope: _Scope) -> None:
        """``<programs>.run(key, body, t)``: mark ``body``."""
        if not (isinstance(call.func, ast.Attribute)
                and call.func.attr == "run"):
            return
        body = call.args[1] if len(call.args) > 1 else next(
            (kw.value for kw in call.keywords if kw.arg == "body"), None)
        if isinstance(body, ast.Name):
            target = scope.resolve(body.id)
            if target is not None:
                target.is_ctx = True
        elif isinstance(body, ast.Call):
            builder = self.callee(body, scope)
            if builder is not None:   # everything nested in the builder
                for sub in builder.nested():
                    sub.is_ctx = True

    def callee(self, call: ast.Call, scope: _Scope) -> Optional[_Scope]:
        """The scope a call runs, where the linter can tell: a local or
        imported name, or a function of an imported module alias."""
        if isinstance(call.func, ast.Name):
            return scope.resolve(call.func.id)
        if (isinstance(call.func, ast.Attribute)
                and isinstance(call.func.value, ast.Name)):
            mod = self.module_alias(call.func.value.id)
            if mod is not None:
                return mod.imported(call.func.attr)
        return None

    def propagate(self) -> bool:
        changed = False
        for scope in list(self.all_scopes()):
            if not scope.is_ctx:
                continue
            for sub in scope.nested():
                if not sub.is_ctx:
                    sub.is_ctx = changed = True
            nodes = (_own_nodes(scope.node, ()) if scope in self.regions
                     else ast.walk(scope.node))
            for call in nodes:
                if isinstance(call, ast.Call):
                    target = self.callee(call, scope)
                    if target is not None and not target.is_ctx:
                        target.is_ctx = changed = True
        return changed

    # -- suppression ---------------------------------------------------------
    def _suppressed(self, rule: str, line: int) -> bool:
        if 1 <= line <= len(self.lines):
            m = _IGNORE_RE.search(self.lines[line - 1])
            if m:
                rules = {r.strip() for r in m.group(1).split(",")}
                return rule in rules or "all" in rules
        return False

    def _emit(self, rule: str, node: ast.AST, symbol: str,
              message: str) -> None:
        line = getattr(node, "lineno", 1)
        if self._suppressed(rule, line):
            return
        self.findings.append(Finding(
            rule=rule, path=self.path, line=line,
            col=getattr(node, "col_offset", 0), symbol=symbol,
            message=message))

    # -- what an expression holds --------------------------------------------
    def _static_annotation(self, ann: Optional[ast.AST]) -> bool:
        if ann is None:
            return False
        text = ast.unparse(ann).replace(" ", "")
        for wrap in ("Optional[", "typing.Optional["):
            if text.startswith(wrap) and text.endswith("]"):
                text = text[len(wrap):-1]
        parts = text.split("|")
        if text.startswith("Union[") and text.endswith("]"):
            parts = text[len("Union["):-1].split(",")
        return all(p in _STATIC_ANNOT or self._frozen_class(p)
                   for p in parts)

    def _frozen_class(self, name: str) -> bool:
        found = self.imported_class(name)
        return found is not None and _is_frozen_dataclass(found[1])

    def kinds(self, scope: _Scope) -> Dict[str, int]:
        """Each local's kind: static (a Python value or metadata), list
        (a starred unpacking: its length is static) or value (a tensor or
        anything computed from one)."""
        if scope._kinds is not None:
            return scope._kinds
        kinds: Dict[str, int] = {name: _STATIC for name in scope.locals}
        scope._kinds = kinds
        fn = scope.node
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            args = fn.args
            for a in args.posonlyargs + args.args + args.kwonlyargs:
                if a.arg not in ("self", "cls") and \
                        not self._static_annotation(a.annotation):
                    kinds[a.arg] = _VALUE
            for a in (args.vararg, args.kwarg):
                if a is not None:
                    kinds[a.arg] = _LIST
        nested = {s.node for s in scope.defs.values()}
        binds = [n for n in _own_nodes(fn, nested) if isinstance(
            n, (ast.Assign, ast.AugAssign, ast.AnnAssign, ast.For,
                ast.comprehension, ast.NamedExpr, ast.withitem))]
        changed = True
        while changed:
            changed = False
            for n in binds:
                for name, kind in self._bindings(n, scope):
                    if name in kinds and kind > kinds[name]:
                        kinds[name] = kind
                        changed = True
        return kinds

    def _bindings(self, n, scope: _Scope):
        if isinstance(n, ast.Assign):
            kind = self.kind(n.value, scope)
            for tgt in n.targets:
                yield from self._bind(tgt, kind)
        elif isinstance(n, ast.AugAssign):
            yield from self._bind(n.target, self.kind(n.value, scope))
        elif isinstance(n, ast.AnnAssign) and n.value is not None:
            yield from self._bind(n.target, self.kind(n.value, scope))
        elif isinstance(n, (ast.For, ast.comprehension)):
            kind = self.kind(n.iter, scope)
            yield from self._bind(n.target, _VALUE if kind else _STATIC)
        elif isinstance(n, ast.NamedExpr):
            yield from self._bind(n.target, self.kind(n.value, scope))
        elif isinstance(n, ast.withitem) and n.optional_vars is not None:
            yield from self._bind(n.optional_vars, _VALUE)

    @staticmethod
    def _bind(target, kind: int):
        if isinstance(target, ast.Name):
            yield target.id, kind
        elif isinstance(target, ast.Starred):
            for n in _names(target.value):
                yield n.id, _LIST if kind else _STATIC
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                yield from _ModuleLinter._bind(elt, kind)

    def kind(self, e: ast.AST, scope: _Scope) -> int:
        """static, list or value: whether reading ``e`` reads a tensor."""
        if e is None or isinstance(e, (ast.Constant, ast.Lambda,
                                       ast.JoinedStr)):
            return _STATIC
        if isinstance(e, ast.Name):
            return self._name_kind(e.id, scope)
        if isinstance(e, ast.Attribute):
            if e.attr in _META_ATTRS:
                return _STATIC
            return _VALUE if self.kind(e.value, scope) else _STATIC
        if isinstance(e, ast.Subscript):
            return _VALUE if self.kind(e.value, scope) else _STATIC
        if isinstance(e, ast.Call):
            return self._call_kind(e, scope)
        if isinstance(e, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in e.ops):
                return _STATIC
            if _static_comparison(e):
                return _STATIC
            return self._max([e.left] + e.comparators, scope, truth=False)
        if isinstance(e, ast.BoolOp):
            return self._max(e.values, scope, truth=True)
        if isinstance(e, ast.UnaryOp):
            k = self.kind(e.operand, scope)
            return _STATIC if (isinstance(e.op, ast.Not)
                               and k == _LIST) else k
        if isinstance(e, ast.BinOp):
            return self._max([e.left, e.right], scope, truth=False)
        if isinstance(e, ast.IfExp):
            return self._max([e.body, e.orelse], scope, truth=False)
        if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
            return self._max(e.elts, scope, truth=False)
        if isinstance(e, ast.Dict):
            return self._max([v for v in e.values], scope, truth=False)
        if isinstance(e, ast.Starred):
            return self.kind(e.value, scope)
        if isinstance(e, (ast.GeneratorExp, ast.ListComp, ast.SetComp)):
            return self._max([e.elt], scope, truth=False)
        if isinstance(e, ast.DictComp):
            return self._max([e.value], scope, truth=False)
        return _VALUE

    def _max(self, exprs, scope: _Scope, truth: bool) -> int:
        """The kind of an expression built from ``exprs``; a list counts
        as a value unless only its truth is read."""
        out = _STATIC
        for x in exprs:
            k = self.kind(x, scope)
            out = max(out, _STATIC if (truth and k == _LIST) else
                      (_VALUE if k else _STATIC))
        return out

    def _call_kind(self, call: ast.Call, scope: _Scope) -> int:
        name = _dotted(call.func)
        if isinstance(call.func, ast.Attribute):
            if call.func.attr in _META_METHODS:
                return _STATIC
            if name in _TORCH_STATIC:
                return _STATIC
            if name.startswith(("torch.", "F.")):
                return _VALUE
            if name.split(".")[0] in _NP:
                return self._args_kind(call, scope)
            if self.kind(call.func.value, scope):
                return _VALUE             # a method of a tensor value
        if isinstance(call.func, ast.Name):
            if call.func.id in _STATIC_BUILTINS:
                return _STATIC
            if call.func.id in ("int", "float", "bool"):
                return _STATIC            # (host-sync flags the read)
        return self._args_kind(call, scope)

    def _args_kind(self, call: ast.Call, scope: _Scope) -> int:
        return self._max(list(call.args) + [k.value for k in call.keywords],
                         scope, truth=False)

    def _name_kind(self, name: str, scope: _Scope) -> int:
        """A name's kind where it is bound: the nearest enclosing function
        scope that binds it. A builder's closure is no Python value here
        (a tensor it closes over is read on the host all the same), so a
        builder parameter is static only when annotated so; module names
        are static."""
        s: Optional[_Scope] = scope
        while s is not None and s is not self.module:
            kinds = self.kinds(s)
            if name in kinds or name in s.locals:
                return kinds.get(name, _STATIC)
            s = s.parent
        return _STATIC

    def _value_names(self, e: ast.AST, scope: _Scope) -> List[str]:
        return sorted({n.id for n in _names(e)
                       if self._name_kind(n.id, scope)})

    # -- rules ---------------------------------------------------------------
    def run_rules(self) -> List[Finding]:
        self._rule_import_time_tensor()
        self._rule_static_in_state()
        for scope in self.all_scopes():
            if scope.is_ctx:
                self._rules_in_context(scope)
        self.findings.sort(key=lambda f: (f.path, f.line, f.col))
        return self.findings

    def _rules_in_context(self, scope: _Scope) -> None:
        nested = {s.node for s in scope.defs.values()}
        if scope in self.regions:
            owner = scope.parent
            nested = {s.node for s in owner.nested()}
            # what the block binds comes from captured work: a value
            scope._kinds = dict(self.kinds(owner))
            scope._kinds.update((name, _VALUE) for name in scope.locals)
        for node in _own_nodes(scope.node, nested):
            if isinstance(node, ast.Call):
                self._check_host_sync(node, scope)
            elif isinstance(node, (ast.If, ast.While, ast.IfExp,
                                   ast.Assert)):
                self._check_branch(node, scope)

    def _check_host_sync(self, call: ast.Call, scope: _Scope) -> None:
        name = _dotted(call.func)
        sym = scope.qualname
        if isinstance(call.func, ast.Attribute):
            attr = call.func.attr
            if attr in _SYNC_METHODS and name.split(".")[0] not in _NP:
                self._emit("host-sync", call, sym,
                           f".{attr}() reads a tensor on the host inside "
                           f"a capture context")
                return
            if attr == "to" and any(_is_cpu(a) for a in list(call.args)
                                    + [k.value for k in call.keywords]):
                self._emit("host-sync", call, sym,
                           ".to('cpu') copies a tensor to the host inside "
                           "a capture context")
                return
            if attr in _SYNC_OPS and name.split(".")[0] not in _NP:
                what = name if name.startswith("torch.") else f".{attr}()"
                self._emit("host-sync", call, sym,
                           f"{what} has a data-dependent result: it waits "
                           f"for the device inside a capture context")
                return
            if name.split(".")[0] in _NP and attr in ("asarray", "array") \
                    and self._args_kind(call, scope):
                self._emit("host-sync", call, sym,
                           f"{name}() of a tensor value copies it to the "
                           f"host inside a capture context")
                return
        if (isinstance(call.func, ast.Name)
                and call.func.id in ("float", "int", "bool")
                and call.args and self.kind(call.args[0], scope)):
            names = self._value_names(call.args[0], scope)
            self._emit("host-sync", call, sym,
                       f"{call.func.id}() of a tensor value "
                       f"({', '.join(names) or 'an expression'}) reads it "
                       f"on the host inside a capture context")

    def _check_branch(self, node, scope: _Scope) -> None:
        test = node.test
        k = self.kind(test, scope)
        if k != _VALUE:
            return
        kw = {ast.If: "if", ast.While: "while", ast.IfExp: "conditional "
              "expression", ast.Assert: "assert"}[type(node)]
        names = self._value_names(test, scope)
        self._emit("tensor-branch", node, scope.qualname,
                   f"Python {kw} on {', '.join(names) or 'a tensor value'}"
                   f" — a value computed inside a capture context; select "
                   f"with torch.where instead")

    def _rule_import_time_tensor(self) -> None:
        def scan_body(body, where: str) -> None:
            for stmt in body:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if isinstance(stmt, ast.ClassDef):
                    scan_body(stmt.body, stmt.name)
                    continue
                stack = [stmt]
                while stack:
                    node = stack.pop()
                    if isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef, ast.Lambda,
                                         ast.ClassDef)):
                        continue
                    stack.extend(ast.iter_child_nodes(node))
                    if not isinstance(node, ast.Call):
                        continue
                    name = _dotted(node.func)
                    parts = name.split(".")
                    if parts[0] != "torch":
                        continue
                    if (len(parts) == 2 and parts[1] in _FACTORIES) or \
                            (len(parts) > 2 and parts[1] == "cuda"):
                        self._emit("import-time-tensor", node,
                                   f"{where}:{name}",
                                   f"{name}() runs at import time: it "
                                   f"allocates (or touches CUDA) as a "
                                   f"side effect of the import")

        scan_body(self.tree.body, "<module>")

    def _rule_static_in_state(self) -> None:
        for cname, node in self.classes.items():
            if _is_frozen_dataclass(node) or _defines_hash(node):
                for stmt in node.body:
                    if (isinstance(stmt, ast.AnnAssign)
                            and isinstance(stmt.target, ast.Name)):
                        annot = ast.unparse(stmt.annotation)
                        if any(a in annot for a in _TENSOR_ANNOT):
                            self._emit(
                                "static-in-state", stmt,
                                f"{cname}.{stmt.target.id}",
                                f"{cname} is hashable (a program key) but "
                                f"declares tensor field "
                                f"'{stmt.target.id}: {annot}': a key must "
                                f"hold hashable Python values only")
            is_nt = any(_dotted(b) in ("NamedTuple", "typing.NamedTuple")
                        for b in node.bases)
            if is_nt and (self.modname, cname) in \
                    self.project.built_in_context:
                for stmt in node.body:
                    if (isinstance(stmt, ast.AnnAssign)
                            and isinstance(stmt.target, ast.Name)):
                        annot = ast.unparse(stmt.annotation)
                        if annot in _SCALAR_ANNOT:
                            self._emit(
                                "static-in-state", stmt,
                                f"{cname}.{stmt.target.id}",
                                f"NamedTuple {cname} is built inside a "
                                f"capture context but field "
                                f"'{stmt.target.id}: {annot}' is a Python "
                                f"scalar, which the capture freezes")

    def constructed_in_context(self) -> Set[Tuple[str, str]]:
        out: Set[Tuple[str, str]] = set()
        for scope in self.all_scopes():
            if not scope.is_ctx:
                continue
            for node in ast.walk(scope.node):
                if isinstance(node, ast.Call) and isinstance(node.func,
                                                             ast.Name):
                    found = self.imported_class(node.func.id)
                    if found is not None:
                        out.add((found[0].modname, found[1].name))
        return out


def _is_frozen_dataclass(node: ast.ClassDef) -> bool:
    for dec in node.decorator_list:
        if isinstance(dec, ast.Call) and _dotted(dec.func) in (
                "dataclasses.dataclass", "dataclass"):
            for kw in dec.keywords:
                if (kw.arg == "frozen" and isinstance(kw.value, ast.Constant)
                        and kw.value.value is True):
                    return True
    return False


def _defines_hash(node: ast.ClassDef) -> bool:
    return any(isinstance(s, ast.FunctionDef) and s.name == "__hash__"
               for s in node.body)


def _is_cpu(e: ast.AST) -> bool:
    if isinstance(e, ast.Constant) and e.value == "cpu":
        return True
    return (isinstance(e, ast.Call) and _dotted(e.func) == "torch.device"
            and bool(e.args) and isinstance(e.args[0], ast.Constant)
            and e.args[0].value == "cpu")


def _static_comparison(cmp_node: ast.Compare) -> bool:
    """True for a comparison against string / ``None`` literals (or
    containers of them): config dispatch, not a read of a value; and for
    a string literal's membership (``"bias" in p``): a tensor holds no
    strings, so that reads a container's keys."""
    if (isinstance(cmp_node.left, ast.Constant)
            and isinstance(cmp_node.left.value, (str, bytes))
            and all(isinstance(op, (ast.In, ast.NotIn))
                    for op in cmp_node.ops)):
        return True
    for comparator in cmp_node.comparators:
        consts = [c for c in ast.walk(comparator)
                  if isinstance(c, ast.Constant)]
        if not consts or not all(isinstance(c.value, (str, bytes))
                                 or c.value is None for c in consts):
            return False
    return True


class _Project:
    """The modules linted together, so reach follows imports."""

    def __init__(self):
        self.modules: Dict[str, _ModuleLinter] = {}
        self.built_in_context: Set[Tuple[str, str]] = set()

    def lint(self, sources: Sequence[Tuple[str, str, str]]) -> List[Finding]:
        """``sources``: (source text, canonical path, module name)."""
        trees = [(ast.parse(src, filename=path), src, path, mod)
                 for src, path, mod in sources]
        for _, _, _, mod in trees:
            self.modules[mod] = None        # known before imports resolve
        for tree, src, path, mod in trees:
            self.modules[mod] = _ModuleLinter(tree, src, path, mod, self)
        linters = [self.modules[mod] for *_, mod in trees]
        for lint in linters:
            lint.mark_roots()
        while any([lint.propagate() for lint in linters]):
            pass
        for lint in linters:
            self.built_in_context |= lint.constructed_in_context()
        findings: List[Finding] = []
        for lint in linters:
            findings.extend(lint.run_rules())
        return findings


def _module_name(path: str) -> str:
    """``src/repro_torch/core/gc.py`` -> ``repro_torch.core.gc``."""
    p = path[len("src/"):] if path.startswith("src/") else path
    p = p[:-3] if p.endswith(".py") else p
    parts = [x for x in p.split("/") if x not in ("", ".")]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts) or "<module>"


def lint_source(src: str, path: str = "<string>") -> List[Finding]:
    """Lint one module's source text; returns sorted findings."""
    return _Project().lint([(src, path, _module_name(path))])


def _canonical_path(p: str) -> str:
    """Repo-relative form of ``p`` so baseline fingerprints are stable
    regardless of the invocation cwd or an absolute ``--root``: anchor
    on the last ``src/`` path component when present (the repo layout),
    else fall back to a plain cwd-relative path."""
    norm = os.path.normpath(p).replace(os.sep, "/")
    head, sep, tail = norm.rpartition("/src/")
    if sep:
        return "src/" + tail
    if norm.startswith("src/"):
        return norm
    return os.path.relpath(p).replace(os.sep, "/")


def lint_paths(paths: Sequence[str], modules: Optional[Sequence[str]] = None
               ) -> List[Finding]:
    """Lint the files ``paths`` together (reach follows imports between
    them); ``modules`` names their modules (default: from the paths)."""
    sources = []
    for i, p in enumerate(paths):
        with open(p, "r") as f:
            src = f.read()
        path = _canonical_path(p)
        sources.append((src, path, modules[i] if modules is not None
                        else _module_name(path)))
    findings = _Project().lint(sources)
    findings.sort(key=lambda f: (f.path, f.line, f.col))
    return findings


def lint_tree(root: str) -> List[Finding]:
    """Lint every ``*.py`` under ``root`` (skipping this package) as one
    package named after ``root``'s directory."""
    root = os.path.normpath(root)
    top = os.path.dirname(root)
    skip = os.path.join("repro_torch", "analysis")
    paths, modules = [], []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                full = os.path.join(dirpath, fn)
                if skip in full:
                    continue    # the linter does host work by design
                rel = os.path.relpath(full, top).replace(os.sep, "/")
                paths.append(full)
                modules.append(_module_name(rel))
    return lint_paths(paths, modules)


def load_baseline(path: str) -> Set[str]:
    """Fingerprints grandfathered by the checked-in baseline file."""
    if not os.path.exists(path):
        return set()
    out: Set[str] = set()
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                out.add(line.split(" #")[0].strip())
    return out


def partition(findings: Iterable[Finding],
              baseline: Set[str]) -> Tuple[List[Finding], List[Finding]]:
    """Split findings into (new, grandfathered-by-baseline)."""
    new, old = [], []
    for f in findings:
        (old if f.fingerprint() in baseline else new).append(f)
    return new, old
