"""Trees of tensors: flatten, unflatten, map, and the leaves' key paths.

The nodes are those of ``jax.tree_util`` that the training runtime
uses: dicts (children in sorted key order), lists, tuples and
``NamedTuple``s (fields in order); ``None`` is a node with no children.
Everything else is a leaf. A leaf's key path joins its keys with ``/``
as the JAX package's checkpoints name them, so a checkpoint written by
either package has the same keys: ``{"opt": AdamWState(step, m, v)}``
gives ``opt/step`` and ``opt/m/w``, a list's second item ``l/1``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

__all__ = ["TreeDef", "tree_flatten", "tree_flatten_with_path",
           "tree_flatten_up_to", "tree_unflatten", "tree_leaves",
           "tree_map"]

_LEAF = "leaf"
_END = object()


@dataclasses.dataclass(frozen=True)
class TreeDef:
    """A tree's structure: its node ``kind`` (``dict``, ``list``,
    ``tuple``, ``None``, a ``NamedTuple`` class, or ``"leaf"``), the dict's
    sorted keys, and the children's structures."""

    kind: Any
    keys: Tuple = ()
    children: Tuple["TreeDef", ...] = ()


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _children(node) -> Tuple[Any, Tuple, List[Tuple[str, Any]]]:
    """(kind, dict keys, [(path key, child)]) of a node; path keys are
    spelled as ``jax.tree_util``'s key entries print."""
    if node is None:
        return None, (), []
    if isinstance(node, dict):
        keys = tuple(sorted(node))
        return dict, keys, [(f"[{k!r}]", node[k]) for k in keys]
    if _is_namedtuple(node):
        return type(node), (), [(f".{f}", getattr(node, f))
                                for f in node._fields]
    if isinstance(node, (list, tuple)):
        return type(node), (), [(f"[{i}]", c) for i, c in enumerate(node)]
    return _LEAF, (), []


def tree_flatten_with_path(tree) -> Tuple[List[Tuple[str, Any]], TreeDef]:
    """([(key path, leaf)], treedef), leaves in ``jax.tree_util`` order."""
    out: List[Tuple[str, Any]] = []

    def walk(node, path: Tuple[str, ...]) -> TreeDef:
        kind, keys, kids = _children(node)
        if kind == _LEAF:
            out.append(("/".join(p.strip("[]'.") for p in path), node))
            return TreeDef(_LEAF)
        return TreeDef(kind, keys, tuple(walk(c, path + (k,))
                                         for k, c in kids))

    treedef = walk(tree, ())
    # ``walk`` refers to itself through its closure: clear that cell, or
    # the cycle keeps ``out`` (every leaf) alive until a garbage
    # collection, and a training step's old parameters with it
    del walk
    return out, treedef


def tree_flatten(tree) -> Tuple[List[Any], TreeDef]:
    flat, treedef = tree_flatten_with_path(tree)
    return [leaf for _, leaf in flat], treedef


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_unflatten(treedef: TreeDef, leaves) -> Any:
    it = iter(leaves)

    def build(td: TreeDef):
        if td.kind == _LEAF:
            return next(it)
        if td.kind is None:
            return None
        kids = [build(c) for c in td.children]
        if td.kind is dict:
            return dict(zip(td.keys, kids))
        if td.kind in (list, tuple):
            return td.kind(kids)
        return td.kind(*kids)                     # a NamedTuple

    out = build(treedef)
    del build                                   # the cycle: see above
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree has")
    return out


def tree_flatten_up_to(treedef: TreeDef, tree) -> List[Any]:
    """The subtrees of ``tree`` at ``treedef``'s leaves, in leaf order
    (``jax.tree_util``'s ``flatten_up_to``): a tree of names whose leaves
    are tuples, read against the structure of a tree of tensors."""
    out: List[Any] = []

    def walk(td: TreeDef, node) -> None:
        if td.kind == _LEAF:
            out.append(node)
            return
        kind, keys, kids = _children(node)
        if kind != td.kind or keys != td.keys or len(kids) != len(
                td.children):
            raise ValueError(f"tree structure {kind} {keys} does not match "
                             f"{td.kind} {td.keys}")
        for child_td, (_, child) in zip(td.children, kids):
            walk(child_td, child)

    walk(treedef, tree)
    del walk                                    # the cycle: see above
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree``, in a tree of its structure; each
    tree of ``rest`` gives the subtree at the same place as a further
    argument (read up to ``tree``'s leaves)."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten_up_to(treedef, r) for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
