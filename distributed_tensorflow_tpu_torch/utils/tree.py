"""Nested containers (dicts, lists, tuples, named tuples, None) with
``jax.tree_util``'s leaf order — what the JAX package's pytree calls
give the datasets, strategies and Keras models, for the port's
host-side code.

As in JAX: a dict's children are taken in sorted key order, ``None``
is a node with no children, and any other object is a leaf unless
``is_leaf`` says otherwise.
"""

from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


class TreeDef:
    """The structure of a tree without its leaves."""

    __slots__ = ("kind", "aux", "children")

    def __init__(self, kind: str, aux=None, children=()):
        self.kind, self.aux, self.children = kind, aux, tuple(children)

    @property
    def num_leaves(self) -> int:
        if self.kind == "leaf":
            return 1
        return sum(c.num_leaves for c in self.children)

    def __eq__(self, other):
        return (isinstance(other, TreeDef) and self.kind == other.kind
                and self.aux == other.aux
                and self.children == other.children)

    def __hash__(self):
        return hash((self.kind, str(self.aux), self.children))

    def __repr__(self):
        return f"TreeDef({self.kind}, {self.aux!r}, {list(self.children)})"


def _flatten(x, is_leaf, leaves) -> TreeDef:
    if is_leaf is not None and is_leaf(x):
        leaves.append(x)
        return TreeDef("leaf")
    if x is None:
        return TreeDef("none")
    if isinstance(x, dict):
        keys = sorted(x)
        return TreeDef("dict", (type(x), tuple(keys)),
                       [_flatten(x[k], is_leaf, leaves) for k in keys])
    if _is_namedtuple(x):
        return TreeDef("namedtuple", type(x),
                       [_flatten(v, is_leaf, leaves) for v in x])
    if isinstance(x, (list, tuple)):
        return TreeDef(type(x).__name__, None,
                       [_flatten(v, is_leaf, leaves) for v in x])
    leaves.append(x)
    return TreeDef("leaf")


def tree_flatten(tree, is_leaf: Callable | None = None):
    """``(leaves, treedef)``."""
    leaves: list = []
    return leaves, _flatten(tree, is_leaf, leaves)


def _build(td: TreeDef, it):
    if td.kind == "leaf":
        return next(it)
    if td.kind == "none":
        return None
    kids = [_build(c, it) for c in td.children]
    if td.kind == "dict":
        cls, keys = td.aux
        out = dict(zip(keys, kids))
        return out if cls is dict else cls(out)
    if td.kind == "namedtuple":
        return td.aux(*kids)
    return tuple(kids) if td.kind == "tuple" else list(kids)


def tree_unflatten(treedef: TreeDef, leaves):
    return _build(treedef, iter(leaves))


def tree_leaves(tree, is_leaf: Callable | None = None) -> list:
    return tree_flatten(tree, is_leaf)[0]


def tree_structure(tree, is_leaf: Callable | None = None) -> TreeDef:
    return tree_flatten(tree, is_leaf)[1]


def tree_map(fn: Callable, tree, *rest, is_leaf: Callable | None = None):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    each tree of ``rest``, which share ``tree``'s structure)."""
    leaves, td = tree_flatten(tree, is_leaf)
    others = [td_leaves(td, r) for r in rest]
    return tree_unflatten(td, [fn(*xs) for xs in zip(leaves, *others)])


def td_leaves(td: TreeDef, tree) -> list:
    """The leaves of ``tree`` down to ``td``'s leaf positions (a leaf of
    ``td`` may hold a whole subtree of ``tree``)."""
    out: list = []

    def walk(t: TreeDef, x):
        if t.kind == "leaf":
            out.append(x)
        elif t.kind == "none":
            return
        elif t.kind == "dict":
            for k, c in zip(t.aux[1], t.children):
                walk(c, x[k])
        else:
            for c, v in zip(t.children, x):
                walk(c, v)
    walk(td, tree)
    return out


def tree_leaves_with_path(tree) -> list[tuple[tuple, Any]]:
    """``[(path, leaf)]``: a path is the tuple of dict keys and sequence
    indices down to the leaf."""
    out: list = []

    def walk(x, path):
        if x is None:
            return
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], path + (k,))
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, path + (i,))
        else:
            out.append((path, x))
    walk(tree, ())
    return out
