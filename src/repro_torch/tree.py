"""Nested containers of tensors: the port's stand-in for JAX pytrees.

A tree is a dict (walked in sorted key order, as JAX does), a tuple or
list, a NamedTuple (walked in field order), or a leaf (anything else).
Parameters, optimizer states, train states and checkpoint payloads are
all such trees.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

Tree = Any


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (tuple, list)):
        return [(str(i), x) for i, x in enumerate(tree)]
    raise TypeError(f"not a container: {type(tree)}")


def _rebuild(tree, values: List[Any]):
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), values))
    if _is_namedtuple(tree):
        return type(tree)(*values)
    return type(tree)(values)


def _is_leaf(x) -> bool:
    return not isinstance(x, (dict, tuple, list))


def tree_flatten_with_names(tree: Tree, prefix: str = "") -> Tuple[List[str], List[Any]]:
    """(names, leaves) in walk order; a name is the '/'-joined path."""
    if _is_leaf(tree):
        return [prefix], [tree]
    names, leaves = [], []
    for key, child in _children(tree):
        n, lv = tree_flatten_with_names(child, f"{prefix}/{key}" if prefix else key)
        names += n
        leaves += lv
    return names, leaves


def tree_leaves(tree: Tree) -> List[Any]:
    return tree_flatten_with_names(tree)[1]


def tree_unflatten(like: Tree, leaves: List[Any]) -> Tree:
    """A tree of ``like``'s structure holding ``leaves`` in walk order."""
    it = iter(leaves)

    def build(node):
        if _is_leaf(node):
            return next(it)
        return _rebuild(node, [build(child) for _, child in _children(node)])

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn: Callable[..., Any], tree: Tree, *rest: Tree) -> Tree:
    """``fn`` applied leaf-wise over trees of one structure."""
    leaves = [tree_leaves(t) for t in (tree, *rest)]
    if any(len(lv) != len(leaves[0]) for lv in leaves):
        raise ValueError("tree_map over trees of different structure")
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*leaves)])
