"""Parameter trees: the port's stand-in for ``jax.tree``.

A tree is nested dicts (flattened in sorted key order, as JAX flattens
them), lists, tuples and NamedTuples; ``None`` is an empty subtree and
anything else a leaf (a sharding spec too, though it is a tuple).  A leaf's path is the tuple of its keys: a dict's
key, a sequence's index (as a string) and a NamedTuple's field as
``".field"``, which is how the reference's checkpoint writes
``jax.tree_util``'s ``GetAttrKey``.
"""
from __future__ import annotations


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node):
    """``(key, child)`` pairs of an inner node, or ``None`` for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if getattr(node, "_tree_leaf", False):
        return None
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def _rebuild(node, children: list):
    if isinstance(node, dict):
        return dict(zip(sorted(node), children))
    if _is_namedtuple(node):
        return type(node)(*children)
    return type(node)(children)


def _child(node, key: str):
    if isinstance(node, dict):
        return node[key]
    if _is_namedtuple(node):
        return getattr(node, key[1:])
    return node[int(key)]


def flatten_with_paths(tree, path: tuple = ()) -> list:
    """``[(path, leaf), ...]`` in flattening order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(path, tree)]
    return [pl for k, c in kids for pl in flatten_with_paths(c, (*path, k))]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def tree_map_with_path(fn, tree, *rest, path: tuple = ()):
    """``fn(path, leaf, *leaves of rest)`` over ``tree``'s structure; the
    other trees are read at the same keys."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(path, tree, *rest)
    return _rebuild(tree, [
        tree_map_with_path(fn, c, *(_child(r, k) for r in rest),
                           path=(*path, k)) for k, c in kids])


def tree_map(fn, tree, *rest):
    """``fn(leaf, *leaves of rest)`` over ``tree``'s structure."""
    return tree_map_with_path(lambda _, *xs: fn(*xs), tree, *rest)


def unflatten_like(tree, leaves):
    """``tree``'s structure with ``leaves`` in flattening order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
