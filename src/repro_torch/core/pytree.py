"""Nested containers of tensors ("trees"), walked as the JAX package's
pytrees are.

A tree is a dict, list, tuple or NamedTuple of trees, ``None`` (a node with
no children, as in ``jax.tree_util``: it yields no leaf and is rebuilt as
``None``), or a leaf (a tensor, a numpy array or a number).  The walk order
is ``jax.tree_util``'s: dict entries in sorted key order, sequences and
NamedTuple fields in order.  A leaf's path names each step as jax's key
paths print: a dict key as itself, a sequence index as its number, a
NamedTuple field as ``.field`` -- so :func:`leaf_paths` gives the JAX
package's leaf names for the same tree.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> list[tuple[str, Any]] | None:
    """(key, child) pairs of a container node, None for a leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(tree)]
    return None


def _rebuild(tree, children: list):
    """A node like ``tree`` holding ``children`` (in walk order); a dict
    keeps ``tree``'s key order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        by_key = dict(zip(sorted(tree), children))
        return {k: by_key[k] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*children)
    return type(tree)(children)


def key_paths(tree, keys: tuple = ()) -> list[tuple[tuple[str, ...], Any]]:
    """``(key path, leaf)`` pairs in walk order."""
    kids = _children(tree)
    if kids is None:
        return [(keys, tree)]
    out = []
    for key, child in kids:
        out += key_paths(child, keys + (key,))
    return out


def leaf_name(keys) -> str:
    """'/'-joined name of one key path: the lookup key joining a tree's save
    and its restore."""
    return "/".join(keys)


def leaf_paths(tree) -> list[tuple[str, Any]]:
    """``(name, leaf)`` pairs in walk order (see :func:`leaf_name`)."""
    return [(leaf_name(keys), leaf) for keys, leaf in key_paths(tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaf_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of each
    tree in ``rest``), in a tree of the same structure."""
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    rest_kids = [[c for _, c in _children(r)] for r in rest]
    return _rebuild(tree, [tree_map(fn, c, *(rk[i] for rk in rest_kids))
                           for i, (_, c) in enumerate(kids)])


def unflatten(template, new_leaves) -> Any:
    """A tree of ``template``'s structure holding ``new_leaves`` (in walk
    order)."""
    it: Iterator = iter(new_leaves)
    out = tree_map(lambda _leaf: next(it), template)
    if next(it, it) is not it:
        raise ValueError("more leaves than the template has")
    return out
