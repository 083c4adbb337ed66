"""Nested dicts of tensors (the port's pytrees), walked in JAX's leaf order.

`jax.tree.flatten` orders a dict's leaves by sorted key; the optimizer's
global norm sums the leaves in that order, so the port walks them so too.
"""

from __future__ import annotations

from typing import Callable


def leaves(tree) -> list:
    """The leaves of a nested dict in sorted-key order (`jax.tree.leaves`)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def paths(tree, prefix: str = "") -> list[tuple[str, object]]:
    """(path joined by "/", leaf) in sorted-key order."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in paths(tree[k], f"{prefix}/{k}" if prefix else str(k))]
    return [(prefix, tree)]


def tree_map(fn: Callable, tree, *rest, is_leaf: Callable = lambda x: False):
    """`fn` over the leaves of `tree` and the matching leaves of `rest`."""
    if isinstance(tree, dict) and not is_leaf(tree):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf) for k, v in tree.items()}
    return fn(tree, *rest)
