"""Nested parameter trees: dicts, lists and tuples of tensors.

The order of :func:`tree_leaves` is the JAX package's ``jax.tree.leaves``
order (dict keys sorted as strings, recursively), so the leaves of a
parameter tree, of its gradients and of an optimizer state line up with the
JAX package's in ``coefficients.npz`` and ``updaterState.npz``.
"""

from __future__ import annotations

from typing import Any, Callable, List


def tree_leaves(tree) -> List[Any]:
    """Leaves of nested dicts/lists/tuples in ``jax.tree.leaves`` order:
    dict keys sorted, sequences in order, ``None`` dropped."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_unflatten_like(like, leaves: List[Any]):
    """Rebuild ``like``'s structure from ``leaves`` (in :func:`tree_leaves`
    order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            rebuilt = {k: build(node[k]) for k in sorted(node)}
            return {k: rebuilt[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return None if node is None else next(it)

    return build(like)


def tree_map(fn: Callable[[Any], Any], tree):
    """``tree`` with ``fn`` applied to each leaf, the structure kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_paths(tree, prefix=()) -> List[tuple]:
    """The key path of each leaf (dict keys and sequence indices), in
    :func:`tree_leaves` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in tree_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in tree_paths(v, prefix + (i,))]
    return [] if tree is None else [prefix]
