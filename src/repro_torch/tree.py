"""The port's trees: nested dicts whose leaves are tensors (or arrays, or
anything that is not a dict), walked in one of two orders.

``flat_leaves`` walks in insertion order and names each leaf by its path
of keys joined by "/" (``layers/attn/wq/w``), as the JAX package's
``tree_flatten_with_path`` joins them; ``unflatten`` is its inverse.
``tree_leaves`` walks in ``jax.tree.flatten``'s order, keys sorted at
every level, where a sum over the leaves must add in the reference's
order.  ``tree_map`` keeps the structure.
"""

from __future__ import annotations

from typing import Callable


def flat_leaves(tree: dict, prefix: str = "") -> dict:
    """A nested tree's leaves by path ("layers/attn/wq/w"), e.g. to set
    ``requires_grad`` on every parameter before ``Model.loss``."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        out.update(flat_leaves(v, path + "/") if isinstance(v, dict) else {path: v})
    return out


def unflatten(like: dict, leaves: dict, prefix: str = "") -> dict:
    """``like``'s structure with each leaf replaced by ``leaves[path]``."""
    return {k: unflatten(v, leaves, f"{prefix}{k}/") if isinstance(v, dict)
            else leaves[f"{prefix}{k}"] for k, v in like.items()}


def tree_leaves(tree) -> list:
    """The leaves of a nested dict in ``jax.tree.flatten``'s order: keys
    sorted at every level."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (each of ``tree``'s structure), as a tree of that structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)
