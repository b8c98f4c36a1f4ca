"""Flat parameter trees in the JAX package's leaf order.

The JAX package keeps parameters as nested dicts and enumerates their
leaves with ``jax.tree.leaves``, which sorts dict keys at every level.
The port keeps a tree as a flat dict from dotted path
(``"BasicBlock_0.Conv_0.kernel"``) to tensor; sorting the paths by their
components gives the same leaf order.  The bucket layout depends on that
order: a bucket index must name the same coordinate in both packages.
"""

from __future__ import annotations

from typing import Callable, Dict, List

Tree = Dict[str, object]


def leaf_names(tree: Tree) -> List[str]:
    """Paths of ``tree`` in ``jax.tree.leaves`` order."""
    return sorted(tree, key=lambda name: name.split("."))


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``jax.tree.map`` over flat trees with the same paths, or over
    lists of the same length (a bucket list)."""
    if isinstance(tree, (list, tuple)):
        return [fn(*xs) for xs in zip(tree, *rest, strict=True)]
    return {k: fn(tree[k], *(r[k] for r in rest)) for k in leaf_names(tree)}


def from_nested(nested, prefix: str = "") -> Tree:
    """Flatten a nested dict (a flax ``params``/``batch_stats`` tree) to
    dotted paths."""
    out = {}
    for key, value in nested.items():
        path = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(value, dict) or hasattr(value, "items"):
            out.update(from_nested(value, path))
        else:
            out[path] = value
    return out

