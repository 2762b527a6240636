"""Parameter trees: nested dicts and lists of tensors, mapped leaf by leaf.

The training side (``train/``) and the mesh (``parallel/mesh.py``) both
walk parameter trees with these. A sharded tree
(``parallel.mesh.ShardedParams``) maps itself through its ``tree_map``
method, replica by replica, so the optimizer and a state's copies run on
it as on one device's tree.
"""

from __future__ import annotations

from typing import Callable


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the tensors of a parameter tree (dicts and lists), with
    the same-shaped trees ``rest`` alongside. An object with a ``tree_map``
    method (a sharded tree) maps itself, with ``rest`` in its layout."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    if hasattr(tree, "tree_map"):
        return tree.tree_map(fn, *rest)
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The tensors of a parameter tree, in :func:`tree_map`'s order (a
    sharded tree's replicas in mesh order)."""
    out: list = []
    tree_map(out.append, tree)
    return out
