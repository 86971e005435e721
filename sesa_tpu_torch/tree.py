"""Small helpers over parameter trees (nested dicts and lists of tensors)."""

from __future__ import annotations

from typing import Callable


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` to every leaf of a tree of dicts, lists and tuples; with
    ``rest``, to the leaves at the same place in each tree
    (``fn(leaf, *rest_leaves)``). The trees must have one structure, else
    ``ValueError``."""
    if isinstance(tree, dict):
        if any(not isinstance(r, dict) or r.keys() != tree.keys() for r in rest):
            raise ValueError(f"trees differ: keys {sorted(tree)}")
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        if any(not isinstance(r, (list, tuple)) or len(r) != len(tree) for r in rest):
            raise ValueError(f"trees differ: a sequence of {len(tree)}")
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)
