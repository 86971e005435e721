"""Small helpers over parameter trees (nested dicts and lists of tensors)."""

from __future__ import annotations

from typing import Callable


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)
