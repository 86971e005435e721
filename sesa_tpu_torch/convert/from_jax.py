"""Carry parameters from the JAX package into the port.

The port keeps the JAX package's bs_roformer parameter tree (grouped band
weights, torch-layout projection weights, the same key names), so the
mapping is a copy of every leaf, checked against the tree the spec
describes. Leaves are numpy arrays (``np.asarray`` of the JAX arrays); this
module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from sesa_tpu_torch.models import bs_roformer
from sesa_tpu_torch.tree import tree_map


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {f"{prefix}#len": len(tree)}
        for i, v in enumerate(tree):
            out.update(_shapes(v, f"{prefix}{i}/"))
        return out
    return {prefix.rstrip("/"): tuple(np.shape(tree))}


def params_from_jax(params_np, spec: bs_roformer.RoformerSpec):
    """JAX bs_roformer parameter tree (numpy leaves) -> the port's tree.

    Raises ``ValueError`` when the tree's keys or shapes differ from those
    ``spec`` describes (checked against the port's own init).
    """
    expected = _shapes(bs_roformer.init_from_spec(torch.Generator().manual_seed(0), spec))
    got = _shapes(params_np)
    if got != expected:
        diff = sorted(set(got.items()) ^ set(expected.items()), key=str)[:8]
        raise ValueError(f"JAX parameter tree does not match the spec: {diff}")
    return tree_map(lambda a: torch.from_numpy(np.array(a, dtype=np.float32)), params_np)
