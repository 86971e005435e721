"""Carry parameters from the JAX package into the port.

The port keeps the JAX package's parameter trees (grouped band weights,
torch-layout projection weights, the same key names, the ``hc`` / ``branch``
nesting and ``vr_mix_*`` leaves of the experimental roformers) for every
ported model, so the mapping is a copy of every leaf, checked against the
tree the port's own init builds. Leaves are
numpy arrays (``np.asarray`` of the JAX arrays); this module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from sesa_tpu_torch.models import bs_roformer, get_model
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


def _expected(model, config):
    gen = torch.Generator().manual_seed(0)
    if isinstance(model, bs_roformer.RoformerSpec):
        mel = model.mel_mlp_convention  # mel_band_roformer's spec
        return bs_roformer.init_from_spec(gen, model, transformer_norm_output=mel,
                                          final_norm=not mel)
    return get_model(model).init(gen, config)


def params_from_jax(params_np, model, config=None):
    """A JAX parameter tree (numpy leaves) -> the port's tree.

    ``model`` is a ``RoformerSpec`` (bs_roformer; mel_band_roformer when its
    ``mel_mlp_convention`` is set) or a model type string, with ``config``,
    such as ``"mel_band_conformer"``, ``"apollo"``, ``"bs_mamba2"``,
    ``"bs_roformer_experimental"``, ``"bs_roformer_custom"``,
    ``"conformer"``, ``"scnet"``, ``"scnet_tran"``, ``"scnet_masked"``,
    ``"scnet_unofficial"``, ``"mdx23c"``, ``"experimental_mdx23c_stht"``,
    ``"htdemucs"`` (its config's ``model`` naming ``htdemucs``, ``hdemucs``
    or the legacy ``demucs``), ``"bandit"``, ``"bandit_v2"``,
    ``"segm_models"`` or ``"torchseg"`` (the MaxViT, ResNet or EfficientNet
    U-Net its config's ``model.encoder_name`` names, else the fallback conv
    U-Net) or ``"swin_upernet"``. Raises ``ValueError``
    when the tree's keys or shapes differ from those of the port's own init.
    """
    expected = _shapes(_expected(model, config))
    got = _shapes(params_np)
    if got != expected:
        diff = sorted(set(got.items()) ^ set(expected.items()), key=str)[:8]
        raise ValueError(f"JAX parameter tree does not match the model: {diff}")
    return tree_map(lambda a: torch.from_numpy(np.array(a, dtype=np.float32)), params_np)
