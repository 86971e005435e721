"""model_type string -> model module dispatch (counterpart of
sesa_tpu/models/registry.py): every model type of the JAX registry."""

from __future__ import annotations

import importlib

MODEL_TYPES = {
    "bs_roformer": "sesa_tpu_torch.models.bs_roformer",
    "bs_roformer_experimental": "sesa_tpu_torch.models.bs_roformer_experimental",
    "bs_roformer_custom": "sesa_tpu_torch.models.bs_roformer_custom",
    "mel_band_roformer": "sesa_tpu_torch.models.mel_band_roformer",
    "mel_band_roformer_experimental": "sesa_tpu_torch.models.mel_band_roformer_experimental",
    "mel_band_conformer": "sesa_tpu_torch.models.mel_band_conformer",
    "apollo": "sesa_tpu_torch.models.apollo",
    "bs_mamba2": "sesa_tpu_torch.models.bs_mamba2",
    "conformer": "sesa_tpu_torch.models.conformer",
    "scnet": "sesa_tpu_torch.models.scnet",
    "scnet_tran": "sesa_tpu_torch.models.scnet_tran",
    "scnet_masked": "sesa_tpu_torch.models.scnet_masked",
    "scnet_unofficial": "sesa_tpu_torch.models.scnet_unofficial",
    "mdx23c": "sesa_tpu_torch.models.mdx23c",
    "experimental_mdx23c_stht": "sesa_tpu_torch.models.mdx23c_stht",
    # model: htdemucs, hdemucs or demucs (the legacy net) in the config
    "htdemucs": "sesa_tpu_torch.models.htdemucs",
    "bandit": "sesa_tpu_torch.models.bandit",
    "bandit_v2": "sesa_tpu_torch.models.bandit_v2",
    # the encoder zoo follows config.model.encoder_name
    "segm_models": "sesa_tpu_torch.models.segm_models",
    "torchseg": "sesa_tpu_torch.models.segm_models",
    "swin_upernet": "sesa_tpu_torch.models.swin_upernet",
}


def get_model(model_type: str):
    """Return the model module for a model_type string."""
    if model_type not in MODEL_TYPES:
        raise ValueError(f"unknown model type {model_type!r}; known: {sorted(MODEL_TYPES)}")
    return importlib.import_module(MODEL_TYPES[model_type])
