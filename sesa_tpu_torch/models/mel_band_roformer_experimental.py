"""Mel-Band RoFormer experimental: value-residual learning and
hyper-connections (counterpart of
sesa_tpu/models/mel_band_roformer_experimental.py); see
``bs_roformer_experimental.py`` for the mechanism.
"""

import dataclasses

from sesa_tpu_torch.models.bs_roformer import apply_from_spec, convert_from_spec, init_from_spec
from sesa_tpu_torch.models.mel_band_roformer import spec_from_config


def _spec(config):
    return dataclasses.replace(spec_from_config(config.model), experimental_forward=True)


def init(generator, config):
    return init_from_spec(generator, _spec(config), transformer_norm_output=True,
                          final_norm=False)


def apply(params, config, x, compute_dtype=None):
    return apply_from_spec(params, _spec(config), x, compute_dtype=compute_dtype)


def convert_torch(state_dict, config):
    return convert_from_spec(state_dict, _spec(config), transformer_norm_output=True,
                             final_norm=False)
