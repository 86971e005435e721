"""BS-RoFormer experimental: value-residual learning and hyper-connections
(counterpart of sesa_tpu/models/bs_roformer_experimental.py).

The base BS-RoFormer plus learned value-residual mixing (each later depth
layer's attention lerps its V toward the first depth layer's V with a
per-head sigmoid mix) and hyper-connection multi-stream residuals (see
``hyper_connections.py``). The experimental Transformer.forward (value
threading, no explicit residual adds after the first depth layer) applies
whether or not the value-residual flag is set.
"""

import dataclasses

from sesa_tpu_torch.models.bs_roformer import (
    apply_from_spec,
    convert_from_spec,
    init_from_spec,
    spec_from_config,
)


def _spec(config):
    return dataclasses.replace(spec_from_config(config.model), experimental_forward=True)


def init(generator, config):
    return init_from_spec(generator, _spec(config))


def apply(params, config, x, compute_dtype=None):
    return apply_from_spec(params, _spec(config), x, compute_dtype=compute_dtype)


def convert_torch(state_dict, config):
    return convert_from_spec(state_dict, _spec(config))
