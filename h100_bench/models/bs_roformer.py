"""The yardstick of ``bs_roformer``: see ``_roformer.py``."""

from __future__ import annotations

import functools

from h100_bench.models import _roformer as R
from h100_bench.reference import roformer as ref

MODEL_TYPE = "bs_roformer"
KERNEL_LIBRARIES = ("attention", "ff")

frames = R.frames
state_dict_layout = functools.partial(R.state_dict_layout, MODEL_TYPE)
model_flops_per_chunk = functools.partial(R.model_flops_per_chunk, MODEL_TYPE)
kernel_bound_s = functools.partial(R.kernel_bound_s, MODEL_TYPE)
kernel_launches = functools.partial(R.kernel_launches, MODEL_TYPE)


def reference_forward(sd, model: dict, x, products=None):
    """The plain forward: x (B, ch, T) -> (B, S, ch, T); ``products`` as
    ``reference.roformer.forward`` takes them (f32 unless given)."""
    return ref.forward(sd, MODEL_TYPE, model, x, products)
