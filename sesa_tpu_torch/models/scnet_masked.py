"""SCNet masked variant (counterpart of sesa_tpu/models/scnet_masked.py):
SCNet plus a learned frequency embedding on the input spectrum, a
conv/GELU/conv/tanh mask head and a complex mask applied to the tiled
mixture spectrum; a periodic Hann window."""

from sesa_tpu_torch.models import scnet
from sesa_tpu_torch.models.scnet import prepare  # noqa: F401  (the session's weight cast)


def init(generator, config):
    return scnet.init(generator, config, variant="masked")


def apply(params, config, x, compute_dtype=None):
    return scnet.apply(params, config, x, variant="masked", compute_dtype=compute_dtype)


def convert_torch(state_dict, config):
    return scnet.convert_torch(state_dict, config, variant="masked")
