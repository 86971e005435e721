"""SCNet with dual-path transformers (counterpart of
sesa_tpu/models/scnet_tran.py): the SCNet encoder and decoder with the
separation net's BiLSTMs replaced by RoPE transformers (kernels K1 and K2
on bf16 CUDA tensors). The unused ``first_conv`` of the reference is kept
for checkpoint compatibility; the STFT is boxcar-windowed like SCNet's."""

from sesa_tpu_torch.models import scnet
from sesa_tpu_torch.models.scnet import prepare  # noqa: F401  (the session's weight cast)


def init(generator, config):
    return scnet.init(generator, config, variant="tran")


def apply(params, config, x, compute_dtype=None):
    return scnet.apply(params, config, x, variant="tran", compute_dtype=compute_dtype)


def convert_torch(state_dict, config):
    return scnet.convert_torch(state_dict, config, variant="tran")
