"""Mel-Band RoFormer, the roformer stack over overlapping mel bands
(counterpart of sesa_tpu/models/mel_band_roformer.py).

Differences from BS-RoFormer: the band layout comes from a binarised
Slaney mel filterbank (overlapping bands, whose masks are averaged by
coverage in ``ops/bands.py``), each Transformer carries its own output
RMSNorm and there is no model-level final norm, the mask estimator has
``mask_estimator_depth`` hidden layers (the mel MLP convention), and
``mask_estimator_depth`` defaults to 1. The transformers are BS-RoFormer's,
so bf16 CUDA tensors run kernels K1 and K2, and the value-residual and
hyper-connection flags mean what they mean there.
"""

from __future__ import annotations

import functools

import numpy as np

from sesa_tpu_torch.models.bs_roformer import (
    RoformerSpec,
    _IGNORED_CONFIG_KEYS,
    apply_from_spec,
    convert_from_spec,
    init_from_spec,
)
from sesa_tpu_torch.ops.mel import mel_filter_bank


@functools.lru_cache(maxsize=8)
def mel_band_feats(num_bands: int, sample_rate: int, n_fft: int, stereo: bool):
    """Per-band packed-feature index tuples from the binarised mel bank:
    fb[0, 0] and fb[-1, -1] forced positive, then each band's frequency
    bins, each expanded to its (stereo, complex) features, f-major:
    feature = (f·ch + s)·2 + c."""
    fb = mel_filter_bank(sample_rate, n_fft, num_bands)
    fb[0, 0] = 1.0
    fb[-1, -1] = 1.0
    mask = fb > 0
    if not mask.any(axis=0).all():
        raise ValueError("every frequency must be covered by some mel band")
    ch = 2 if stereo else 1
    feats = []
    for bidx in range(num_bands):
        freqs = np.nonzero(mask[bidx])[0]
        f = (freqs[:, None] * ch * 2 + np.arange(ch * 2)[None, :]).reshape(-1)
        feats.append(tuple(f.astype(np.int32).tolist()))
    return tuple(feats)


_MEL_IGNORED = _IGNORED_CONFIG_KEYS | {"sample_rate", "num_bands"}


def spec_from_config(model_cfg) -> RoformerSpec:
    cfg = {k: v for k, v in dict(model_cfg).items() if k not in _MEL_IGNORED}
    if "use_value_residual_learning" in cfg:
        cfg["value_residual"] = bool(cfg.pop("use_value_residual_learning"))
    cfg.setdefault("mask_estimator_depth", 1)
    feats = mel_band_feats(int(dict(model_cfg).get("num_bands", 60)),
                           int(dict(model_cfg).get("sample_rate", 44100)),
                           int(cfg.get("stft_n_fft", 2048)), bool(cfg.get("stereo", False)))
    return RoformerSpec(band_feats=feats, mel_mlp_convention=True, **cfg)


def init(generator, config):
    return init_from_spec(generator, spec_from_config(config.model),
                          transformer_norm_output=True, final_norm=False)


def apply(params, config, x, compute_dtype=None):
    return apply_from_spec(params, spec_from_config(config.model), x,
                           compute_dtype=compute_dtype)


def convert_torch(state_dict, config):
    return convert_from_spec(state_dict, spec_from_config(config.model),
                             transformer_norm_output=True, final_norm=False)
