"""Mel-Band Conformer, the mel band-split stack with axial Conformers
(counterpart of sesa_tpu/models/mel_band_conformer.py).

The band machinery is Mel-Band RoFormer's (binarised mel bands, band split,
mask estimator with the mel MLP convention, overlapping masks averaged by
coverage), but the time and freq blocks are lucidrains Conformers
(``conformer_core.py``: kernels K2, K4 and K5 on bf16 CUDA tensors) and
there is no final norm (each ConformerBlock post-norms itself). A Python
loop over depth replaces the JAX ``lax.scan``.
"""

from __future__ import annotations

import torch

from sesa_tpu_torch.models import conformer_core as cc
from sesa_tpu_torch.models.bs_roformer import _band_plan, _make_take
from sesa_tpu_torch.models.mel_band_roformer import mel_band_feats
from sesa_tpu_torch.ops import bands as B
from sesa_tpu_torch.ops.prec import net_precision
from sesa_tpu_torch.ops.stft import hann_window, istft_ri, stft_ri
from sesa_tpu_torch.tree import tree_map

_DEFAULTS = dict(dim=192, depth=6, stereo=False, num_stems=1, time_conformer_depth=2,
                 freq_conformer_depth=2, num_bands=60, dim_head=64, heads=8, ff_mult=4,
                 conv_expansion_factor=2, conv_kernel_size=31, sample_rate=44100,
                 stft_n_fft=2048, stft_hop_length=512, stft_win_length=2048,
                 stft_normalized=False, mask_estimator_depth=1,
                 match_input_audio_length=False)


def _kwargs(config):
    kw = dict(_DEFAULTS)
    kw.update({k: v for k, v in dict(config.model).items() if k in kw})
    return kw


def _plan(kw) -> B.BandPlan:
    n_fft, stereo = int(kw["stft_n_fft"]), bool(kw["stereo"])
    feats = mel_band_feats(int(kw["num_bands"]), int(kw["sample_rate"]), n_fft, stereo)
    return _band_plan(feats, (n_fft // 2 + 1) * (2 if stereo else 1) * 2)


def _conformer_kwargs(kw):
    return {k: kw[k] for k in ("dim_head", "heads", "ff_mult", "conv_expansion_factor",
                               "conv_kernel_size")}


def init(generator: torch.Generator, config):
    """Random parameters drawn on the CPU from ``generator`` (the numbers
    differ from the JAX package's init)."""
    kw = _kwargs(config)
    plan = _plan(kw)
    ckw = _conformer_kwargs(kw)
    layers = [{"time": cc.conformer_init(generator, kw["dim"], kw["time_conformer_depth"], **ckw),
               "freq": cc.conformer_init(generator, kw["dim"], kw["freq_conformer_depth"], **ckw)}
              for _ in range(kw["depth"])]
    return {
        "band_split": B.band_split_init(generator, plan, kw["dim"]),
        "layers": layers,
        # mel MLP convention: mask_estimator_depth hidden layers
        "mask_estimators": [B.mask_estimator_init(generator, plan, kw["dim"],
                                                  kw["mask_estimator_depth"], 4)
                            for _ in range(kw["num_stems"])],
    }


def apply(params, config, x: torch.Tensor, compute_dtype=None):
    """x (B, ch, T) -> (B, num_stems, ch, T).

    ``compute_dtype=torch.bfloat16`` runs the band split, conformers and mask
    estimators in bf16 (kernels K2, K4 and K5 on CUDA); the STFT, mask
    multiply and iSTFT stay f32.
    """
    with net_precision(compute_dtype) as dtype:
        kw = _kwargs(config)
        plan = _plan(kw)
        b, ch, t = x.shape
        if ch != (2 if kw["stereo"] else 1):
            raise ValueError(f"expected {2 if kw['stereo'] else 1} channels, got {ch}")

        window = hann_window(kw["stft_win_length"], device=x.device)
        s = stft_ri(x, kw["stft_n_fft"], kw["stft_hop_length"], window,
                    win_length=kw["stft_win_length"], normalized=kw["stft_normalized"])
        tf = s.shape[-2]
        n_features = plan.num_features
        # pack (f, s, c) minor-to-major order: feature = (f*ch + s)*2 + c
        sp = s.permute(0, 3, 2, 1, 4).reshape(b, tf, n_features)

        if dtype != torch.float32:
            params = tree_map(lambda p: p.to(dtype), params)
        xb = B.band_split_apply(plan, params["band_split"], sp.to(dtype))
        nb, dim = plan.num_bands, kw["dim"]
        for layer in params["layers"]:
            z = xb.permute(0, 2, 1, 3).reshape(b * nb, tf, dim)  # sequence = frames
            z = cc.conformer_apply(layer["time"], z, kw["heads"])
            z = z.reshape(b, nb, tf, dim).permute(0, 2, 1, 3).reshape(b * tf, nb, dim)
            xb = cc.conformer_apply(layer["freq"], z, kw["heads"]).reshape(b, tf, nb, dim)

        masks = torch.stack([B.mask_estimator_apply(plan, p, xb)
                             for p in params["mask_estimators"]], dim=1).float()

        nstems = masks.shape[1]
        m = masks.reshape(b, nstems, tf, n_features // 2, 2)
        sr = sp.reshape(b, 1, tf, n_features // 2, 2)
        re = m[..., 0] * sr[..., 0] - m[..., 1] * sr[..., 1]
        im = m[..., 0] * sr[..., 1] + m[..., 1] * sr[..., 0]
        n_freq = kw["stft_n_fft"] // 2 + 1
        out = torch.stack([re, im], dim=-1).reshape(b, nstems, tf, n_freq, ch, 2)
        return istft_ri(out.permute(0, 1, 4, 3, 2, 5), kw["stft_n_fft"], kw["stft_hop_length"],
                        window, win_length=kw["stft_win_length"],
                        normalized=kw["stft_normalized"], length=t)


def convert_torch(state_dict, config):
    """Band and mask keys as the roformer family's; the axial blocks are
    lucidrains Conformers at ``layers.{d}.{0,1}``. Every key is consumed;
    leftovers raise."""
    kw = _kwargs(config)
    plan = _plan(kw)
    sd, used, take = _make_take(cc.apply_key_map(state_dict))

    bs_groups = [{
        "norm_gamma": torch.stack([take(f"band_split.to_features.{i}.0.gamma") for i in ids]),
        "weight": torch.stack([take(f"band_split.to_features.{i}.1.weight").T for i in ids]),
        "bias": torch.stack([take(f"band_split.to_features.{i}.1.bias") for i in ids]),
    } for ids in plan.group_band_ids]

    layers = [{"time": cc.convert_conformer(take, f"layers.{d}.0", kw["time_conformer_depth"]),
               "freq": cc.convert_conformer(take, f"layers.{d}.1", kw["freq_conformer_depth"])}
              for d in range(kw["depth"])]

    mask_estimators = []
    for s in range(kw["num_stems"]):
        pre = f"mask_estimators.{s}.to_freqs"
        n_hidden = kw["mask_estimator_depth"]  # the mel MLP convention
        hidden = [{
            "weight": torch.stack([take(f"{pre}.{i}.0.{2 * li}.weight").T
                                   for i in range(plan.num_bands)]),
            "bias": torch.stack([take(f"{pre}.{i}.0.{2 * li}.bias")
                                 for i in range(plan.num_bands)]),
        } for li in range(n_hidden)]
        last = 2 * n_hidden
        groups = [{
            "weight": torch.stack([take(f"{pre}.{i}.0.{last}.weight").T for i in ids]),
            "bias": torch.stack([take(f"{pre}.{i}.0.{last}.bias") for i in ids]),
        } for ids in plan.group_band_ids]
        mask_estimators.append({"hidden": hidden, "groups": groups})

    params = {"band_split": {"groups": bs_groups}, "layers": layers,
              "mask_estimators": mask_estimators}
    unused = {k for k in set(sd) - used
              if not k.endswith(("freq_indices", "freqs_per_band", "num_freqs_per_band",
                                 "num_bands_per_freq"))}
    if unused:
        raise ValueError(
            f"unconsumed checkpoint keys: {sorted(unused)[:8]} ... — this conformer-family "
            "checkpoint's module layout differs from the assumed lucidrains reconstruction. "
            "See README 'Conformer checkpoint layout recovery' for how to supply a key "
            "mapping (SESA_CONFORMER_KEY_MAP).")
    return tree_map(lambda v: v.contiguous(), params)
