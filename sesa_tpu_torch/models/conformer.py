"""ConformerMSS, the magnitude-STFT conformer with complex masks
(counterpart of sesa_tpu/models/conformer.py).

Magnitude STFT -> linear projection of each frame's (channels·freq)
magnitudes -> lucidrains Conformer stack over frames (``conformer_core.py``)
-> tanh -> linear to per source·channel real/imag masks -> complex multiply
with the STFT -> iSTFT. The STFT parameters come from ``config.stft``.

The model runs in f32 only: its ``apply`` takes no ``compute_dtype``, as the
JAX function has none, so a bf16 session calls it on the f32 weights
(``runtime/session.py``) and it reaches no kernel (the conformer's kernels
take bf16 only).
"""

from __future__ import annotations

import torch

from sesa_tpu_torch.models import conformer_core as cc
from sesa_tpu_torch.models.bs_roformer import _make_take
from sesa_tpu_torch.models.layers import kaiming_uniform, linear
from sesa_tpu_torch.ops.prec import net_precision
from sesa_tpu_torch.ops.stft import hann_window, istft_ri, stft_ri


def _kwargs(config):
    model = dict(config.model)
    stft = dict(config.get("stft", {}) or {})
    kw = dict(in_channels=2, sources=2, freq_bins=2049, embed_dim=512, depth=8,
              dim_head=64, heads=8, ff_mult=4, conv_expansion_factor=2,
              conv_kernel_size=31)
    kw.update({k: v for k, v in model.items() if k in kw})
    kw["n_fft"] = int(stft.get("n_fft", 4096))
    kw["hop_length"] = int(stft.get("hop_length", 1024))
    kw["win_length"] = int(stft.get("win_length", kw["n_fft"]))
    kw["center"] = bool(stft.get("center", True))
    if kw["freq_bins"] != kw["n_fft"] // 2 + 1:
        raise ValueError(f"freq_bins {kw['freq_bins']} must be stft.n_fft // 2 + 1 "
                         f"= {kw['n_fft'] // 2 + 1}")
    return kw


def init(generator: torch.Generator, config):
    """Random parameters drawn on the CPU from ``generator`` (the numbers
    differ from the JAX package's init)."""
    kw = _kwargs(config)
    fb, ch, emb = kw["freq_bins"], kw["in_channels"], kw["embed_dim"]
    out = kw["sources"] * ch * 2
    return {
        "input_proj": {"weight": kaiming_uniform((emb, fb * ch), fb * ch, generator),
                       "bias": torch.zeros(emb)},
        "conformer": cc.conformer_init(
            generator, emb, kw["depth"], dim_head=kw["dim_head"], heads=kw["heads"],
            ff_mult=kw["ff_mult"], conv_expansion_factor=kw["conv_expansion_factor"],
            conv_kernel_size=kw["conv_kernel_size"]),
        "output_proj": {"weight": kaiming_uniform((fb * out, emb), emb, generator),
                        "bias": torch.zeros(fb * out)},
    }


def apply(params, config, x):
    """(B, C, T) -> (B, S, C, T), in f32."""
    with net_precision(None):
        kw = _kwargs(config)
        b, ch, t_samples = x.shape
        fb, s_src = kw["freq_bins"], kw["sources"]
        x = x.float()

        window = hann_window(kw["win_length"], device=x.device)
        spec = stft_ri(x.reshape(b * ch, t_samples), kw["n_fft"], kw["hop_length"], window,
                       win_length=kw["win_length"], center=kw["center"])
        tf = spec.shape[-2]
        spec = spec.reshape(b, ch, fb, tf, 2)
        mag = torch.sqrt(spec[..., 0] ** 2 + spec[..., 1] ** 2)  # (B, C, F, T)

        z = mag.permute(0, 3, 1, 2).reshape(b, tf, ch * fb)
        z = linear(z, params["input_proj"])
        z = cc.conformer_apply(params["conformer"], z, kw["heads"])
        z = linear(torch.tanh(z), params["output_proj"])

        # (B, T, 2·S·C·F) -> (B, 2, S, C, F, T)
        z = z.reshape(b, tf, s_src * ch * 2, fb).permute(0, 2, 3, 1)
        z = z.reshape(b, 2, s_src, ch, fb, tf)
        m_re, m_im = z[:, 0], z[:, 1]  # (B, S, C, F, T)
        sr_, si_ = spec[:, None, ..., 0], spec[:, None, ..., 1]  # (B, 1, C, F, T)
        est = torch.stack([m_re * sr_ - m_im * si_, m_re * si_ + m_im * sr_], dim=-1)
        wav = istft_ri(est.reshape(b * s_src * ch, fb, tf, 2), kw["n_fft"], kw["hop_length"],
                       window, win_length=kw["win_length"], center=kw["center"], length=t_samples)
        return wav.reshape(b, s_src, ch, t_samples)


def convert_torch(state_dict, config):
    """Reference ConformerMSS checkpoint keys (``core.input_proj_stft``,
    ``core.model`` = a lucidrains Conformer, ``core.output_proj``) -> the
    port's tree. Every key but the STFT window buffers is consumed;
    leftovers raise."""
    kw = _kwargs(config)
    sd, used, take = _make_take(cc.apply_key_map(state_dict))
    params = {
        "input_proj": {"weight": take("core.input_proj_stft.weight"),
                       "bias": take("core.input_proj_stft.bias")},
        "conformer": cc.convert_conformer(take, "core.model", kw["depth"]),
        "output_proj": {"weight": take("core.output_proj.weight"),
                        "bias": take("core.output_proj.bias")},
    }
    unused = {k for k in set(sd) - used if not k.startswith("window")}
    if unused:
        raise ValueError(
            f"unconsumed checkpoint keys: {sorted(unused)[:8]} ... — this "
            "conformer checkpoint's module layout differs from the assumed "
            "lucidrains reconstruction (frozen in tests/fixtures/layouts/). "
            "See README 'Conformer checkpoint layout recovery' for what to "
            "report and how to supply a key mapping.")
    return params
