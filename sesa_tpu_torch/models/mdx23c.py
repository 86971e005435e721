"""MDX23C, the TFC-TDF v3 U-Net (counterpart of sesa_tpu/models/mdx23c.py).

STFT with complex-as-channels and a dim_f crop -> subband fold (cac2cws)
-> 1x1 conv -> U-Net of TFC-TDF blocks (two 3x3 convs around a
bottlenecked frequency MLP, plus a 1x1 shortcut) with kernel == stride
down and up convs -> the decoder's output gated by the first conv's ->
final 1x1 convs -> subband unfold -> zero-padded spectrum -> iSTFT.

Layout NCHW with the torch channel order, so converted checkpoints load
without transposes; inside the U-Net the spatial dims are (T, F).

``compute_dtype=torch.bfloat16`` runs the conv net in bf16 on weights cast
once by :func:`prepare`; the STFT, the norm statistics (f32 inside
``layers.instance_norm2d`` / ``batch_norm2d``) and the synthesis stay f32,
as in the JAX package. The iSTFT runs on cuFFT through ``istft_ri``, which
ignores the imaginary parts of the DC and Nyquist bins as the JAX one does.
The JAX package's ``SESA_MDX23C_SCAN_BLOCKS`` switch is left out: the blocks
run as a plain loop, which gives the same numbers.
"""

from __future__ import annotations

import torch

from sesa_tpu_torch.models import layers as L
from sesa_tpu_torch.ops.prec import net_precision
from sesa_tpu_torch.ops.stft import hann_window, istft_ri, stft_ri
from sesa_tpu_torch.tree import tree_map


def _dims(config, hartley=False):
    """The static dimension plan shared by init, apply and convert_torch.

    The Hartley variant has real spectra: dim_c = k*ch (no complex factor)
    and f = dim_f // (k // 2), since all n_fft bins enter the net."""
    k = config.model.num_subbands
    ch = config.audio.num_channels
    dim_c = k * ch if hartley else k * ch * 2
    n = config.model.num_scales
    scale = tuple(config.model.scale)
    l = config.model.num_blocks_per_scale
    c = config.model.num_channels
    g = config.model.growth
    bn = config.model.bottleneck_factor
    f = config.audio.dim_f // (k // 2) if hartley else config.audio.dim_f // k
    return k, dim_c, n, scale, l, c, g, bn, f


def num_target_instruments(config) -> int:
    """reference utils.py:480-499 prefer_target_instrument."""
    training = dict(config).get("training") or {}
    if training.get("target_instrument"):
        return 1
    return len(training["instruments"])


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _init_norm(has_params, c, extra_bn=False):
    if not has_params:
        return {}
    p = {"weight": torch.ones(c), "bias": torch.zeros(c)}
    if extra_bn:
        p["running_mean"] = torch.zeros(c)
        p["running_var"] = torch.ones(c)
    return p


def init(generator: torch.Generator, config, hartley=False):
    """Random parameters drawn on the CPU from ``generator`` (the numbers
    differ from the JAX package's init; the tree is the same)."""
    k, dim_c, n, scale, l, c, g, bn, f = _dims(config, hartley)
    norm_type = config.model.norm
    _, has_norm = L.make_norm2d(norm_type)
    is_bn = norm_type == "BatchNorm"

    def conv_w(ci, co, kh, kw):
        return L.kaiming_uniform((co, ci, kh, kw), ci * kh * kw, generator)

    def lin_w(ci, co):
        return {"weight": L.kaiming_uniform((co, ci), ci, generator)}

    def tfc_tdf(in_c, cc, ff):
        blocks = []
        for _ in range(l):
            blocks.append({
                "tfc1_norm": _init_norm(has_norm, in_c, is_bn),
                "tfc1_conv": conv_w(in_c, cc, 3, 3),
                "tdf_norm1": _init_norm(has_norm, cc, is_bn),
                "tdf_lin1": lin_w(ff, ff // bn),
                "tdf_norm2": _init_norm(has_norm, cc, is_bn),
                "tdf_lin2": lin_w(ff // bn, ff),
                "tfc2_norm": _init_norm(has_norm, cc, is_bn),
                "tfc2_conv": conv_w(cc, cc, 3, 3),
                "shortcut": conv_w(in_c, cc, 1, 1),
            })
            in_c = cc
        return blocks

    params = {"first_conv": conv_w(dim_c, c, 1, 1)}
    cc, ff = c, f
    encoder = []
    for _ in range(n):
        encoder.append({"tfc_tdf": tfc_tdf(cc, cc, ff),
                        "down_norm": _init_norm(has_norm, cc, is_bn),
                        "down_conv": conv_w(cc, cc + g, scale[0], scale[1])})
        ff //= scale[1]
        cc += g
    params["encoder"] = encoder
    params["bottleneck"] = tfc_tdf(cc, cc, ff)
    decoder = []
    for _ in range(n):
        block = {"up_norm": _init_norm(has_norm, cc, is_bn),
                 # ConvTranspose2d weights: IOHW
                 "up_conv": L.kaiming_uniform((cc, cc - g, scale[0], scale[1]),
                                              cc * scale[0] * scale[1], generator)}
        ff *= scale[1]
        cc -= g
        block["tfc_tdf"] = tfc_tdf(2 * cc, cc, ff)
        decoder.append(block)
    params["decoder"] = decoder
    s = num_target_instruments(config)
    params["final_conv1"] = conv_w(cc + dim_c, cc, 1, 1)
    params["final_conv2"] = conv_w(cc, s * dim_c, 1, 1)
    return params


def prepare(params, config, compute_dtype=None):
    """Weight preparation, done once per session and dtype: every leaf cast
    to ``compute_dtype`` (batch norm's folded scale and shift are still
    computed in f32). :func:`apply` accepts the result in place of the raw
    tree."""
    if compute_dtype is None:
        return params
    return tree_map(lambda p: p.to(compute_dtype), params)


# --------------------------------------------------------------------------
# apply
# --------------------------------------------------------------------------

def _tfc_tdf_block(b, x, norm_fn, act):
    s = L.conv2d(x, b["shortcut"])
    x = L.conv2d(act(norm_fn(x, b["tfc1_norm"])), b["tfc1_conv"], padding=(1, 1))
    t = L.linear(act(norm_fn(x, b["tdf_norm1"])), b["tdf_lin1"])
    t = L.linear(act(norm_fn(t, b["tdf_norm2"])), b["tdf_lin2"])
    x = x + t
    x = L.conv2d(act(norm_fn(x, b["tfc2_norm"])), b["tfc2_conv"], padding=(1, 1))
    return x + s


def _apply_tfc_tdf(blocks, x, norm_fn, act):
    for b in blocks:
        x = _tfc_tdf_block(b, x, norm_fn, act)
    return x


def spectrogram(x: torch.Tensor, config) -> torch.Tensor:
    """Waveform (B, ch, T) -> (B, ch*2, dim_f, frames) f32, complex as
    channels in (ch, re/im) order, cropped to dim_f."""
    n_fft = config.audio.n_fft
    window = hann_window(n_fft, device=x.device)
    spec = stft_ri(x, n_fft, config.audio.hop_length, window)  # (B, ch, F, T, 2)
    spec = spec.movedim(-1, 2)  # (B, ch, 2, F, T)
    b, ch, _, f, t = spec.shape
    return spec.reshape(b, ch * 2, f, t)[:, :, :config.audio.dim_f]


def inverse_spectrogram(spec: torch.Tensor, config, length) -> torch.Tensor:
    """(..., ch*2, dim_f, frames) -> (..., ch, hop*(frames-1)); the bins
    above dim_f are zero."""
    n_fft = config.audio.n_fft
    window = hann_window(n_fft, device=spec.device)
    batch_dims = spec.shape[:-3]
    c2, f, t = spec.shape[-3:]
    n = n_fft // 2 + 1
    spec = torch.cat([spec, spec.new_zeros(batch_dims + (c2, n - f, t))], dim=-2)
    spec = spec.reshape(batch_dims + (c2 // 2, 2, n, t)).movedim(-3, -1)  # (..., ch, F, T, 2)
    return istft_ri(spec, n_fft, config.audio.hop_length, window)


def _cac2cws(x, k):
    b, c, f, t = x.shape
    return x.reshape(b, c, k, f // k, t).reshape(b, c * k, f // k, t)


def _cws2cac(x, k):
    b, c, f, t = x.shape
    return x.reshape(b, c // k, k, f, t).reshape(b, c // k, f * k, t)


def apply(params, config, x: torch.Tensor, transform=None, hartley=False,
          compute_dtype=None) -> torch.Tensor:
    """(B, ch, T) -> (B, S, ch, T) separated stems.

    ``transform``: an (analysis, synthesis) pair in place of the STFT (the
    Hartley variant's). ``compute_dtype``: the conv net's dtype; analysis,
    synthesis and the norm statistics stay f32."""
    k, dim_c, n, scale, l, c, g, bn, f = _dims(config, hartley)
    norm_fn, _ = L.make_norm2d(config.model.norm)
    act = L.make_act(config.model.act)
    s_stems = num_target_instruments(config)
    length = x.shape[-1]
    with net_precision(compute_dtype) as dtype:

        analysis, synthesis = transform or (spectrogram, inverse_spectrogram)
        spec = analysis(x, config).to(dtype)  # (B, ch*2, dim_f, T) (Hartley: (B, ch, n_fft, T))
        params = prepare(params, config, compute_dtype)
        mix = xx = _cac2cws(spec, k)  # (B, dim_c, f, T)

        first_out = xx = L.conv2d(xx, params["first_conv"])
        xx = xx.transpose(-1, -2)  # (B, c, T, f)

        skips = []
        for block in params["encoder"]:
            xx = _apply_tfc_tdf(block["tfc_tdf"], xx, norm_fn, act)
            skips.append(xx)
            xx = L.conv2d(act(norm_fn(xx, block["down_norm"])), block["down_conv"], stride=scale)

        xx = _apply_tfc_tdf(params["bottleneck"], xx, norm_fn, act)

        for block in params["decoder"]:
            xx = L.conv_transpose2d_block(act(norm_fn(xx, block["up_norm"])), block["up_conv"])
            xx = torch.cat([xx, skips.pop()], dim=1)
            xx = _apply_tfc_tdf(block["tfc_tdf"], xx, norm_fn, act)

        xx = xx.transpose(-1, -2)  # back to (B, c, f, T)
        xx = xx * first_out  # reduce artifacts (reference :230)
        xx = L.conv2d(torch.cat([mix, xx], dim=1), params["final_conv1"])
        xx = L.conv2d(act(xx), params["final_conv2"])
        xx = _cws2cac(xx, k)  # (B, S*ch*2, dim_f, T)

        b = xx.shape[0]
        xx = xx.float()  # synthesis runs f32
        xx = xx.reshape(b, s_stems, dim_c // k, xx.shape[-2], xx.shape[-1])
        wav = synthesis(xx, config, length)  # (B, S, ch, T')
        # center=True gives hop*(frames-1) samples; frames = 1 + T//hop
        if wav.shape[-1] < length:
            wav = torch.nn.functional.pad(wav, (0, length - wav.shape[-1]))
        return wav[..., :length]


# --------------------------------------------------------------------------
# torch checkpoint conversion
# --------------------------------------------------------------------------

def convert_torch(state_dict, config, hartley=False):
    """Map a reference TFC_TDF_net state dict onto the parameter tree.

    Key scheme (reference models/mdx23c_tfc_tdf_v3.py:100-187): Sequential
    indices tfc1/tfc2 = [norm, act, conv], tdf = [norm, act, lin, norm, act,
    lin], down/upscale .conv = [norm, act, conv], final_conv = [conv, act,
    conv]. Raises ``ValueError`` on a key it does not consume."""
    k, dim_c, n, scale, l, c, g, bn, f = _dims(config, hartley)
    norm_type = config.model.norm
    _, has_norm = L.make_norm2d(norm_type)
    is_bn = norm_type == "BatchNorm"
    sd = {key: torch.as_tensor(v) for key, v in state_dict.items()}
    used = set()

    def take(key):
        used.add(key)
        return sd[key].float()

    def norm_params(prefix):
        if not has_norm:
            return {}
        p = {"weight": take(f"{prefix}.weight"), "bias": take(f"{prefix}.bias")}
        if is_bn:
            p["running_mean"] = take(f"{prefix}.running_mean")
            p["running_var"] = take(f"{prefix}.running_var")
            used.add(f"{prefix}.num_batches_tracked")
        return p

    def tfc_tdf(prefix):
        blocks = []
        for i in range(l):
            p = f"{prefix}.blocks.{i}"
            blocks.append({
                "tfc1_norm": norm_params(f"{p}.tfc1.0"),
                "tfc1_conv": take(f"{p}.tfc1.2.weight"),
                "tdf_norm1": norm_params(f"{p}.tdf.0"),
                "tdf_lin1": {"weight": take(f"{p}.tdf.2.weight")},
                "tdf_norm2": norm_params(f"{p}.tdf.3"),
                "tdf_lin2": {"weight": take(f"{p}.tdf.5.weight")},
                "tfc2_norm": norm_params(f"{p}.tfc2.0"),
                "tfc2_conv": take(f"{p}.tfc2.2.weight"),
                "shortcut": take(f"{p}.shortcut.weight"),
            })
        return blocks

    params = {"first_conv": take("first_conv.weight")}
    params["encoder"] = [{"tfc_tdf": tfc_tdf(f"encoder_blocks.{i}.tfc_tdf"),
                          "down_norm": norm_params(f"encoder_blocks.{i}.downscale.conv.0"),
                          "down_conv": take(f"encoder_blocks.{i}.downscale.conv.2.weight")}
                         for i in range(n)]
    params["bottleneck"] = tfc_tdf("bottleneck_block")
    params["decoder"] = [{"up_norm": norm_params(f"decoder_blocks.{i}.upscale.conv.0"),
                          "up_conv": take(f"decoder_blocks.{i}.upscale.conv.2.weight"),
                          "tfc_tdf": tfc_tdf(f"decoder_blocks.{i}.tfc_tdf")}
                         for i in range(n)]
    params["final_conv1"] = take("final_conv.0.weight")
    params["final_conv2"] = take("final_conv.2.weight")

    unused = set(sd) - used
    if unused:
        raise ValueError(f"unconsumed checkpoint keys: {sorted(unused)[:8]} ...")
    return params
