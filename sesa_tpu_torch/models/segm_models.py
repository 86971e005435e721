"""segm_models / torchseg, STFT image segmentation U-Nets (counterpart of
sesa_tpu/models/segm_models.py).

The mdx23c-style shell (STFT with complex as channels, subband fold, 1x1
first conv, the U-Net's output gated by the first conv's, final 1x1 convs,
iSTFT) around an smp / torchseg image segmentation network. Three encoder
zoos are native, with checkpoint conversion: MaxViT (VOCALS-VitLarge23's
``tu-maxvit_large_tf_512``, ``maxvit_unet``), torchvision ResNet
(``resnet_unet``) and EfficientNet b0-b7 (``efficientnet_unet``). A config
naming another encoder gets a self-contained symmetric conv U-Net, which
can be initialised and run; converting such a checkpoint raises.

The model runs in f32 only: its ``apply`` takes no ``compute_dtype``, as the
JAX function has none, so a bf16 session calls it on the f32 weights.
"""

from __future__ import annotations

import torch

from sesa_tpu_torch.models import efficientnet_unet, maxvit_unet, resnet_unet
from sesa_tpu_torch.models import layers as L
from sesa_tpu_torch.models.bs_roformer import _make_take
from sesa_tpu_torch.models.mdx23c import (_cac2cws, _cws2cac, inverse_spectrogram,
                                          num_target_instruments, spectrogram)
from sesa_tpu_torch.ops.prec import net_precision

_DEPTH = 4


def _dims(config):
    k = config.model.num_subbands
    dim_c = k * config.audio.num_channels * 2
    c = config.model.num_channels
    return k, dim_c, c


def _native(config):
    """(encoder module, spec) of a native encoder zoo, else None."""
    for mod, test in ((maxvit_unet, maxvit_unet.is_maxvit), (resnet_unet, resnet_unet.is_resnet),
                      (efficientnet_unet, efficientnet_unet.is_efficientnet)):
        if test(config):
            return mod, mod.spec_from_config(config)
    return None


def init(generator: torch.Generator, config):
    """Random parameters drawn on the CPU from ``generator`` (the numbers
    differ from the JAX package's init; the tree is the same)."""
    k, dim_c, c = _dims(config)
    s = num_target_instruments(config)

    def conv_w(ci, co, kh, kw):
        return L.kaiming_uniform((co, ci, kh, kw), ci * kh * kw, generator)

    native = _native(config)
    if native is not None:
        mod, spec = native
        _require_unet_decoder(config)
        return {"first_conv": conv_w(dim_c, c, 1, 1),
                "unet": mod.init(generator, c, spec),
                "final_conv1": conv_w(c + dim_c, c, 1, 1),
                "final_conv2": conv_w(c, s * dim_c, 1, 1)}

    def block(ci, co):
        return {"conv1": conv_w(ci, co, 3, 3),
                "norm1": {"weight": torch.ones(co), "bias": torch.zeros(co)},
                "conv2": conv_w(co, co, 3, 3),
                "norm2": {"weight": torch.ones(co), "bias": torch.zeros(co)}}

    params = {"first_conv": conv_w(dim_c, c, 1, 1)}
    enc, cc = [], c
    for _ in range(_DEPTH):
        enc.append({"block": block(cc, cc * 2), "down": conv_w(cc * 2, cc * 2, 2, 2)})
        cc *= 2
    params["encoder"] = enc
    params["bottleneck"] = block(cc, cc)
    dec = []
    for _ in range(_DEPTH):
        # after upsampling (cc -> cc//2), the skip from the matching encoder
        # level contributes cc channels
        dec.append({"up": L.kaiming_uniform((cc, cc // 2, 2, 2), cc * 4, generator),
                    "block": block(cc // 2 + cc, cc // 2)})
        cc //= 2
    params["decoder"] = dec
    params["final_conv1"] = conv_w(c + dim_c, c, 1, 1)
    params["final_conv2"] = conv_w(c, s * dim_c, 1, 1)
    return params


def _require_unet_decoder(config):
    dec = config.model.get("decoder_type", "unet")
    if dec != "unet":
        raise NotImplementedError(
            f"native encoders (maxvit/resnet/efficientnet) are implemented "
            f"for decoder_type 'unet' (smp.Unet, the layout VitLarge23 "
            f"uses); got {dec!r}")


def _block_apply(p, x, act):
    x = L.conv2d(x, p["conv1"], padding=(1, 1))
    x = act(L.instance_norm2d(x, p["norm1"]))
    x = L.conv2d(x, p["conv2"], padding=(1, 1))
    return act(L.instance_norm2d(x, p["norm2"]))


def _unet_apply(params, x, act):
    skips = []
    for e in params["encoder"]:
        x = _block_apply(e["block"], x, act)
        skips.append(x)
        x = L.conv2d(x, e["down"], stride=(2, 2))
    x = _block_apply(params["bottleneck"], x, act)
    for d in params["decoder"]:
        x = L.conv_transpose2d_block(x, d["up"])
        x = torch.cat([x, skips.pop()], dim=1)
        x = _block_apply(d["block"], x, act)
    return x


def image_path(params, config, mix):
    """The spectral-image path (everything between STFT and iSTFT):
    (B, dim_c, f//k, t) -> (B, S*dim_c, f//k, t), reference
    Segm_Models_Net.forward without the STFT pair."""
    act = L.make_act(config.model.act)
    first_out = xx = L.conv2d(mix, params["first_conv"])
    xx = xx.transpose(-1, -2)
    if "unet" in params:
        mod, spec = _native(config)
        xx = mod.apply(params["unet"], xx, spec)
    else:
        xx = _unet_apply(params, xx, act)
    xx = xx.transpose(-1, -2) * first_out
    xx = L.conv2d(torch.cat([mix, xx], dim=1), params["final_conv1"])
    return L.conv2d(act(xx), params["final_conv2"])


def apply(params, config, x: torch.Tensor) -> torch.Tensor:
    """(B, ch, T) -> (B, S, ch, T), in f32 (shell identical to mdx23c's)."""
    with net_precision(None):
        k, dim_c, c = _dims(config)
        s_stems = num_target_instruments(config)
        length = x.shape[-1]

        mix = _cac2cws(spectrogram(x.float(), config), k)
        xx = _cws2cac(image_path(params, config, mix), k)
        xx = xx.reshape(xx.shape[0], s_stems, dim_c // k, xx.shape[-2], xx.shape[-1])
        wav = inverse_spectrogram(xx, config, length)
        if wav.shape[-1] < length:
            wav = torch.nn.functional.pad(wav, (0, length - wav.shape[-1]))
        return wav[..., :length]


def convert_torch(state_dict, config):
    """Convert a reference Segm_Models_Net / Torchseg_Net state dict.

    Shell keys (reference segm_models.py:190-255): ``first_conv.weight``,
    ``unet_model.*`` (the smp / torchseg model), ``final_conv.0.weight``,
    ``final_conv.2.weight``. MaxViT, ResNet and EfficientNet U-Nets convert
    fully; other encoder zoos raise. Every key is consumed; leftovers
    raise."""
    native = _native(config)
    if native is None:
        raise NotImplementedError(
            "segm_models/torchseg checkpoint conversion is implemented for "
            "MaxViT-Unet (the layout the curated registry needs, e.g. "
            "VOCALS-VitLarge23), ResNet-Unet, and EfficientNet-Unet (b0-b7) "
            f"encoders; this config names encoder "
            f"{str(config.model.get('encoder_name', '?'))!r}, whose imagenet "
            "zoo (segmentation_models_pytorch / torchseg / timm) is not "
            "reproduced in this port. Use the roformer/mdx23c/scnet "
            "families, or initialise this architecture fresh with init().")
    sub_mod, spec = native
    _require_unet_decoder(config)

    # torchseg wraps the timm model directly as `encoder`; smp's
    # TimmUniversalEncoder nests it as `encoder.model`
    if ("unet_model.encoder.model.stem.conv1.weight" not in state_dict
            and "unet_model.encoder.stem.conv1.weight" in state_dict):
        state_dict = {k.replace("unet_model.encoder.", "unet_model.encoder.model."): v
                      for k, v in state_dict.items()}
    sd, used, take = _make_take(state_dict)
    params = {"first_conv": take("first_conv.weight"),
              "unet": sub_mod.convert(sd, take, "unet_model.", spec),
              "final_conv1": take("final_conv.0.weight"),
              "final_conv2": take("final_conv.2.weight")}
    unused = set(sd) - used
    if unused:
        raise ValueError(
            f"unconsumed segm_models checkpoint keys: {sorted(unused)[:10]} "
            f"(+{max(0, len(unused) - 10)} more): the checkpoint layout "
            "differs from the reconstructed timm/smp layout; refusing to "
            "load it partially.")
    return params
