"""EfficientNet-encoder smp.Unet for segm_models / torchseg checkpoints
(counterpart of sesa_tpu/models/efficientnet_unet.py).

smp's EfficientNetEncoder (the lukemelas ``efficientnet-pytorch`` layout,
``_fc`` deleted) with its conventions: TF-SAME padding (asymmetric (0, 1) /
(1, 2) pads on stride-2 convs), swish, an SE squeeze of 0.25 of the block's
pre-expansion channels, encoder BatchNorm eps 1e-3 (the decoder's 1e-5).
Key layout:

    encoder._conv_stem.weight                encoder._bn0.{...}
    encoder._blocks.{i}._expand_conv.weight  ._bn0   (expand_ratio != 1)
    encoder._blocks.{i}._depthwise_conv.weight  ._bn1
    encoder._blocks.{i}._se_reduce / ._se_expand   (1x1 convs with bias)
    encoder._blocks.{i}._project_conv.weight    ._bn2
    encoder._conv_head.weight  encoder._bn1.{...}   (unused by smp.Unet's
        forward; consumed when present)

The feature pyramid is smp's: [stem (1/2), the blocks split at the last
block before each stride-2 transition (1/4, 1/8, 1/16), the final block's
output (1/32)], feeding the smp UnetDecoder of ``resnet_unet``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from sesa_tpu_torch.models import layers as L
from sesa_tpu_torch.models.resnet_unet import bn_init, bn_keys, decode, decoder_init, decoder_keys

_BN_EPS = 1e-3  # lukemelas/keras EfficientNet convention (decoder BNs: 1e-5)

# (width_coefficient, depth_coefficient) per model, the EfficientNet paper's
# table; smp exposes exactly these eight
EFFICIENTNET_COEFFS = {
    "efficientnet-b0": (1.0, 1.0),
    "efficientnet-b1": (1.0, 1.1),
    "efficientnet-b2": (1.1, 1.2),
    "efficientnet-b3": (1.2, 1.4),
    "efficientnet-b4": (1.4, 1.8),
    "efficientnet-b5": (1.6, 2.2),
    "efficientnet-b6": (1.8, 2.6),
    "efficientnet-b7": (2.0, 3.1),
}

# base (B0) stage table: repeats, kernel, stride, expand_ratio, cin, cout
_BASE_STAGES = (
    (1, 3, 1, 1, 32, 16),
    (2, 3, 2, 6, 16, 24),
    (2, 5, 2, 6, 24, 40),
    (3, 3, 2, 6, 40, 80),
    (3, 5, 1, 6, 80, 112),
    (4, 5, 2, 6, 112, 192),
    (1, 3, 1, 6, 192, 320),
)

_DEFAULT_DECODER = (256, 128, 64, 32, 16)


def _round_filters(f, width):
    """lukemelas round_filters: divisor-8 rounding, never below 90%."""
    f *= width
    new = max(8, (int(f) + 4) // 8 * 8)
    if new < 0.9 * f:
        new += 8
    return int(new)


def _round_repeats(r, depth):
    return int(math.ceil(depth * r))


def is_efficientnet(config) -> bool:
    return str(config.model.get("encoder_name", "")) in EFFICIENTNET_COEFFS


def spec_from_config(config):
    name = str(config.model.encoder_name)
    w, d = EFFICIENTNET_COEFFS[name]
    # tiny-test override: config.model.efficientnet = {width: .., depth: ..}
    over = dict(config.model.get("efficientnet", {}) or {})
    w = float(over.get("width", w))
    d = float(over.get("depth", d))

    blocks = []
    cin = _round_filters(32, w)
    stem = cin
    for (r, k, s, e, _, bo) in _BASE_STAGES:
        cout = _round_filters(bo, w)
        for j in range(_round_repeats(r, d)):
            ci = cin if j == 0 else cout
            blocks.append(dict(k=k, s=s if j == 0 else 1, e=e, cin=ci, cout=cout,
                               se=max(1, int(ci * 0.25))))
        cin = cout
    # features split at the last block before each stride-2 transition
    # beyond the first (which begins the 1/4 level); final split = end
    s2 = [i for i, b in enumerate(blocks) if b["s"] == 2]
    splits = s2[1:] + [len(blocks)]
    if len(splits) != 4:
        raise ValueError(f"unexpected EfficientNet stride layout: {s2}")

    dec = dict(config.get("decoder_unet", {}) or {})
    return dict(stem=stem, blocks=blocks, splits=tuple(splits), head=_round_filters(1280, w),
                decoder_channels=tuple(int(v) for v in dec.get("decoder_channels",
                                                               _DEFAULT_DECODER)))


def _feat_channels(spec):
    """[stem (1/2), 1/4, 1/8, 1/16, 1/32] channel counts."""
    return [spec["stem"]] + [spec["blocks"][i - 1]["cout"] for i in spec["splits"]]


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init(generator: torch.Generator, in_channels, spec):
    """Random parameters drawn on the CPU from ``generator`` (the numbers
    differ from the JAX package's init; the tree is the same)."""
    def conv(ci, co, k):
        return {"weight": L.kaiming_uniform((co, ci, k, k), ci * k * k, generator)}

    params = {"stem": {"conv": conv(in_channels, spec["stem"], 3), "bn": bn_init(spec["stem"])}}
    blocks = []
    for b in spec["blocks"]:
        exp = b["cin"] * b["e"]
        p = {}
        if b["e"] != 1:
            p["expand"] = conv(b["cin"], exp, 1)
            p["expand_bn"] = bn_init(exp)
        p["dw"] = {"weight": L.kaiming_uniform((exp, 1, b["k"], b["k"]), b["k"] * b["k"],
                                               generator)}
        p["dw_bn"] = bn_init(exp)
        p["se_reduce"] = dict(conv(exp, b["se"], 1), bias=torch.zeros(b["se"]))
        p["se_expand"] = dict(conv(b["se"], exp, 1), bias=torch.zeros(exp))
        p["project"] = conv(exp, b["cout"], 1)
        p["project_bn"] = bn_init(b["cout"])
        blocks.append(p)
    params["blocks"] = blocks
    params["head"] = {"conv": conv(spec["blocks"][-1]["cout"], spec["head"], 1),
                      "bn": bn_init(spec["head"])}
    params["decoder"], cc = decoder_init(conv, _feat_channels(spec), spec["decoder_channels"])
    params["seg_head"] = {"weight": L.kaiming_uniform((in_channels, cc, 3, 3), cc * 9, generator),
                          "bias": torch.zeros(in_channels)}
    return params


# --------------------------------------------------------------------------
# apply
# --------------------------------------------------------------------------

def _same_conv(x, weight, k, stride, groups=1):
    """TF-SAME conv for even spatial dims: stride 1 pads k//2 both sides;
    stride 2 pads (total k-2) split low-first, (0, 1) for k=3 and (1, 2) for
    k=5, as lukemelas Conv2dStaticSamePadding does."""
    if stride == 1:
        return L.conv2d(x, weight, padding=(k // 2, k // 2), groups=groups)
    lo, hi = (k - 2) // 2, (k - 2) - (k - 2) // 2
    x = F.pad(x, (lo, hi, lo, hi))
    return L.conv2d(x, weight, stride=(stride, stride), groups=groups)


def _bn(x, p):
    return L.batch_norm2d(x, p, eps=_BN_EPS)


def _mbconv(p, x, b):
    inp = x
    if b["e"] != 1:
        x = L.swish(_bn(L.conv2d(x, p["expand"]["weight"]), p["expand_bn"]))
    x = _same_conv(x, p["dw"]["weight"], b["k"], b["s"], groups=b["cin"] * b["e"])
    x = L.swish(_bn(x, p["dw_bn"]))
    se = x.mean(dim=(2, 3), keepdim=True)
    se = L.swish(L.conv2d(se, p["se_reduce"]["weight"], p["se_reduce"]["bias"]))
    se = torch.sigmoid(L.conv2d(se, p["se_expand"]["weight"], p["se_expand"]["bias"]))
    x = _bn(L.conv2d(x * se, p["project"]["weight"]), p["project_bn"])
    if b["s"] == 1 and b["cin"] == b["cout"]:
        x = x + inp
    return x


def _encoder(params, x, spec):
    x = _same_conv(x, params["stem"]["conv"]["weight"], 3, 2)
    x = L.swish(_bn(x, params["stem"]["bn"]))
    feats, start = [x], 0
    for end in spec["splits"]:
        for i in range(start, end):
            x = _mbconv(params["blocks"][i], x, spec["blocks"][i])
        feats.append(x)
        start = end
    return feats


def apply(params, x, spec):
    """smp.Unet forward: NCHW (B, c, H, W) -> (B, c, H, W); H, W divisible
    by 32 (the encoder's total stride), as in smp."""
    return decode(params, _encoder(params, x, spec))


# --------------------------------------------------------------------------
# torch checkpoint conversion
# --------------------------------------------------------------------------

def convert(sd, take, prefix, spec):
    """Convert the ``unet_model.`` subtree (smp.Unet with an
    EfficientNetEncoder in the lukemelas key layout documented above)."""
    enc = prefix + "encoder."

    def conv(pfx, bias=False):
        p = {"weight": take(pfx + ".weight")}
        if bias:
            p["bias"] = take(pfx + ".bias")
        return p

    params = {"stem": {"conv": conv(enc + "_conv_stem"), "bn": bn_keys(sd, take, enc + "_bn0")}}
    blocks = []
    for i, blk in enumerate(spec["blocks"]):
        b = f"{enc}_blocks.{i}"
        p = {}
        if blk["e"] != 1:
            p["expand"] = conv(b + "._expand_conv")
            p["expand_bn"] = bn_keys(sd, take, b + "._bn0")
        p["dw"] = conv(b + "._depthwise_conv")
        p["dw_bn"] = bn_keys(sd, take, b + "._bn1")
        p["se_reduce"] = conv(b + "._se_reduce", bias=True)
        p["se_expand"] = conv(b + "._se_expand", bias=True)
        p["project"] = conv(b + "._project_conv")
        p["project_bn"] = bn_keys(sd, take, b + "._bn2")
        blocks.append(p)
    params["blocks"] = blocks
    # smp's EfficientNetEncoder deletes only _fc; the unused imagenet head
    # stays in checkpoints: consume it when there
    if enc + "_conv_head.weight" in sd:
        params["head"] = {"conv": conv(enc + "_conv_head"), "bn": bn_keys(sd, take, enc + "_bn1")}
    params["decoder"], params["seg_head"] = decoder_keys(sd, take, prefix,
                                                         len(spec["decoder_channels"]), conv)
    return params
