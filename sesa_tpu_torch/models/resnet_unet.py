"""ResNet-encoder smp.Unet for segm_models / torchseg checkpoints
(counterpart of sesa_tpu/models/resnet_unet.py).

A torchvision-layout ResNet encoder (7x7/2 stem conv + BN + ReLU, 3x3/2 max
pool, four stages of BasicBlock or Bottleneck) feeding smp's UnetDecoder (2x
nearest upsampling + skip concat + two conv3x3-BN-ReLU per block, then a 3x3
segmentation head). The feature pyramid is smp's ResNetEncoder's: [relu1
(1/2), layer1 (1/4), layer2 (1/8), layer3 (1/16), layer4 (1/32)]; the
decoder takes it deepest-first, its last block without a skip, so the output
returns to the input resolution.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sesa_tpu_torch.models import layers as L

# torchvision layouts; expansion is the Bottleneck output multiplier
RESNET_SPECS = {
    "resnet18": dict(block="basic", layers=(2, 2, 2, 2), expansion=1),
    "resnet34": dict(block="basic", layers=(3, 4, 6, 3), expansion=1),
    "resnet50": dict(block="bottleneck", layers=(3, 4, 6, 3), expansion=4),
    "resnet101": dict(block="bottleneck", layers=(3, 4, 23, 3), expansion=4),
    "resnet152": dict(block="bottleneck", layers=(3, 8, 36, 3), expansion=4),
}

_DEFAULT_DECODER = (256, 128, 64, 32, 16)


def is_resnet(config) -> bool:
    return str(config.model.get("encoder_name", "")) in RESNET_SPECS


def spec_from_config(config):
    name = str(config.model.encoder_name)
    s = dict(RESNET_SPECS[name])
    # tiny-test override: config.model.resnet = {base: 8, layers: [1,1,1,1]}
    over = dict(config.model.get("resnet", {}) or {})
    s["base"] = int(over.get("base", 64))
    if "layers" in over:
        s["layers"] = tuple(int(v) for v in over["layers"])
    dec = dict(config.get("decoder_unet", {}) or {})
    s["decoder_channels"] = tuple(int(v) for v in dec.get("decoder_channels", _DEFAULT_DECODER))
    return s


def _stage_channels(spec):
    b = spec["base"]
    return [b, 2 * b, 4 * b, 8 * b]


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def bn_init(c):
    return {"weight": torch.ones(c), "bias": torch.zeros(c),
            "running_mean": torch.zeros(c), "running_var": torch.ones(c)}


def decoder_init(conv, feat, decoder_channels):
    """smp UnetDecoder blocks over the pyramid's channels ``feat`` (shallow
    first): in = previous out + skip, out = decoder_channels[i]."""
    skips = feat[-2::-1] + [0]  # deepest-first, last block skip-less
    decoder, cc = [], feat[-1]
    for dc, sk in zip(decoder_channels, skips):
        decoder.append({"conv1": {"conv": conv(cc + sk, dc, 3), "bn": bn_init(dc)},
                        "conv2": {"conv": conv(dc, dc, 3), "bn": bn_init(dc)}})
        cc = dc
    return decoder, cc


def init(generator: torch.Generator, in_channels, spec):
    """Random parameters drawn on the CPU from ``generator`` (the numbers
    differ from the JAX package's init; the tree is the same)."""
    exp = spec["expansion"]

    def conv(ci, co, k):
        return {"weight": L.kaiming_uniform((co, ci, k, k), ci * k * k, generator)}

    def basic(ci, co, stride):
        p = {"conv1": conv(ci, co, 3), "bn1": bn_init(co), "conv2": conv(co, co, 3),
             "bn2": bn_init(co)}
        if stride != 1 or ci != co:
            p["downsample"] = {"conv": conv(ci, co, 1), "bn": bn_init(co)}
        return p

    def bottleneck(ci, cm, stride):
        co = cm * exp
        p = {"conv1": conv(ci, cm, 1), "bn1": bn_init(cm), "conv2": conv(cm, cm, 3),
             "bn2": bn_init(cm), "conv3": conv(cm, co, 1), "bn3": bn_init(co)}
        if stride != 1 or ci != co:
            p["downsample"] = {"conv": conv(ci, co, 1), "bn": bn_init(co)}
        return p

    base = spec["base"]
    params = {"conv1": conv(in_channels, base, 7), "bn1": bn_init(base)}
    ci, stages = base, []
    for si, (cm, depth) in enumerate(zip(_stage_channels(spec), spec["layers"])):
        blocks = []
        for bi in range(depth):
            stride = 2 if (si > 0 and bi == 0) else 1
            if spec["block"] == "basic":
                blocks.append(basic(ci, cm, stride))
                ci = cm
            else:
                blocks.append(bottleneck(ci, cm, stride))
                ci = cm * exp
        stages.append(blocks)
    params["layers"] = stages
    feat = [base] + [c * exp for c in _stage_channels(spec)]
    params["decoder"], cc = decoder_init(conv, feat, spec["decoder_channels"])
    params["seg_head"] = {"weight": L.kaiming_uniform((in_channels, cc, 3, 3), cc * 9, generator),
                          "bias": torch.zeros(in_channels)}
    return params


# --------------------------------------------------------------------------
# apply
# --------------------------------------------------------------------------

def _maxpool_3x3s2(x):
    """torch MaxPool2d(3, stride=2, padding=1) on NCHW (pads with -inf)."""
    return F.max_pool2d(x, 3, stride=2, padding=1)


def _block_apply(p, x, stride, kind):
    idn = x
    if kind == "basic":
        y = L.relu(L.batch_norm2d(L.conv2d(x, p["conv1"]["weight"], stride=(stride, stride),
                                           padding=(1, 1)), p["bn1"]))
        y = L.batch_norm2d(L.conv2d(y, p["conv2"]["weight"], padding=(1, 1)), p["bn2"])
    else:
        y = L.relu(L.batch_norm2d(L.conv2d(x, p["conv1"]["weight"]), p["bn1"]))
        y = L.relu(L.batch_norm2d(L.conv2d(y, p["conv2"]["weight"], stride=(stride, stride),
                                           padding=(1, 1)), p["bn2"]))
        y = L.batch_norm2d(L.conv2d(y, p["conv3"]["weight"]), p["bn3"])
    if "downsample" in p:
        idn = L.batch_norm2d(L.conv2d(x, p["downsample"]["conv"]["weight"],
                                      stride=(stride, stride)), p["downsample"]["bn"])
    return L.relu(y + idn)


def _encoder(params, x, spec):
    x = L.conv2d(x, params["conv1"]["weight"], stride=(2, 2), padding=(3, 3))
    f1 = L.relu(L.batch_norm2d(x, params["bn1"]))
    feats = [f1]
    x = _maxpool_3x3s2(f1)
    for si, blocks in enumerate(params["layers"]):
        for bi, bp in enumerate(blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            x = _block_apply(bp, x, stride, spec["block"])
        feats.append(x)
    return feats


def _upsample2(x):
    """2x nearest-neighbour upsampling on NCHW."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def _decoder_block(p, x, skip):
    x = _upsample2(x)
    if skip is not None:
        x = torch.cat([x, skip], dim=1)
    x = L.conv2d(x, p["conv1"]["conv"]["weight"], padding=(1, 1))
    x = L.relu(L.batch_norm2d(x, p["conv1"]["bn"]))
    x = L.conv2d(x, p["conv2"]["conv"]["weight"], padding=(1, 1))
    return L.relu(L.batch_norm2d(x, p["conv2"]["bn"]))


def decode(params, feats):
    """smp UnetDecoder + segmentation head over the pyramid (shallow first)."""
    feats = feats[::-1]
    y = feats[0]
    for p, skip in zip(params["decoder"], feats[1:] + [None]):
        y = _decoder_block(p, y, skip)
    return L.conv2d(y, params["seg_head"]["weight"], params["seg_head"].get("bias"),
                    padding=(1, 1))


def apply(params, x, spec):
    """smp.Unet forward: NCHW (B, c, H, W) -> (B, c, H, W). H and W must be
    divisible by 32 (the encoder's total stride), as in smp."""
    return decode(params, _encoder(params, x, spec))


# --------------------------------------------------------------------------
# torch checkpoint conversion
# --------------------------------------------------------------------------

def bn_keys(sd, take, pfx):
    p = {"weight": take(pfx + ".weight"), "bias": take(pfx + ".bias"),
         "running_mean": take(pfx + ".running_mean"),
         "running_var": take(pfx + ".running_var")}
    if (pfx + ".num_batches_tracked") in sd:
        take(pfx + ".num_batches_tracked")
    return p


def decoder_keys(sd, take, prefix, n_blocks, conv):
    """smp UnetDecoder ``decoder.blocks.{i}.conv{1,2}.{0: conv, 1: BN}`` and
    the 3x3 head ``segmentation_head.0`` under ``prefix``. ``conv(key,
    bias)`` reads one convolution, by the encoder's rule for its bias."""
    decoder = [{"conv1": {"conv": conv(f"{prefix}decoder.blocks.{i}.conv1.0", bias=False),
                          "bn": bn_keys(sd, take, f"{prefix}decoder.blocks.{i}.conv1.1")},
                "conv2": {"conv": conv(f"{prefix}decoder.blocks.{i}.conv2.0", bias=False),
                          "bn": bn_keys(sd, take, f"{prefix}decoder.blocks.{i}.conv2.1")}}
               for i in range(n_blocks)]
    return decoder, conv(prefix + "segmentation_head.0", bias=True)


def convert(sd, take, prefix, spec):
    """Convert the ``unet_model.`` subtree (smp.Unet with a ResNetEncoder:
    torchvision keys under ``encoder.``, smp decoder under
    ``decoder.blocks.``, 3x3 head under ``segmentation_head.0``)."""
    enc = prefix + "encoder."

    def conv(pfx, bias=False):
        p = {"weight": take(pfx + ".weight")}
        if bias and (pfx + ".bias") in sd:
            p["bias"] = take(pfx + ".bias")
        return p

    params = {"conv1": conv(enc + "conv1"), "bn1": bn_keys(sd, take, enc + "bn1")}
    stages = []
    for si, depth in enumerate(spec["layers"]):
        blocks = []
        for bi in range(depth):
            b = f"{enc}layer{si + 1}.{bi}"
            p = {"conv1": conv(b + ".conv1"), "bn1": bn_keys(sd, take, b + ".bn1"),
                 "conv2": conv(b + ".conv2"), "bn2": bn_keys(sd, take, b + ".bn2")}
            if spec["block"] == "bottleneck":
                p["conv3"] = conv(b + ".conv3")
                p["bn3"] = bn_keys(sd, take, b + ".bn3")
            if f"{b}.downsample.0.weight" in sd:
                p["downsample"] = {"conv": conv(b + ".downsample.0"),
                                   "bn": bn_keys(sd, take, b + ".downsample.1")}
            blocks.append(p)
        stages.append(blocks)
    params["layers"] = stages
    params["decoder"], params["seg_head"] = decoder_keys(sd, take, prefix,
                                                         len(spec["decoder_channels"]), conv)
    return params
