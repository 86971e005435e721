"""MaxViT-encoder smp-style U-Net, the VitLarge23 segm_models backbone
(counterpart of sesa_tpu/models/maxvit_unet.py).

timm's TF-ported MaxViT (``tu-maxvit_large_tf_512`` for VOCALS-VitLarge23):
MBConv blocks and block / grid partition attention with TF relative-position
bias tables, under the tf preset (BatchNorm eps 1e-3, LayerNorm eps 1e-5,
tanh-GELU, TF 'same' padding, qkv packed ``head_first=False``), feeding the
smp UnetDecoder of ``resnet_unet``. The converter accepts both ``stages.0``
and flattened ``stages_0`` naming and optional conv biases.

The partition attention is a plain batched product with an additive bias
and an f32 softmax, as in the JAX package: the windows hold partition^2
tokens (256 at the tf_512 variants).
"""

from __future__ import annotations

import re

import numpy as np
import torch
import torch.nn.functional as F

from sesa_tpu_torch.models import layers as L
from sesa_tpu_torch.models.resnet_unet import bn_init, decode, decoder_init, decoder_keys

# named timm variants: dims, depths, stem_width (dim_head is always 32)
_VARIANTS = {
    "maxvit_tiny": ((64, 128, 256, 512), (2, 2, 5, 2), 64),
    "maxvit_small": ((96, 192, 384, 768), (2, 2, 5, 2), 64),
    "maxvit_base": ((96, 192, 384, 768), (2, 6, 14, 2), 64),
    "maxvit_large": ((128, 256, 512, 1024), (2, 6, 14, 2), 128),
    "maxvit_xlarge": ((192, 384, 768, 1536), (2, 6, 14, 2), 192),
}

_DECODER_CHANNELS = (256, 128, 64, 32, 16)
_BN_EPS = 1e-3
_LN_EPS = 1e-5


def spec_from_config(config):
    """Resolve the encoder spec from config.model.encoder_name (+ overrides).

    ``config.model.maxvit`` may override any of dims/depths/stem_width/
    dim_head/partition (the tests build tiny variants so)."""
    name = str(config.model.get("encoder_name", ""))
    base = name[3:] if name.startswith("tu-") else name
    spec = None
    for key, (dims, depths, stem) in _VARIANTS.items():
        if base.startswith(key):
            m = re.search(r"_(\d+)$", base)
            img = int(m.group(1)) if m else 224
            spec = {"dims": dims, "depths": depths, "stem_width": stem,
                    "dim_head": 32, "partition": img // 32}
    over = config.model.get("maxvit", None)
    if spec is None:
        # unknown maxvit flavours (rmlp/rw/nano/...) have other block
        # layouts: require an explicit full spec override
        required = ("dims", "depths", "stem_width", "dim_head", "partition")
        if not over or not all(k in over for k in required):
            raise NotImplementedError(
                f"maxvit encoder {name!r} is not one of the known tf "
                f"variants ({', '.join(sorted(_VARIANTS))}); provide a full "
                "config.model.maxvit spec (dims/depths/stem_width/dim_head/"
                "partition) or use a supported encoder_name")
        spec = {}
    if over:
        spec.update({k: tuple(v) if isinstance(v, (list, tuple)) else v
                     for k, v in dict(over).items()})
    dec = None
    if "decoder_unet" in config:
        dec = config.decoder_unet.get("decoder_channels", None)
    spec["decoder_channels"] = tuple(dec) if dec else _DECODER_CHANNELS
    return spec


def is_maxvit(config):
    return "maxvit" in str(config.model.get("encoder_name", ""))


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init(generator: torch.Generator, in_channels, spec):
    """Random parameters drawn on the CPU from ``generator`` (the numbers
    differ from the JAX package's init; the tree is the same)."""
    dims, depths = spec["dims"], spec["depths"]
    stem_w, part = spec["stem_width"], spec["partition"]

    def conv(ci, co, kh, kw, bias=True, groups=1):
        fan = (ci // groups) * kh * kw
        p = {"weight": L.kaiming_uniform((co, ci // groups, kh, kw), fan, generator)}
        if bias:
            p["bias"] = torch.zeros(co)
        return p

    def ln(c):
        return {"weight": torch.ones(c), "bias": torch.zeros(c)}

    def dense(ci, co):
        return {"weight": L.kaiming_uniform((co, ci), ci, generator), "bias": torch.zeros(co)}

    def mbconv(ci, co, stride):
        mid = co * 4
        p = {"pre_norm": bn_init(ci),
             "conv1": conv(ci, mid, 1, 1, bias=False),
             "norm1": bn_init(mid),
             "conv2": conv(mid, mid, 3, 3, bias=False, groups=mid),
             "norm2": bn_init(mid),
             "se": {"fc1": conv(mid, max(1, ci // 4), 1, 1),
                    "fc2": conv(max(1, ci // 4), mid, 1, 1)},
             "conv3": conv(mid, co, 1, 1)}
        if stride == 2 and ci != co:
            p["shortcut"] = conv(ci, co, 1, 1)
        return p

    def attn(dim):
        heads = dim // spec["dim_head"]
        return {"norm1": ln(dim), "qkv": dense(dim, dim * 3),
                "rel_pos": torch.zeros(heads, 2 * part - 1, 2 * part - 1),
                "proj": dense(dim, dim), "norm2": ln(dim),
                "fc1": dense(dim, dim * 4), "fc2": dense(dim * 4, dim)}

    stages, cin = [], stem_w
    for dim, depth in zip(dims, depths):
        stages.append({"blocks": [{"conv": mbconv(cin if i == 0 else dim, dim, 2 if i == 0 else 1),
                                   "attn_block": attn(dim), "attn_grid": attn(dim)}
                                  for i in range(depth)]})
        cin = dim
    decoder, cc = decoder_init(lambda ci, co, k: conv(ci, co, k, k, bias=False),
                               [stem_w] + list(dims), spec["decoder_channels"])
    return {"encoder": {"stem": {"conv1": conv(in_channels, stem_w, 3, 3),
                                 "norm1": bn_init(stem_w),
                                 "conv2": conv(stem_w, stem_w, 3, 3)},
                        "stages": stages},
            "decoder": decoder,
            "seg_head": conv(cc, in_channels, 3, 3)}


# --------------------------------------------------------------------------
# apply
# --------------------------------------------------------------------------

def _pad_same(x, k, s):
    """TF 'same' padding on NCHW (the extra row and column on the bottom and
    right)."""
    ih, iw = x.shape[-2:]
    ph = max((-(-ih // s) - 1) * s + k - ih, 0)
    pw = max((-(-iw // s) - 1) * s + k - iw, 0)
    if ph or pw:
        x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
    return x


def _conv_same(x, p, stride=1, groups=1):
    k = p["weight"].shape[-1]
    return L.conv2d(_pad_same(x, k, stride), p["weight"], p.get("bias"),
                    stride=(stride, stride), groups=groups)


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def _bn_act(x, p, act=True):
    x = L.batch_norm2d(x, p, eps=_BN_EPS)
    return _gelu_tanh(x) if act else x


def _mbconv(p, x, stride):
    if stride == 2:
        short = F.avg_pool2d(x, 2)  # the 2x2 window's sum x 0.25, VALID
        if "shortcut" in p:
            short = L.conv2d(short, p["shortcut"]["weight"], p["shortcut"].get("bias"))
    else:
        short = x
    x = _bn_act(x, p["pre_norm"], act=False)
    x = L.conv2d(x, p["conv1"]["weight"], p["conv1"].get("bias"))
    x = _bn_act(x, p["norm1"])
    x = _conv_same(x, p["conv2"], stride=stride, groups=x.shape[1])
    x = _bn_act(x, p["norm2"])
    s = x.mean(dim=(2, 3), keepdim=True)
    s = L.conv2d(s, p["se"]["fc1"]["weight"], p["se"]["fc1"].get("bias"))
    s = L.conv2d(L.swish(s), p["se"]["fc2"]["weight"], p["se"]["fc2"].get("bias"))
    x = x * torch.sigmoid(s)
    x = L.conv2d(x, p["conv3"]["weight"], p["conv3"].get("bias"))
    return x + short


def _rel_bias(table, part):
    """(heads, 2p-1, 2p-1) table -> (heads, p*p, p*p) bias: entry [h, (i, j),
    (x, y)] = table[h, i - x + p - 1, j - y + p - 1]."""
    idx = np.arange(part)
    rel = torch.as_tensor(idx[:, None] - idx[None, :] + part - 1, device=table.device)  # (p, p)
    t = table[:, rel][:, :, :, rel]  # (h, i, x, j, y)
    n = part * part
    return t.permute(0, 1, 3, 2, 4).reshape(table.shape[0], n, n)


def _partition_attn(p, x, part, dim_head, grid):
    """NHWC partition attention (block: local windows; grid: strided)."""
    b, h, w, c = x.shape
    if h % part or w % part:
        raise ValueError(
            f"maxvit feature map {h}x{w} not divisible by partition {part}; "
            "chunk_size/dim_f must keep the STFT image a multiple of "
            f"{part * 32} (e.g. 512x512 for the tf_512 variants)")
    y = L.layer_norm(x, p["norm1"], eps=_LN_EPS)
    if grid:
        y = y.reshape(b, part, h // part, part, w // part, c).permute(0, 2, 4, 1, 3, 5)
    else:
        y = y.reshape(b, h // part, part, w // part, part, c).permute(0, 1, 3, 2, 4, 5)
    n = part * part
    y = y.reshape(-1, n, c)

    heads = c // dim_head
    qkv = L.linear(y, p["qkv"]).reshape(-1, n, 3, heads, dim_head)  # head_first=False packing
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (bw, heads, n, d)
    att = torch.matmul(q * (dim_head ** -0.5), k.transpose(-1, -2))
    att = torch.softmax(att + _rel_bias(p["rel_pos"], part)[None], dim=-1)
    y = torch.matmul(att, v).transpose(1, 2).reshape(-1, n, c)
    y = L.linear(y, p["proj"])

    y = y.reshape(b, h // part, w // part, part, part, c)
    if grid:
        y = y.permute(0, 3, 1, 4, 2, 5).reshape(b, h, w, c)
    else:
        y = y.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)
    x = x + y
    z = L.layer_norm(x, p["norm2"], eps=_LN_EPS)
    z = L.linear(_gelu_tanh(L.linear(z, p["fc1"])), p["fc2"])
    return x + z


def _encoder(p, x, spec):
    part, dh = spec["partition"], spec["dim_head"]
    stem = p["stem"]
    x = _conv_same(x, stem["conv1"], stride=2)
    x = _bn_act(x, stem["norm1"])
    x = _conv_same(x, stem["conv2"])
    feats = [x]
    for stage in p["stages"]:
        for i, blk in enumerate(stage["blocks"]):
            x = _mbconv(blk["conv"], x, 2 if i == 0 else 1)
            x = x.permute(0, 2, 3, 1)  # NHWC for attention
            x = _partition_attn(blk["attn_block"], x, part, dh, grid=False)
            x = _partition_attn(blk["attn_grid"], x, part, dh, grid=True)
            x = x.permute(0, 3, 1, 2)
        feats.append(x)
    return feats


def apply(params, x, spec):
    """smp.Unet forward: NCHW (B, c, H, W) -> (B, c, H, W)."""
    return decode(params, _encoder(params["encoder"], x, spec))


# --------------------------------------------------------------------------
# torch checkpoint conversion
# --------------------------------------------------------------------------

def convert(sd, take, prefix, spec):
    """Convert the ``unet_model.`` subtree of a Segm_Models_Net state dict.

    ``sd`` / ``take`` come from the caller's strict-consumption harness.
    Handles both flattened (``stages_0``, timm features_only) and nested
    (``stages.0``) stage naming; conv biases are optional everywhere a BN
    follows (upstream TF ports differ on this)."""
    enc = prefix + "encoder.model."

    def alias(key):
        # canonical: stages_{i}; alias: stages.{i}
        if key in sd:
            return key
        alt = re.sub(r"stages_(\d+)\.", r"stages.\1.", key)
        return alt if alt in sd else key

    def t(key):
        return take(alias(key))

    def has(key):
        return alias(key) in sd

    def conv(pfx, bias=True):
        p = {"weight": t(pfx + ".weight")}
        if bias and has(pfx + ".bias"):
            p["bias"] = t(pfx + ".bias")
        return p

    def bn(pfx):
        p = {k: t(f"{pfx}.{k}") for k in ("weight", "bias", "running_mean", "running_var")}
        if has(pfx + ".num_batches_tracked"):
            t(pfx + ".num_batches_tracked")
        return p

    def wb(pfx):
        return {"weight": t(pfx + ".weight"), "bias": t(pfx + ".bias")}

    def mbconv(pfx, stride):
        p = {"pre_norm": bn(pfx + ".pre_norm"),
             "conv1": conv(pfx + ".conv1_1x1"),
             "norm1": bn(pfx + ".norm1"),
             "conv2": conv(pfx + ".conv2_kxk"),
             "norm2": bn(pfx + ".norm2"),
             "se": {"fc1": conv(pfx + ".se.fc1"), "fc2": conv(pfx + ".se.fc2")},
             "conv3": conv(pfx + ".conv3_1x1")}
        if stride == 2 and has(pfx + ".shortcut.expand.weight"):
            p["shortcut"] = conv(pfx + ".shortcut.expand")
        return p

    def attn(pfx):
        return {"norm1": wb(pfx + ".norm1"),
                "qkv": wb(pfx + ".attn.qkv"),
                "rel_pos": t(pfx + ".attn.rel_pos.relative_position_bias_table"),
                "proj": wb(pfx + ".attn.proj"),
                "norm2": wb(pfx + ".norm2"),
                "fc1": wb(pfx + ".mlp.fc1"),
                "fc2": wb(pfx + ".mlp.fc2")}

    stages = []
    for i, depth in enumerate(spec["depths"]):
        blocks = []
        for j in range(depth):
            b = f"{enc}stages_{i}.blocks.{j}"
            blocks.append({"conv": mbconv(b + ".conv", 2 if j == 0 else 1),
                           "attn_block": attn(b + ".attn_block"),
                           "attn_grid": attn(b + ".attn_grid")})
        stages.append({"blocks": blocks})
    decoder, seg_head = decoder_keys(sd, take, prefix, len(spec["decoder_channels"]), conv)
    return {"encoder": {"stem": {"conv1": conv(enc + "stem.conv1"),
                                 "norm1": bn(enc + "stem.norm1"),
                                 "conv2": conv(enc + "stem.conv2")},
                        "stages": stages},
            "decoder": decoder,
            "seg_head": seg_head}
