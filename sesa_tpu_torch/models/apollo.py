"""Apollo — band-split roformer/ICB audio restoration model (counterpart of
sesa_tpu/models/apollo.py).

STFT -> 80 uniform subbands -> per-band power normalisation with a log-power
feature -> per-band bottleneck -> ``layer`` x BSNet (band-axis roformer with
its own interleaved RoPE + three ICB conv blocks over time) -> per-band GLU
output heads -> RI spectrum -> iSTFT. The 79 equal-width bands run as one
batched einsum; the odd final band runs separately.

Under bf16 the band attention goes through kernel K7
(``ops.attention.fused_rope_attention``) and every ICB block through kernel
K6 (``ops.convblock.fused_apollo_conv``) where ``apollo_kernels`` finds that
the kernel takes the shape, and through the plain layers elsewhere; in f32
(parity and the bf16 -> f32 rescue) both stay on plain tensor code. The STFT,
the iSTFT and the band features are always f32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from sesa_tpu_torch import to_device
from sesa_tpu_torch.models.layers import kaiming_uniform
from sesa_tpu_torch.ops.attention import fused_rope_attention, k7_plan, padded_block_weights, sdpa
from sesa_tpu_torch.ops.convblock import apollo_conv_shape_ok, fused_apollo_conv
from sesa_tpu_torch.ops.stft import hann_window, istft_ri, stft_ri
from sesa_tpu_torch.tree import tree_map

_EPS_F32 = float(np.finfo(np.float32).eps)
NUM_HEAD = 8


def _dims(config):
    m = dict(config["model"])
    sr = int(m["sr"])
    win = int(sr * m["win"] // 1000)
    stride = win // 2
    enc_dim = win // 2 + 1
    feature_dim = int(m["feature_dim"])
    layer = int(m["layer"])
    bandwidth = int(win / 160)
    band_width = [bandwidth] * 79 + [enc_dim - 79 * bandwidth]
    return sr, win, stride, enc_dim, feature_dim, layer, band_width


def _rms_norm_last(x, weight, eps=1e-5):
    """Apollo RMSNorm on (..., N): rms over the trailing channel axis, the
    statistics and the normalisation in f32 under a bf16 compute dtype, the
    result rounded before it meets the weight (channels last, as the JAX
    package; the reference keeps (B, N, T)). The sum of squares is one
    reduction that reads x in its own dtype and accumulates in f32, so no f32
    copy of x is made for it."""
    sq = torch.linalg.vector_norm(x, dim=-1, keepdim=True, dtype=torch.float32).square()
    norm = x * torch.rsqrt(sq / x.shape[-1] + eps)  # f32: x is promoted
    return norm.to(x.dtype) * weight


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init(generator: torch.Generator, config):
    """Random parameters drawn on the CPU from ``generator``; the tree and
    its key names are those of sesa_tpu/models/apollo.py ``init``."""
    sr, win, stride, enc_dim, n, layer, band_width = _dims(config)
    bw, bw_l = band_width[0], band_width[-1]

    def conv1x1(ci, co, m=1):
        return kaiming_uniform((m, co, ci) if m > 1 else (co, ci), ci, generator)

    def bias(co, ci, m=1):
        return kaiming_uniform((m, co) if m > 1 else (co,), ci, generator)

    def roformer(nd):
        return {"input_norm": torch.ones(nd), "qkv_w": conv1x1(nd, nd * 3),
                "out_w": conv1x1(nd, nd), "mlp_norm": torch.ones(nd),
                "mlp_in": conv1x1(nd, nd * 8), "mlp_out": conv1x1(nd * 4, nd)}

    def conv_act_norm(nd, kernel=7):
        return {"dw_w": kaiming_uniform((nd, 1, kernel), kernel, generator),
                "dw_b": bias(nd, kernel), "norm": torch.ones(nd),
                "pw1_w": conv1x1(nd, nd * 4), "pw1_b": bias(nd * 4, nd),
                "pw2_w": conv1x1(nd * 4, nd), "pw2_b": bias(nd, nd * 4)}

    return {
        # 79 uniform bands batched + the final odd band
        "bn_norm": torch.ones((79, bw * 2 + 1)),
        "bn_w": conv1x1(bw * 2 + 1, n, m=79),
        "bn_b": bias(n, bw * 2 + 1, m=79),
        "bn_norm_last": torch.ones(bw_l * 2 + 1),
        "bn_w_last": conv1x1(bw_l * 2 + 1, n),
        "bn_b_last": bias(n, bw_l * 2 + 1),
        "layers": [{"band_net": roformer(n), "seq_net": [conv_act_norm(n) for _ in range(3)]}
                   for _ in range(layer)],
        "out_norm": torch.ones((79, n)),
        "out_w": conv1x1(n, bw * 4, m=79),
        "out_b": bias(bw * 4, n, m=79),
        "out_norm_last": torch.ones(n),
        "out_w_last": conv1x1(n, bw_l * 4),
        "out_b_last": bias(bw_l * 4, n),
    }


# --------------------------------------------------------------------------
# apply
# --------------------------------------------------------------------------

def _apollo_rope(n_dim, seq_len, theta=10000.0):
    """(cos, sin) float32 numpy tables (seq_len, n_dim), interleaved pairs."""
    freq = 1.0 / (theta ** (np.arange(0, n_dim, 2)[: n_dim // 2] / n_dim))
    pos = np.arange(seq_len)[:, None] * freq[None, :]
    return (np.repeat(np.cos(pos), 2, axis=-1).astype(np.float32),
            np.repeat(np.sin(pos), 2, axis=-1).astype(np.float32))


def _rope_tables(n_dim, seq_len, like):
    """The rope tables in the network dtype on the network's device."""
    return tuple(to_device(t, like.device, like.dtype) for t in _apollo_rope(n_dim, seq_len))


def _rotate_pairs(x):
    x2 = x.unflatten(-1, (-1, 2))
    return torch.stack([-x2[..., 1], x2[..., 0]], dim=-1).flatten(-2)


def _roformer_apply(p, x, num_head=NUM_HEAD):
    """x (B, S, N) band-axis transformer (the sequence axis is the bands):
    the f32 path, with the checkpoint's head-major qkv packing."""
    b, s, n = x.shape
    hidden = n // num_head
    xn = _rms_norm_last(x, p["input_norm"])
    qkv = xn @ p["qkv_w"].T
    # head h owns rows [3h·hd, 3(h+1)·hd) of the packed axis as (q_h, k_h, v_h)
    qkv = qkv.reshape(b, s, num_head, hidden * 3).permute(0, 2, 1, 3)  # (B, H, S, 3h)
    q, k, v = qkv.split(hidden, dim=-1)
    cos, sin = _rope_tables(hidden, s, x)
    q = q * cos + _rotate_pairs(q) * sin
    k = k * cos + _rotate_pairs(k) * sin
    out = sdpa(q, k, v)  # (B, H, S, h)
    out = out.permute(0, 2, 1, 3).reshape(b, s, n)
    out = out @ p["out_w"].T + x
    return _roformer_mlp(p, out)


def _roformer_mlp(p, out):
    """RMSNorm -> 8N projection -> SiLU -> split -> SiLU(gate) * z -> N. The
    second SiLU on the gate half is the reference's behaviour."""
    h = _rms_norm_last(out, p["mlp_norm"]) @ p["mlp_in"].T
    h = F.silu(h, inplace=True)
    gate, z = h.chunk(2, dim=-1)
    h = F.silu(gate).mul_(z)
    return out + h @ p["mlp_out"].T


def _qkv_head_block_perm(n, num_head):
    """Row permutation taking the checkpoint's head-major qkv packing
    [(q0,k0,v0),(q1,k1,v1),...] to kernel K7's component-major
    [q0..qH | k0..kH | v0..vH] layout."""
    dh = n // num_head
    rows = np.arange(3 * n).reshape(num_head, 3, dh)
    return torch.from_numpy(np.transpose(rows, (1, 0, 2)).reshape(-1).copy())


def _roformer_apply_folded(p, feat, num_head=NUM_HEAD):
    """Band transformer on feat (B', S, T, N) through kernel K7. Numerics
    match :func:`_roformer_apply`; the packed qkv tensor goes into the kernel
    as the projection writes it and the attended heads come out as the out
    projection reads them, so the (., S, S) logits and the per-head splits
    never exist in device memory. The band/time transpose is one copy of the
    normed activation before the qkv projection and is folded into the
    residual add after the out projection.

    ``p["qkv_w_cm"]`` is the component-major qkv weight of :func:`prepare`;
    without it the rows are permuted here. Where K7's plan runs the heads at
    a width above dh (:func:`k7_plan` ``repack``: dh not a multiple of 8, or
    8 heads too wide for whole boxes), W_qkv's rows and W_o's columns are
    zero-padded per head to that width (``padded_block_weights``, kept while
    the weights live), so the projection writes the padded heads and the
    kernel takes them as they lie; the zero columns add nothing to q·kᵀ and
    give zero output columns, which meet W_o's zero columns. The rope is
    ``_apollo_rope``'s, 2·(dh // 2) wide (an odd dh leaves its last column
    unrotated), and the scale the real dh's."""
    b, s, t, n = feat.shape
    dh = n // num_head
    wq = p.get("qkv_w_cm")
    if wq is None:
        wq = p["qkv_w"][_qkv_head_block_perm(n, num_head).to(feat.device)]
    wo = p["out_w"]
    plan = k7_plan(b * t, s, num_head, dh, 2 * (dh // 2))
    width = dh if plan is None else plan["width"]
    if width != dh:
        wq, wo, _ = padded_block_weights(wq, wo, dh, width)
    xn = _rms_norm_last(feat, p["input_norm"]).transpose(1, 2).contiguous()  # (B', T, S, N)
    qkv = (xn @ wq.T).reshape(b * t, s, 3 * num_head * width)
    del xn
    cos, sin = _rope_tables(dh, s, feat)
    out = fused_rope_attention(qkv, num_head, dh ** -0.5, rope=(cos, sin))
    del qkv
    out = (out @ wo.T).reshape(b, t, s, n)
    out = torch.add(feat, out.transpose(1, 2), out=torch.empty_like(feat))
    return _roformer_mlp(p, out)


def apollo_kernels(device_type: str, dtype, rows: int, frames: int, bands: int,
                   feature_dim: int, kernel: int = 7) -> frozenset:
    """The kernels Apollo's layers run, a subset of {"K6", "K7"}: a pure
    function of the device type, the dtype and the shapes (``rows`` = batch ×
    channels, ``frames``, ``bands``, ``feature_dim`` N, the ICB's ``kernel``
    taps).

    Only bf16 takes kernels. On CUDA, K7 takes the band layers where
    :func:`k7_plan` plans (rows · frames) sequences of ``bands`` at 8 heads
    × N / 8 with the model's rope, 2·(N / 8 // 2) wide (every N that is a
    multiple of 8 at Apollo's 80 bands), else the band layer runs
    :func:`_roformer_apply`;
    K6 takes the ICBs where :func:`apollo_conv_shape_ok` accepts (rows ·
    bands · frames) tokens of N with hidden 4N, else they run
    :func:`_conv_act_norm_apply` (sesa_tpu/models/apollo.py:222-230). On the
    CPU both wrappers run their plain versions, which take every shape."""
    if dtype != torch.bfloat16 or device_type not in ("cuda", "cpu"):
        return frozenset()
    if device_type == "cpu":
        return frozenset({"K6", "K7"})
    dh = feature_dim // NUM_HEAD
    take = {"K7": feature_dim % NUM_HEAD == 0
            and k7_plan(rows * frames, bands, NUM_HEAD, dh, 2 * (dh // 2)) is not None,
            "K6": apollo_conv_shape_ok(rows * bands * frames, feature_dim, 4 * feature_dim,
                                       kernel)}
    return frozenset(name for name, ok in take.items() if ok)


def _conv_act_norm_apply(p, x, kernel=7):
    """(B, T, N) depthwise conv over T + RMSNorm + pointwise MLP, residual:
    the f32 path. The depthwise conv is ``kernel`` shifted multiply-adds, so
    no library convolution (and none of its reduced-precision modes) is
    involved; the padding of (kernel - 1) // 2 on both sides preserves the
    length for odd kernels only."""
    if kernel % 2 == 0:
        raise ValueError(f"apollo conv block: the kernel size must be odd, got {kernel}")
    t = x.shape[1]
    half = (kernel - 1) // 2
    xp = F.pad(x, (0, 0, half, half))
    taps = p["dw_w"][:, 0, :]  # (N, k)
    y = p["dw_b"] + xp[:, 0:t] * taps[:, 0]
    for i in range(1, kernel):
        y = y + xp[:, i:i + t] * taps[:, i]
    y = _rms_norm_last(y, p["norm"])
    y = F.silu(y @ p["pw1_w"].T + p["pw1_b"])
    return x + (y @ p["pw2_w"].T + p["pw2_b"])


def prepare(params, config, compute_dtype=None):
    """Weight preparation, done once per session and dtype: every leaf cast
    to ``compute_dtype`` and, for kernel K7, each layer's qkv weight with its
    rows permuted from the checkpoint's head-major packing to component-major
    (``qkv_w_cm``). :func:`apply` accepts the result in place of the raw
    tree."""
    n = _dims(config)[4]
    if compute_dtype is not None:
        params = tree_map(lambda p: p.to(compute_dtype), params)
    perm = _qkv_head_block_perm(n, NUM_HEAD)
    layers = []
    for lp in params["layers"]:
        band = dict(lp["band_net"])
        band["qkv_w_cm"] = band["qkv_w"][perm.to(band["qkv_w"].device)].contiguous()
        layers.append({"band_net": band, "seq_net": lp["seq_net"]})
    return {**params, "layers": layers}


def _is_prepared(params, compute_dtype):
    band = params["layers"][0]["band_net"] if params["layers"] else {}
    return "qkv_w_cm" in band and band["qkv_w_cm"].dtype == (compute_dtype or torch.float32)


def apply(params, config, x, compute_dtype=None):
    """(B, ch, T) -> (B, 1, ch, T) restored audio (a single 'stem').

    ``compute_dtype``: run the band / roformer / conv-block net in this dtype
    (bf16 on the GPU); the STFT, the iSTFT and the band features stay f32.
    ``params`` is the tree of :func:`init` or of :func:`prepare` for this
    dtype.
    """
    sr, win, stride, enc_dim, n, layer, band_width = _dims(config)
    bw, bw_l = band_width[0], band_width[-1]
    b, ch, nsample = x.shape
    bp = b * ch
    if not _is_prepared(params, compute_dtype):
        params = prepare(params, config, compute_dtype)

    window = hann_window(win, device=x.device)
    spec = stft_ri(x.reshape(bp, nsample), win, stride, window)  # (B', F, T, 2)
    t = spec.shape[-2]

    # uniform bands, channels last: (B', 79, T, bw, 2); the last band separate
    uni = spec[:, : 79 * bw].reshape(bp, 79, bw, t, 2).permute(0, 1, 3, 2, 4)
    last = spec[:, 79 * bw:].permute(0, 2, 1, 3)  # (B', T, bw_l, 2)

    def band_features(s):  # (..., T, BW, 2) -> normalised spectrum + log power
        power = torch.sqrt((s[..., 0] ** 2 + s[..., 1] ** 2).sum(dim=-1, keepdim=True)
                           + _EPS_F32)
        return torch.cat([s[..., 0] / power, s[..., 1] / power, torch.log(power)], dim=-1)

    feat_uni = band_features(uni)  # (B', 79, T, 2bw+1)
    feat_last = band_features(last)  # (B', T, 2bw_l+1)
    if compute_dtype is not None:
        feat_uni, feat_last = feat_uni.to(compute_dtype), feat_last.to(compute_dtype)
    feat_uni = _rms_norm_last(feat_uni, params["bn_norm"][:, None, :])
    feat_uni = (torch.einsum("bmtc,mnc->bmtn", feat_uni, params["bn_w"])
                + params["bn_b"][None, :, None, :])
    feat_last = _rms_norm_last(feat_last, params["bn_norm_last"])
    feat_last = feat_last @ params["bn_w_last"].T + params["bn_b_last"]
    feat = torch.cat([feat_uni, feat_last[:, None]], dim=1)  # (B', 80, T, N)
    del feat_uni, feat_last, uni, last, spec
    nband = feat.shape[1]

    kernels = apollo_kernels(feat.device.type, feat.dtype, bp, t, nband, n)
    for lp in params["layers"]:
        # band communication: the sequence axis is the bands, batched over (B', T)
        if "K7" in kernels:
            feat = _roformer_apply_folded(lp["band_net"], feat)
        else:
            z = feat.transpose(1, 2).reshape(-1, nband, n)
            z = _roformer_apply(lp["band_net"], z)
            feat = z.reshape(bp, t, nband, n).transpose(1, 2)
        # sequence modelling over the frames of each band
        z = feat.reshape(bp * nband, t, n)
        for blk in lp["seq_net"]:
            z = fused_apollo_conv(z, blk) if "K6" in kernels else _conv_act_norm_apply(blk, z)
        feat = z.reshape(bp, nband, t, n)

    # output heads: RMSNorm + 1x1 + GLU -> RI per band
    hu = _rms_norm_last(feat[:, :79], params["out_norm"][:, None, :])
    hu = torch.einsum("bmtn,mon->bmto", hu, params["out_w"]) + params["out_b"][None, :, None, :]
    a, g = hu.chunk(2, dim=-1)
    hu = (a * torch.sigmoid(g)).reshape(bp, 79, t, 2, bw)  # (B', 79, T, 2, bw)

    hl = _rms_norm_last(feat[:, 79], params["out_norm_last"])
    hl = hl @ params["out_w_last"].T + params["out_b_last"]
    a, g = hl.chunk(2, dim=-1)
    hl = (a * torch.sigmoid(g)).reshape(bp, t, 2, bw_l).permute(0, 2, 3, 1)  # (B', 2, bw_l, T)

    spec_out = torch.cat([hu.permute(0, 3, 1, 4, 2).reshape(bp, 2, 79 * bw, t), hl], dim=2)
    spec_ri = torch.stack([spec_out[:, 0], spec_out[:, 1]], dim=-1).float()  # (B', F, T, 2)

    wav = istft_ri(spec_ri, win, stride, window, length=nsample)
    return wav.reshape(b, 1, ch, nsample)


# --------------------------------------------------------------------------
# torch checkpoint conversion
# --------------------------------------------------------------------------

def convert_torch(state_dict, config):
    """Key scheme (reference apollo.py): BN.{i}.{0,1}, net.{l}.band_net.*,
    net.{l}.seq_net.blocks.{j}.conv.{0,1,2,4}, output.{i}.{0,1}."""
    layer = _dims(config)[5]
    sd = {k: torch.as_tensor(np.asarray(v)) for k, v in state_dict.items()}
    used = set()

    def take(key):
        used.add(key)
        return sd[key]

    def conv_squeeze(key):  # torch conv1d 1x1 weight (O, I, 1) -> (O, I)
        return take(key)[..., 0]

    params = {
        "bn_norm": torch.stack([take(f"BN.{i}.0.weight") for i in range(79)]),
        "bn_w": torch.stack([conv_squeeze(f"BN.{i}.1.weight") for i in range(79)]),
        "bn_b": torch.stack([take(f"BN.{i}.1.bias") for i in range(79)]),
        "bn_norm_last": take("BN.79.0.weight"),
        "bn_w_last": conv_squeeze("BN.79.1.weight"),
        "bn_b_last": take("BN.79.1.bias"),
        "out_norm": torch.stack([take(f"output.{i}.0.weight") for i in range(79)]),
        "out_w": torch.stack([conv_squeeze(f"output.{i}.1.weight") for i in range(79)]),
        "out_b": torch.stack([take(f"output.{i}.1.bias") for i in range(79)]),
        "out_norm_last": take("output.79.0.weight"),
        "out_w_last": conv_squeeze("output.79.1.weight"),
        "out_b_last": take("output.79.1.bias"),
    }
    layers = []
    for li in range(layer):
        bn = f"net.{li}.band_net"
        blk = f"net.{li}.seq_net.blocks"
        layers.append({
            "band_net": {
                "input_norm": take(f"{bn}.input_norm.weight"),
                "qkv_w": conv_squeeze(f"{bn}.weight.weight"),
                "out_w": conv_squeeze(f"{bn}.output.weight"),
                "mlp_norm": take(f"{bn}.MLP.0.weight"),
                "mlp_in": conv_squeeze(f"{bn}.MLP.1.weight"),
                "mlp_out": conv_squeeze(f"{bn}.MLP_output.weight"),
            },
            "seq_net": [{
                "dw_w": take(f"{blk}.{j}.conv.0.weight"),
                "dw_b": take(f"{blk}.{j}.conv.0.bias"),
                "norm": take(f"{blk}.{j}.conv.1.weight"),
                "pw1_w": conv_squeeze(f"{blk}.{j}.conv.2.weight"),
                "pw1_b": take(f"{blk}.{j}.conv.2.bias"),
                "pw2_w": conv_squeeze(f"{blk}.{j}.conv.4.weight"),
                "pw2_b": take(f"{blk}.{j}.conv.4.bias"),
            } for j in range(3)],
        })
        # RoPE caches are registered buffers in checkpoints; recomputed here
        for extra in (f"{bn}.cos_freq", f"{bn}.sin_freq"):
            if extra in sd:
                used.add(extra)
    params["layers"] = layers

    unused = set(sd) - used
    if unused:
        raise ValueError(f"unconsumed checkpoint keys: {sorted(unused)[:8]} ...")
    return params
