"""HTDemucs, the hybrid transformer Demucs, and its v3 hybrid HDemucs
(counterpart of sesa_tpu/models/htdemucs.py).

Reflect-padded normalised STFT (hop = nfft/4, trimmed so its frames align
with the time branch's strides) -> complex-as-channels, per-sample
normalisation -> strided freq-encoder layers (DConv residual branches, a
scaled frequency embedding after layer 0) beside time-encoder layers ->
the cross-domain transformer (sinusoidal 2-D / 1-D embeddings, pre-norm
layers with LayerScale, self and cross attention in turn; ``hdemucs`` has
none and starts its decoder from zeros) -> mirrored decoders with skips ->
the spectral output rescaled and iSTFT'd, summed with the time branch's.
Output modes: ``cac=True`` (complex as channels, every published
checkpoint), and magnitude models through Wiener EM (``wiener_iters`` >= 0)
or the mix-phase soft mask (``wiener_iters`` < 0). ``model: demucs``
configs go to ``demucs_legacy``.

``compute_dtype=torch.bfloat16`` runs the encoders, the transformer and the
decoders in bf16 on weights cast once by :func:`prepare`; the STFT, the
iSTFT, the mix statistics (ddof 0, jnp's default) and the output assembly
stay f32. The transformer's attention is plain PyTorch, as in the JAX
package (an einsum, not ``sdpa``): products in the net's dtype, softmax in
f32, the probabilities cast back before the product with V. The deep
hdemucs layers' BLSTMs run on cuDNN in f32 on cast inputs
(``demucs_legacy._blstm``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from sesa_tpu_torch import to_device
from sesa_tpu_torch.models import demucs_legacy
from sesa_tpu_torch.models import layers as L
from sesa_tpu_torch.ops.prec import net_precision
from sesa_tpu_torch.ops.stft import hann_window, istft_ri, stft_ri
from sesa_tpu_torch.ops.wiener import wiener_ri
from sesa_tpu_torch.tree import tree_map


def _kwargs(config):
    """HTDemucs(**extra, **config.htdemucs) (reference demucs4ht.py:696-713)."""
    cfg = dict(config)
    variant = cfg.get("model", "htdemucs")
    if variant not in ("htdemucs", "hdemucs"):
        raise NotImplementedError(
            f"model variant {variant!r} is not implemented: 'htdemucs', "
            "'hdemucs' and the legacy time-domain 'demucs' are supported")
    if variant == "hdemucs":
        # the demucs package's HDemucs defaults (the v3 hybrid: depth 6, no
        # transformer, DConv attn/lstm inserts at layers >= 4)
        kw = dict(
            channels=48, growth=2, nfft=4096, wiener_iters=0,
            wiener_residual=False, cac=True, depth=6,
            rewrite=True, multi_freqs=None, multi_freqs_depth=2, freq_emb=0.2,
            emb_scale=10, emb_smooth=True, kernel_size=8, time_stride=2,
            stride=4, context=1, context_enc=0, norm_starts=4, norm_groups=4,
            dconv_mode=1, dconv_depth=2, dconv_comp=4, dconv_attn=4,
            dconv_lstm=4, dconv_init=1e-4,
            # fixed for this variant (no transformer, no subbands)
            bottom_channels=0, t_layers=0, t_hidden_scale=4.0, t_heads=8,
            t_max_period=10000.0, t_weight_pos_embed=1.0, t_cross_first=False,
            num_subbands=1,
        )
        sec = cfg.get("hdemucs", {}) or {}
    else:
        kw = dict(
            channels=48, growth=2, nfft=4096, wiener_iters=0, wiener_residual=False,
            cac=True, depth=4,
            rewrite=True, multi_freqs=None, multi_freqs_depth=3, freq_emb=0.2,
            emb_scale=10, emb_smooth=True, kernel_size=8, time_stride=2, stride=4,
            context=1, context_enc=0, norm_starts=4, norm_groups=4, dconv_mode=1,
            dconv_depth=2, dconv_comp=8, dconv_init=1e-3, bottom_channels=0,
            t_layers=5, t_hidden_scale=4.0, t_heads=8, t_max_period=10000.0,
            t_weight_pos_embed=1.0, t_cross_first=False, num_subbands=1,
            # the reference HTDemucs class has no DConv attn/lstm knobs
            dconv_attn=10 ** 9, dconv_lstm=10 ** 9,
        )
        sec = cfg.get("htdemucs", {}) or {}
    kw["variant"] = variant
    frozen = {"variant"} if variant == "hdemucs" else {"variant", "dconv_attn", "dconv_lstm"}
    kw.update({k: v for k, v in sec.items() if k in kw and k not in frozen})
    training = cfg.get("training", {}) or {}
    kw["sources"] = list(training.get("instruments", ["drums", "bass", "other", "vocals"]))
    kw["audio_channels"] = int(training.get("channels", 2))
    kw["samplerate"] = int(training.get("samplerate", 44100))
    kw["segment"] = training.get("segment", 10)
    return kw


def _layer_plan(kw):
    """Per-depth (freq) channel and kernel plan (reference :263-370)."""
    plan = []
    cac_f = 2 if kw["cac"] else 1
    subs = kw["num_subbands"]
    chin = kw["audio_channels"]
    chin_z = chin * cac_f * subs  # the subband fold widens the channels
    chout = chout_z = kw["channels"]
    freqs = kw["nfft"] // 2
    for index in range(kw["depth"]):
        norm = index >= kw["norm_starts"]
        freq = freqs > 1
        ker, stri, pad = kw["kernel_size"], kw["stride"], True
        if not freq:
            # time layers after the frequency axis collapsed (hdemucs depth 6)
            ker, stri = kw["time_stride"] * 2, kw["time_stride"]
        last_freq = False
        if freq and freqs <= kw["kernel_size"]:
            ker, pad, last_freq = freqs, False, True
        if last_freq:
            chout_z = max(chout, chout_z)
            chout = chout_z
        # MultiWrap's per-band split wraps the outermost freq layers, whose
        # decoders lose the rewrite's frequency context
        multi = bool(kw["multi_freqs"]) and index < kw["multi_freqs_depth"] and freq
        plan.append(dict(index=index, norm=norm, freq=freq, ker=ker, stride=stri,
                         pad=pad, last_freq=last_freq, chin=chin, chin_z=chin_z,
                         chout=chout, chout_z=chout_z, freqs=freqs,
                         multi=multi, context_freq=not multi,
                         attn=index >= kw["dconv_attn"],
                         lstm=index >= kw["dconv_lstm"]))
        if index == 0:
            chin = kw["audio_channels"] * len(kw["sources"])
            chin_z = chin * cac_f * subs
        plan[-1]["dec_chin"] = chin
        plan[-1]["dec_chin_z"] = chin_z
        chin, chin_z = chout, chout_z
        chout = int(kw["growth"] * chout)
        chout_z = int(kw["growth"] * chout_z)
        if freq:
            freqs = 1 if freqs <= kw["kernel_size"] else freqs // kw["stride"]
    return plan


def _variant(config):
    return dict(config).get("model", "htdemucs")


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _norm_p(c):
    return {"weight": torch.ones(c), "bias": torch.zeros(c)}


def init(generator: torch.Generator, config):
    """Random parameters drawn on the CPU from ``generator`` (the numbers
    differ from the JAX package's init; the tree is the same)."""
    if _variant(config) == "demucs":
        return demucs_legacy.init(generator, config)
    kw = _kwargs(config)
    plan = _layer_plan(kw)

    def uniform(shape, fan):
        return L.kaiming_uniform(shape, fan, generator)

    def conv(ci, co, khw):
        return {"weight": uniform((co, ci) + tuple(khw), ci * int(np.prod(khw))),
                "bias": torch.zeros(co)}

    def convtr(ci, co, khw):
        return {"weight": uniform((ci, co) + tuple(khw), ci * int(np.prod(khw))),
                "bias": torch.zeros(co)}

    def lstm_p(ci, h):
        def side():
            return {"weight_ih": uniform((4 * h, ci), ci), "weight_hh": uniform((4 * h, h), h),
                    "bias_ih": torch.zeros(4 * h), "bias_hh": torch.zeros(4 * h)}
        return {"fwd": side(), "bwd": side()}

    def dconv(ch, attn=False, lstm=False):
        hidden = max(1, ch // kw["dconv_comp"])
        blocks = []
        for _ in range(kw["dconv_depth"]):
            blk = {"conv1": conv(ch, hidden, (3,)), "norm1": _norm_p(hidden),
                   "conv2": conv(hidden, 2 * ch, (1,)), "norm2": _norm_p(2 * ch),
                   "scale": torch.full((ch,), kw["dconv_init"])}
            if lstm:
                blk["lstm"] = {
                    "layers": [lstm_p(hidden if i == 0 else 2 * hidden, hidden)
                               for i in range(2)],
                    "linear": {"weight": uniform((hidden, 2 * hidden), 2 * hidden),
                               "bias": torch.zeros(hidden)}}
            if attn:
                blk["attn"] = {name: conv(hidden, co_a, (1,)) for name, co_a in
                               (("content", hidden), ("query", hidden), ("key", hidden),
                                ("query_decay", 16), ("proj", hidden))}
            blocks.append(blk)
        return blocks

    def enc_layer(ci, co, ker, freq, norm, empty=False, attn=False, lstm=False):
        p = {"conv": conv(ci, co, (ker, 1) if freq else (ker,))}
        if empty:
            return p
        if norm:
            p["norm1"] = _norm_p(co)
        if kw["rewrite"]:
            ctx = kw["context_enc"]
            # HEncLayer passes an int kernel to Conv2d: freq rewrites are square
            rk = (1 + 2 * ctx, 1 + 2 * ctx) if freq else (1 + 2 * ctx,)
            p["rewrite"] = conv(co, 2 * co, rk)
            if norm:
                p["norm2"] = _norm_p(2 * co)
        if kw["dconv_mode"] & 1:
            p["dconv"] = dconv(co, attn, lstm)
        return p

    def dec_layer(ci, co, ker, freq, norm, empty=False, context_freq=True,
                  attn=False, lstm=False):
        p = {"conv_tr": convtr(ci, co, (ker, 1) if freq else (ker,))}
        if norm:
            p["norm2"] = _norm_p(co)
        if empty:
            return p
        if kw["rewrite"]:
            ctx = kw["context"]
            if freq:
                rk = (1 + 2 * ctx, 1 + 2 * ctx) if context_freq else (1, 1 + 2 * ctx)
            else:
                rk = (1 + 2 * ctx,)
            p["rewrite"] = conv(ci, 2 * ci, rk)
            if norm:
                p["norm1"] = _norm_p(2 * ci)
        if kw["dconv_mode"] & 2:
            p["dconv"] = dconv(ci, attn, lstm)
        return p

    n_bands = len(kw["multi_freqs"] or []) + 1
    params = {"encoder": [], "tencoder": [], "decoder": [], "tdecoder": []}
    for lp in plan:
        al = dict(attn=lp["attn"], lstm=lp["lstm"])
        if lp["multi"]:  # MultiWrap: n_bands independent replicas of the layer
            e = {"layers": [enc_layer(lp["chin_z"], lp["chout_z"], lp["ker"], True,
                                      lp["norm"], **al) for _ in range(n_bands)]}
        else:
            e = enc_layer(lp["chin_z"], lp["chout_z"], lp["ker"], lp["freq"], lp["norm"], **al)
        params["encoder"].append(e)
        if lp["freq"]:
            params["tencoder"].append(enc_layer(lp["chin"], lp["chout"], kw["kernel_size"],
                                                False, lp["norm"], empty=lp["last_freq"], **al))
        if lp["multi"]:
            d = {"layers": [dec_layer(lp["chout_z"], lp["dec_chin_z"], lp["ker"], True,
                                      lp["norm"], context_freq=False, **al)
                            for _ in range(n_bands)]}
        else:
            d = dec_layer(lp["chout_z"], lp["dec_chin_z"], lp["ker"], lp["freq"], lp["norm"],
                          context_freq=lp["context_freq"], **al)
        params["decoder"].insert(0, d)
        if lp["freq"]:
            params["tdecoder"].insert(0, dec_layer(lp["chout"], lp["dec_chin"],
                                                   kw["kernel_size"], False, lp["norm"],
                                                   empty=lp["last_freq"], **al))

    # the frequency embedding after encoder layer 0
    freqs_after0 = plan[0]["freqs"] // kw["stride"]
    emb = torch.randn((freqs_after0, plan[1]["chin_z"]), generator=generator)
    params["freq_emb"] = emb / kw["emb_scale"]

    if not kw["t_layers"]:  # hdemucs: no cross transformer
        return params
    dim = tr_ch = kw["channels"] * kw["growth"] ** (kw["depth"] - 1)
    if kw["bottom_channels"]:
        dim = kw["bottom_channels"]  # 1x1 channel up/downsamplers around it
    hidden = int(kw["t_hidden_scale"] * dim)

    def lin(ci, co):
        return {"weight": uniform((co, ci), ci), "bias": torch.zeros(co)}

    def t_layer(cross):
        p = {"attn": {"in_proj_weight": uniform((3 * dim, dim), dim),
                      "in_proj_bias": torch.zeros(3 * dim),
                      "out_proj": lin(dim, dim)},
             "linear1": lin(dim, hidden), "linear2": lin(hidden, dim),
             "norm1": _norm_p(dim), "norm2": _norm_p(dim),
             "gamma_1": torch.full((dim,), 1e-4), "gamma_2": torch.full((dim,), 1e-4),
             "norm_out": _norm_p(dim)}
        if cross:
            p["norm3"] = _norm_p(dim)
        return p

    ct = {"norm_in": _norm_p(dim), "norm_in_t": _norm_p(dim), "layers": [], "layers_t": []}
    parity = 1 if kw["t_cross_first"] else 0
    for i in range(kw["t_layers"]):
        cross = i % 2 != parity
        ct["layers"].append(t_layer(cross))
        ct["layers_t"].append(t_layer(cross))
    params["crosstransformer"] = ct
    if kw["bottom_channels"]:
        for name, ci, co in (("channel_upsampler", tr_ch, dim), ("channel_downsampler", dim, tr_ch),
                             ("channel_upsampler_t", tr_ch, dim),
                             ("channel_downsampler_t", dim, tr_ch)):
            params[name] = {"weight": uniform((co, ci, 1), ci), "bias": torch.zeros(co)}
    return params


def prepare(params, config, compute_dtype=None):
    """Weight preparation, done once per session and dtype: every leaf cast
    to ``compute_dtype``. :func:`apply` accepts the result in place of the
    raw tree."""
    if compute_dtype is None:
        return params
    return tree_map(lambda p: p.to(compute_dtype), params)


# --------------------------------------------------------------------------
# apply helpers
# --------------------------------------------------------------------------

def _maybe_norm(x, p, key, groups):
    return L.group_norm(x, p[key], groups) if key in p else x


def _dconv_apply(blocks, x):
    """(B, C, T) residual DConv branch, with the skip-BLSTM and LocalState
    inserts of the deep hdemucs layers."""
    for d, b in enumerate(blocks):
        y = demucs_legacy.dilated_conv1d(x, b["conv1"], 2 ** d)
        y = L.gelu(L.group_norm(y, b["norm1"], 1))
        if "lstm" in b:
            y = demucs_legacy._blstm(b["lstm"], y, max_steps=200, skip=True)
        if "attn" in b:
            y = demucs_legacy._local_state(b["attn"], y)
        y = L.conv1d(y, b["conv2"]["weight"], b["conv2"]["bias"])
        y = L.glu(L.group_norm(y, b["norm2"], 1), dim=1)
        x = x + y * b["scale"][None, :, None]
    return x


def _dconv_any(p, y, freq):
    """The DConv over (B, C, T), or over each frequency row of (B, C, F, T)."""
    if not freq:
        return _dconv_apply(p, y)
    b, c, fr, t = y.shape
    z = _dconv_apply(p, y.permute(0, 2, 1, 3).reshape(-1, c, t))
    return z.reshape(b, fr, c, t).permute(0, 2, 1, 3)


def _rewrite_glu(p, y, freq, groups, norm_key):
    """The rewrite conv ("same" padding from its kernel), its norm and GLU."""
    w = p["rewrite"]["weight"]
    if freq:
        z = L.conv2d(y, w, p["rewrite"]["bias"],
                     padding=((w.shape[2] - 1) // 2, (w.shape[3] - 1) // 2))
    else:
        z = L.conv1d(y, w, p["rewrite"]["bias"], padding=(w.shape[2] - 1) // 2)
    return L.glu(_maybe_norm(z, p, norm_key, groups), dim=1)


def _henc_apply(p, x, kw, freq, ker, stride, pad, inject=None, empty=False):
    groups = kw["norm_groups"]
    if not freq and x.ndim == 4:
        x = x.reshape(x.shape[0], -1, x.shape[-1])
    if not freq and x.shape[-1] % stride != 0:
        x = F.pad(x, (0, stride - x.shape[-1] % stride))
    padding = ker // 4 if pad else 0
    if freq:
        y = L.conv2d(x, p["conv"]["weight"], p["conv"]["bias"], stride=(stride, 1),
                     padding=(padding, 0))
    else:
        y = L.conv1d(x, p["conv"]["weight"], p["conv"]["bias"], stride=stride,
                     padding=padding)
    if empty:
        return y
    if inject is not None:
        if inject.ndim == 3 and y.ndim == 4:
            inject = inject[:, :, None]
        y = y + inject
    y = L.gelu(_maybe_norm(y, p, "norm1", groups))
    if "dconv" in p:
        y = _dconv_any(p["dconv"], y, freq)
    if "rewrite" in p:
        return _rewrite_glu(p, y, freq, groups, "norm2")
    return y


def _hdec_apply(p, x, skip, length, kw, freq, ker, stride, pad, chin, last=False,
                empty=False):
    groups = kw["norm_groups"]
    if freq and x.ndim == 3:
        x = x.reshape(x.shape[0], chin, -1, x.shape[-1])
    if not empty:
        x = x + skip
        y = _rewrite_glu(p, x, freq, groups, "norm1") if "rewrite" in p else x
        if "dconv" in p:
            y = _dconv_any(p["dconv"], y, freq)
    else:
        if skip is not None:
            raise ValueError("an empty decoder layer takes no skip")
        y = x

    # HDecLayer crops kernel_size//4 (HEncLayer's pad), not (ker-stride)//2
    padding = ker // 4 if pad else 0
    if freq:
        z = L.conv_transpose2d(y, p["conv_tr"]["weight"], p["conv_tr"]["bias"],
                               stride=(stride, 1))
        z = _maybe_norm(z, p, "norm2", groups)
        if padding:
            z = z[..., padding:-padding, :]
    else:
        z = F.conv_transpose1d(y, p["conv_tr"]["weight"], p["conv_tr"]["bias"], stride=stride)
        z = _maybe_norm(z, p, "norm2", groups)
        z = z[..., padding:padding + length]
    if not last:
        z = L.gelu(z)
    return z, y


def _henc_multi(p, x, kw, ker, stride):
    """MultiWrap's frequency-band split around HEncLayer replicas: band b
    covers input rows [start, limit), ``limit`` re-rounded to a whole number
    of conv frames; the first band left-pads K//4 rows, the last right-pads
    K//4, and consecutive bands overlap by K - stride rows, so identical
    replicas reproduce one unwrapped padded layer."""
    ratios = list(kw["multi_freqs"]) + [1]
    frq = x.shape[2]
    pad = ker // 4
    outs = []
    start = 0
    for ratio, sub in zip(ratios, p["layers"]):
        if ratio == 1:
            limit = frq
        else:
            limit = int(round(frq * ratio))
            le = limit - start
            if start == 0:
                le += pad
            frames = int(round((le - ker) / stride + 1))
            limit = start + (frames - 1) * stride + ker
            if start == 0:
                limit -= pad
        if not 0 < limit - start <= frq:
            raise ValueError(f"MultiWrap band [{start}, {limit}) of {frq} rows")
        y = x[:, :, start:limit, :]
        if start == 0:
            y = F.pad(y, (0, 0, pad, 0))
        if ratio == 1:
            y = F.pad(y, (0, 0, 0, pad))
        outs.append(_henc_apply(sub, y, kw, True, ker, stride, False))
        start = limit - ker + stride
    return torch.cat(outs, dim=2)


def _hdec_multi(p, x, skip, kw, ker, stride, chin, last):
    """MultiWrap around HDecLayer replicas: each band's transposed conv spans
    K - stride rows past the next band's start; the overlap is summed with
    one duplicate bias removed, then K//4 rows are cropped at both ends."""
    ratios = list(kw["multi_freqs"]) + [1]
    frq = x.shape[2]
    pad = ker // 4
    outs = []
    start = 0
    for ratio, sub in zip(ratios, p["layers"]):
        limit = frq if ratio == 1 else int(round(frq * ratio))
        # last=True: the GELU comes once, below; pad=False: the crop too
        z, _ = _hdec_apply(sub, x[:, :, start:limit], skip[:, :, start:limit], None, kw, True,
                           ker, stride, False, chin=chin, last=True)
        if outs:
            ov = ker - stride
            bias = sub["conv_tr"]["bias"].to(z.dtype)
            merged = outs[-1][:, :, -ov:] + z[:, :, :ov] - bias[None, :, None, None]
            outs[-1] = torch.cat([outs[-1][:, :, :-ov], merged], dim=2)
            z = z[:, :, ov:]
        outs.append(z)
        start = limit
    out = torch.cat(outs, dim=2)
    if pad:
        out = out[:, :, pad:-pad]
    if not last:
        out = L.gelu(out)
    return out, None


def _sin_embedding_1d(length, dim, max_period, device):
    pos = np.arange(length)[:, None]
    half = dim // 2
    adim = np.arange(half)[None, :]
    phase = pos / (max_period ** (adim / (half - 1)))
    return to_device(np.concatenate([np.cos(phase), np.sin(phase)], axis=-1)[None], device,
                     torch.float32)


def _sin_embedding_2d(d_model, height, width, max_period, device):
    pe = np.zeros((d_model, height, width))
    dm = d_model // 2
    div = np.exp(np.arange(0.0, dm, 2) * -(math.log(max_period) / dm))
    pos_w = np.arange(width)[:, None]
    pos_h = np.arange(height)[:, None]
    pe[0:dm:2] = np.tile(np.sin(pos_w * div).T[:, None, :], (1, height, 1))
    pe[1:dm:2] = np.tile(np.cos(pos_w * div).T[:, None, :], (1, height, 1))
    pe[dm::2] = np.tile(np.sin(pos_h * div).T[:, :, None], (1, 1, width))
    pe[dm + 1::2] = np.tile(np.cos(pos_h * div).T[:, :, None], (1, 1, width))
    return to_device(pe[None], device, torch.float32)


def _mha(p, q, k, v, heads):
    """torch nn.MultiheadAttention (batch first) with its packed in-proj:
    products in the input's dtype, softmax in f32, cast back."""
    d = q.shape[-1]
    wq, wk, wv = p["in_proj_weight"].chunk(3, dim=0)
    bq, bk, bv = p["in_proj_bias"].chunk(3, dim=0)
    b, tq, tk, dh = q.shape[0], q.shape[1], k.shape[1], d // heads
    qq = F.linear(q, wq, bq).reshape(b, tq, heads, dh).transpose(1, 2)
    kk = F.linear(k, wk, bk).reshape(b, tk, heads, dh).transpose(1, 2)
    vv = F.linear(v, wv, bv).reshape(b, tk, heads, dh).transpose(1, 2)
    sim = torch.matmul(qq, kk.transpose(-1, -2)) * (dh ** -0.5)
    attn = torch.softmax(sim.float(), dim=-1).to(qq.dtype)
    out = torch.matmul(attn, vv).transpose(1, 2).reshape(b, tq, d)
    return L.linear(out, p["out_proj"])


def _t_norm_out(x, p):
    """MyGroupNorm(1, d) on (B, T, C): normalised over (T, C) per sample."""
    return L.group_norm(x.transpose(1, 2), p, 1).transpose(1, 2)


def _t_ff(p, y):
    return L.linear(L.gelu(L.linear(y, p["linear1"])), p["linear2"])


def _t_self_layer(p, x, heads):
    y = L.layer_norm(x, p["norm1"])
    x = x + p["gamma_1"] * _mha(p["attn"], y, y, y, heads)
    x = x + p["gamma_2"] * _t_ff(p, L.layer_norm(x, p["norm2"]))
    return _t_norm_out(x, p["norm_out"])


def _t_cross_layer(p, q, kv, heads):
    qn = L.layer_norm(q, p["norm1"])
    kn = L.layer_norm(kv, p["norm2"])
    x = q + p["gamma_1"] * _mha(p["attn"], qn, kn, kn, heads)
    x = x + p["gamma_2"] * _t_ff(p, L.layer_norm(x, p["norm3"]))
    return _t_norm_out(x, p["norm_out"])


def _conv1x1(p, x):
    return L.conv1d(x, p["weight"], p["bias"])


# --------------------------------------------------------------------------
# apply
# --------------------------------------------------------------------------

def apply(params, config, mix: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """(B, ch, T) -> (B, sources, ch, T). ``model: demucs`` configs run the
    legacy time-domain net (``demucs_legacy``)."""
    if _variant(config) == "demucs":
        return demucs_legacy.apply(params, config, mix, compute_dtype=compute_dtype)
    with net_precision(compute_dtype) as dtype:
        kw = _kwargs(config)
        plan = _layer_plan(kw)
        nfft, hl = kw["nfft"], kw["nfft"] // 4
        mix = mix.float()
        b, ch, length = mix.shape

        # ---- STFT with the demucs alignment (reference :427-447) ----
        le = int(math.ceil(length / hl))
        pad = hl // 2 * 3
        xpad = F.pad(mix, (pad, pad + le * hl - length), mode="reflect")
        window = hann_window(nfft, device=mix.device)
        spec = stft_ri(xpad.reshape(b * ch, -1), nfft, hl, window, normalized=True)
        spec = spec[:, :-1, 2:2 + le]  # drop the Nyquist row; trim the frames
        z_mix = spec.reshape(b, ch, nfft // 2, le, 2)

        if kw["cac"]:  # (B, C*2, F, T) with (ch, re/im) major-minor
            mag = z_mix.permute(0, 1, 4, 2, 3).reshape(b, ch * 2, nfft // 2, le)
        else:
            mag = torch.sqrt(z_mix[..., 0] ** 2 + z_mix[..., 1] ** 2)

        subs = kw["num_subbands"]
        if subs > 1:  # cac2cws: frequency rows (k, f/k) into channels
            c_in = mag.shape[1]
            mag = mag.reshape(b, c_in * subs, (nfft // 2) // subs, le)

        # ddof 0, jnp's default (the torch oracle of the JAX tests uses ddof 1)
        std, mean = torch.std_mean(mag, dim=(1, 2, 3), keepdim=True, correction=0)
        x = (mag - mean) / (1e-5 + std)
        stdt, meant = torch.std_mean(mix, dim=(1, 2), keepdim=True, correction=0)
        xt = (mix - meant) / (1e-5 + stdt)

        x, xt = x.to(dtype), xt.to(dtype)
        params = prepare(params, config, compute_dtype)

        saved, saved_t, lengths, lengths_t = [], [], [], []
        for idx, lp in enumerate(plan):
            lengths.append(x.shape[-1])
            inject = None
            if idx < len(params["tencoder"]):
                lengths_t.append(xt.shape[-1])
                tout = _henc_apply(params["tencoder"][idx], xt, kw, False, kw["kernel_size"],
                                   kw["stride"], True, empty=lp["last_freq"])
                if not lp["last_freq"]:
                    xt = tout
                    saved_t.append(xt)
                else:
                    inject = tout
            ep = params["encoder"][idx]
            if "layers" in ep:
                if inject is not None or lp["norm"]:
                    raise ValueError("MultiWrap takes neither a normed layer nor an injection")
                x = _henc_multi(ep, x, kw, lp["ker"], lp["stride"])
            else:
                x = _henc_apply(ep, x, kw, lp["freq"], lp["ker"], lp["stride"], lp["pad"],
                                inject=inject)
            if idx == 0:
                # ScaledEmbedding: the table is sized from the nominal frequency
                # count; only the rows present are read (1/k of it with k subbands)
                emb = (params["freq_emb"] * kw["emb_scale"])[:x.shape[2]]
                x = x + kw["freq_emb"] * emb.t()[None, :, :, None]
            saved.append(x)

        if kw["variant"] == "hdemucs":
            # no bottleneck net: the decoder starts from zeros and the signal
            # flows through the skips
            return _decode_and_assemble(params, kw, plan, torch.zeros_like(x), xt, saved, saved_t,
                                        lengths, lengths_t, z_mix, mean, std, meant, stdt, length,
                                        le, subs)
        ct = params["crosstransformer"]
        if kw["bottom_channels"]:  # 1x1 channel upsamplers (reference :620-625)
            bb, c0, fr0, t0 = x.shape
            x = _conv1x1(params["channel_upsampler"], x.reshape(bb, c0, fr0 * t0))
            x = x.reshape(bb, -1, fr0, t0)
            xt = _conv1x1(params["channel_upsampler_t"], xt)
        bb, cc, fr, t1 = x.shape
        pos2d = _sin_embedding_2d(cc, fr, t1, kw["t_max_period"], x.device)
        # token order (t1, fr): 'b c fr t1 -> b (t1 fr) c'
        tok = x.permute(0, 3, 2, 1).reshape(bb, t1 * fr, cc)
        pos_tok = pos2d.permute(0, 3, 2, 1).reshape(1, t1 * fr, cc)
        tok = L.layer_norm(tok, ct["norm_in"])
        # the position tables are f32; cast so bf16 tokens stay bf16
        tok = tok + (kw["t_weight_pos_embed"] * pos_tok).to(tok.dtype)

        t2 = xt.shape[-1]
        tokt = L.layer_norm(xt.transpose(1, 2), ct["norm_in_t"])
        pos_t = _sin_embedding_1d(t2, cc, kw["t_max_period"], x.device)
        tokt = tokt + (kw["t_weight_pos_embed"] * pos_t).to(tokt.dtype)

        parity = 1 if kw["t_cross_first"] else 0
        for i in range(kw["t_layers"]):
            if i % 2 == parity:
                tok = _t_self_layer(ct["layers"][i], tok, kw["t_heads"])
                tokt = _t_self_layer(ct["layers_t"][i], tokt, kw["t_heads"])
            else:
                old = tok
                tok = _t_cross_layer(ct["layers"][i], tok, tokt, kw["t_heads"])
                tokt = _t_cross_layer(ct["layers_t"][i], tokt, old, kw["t_heads"])

        x = tok.reshape(bb, t1, fr, cc).permute(0, 3, 2, 1)
        xt = tokt.transpose(1, 2)
        if kw["bottom_channels"]:  # back to the encoder's channels (reference :630-634)
            x = _conv1x1(params["channel_downsampler"], x.reshape(bb, cc, fr * t1))
            x = x.reshape(bb, -1, fr, t1)
            xt = _conv1x1(params["channel_downsampler_t"], xt)

        return _decode_and_assemble(params, kw, plan, x, xt, saved, saved_t, lengths, lengths_t,
                                    z_mix, mean, std, meant, stdt, length, le, subs)


def _decode_and_assemble(params, kw, plan, x, xt, saved, saved_t, lengths, lengths_t,
                         z_mix, mean, std, meant, stdt, length, le, subs):
    """The decoder sweep and the spectral output assembly (both variants)."""
    b, ch = z_mix.shape[:2]
    nfft = 2 * z_mix.shape[2]
    hl = nfft // 4
    pad = hl // 2 * 3
    window = hann_window(nfft, device=z_mix.device)

    s_src = len(kw["sources"])
    offset = kw["depth"] - len(params["tdecoder"])
    for idx, lp in enumerate(reversed(plan)):
        skip = saved.pop(-1)
        dp = params["decoder"][idx]
        last = lp["index"] == 0
        if "layers" in dp:
            lengths.pop(-1)
            x, pre = _hdec_multi(dp, x, skip, kw, lp["ker"], lp["stride"], chin=lp["chout_z"],
                                 last=last)
        else:
            x, pre = _hdec_apply(dp, x, skip, lengths.pop(-1), kw, lp["freq"], lp["ker"],
                                 lp["stride"], lp["pad"], chin=lp["chout_z"], last=last)
        if idx >= offset:
            tdec = params["tdecoder"][idx - offset]
            length_t = lengths_t.pop(-1)
            if lp["last_freq"]:
                xt, _ = _hdec_apply(tdec, pre[:, :, 0], None, length_t, kw, False,
                                    kw["kernel_size"], kw["stride"], True, chin=lp["chout"],
                                    last=last, empty=True)
            else:
                xt, _ = _hdec_apply(tdec, xt, saved_t.pop(-1), length_t, kw, False,
                                    kw["kernel_size"], kw["stride"], True, chin=lp["chout"],
                                    last=last)

    # ---- output assembly (f32) ----
    x, xt = x.float(), xt.float()
    if subs > 1:  # cws2cac: the subband channels back onto the frequency axis
        c_all, fsub = x.shape[1], x.shape[2]
        x = x.reshape(b, c_all // subs, subs * fsub, le)

    if kw["cac"]:
        x = x.reshape(b, s_src, ch * 2, nfft // 2, le)
        x = x * std[:, None] + mean[:, None]
        # the CaC output -> RI spectrum (reference :470-478)
        zout = x.reshape(b, s_src, ch, 2, nfft // 2, le).permute(0, 1, 2, 4, 5, 3)
    else:
        # magnitudes -> Wiener EM or the mix-phase soft mask (reference :470-517)
        m = x.reshape(b, s_src, ch, nfft // 2, le)
        m = m * std[:, None] + mean[:, None]
        niters = kw["wiener_iters"]
        if niters < 0:
            mag = torch.sqrt(z_mix[..., 0] ** 2 + z_mix[..., 1] ** 2).clamp_min(1e-8)
            zout = (z_mix / mag[..., None])[:, None] * m[..., None]  # (B, S, ch, F, T, 2)
        else:
            tgt = m.permute(0, 4, 3, 2, 1)  # (B, T, F, ch, S)
            mx = z_mix.permute(0, 3, 2, 1, 4)  # (B, T, F, ch, 2)
            out = torch.stack([wiener_ri(tgt[i], mx[i], niters, residual=kw["wiener_residual"])
                               for i in range(b)])  # (B, T, F, ch, 2, S)
            if kw["wiener_residual"]:
                out = out[..., :-1]
            zout = out.permute(0, 5, 3, 2, 1, 4)  # (B, S, ch, F, T, 2)

    # ---- iSTFT with the demucs alignment (reference :449-457) ----
    zz = F.pad(zout, (0, 0, 2, 2, 0, 1))  # the Nyquist row back; 2 frames each side
    le2 = hl * int(math.ceil(length / hl)) + 2 * pad
    wav = istft_ri(zz.reshape(-1, nfft // 2 + 1, zz.shape[-2], 2), nfft, hl, window,
                   normalized=True, length=le2)
    wav = wav[..., pad:pad + length].reshape(b, s_src, ch, length)

    xt = xt.reshape(b, s_src, ch, length)
    return xt * stdt[:, None] + meant[:, None] + wav


# --------------------------------------------------------------------------
# torch checkpoint conversion
# --------------------------------------------------------------------------

def convert_torch(state_dict, config):
    """Map a demucs-package HTDemucs / HDemucs state dict (or, for ``model:
    demucs``, a Demucs one) onto the parameter tree. Raises ``ValueError``
    on a key it does not consume."""
    if _variant(config) == "demucs":
        return demucs_legacy.convert_torch(state_dict, config)
    kw = _kwargs(config)
    plan = _layer_plan(kw)
    sd = {k: torch.as_tensor(v) for k, v in state_dict.items()}
    used = set()

    def take(key):
        used.add(key)
        return sd[key].float()

    def wb(prefix):
        p = {"weight": take(f"{prefix}.weight")}
        if f"{prefix}.bias" in sd:
            p["bias"] = take(f"{prefix}.bias")
        return p

    def dconv(prefix):
        blocks = []
        d = 0
        while f"{prefix}.layers.{d}.0.weight" in sd:
            p = f"{prefix}.layers.{d}"
            blk = {"conv1": wb(f"{p}.0"), "norm1": wb(f"{p}.1")}
            # the deep hdemucs layers insert a BLSTM, then LocalState, at index 3
            j = 3
            if f"{p}.{j}.lstm.weight_ih_l0" in sd:
                blk["lstm"] = demucs_legacy.lstm_params(take, f"{p}.{j}", 2)
                j += 1
            if f"{p}.{j}.content.weight" in sd:
                blk["attn"] = {name: wb(f"{p}.{j}.{name}") for name in
                               ("content", "query", "key", "query_decay", "proj")}
                j += 1
            blk["conv2"] = wb(f"{p}.{j}")
            blk["norm2"] = wb(f"{p}.{j + 1}")
            blk["scale"] = take(f"{p}.{j + 3}.scale")
            blocks.append(blk)
            d += 1
        return blocks

    def enc(prefix, norm, empty=False):
        p = {"conv": wb(f"{prefix}.conv")}
        if empty:
            return p
        if norm:
            p["norm1"] = wb(f"{prefix}.norm1")
        if f"{prefix}.rewrite.weight" in sd:
            p["rewrite"] = wb(f"{prefix}.rewrite")
            if norm:
                p["norm2"] = wb(f"{prefix}.norm2")
        if f"{prefix}.dconv.layers.0.0.weight" in sd:
            p["dconv"] = dconv(f"{prefix}.dconv")
        return p

    def dec(prefix, norm, empty=False):
        p = {"conv_tr": wb(f"{prefix}.conv_tr")}
        if norm:
            p["norm2"] = wb(f"{prefix}.norm2")
        if empty:
            return p
        if f"{prefix}.rewrite.weight" in sd:
            p["rewrite"] = wb(f"{prefix}.rewrite")
            if norm:
                p["norm1"] = wb(f"{prefix}.norm1")
        if f"{prefix}.dconv.layers.0.0.weight" in sd:
            p["dconv"] = dconv(f"{prefix}.dconv")
        return p

    n_bands = len(kw["multi_freqs"] or []) + 1
    params = {"encoder": [], "tencoder": [], "decoder": [], "tdecoder": []}
    n_t = sum(1 for lp in plan if lp["freq"])
    for i, lp in enumerate(plan):
        if lp["multi"]:
            params["encoder"].append({"layers": [enc(f"encoder.{i}.layers.{k}", lp["norm"])
                                                 for k in range(n_bands)]})
        else:
            params["encoder"].append(enc(f"encoder.{i}", lp["norm"]))
    for i in range(n_t):
        params["tencoder"].append(enc(f"tencoder.{i}", plan[i]["norm"],
                                      empty=plan[i]["last_freq"]))
    for i in range(kw["depth"]):
        lp = plan[kw["depth"] - 1 - i]
        if lp["multi"]:
            params["decoder"].append({"layers": [dec(f"decoder.{i}.layers.{k}", lp["norm"])
                                                 for k in range(n_bands)]})
        else:
            params["decoder"].append(dec(f"decoder.{i}", lp["norm"]))
    for i in range(n_t):
        lp = plan[n_t - 1 - i]
        params["tdecoder"].append(dec(f"tdecoder.{i}", lp["norm"], empty=lp["last_freq"]))

    params["freq_emb"] = take("freq_emb.embedding.weight")

    if kw["t_layers"]:
        ct = {"norm_in": wb("crosstransformer.norm_in"),
              "norm_in_t": wb("crosstransformer.norm_in_t"), "layers": [], "layers_t": []}
        parity = 1 if kw["t_cross_first"] else 0
        for branch in ("layers", "layers_t"):
            for i in range(kw["t_layers"]):
                cross = i % 2 != parity
                pfx = f"crosstransformer.{branch}.{i}"
                attn = f"{pfx}.{'cross_attn' if cross else 'self_attn'}"
                lp = {"attn": {"in_proj_weight": take(f"{attn}.in_proj_weight"),
                               "in_proj_bias": take(f"{attn}.in_proj_bias"),
                               "out_proj": wb(f"{attn}.out_proj")},
                      "linear1": wb(f"{pfx}.linear1"), "linear2": wb(f"{pfx}.linear2"),
                      "norm1": wb(f"{pfx}.norm1"), "norm2": wb(f"{pfx}.norm2"),
                      "gamma_1": take(f"{pfx}.gamma_1.scale"),
                      "gamma_2": take(f"{pfx}.gamma_2.scale"),
                      "norm_out": wb(f"{pfx}.norm_out")}
                if cross:
                    lp["norm3"] = wb(f"{pfx}.norm3")
                ct[branch].append(lp)
        params["crosstransformer"] = ct
        if kw["bottom_channels"]:
            for name in ("channel_upsampler", "channel_downsampler", "channel_upsampler_t",
                         "channel_downsampler_t"):
                params[name] = wb(name)

    unused = set(sd) - used
    if unused:
        raise ValueError(f"unconsumed checkpoint keys: {sorted(unused)[:10]} ...")
    return params
