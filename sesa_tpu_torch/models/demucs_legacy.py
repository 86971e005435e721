"""Legacy time-domain Demucs, the v2 architecture in the demucs package's
layout (counterpart of sesa_tpu/models/demucs_legacy.py).

An htdemucs config with ``model: demucs`` lands here (reference
models/demucs4ht.py:696-713): a 1-D conv U-Net over the waveform with
julius-style x2 sinc resampling around it, DConv residual branches (with
skip-BLSTM and LocalState decay-attention inserts at the deep layers), an
optional BLSTM bottleneck, GLU rewrite convolutions and mono-std
normalisation (ddof 1, as the JAX package and the demucs package have it).

``compute_dtype=torch.bfloat16`` runs the U-Net in bf16. Its BLSTMs run on
cuDNN in f32 on inputs and weights cast from bf16, each layer's output cast
back (``models/scnet.py`` measured cuDNN's bf16 LSTM slower on long
sequences and less exact). The x2 resampling runs f32 on both sides: the
JAX function raises in bf16 there (its sinc bank is f32 and lax takes no
mixed dtypes), so the bf16 decoder output is resampled as f32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from sesa_tpu_torch.models import layers as L
from sesa_tpu_torch.ops.prec import net_precision
from sesa_tpu_torch.tree import tree_map


def kwargs_from_config(config):
    """Demucs(**extra, **config.demucs) (reference demucs4ht.py:696-713)."""
    cfg = dict(config)
    kw = dict(
        channels=64, growth=2.0, depth=6, rewrite=True, lstm_layers=0,
        kernel_size=8, stride=4, context=1, gelu=True, glu=True,
        norm_starts=4, norm_groups=4, dconv_mode=1, dconv_depth=2,
        dconv_comp=4, dconv_attn=4, dconv_lstm=4, dconv_init=1e-4,
        normalize=True, resample=True,
    )
    kw.update({k: v for k, v in (cfg.get("demucs", {}) or {}).items() if k in kw})
    training = cfg.get("training", {}) or {}
    kw["sources"] = list(training.get("instruments", ["drums", "bass", "other", "vocals"]))
    kw["audio_channels"] = int(training.get("channels", 2))
    if not kw["gelu"] or not kw["glu"]:
        raise NotImplementedError(
            "demucs with gelu=False/glu=False has no known checkpoints; "
            "only the default GELU+GLU configuration is implemented")
    return kw


def valid_length(length, kw):
    if kw["resample"]:
        length *= 2
    for _ in range(kw["depth"]):
        length = math.ceil((length - kw["kernel_size"]) / kw["stride"]) + 1
        length = max(1, length)
    for _ in range(kw["depth"]):
        length = (length - 1) * kw["stride"] + kw["kernel_size"]
    if kw["resample"]:
        length = math.ceil(length / 2)
    return int(length)


# --------------------------------------------------------------------------
# julius-style x2 resampling (sinc bank, each phase normalised to sum 1)
# --------------------------------------------------------------------------

def _resample_kernel(old_sr, new_sr, zeros=24, rolloff=0.945):
    sr = min(new_sr, old_sr) * rolloff
    width = int(math.ceil(zeros * old_sr / sr))
    idx = np.arange(-width, width + old_sr, dtype=np.float64)
    kernels = []
    for i in range(new_sr):
        t = (-i / new_sr + idx / old_sr) * sr
        t = np.clip(t, -zeros, zeros) * math.pi
        window = np.cos(t / zeros / 2) ** 2
        kernel = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
        kernel = kernel * window
        kernels.append(kernel / kernel.sum())
    return np.stack(kernels).astype(np.float32)[:, None, :], width


def _resample(x: torch.Tensor, old_sr: int, new_sr: int) -> torch.Tensor:
    """(B, C, T) -> (B, C, T*new/old) f32, julius.resample_frac semantics."""
    if old_sr == new_sr:
        return x
    kernel, width = _resample_kernel(old_sr, new_sr)
    b, c, length = x.shape
    y = F.pad(x.float().reshape(-1, 1, length), (width, width + old_sr), mode="replicate")
    y = F.conv1d(y, torch.from_numpy(kernel).to(y.device), stride=old_sr)
    y = y.transpose(1, 2).reshape(b, c, -1)
    return y[..., :int(new_sr * length / old_sr)]


def center_trim(x: torch.Tensor, length: int) -> torch.Tensor:
    delta = x.shape[-1] - length
    return x[..., delta // 2:x.shape[-1] - (delta - delta // 2)]


# --------------------------------------------------------------------------
# BLSTM (torch's bidirectional LSTM layers + linear; optional framing)
# --------------------------------------------------------------------------

def _bilstm_layer(h: torch.Tensor, p) -> torch.Tensor:
    """One bidirectional layer in f32 on inputs and weights cast from the
    net's dtype, its output cast back."""
    return L.bilstm(h.float(), tree_map(lambda w: w.float(), p)).to(h.dtype)


def _blstm(p, x: torch.Tensor, max_steps=None, skip=False) -> torch.Tensor:
    """(B, C, T) -> (B, C, T). ``p``: {"layers": [{"fwd", "bwd"}, ...],
    "linear"}. With ``max_steps`` and T beyond it, the sequence runs as
    frames of ``max_steps`` at half that stride, each frame's overlap
    trimmed by a quarter of its width on the sides it shares."""
    b, c, t = x.shape
    framed = max_steps is not None and t > max_steps
    y_in = x
    if framed:
        width = max_steps
        stride = width // 2
        nframes = -(-t // stride)
        tgt = (nframes - 1) * stride + width
        xp = F.pad(x, (0, tgt - t))
        frames = xp.unfold(-1, width, stride)  # (B, C, nframes, width)
        x = frames.permute(0, 2, 1, 3).reshape(b * nframes, c, width)
    h = x.transpose(1, 2)  # (B', T', C)
    for lp in p["layers"]:
        h = _bilstm_layer(h, lp)
    h = L.linear(h, p["linear"])
    out = h.transpose(1, 2)
    if framed:
        frames = out.reshape(b, nframes, c, width)
        limit = stride // 2
        parts = []
        for k in range(nframes):
            if k == 0:
                parts.append(frames[:, k, :, :-limit])
            elif k == nframes - 1:
                parts.append(frames[:, k, :, limit:])
            else:
                parts.append(frames[:, k, :, limit:-limit])
        out = torch.cat(parts, dim=-1)[..., :t]
    if skip:
        out = out + y_in
    return out


# --------------------------------------------------------------------------
# LocalState decay attention (demucs/demucs.py LocalState)
# --------------------------------------------------------------------------

def _local_state(p, x: torch.Tensor, heads=4, ndecay=4) -> torch.Tensor:
    b, c, t = x.shape

    def c1(name):
        return L.conv1d(x, p[name]["weight"], p[name]["bias"])

    # positions in the net's dtype, as the JAX function has them
    idx = torch.arange(t, device=x.device).to(x.dtype)
    delta = idx[:, None] - idx[None, :]
    queries = c1("query").reshape(b, heads, -1, t)
    keys = c1("key").reshape(b, heads, -1, t)
    dots = torch.einsum("bhct,bhcs->bhts", keys, queries)
    dots = dots / (keys.shape[2] ** 0.5)
    decays = torch.arange(1, ndecay + 1, device=x.device).to(x.dtype)
    decay_q = torch.sigmoid(c1("query_decay").reshape(b, heads, -1, t)) / 2
    decay_kernel = -decays[:, None, None] * delta.abs() / (ndecay ** 0.5)
    dots = dots + torch.einsum("fts,bhfs->bhts", decay_kernel, decay_q)
    eye = torch.eye(t, dtype=torch.bool, device=x.device)
    dots = dots.masked_fill(eye, -100.0)
    weights = torch.softmax(dots, dim=2)
    content = c1("content").reshape(b, heads, -1, t)
    result = torch.einsum("bhts,bhct->bhcs", weights, content).reshape(b, -1, t)
    return x + L.conv1d(result, p["proj"]["weight"], p["proj"]["bias"])


# --------------------------------------------------------------------------
# DConv with the lstm / attn inserts
# --------------------------------------------------------------------------

def dilated_conv1d(x, p, dilation):
    """The DConv's first conv: kernel k, ``dilation``, "same" padding."""
    k = p["weight"].shape[-1]
    return F.conv1d(x, p["weight"], p["bias"], padding=dilation * (k // 2), dilation=dilation)


def _dconv(p, x: torch.Tensor) -> torch.Tensor:
    for d, blk in enumerate(p):
        y = dilated_conv1d(x, blk["conv1"], 2 ** d)
        y = L.gelu(L.group_norm(y, blk["gn1"], 1))
        if "lstm" in blk:
            y = _blstm(blk["lstm"], y, max_steps=200, skip=True)
        if "attn" in blk:
            y = _local_state(blk["attn"], y)
        y = L.conv1d(y, blk["conv2"]["weight"], blk["conv2"]["bias"])
        y = L.glu(L.group_norm(y, blk["gn2"], 1), dim=1)
        x = x + y * blk["scale"][None, :, None]
    return x


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _channel_plan(kw):
    plan = []
    cin, ch = kw["audio_channels"], kw["channels"]
    for _ in range(kw["depth"]):
        plan.append((cin, ch))
        cin, ch = ch, int(kw["growth"] * ch)
    return plan


def init(generator: torch.Generator, config):
    """Random parameters drawn on the CPU from ``generator`` (the numbers
    differ from the JAX package's init; the tree is the same)."""
    kw = kwargs_from_config(config)

    def uniform(shape, fan):
        return L.kaiming_uniform(shape, fan, generator)

    def conv(ci, co, k):
        return {"weight": uniform((co, ci, k), ci * k), "bias": torch.zeros(co)}

    def gn(c):
        return {"weight": torch.ones(c), "bias": torch.zeros(c)}

    def lstm_layer(ci, h):
        def side():
            return {"weight_ih": uniform((4 * h, ci), ci), "weight_hh": uniform((4 * h, h), h),
                    "bias_ih": torch.zeros(4 * h), "bias_hh": torch.zeros(4 * h)}
        return {"fwd": side(), "bwd": side()}

    def blstm(c, layers):
        return {"layers": [lstm_layer(c if i == 0 else 2 * c, c) for i in range(layers)],
                "linear": {"weight": uniform((c, 2 * c), 2 * c), "bias": torch.zeros(c)}}

    def dconv(c, attn, lstm):
        hidden = int(c / kw["dconv_comp"])
        blocks = []
        for _ in range(kw["dconv_depth"]):
            blk = {"conv1": conv(c, hidden, 3), "gn1": gn(hidden),
                   "conv2": conv(hidden, 2 * c, 1), "gn2": gn(2 * c),
                   "scale": torch.full((c,), kw["dconv_init"])}
            if lstm:
                blk["lstm"] = blstm(hidden, 2)
            if attn:
                blk["attn"] = {"content": conv(hidden, hidden, 1),
                               "query": conv(hidden, hidden, 1),
                               "key": conv(hidden, hidden, 1),
                               "query_decay": conv(hidden, 4 * 4, 1),
                               "proj": conv(hidden, hidden, 1)}
            blocks.append(blk)
        return blocks

    n_src = len(kw["sources"])
    encoder, decoder = [], []
    for index, (cin, ch) in enumerate(_channel_plan(kw)):
        normed = index >= kw["norm_starts"]
        attn, lstm = index >= kw["dconv_attn"], index >= kw["dconv_lstm"]
        e = {"conv": conv(cin, ch, kw["kernel_size"])}
        if normed:
            e["norm"] = gn(ch)
        if kw["dconv_mode"] & 1:
            e["dconv"] = dconv(ch, attn, lstm)
        if kw["rewrite"]:
            e["rewrite"] = conv(ch, 2 * ch, 1)
            if normed:
                e["rewrite_norm"] = gn(2 * ch)
        encoder.append(e)

        cout = cin if index > 0 else n_src * kw["audio_channels"]
        d = {}
        if kw["rewrite"]:
            d["rewrite"] = conv(ch, 2 * ch, 2 * kw["context"] + 1)
            if normed:
                d["rewrite_norm"] = gn(2 * ch)
        if kw["dconv_mode"] & 2:
            d["dconv"] = dconv(ch, attn, lstm)
        d["tconv"] = {"weight": uniform((ch, cout, kw["kernel_size"]), ch * kw["kernel_size"]),
                      "bias": torch.zeros(cout)}
        if index > 0 and normed:
            d["norm"] = gn(cout)
        decoder.insert(0, d)

    params = {"encoder": encoder, "decoder": decoder}
    if kw["lstm_layers"]:
        params["lstm"] = blstm(_channel_plan(kw)[-1][1], kw["lstm_layers"])
    return params


def prepare(params, config, compute_dtype=None):
    """Weight preparation, done once per session and dtype: every leaf cast
    to ``compute_dtype``. :func:`apply` accepts the result in place of the
    raw tree."""
    if compute_dtype is None:
        return params
    return tree_map(lambda p: p.to(compute_dtype), params)


# --------------------------------------------------------------------------
# apply
# --------------------------------------------------------------------------

def apply(params, config, mix: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """(B, C, T) -> (B, S, C, T); the demucs package's Demucs.forward."""
    kw = kwargs_from_config(config)
    with net_precision(compute_dtype) as dtype:
        x = mix.float()
        length = x.shape[-1]

        if kw["normalize"]:
            mono = x.mean(dim=1, keepdim=True)
            std, mean = torch.std_mean(mono, dim=-1, keepdim=True, correction=1)
            x = (x - mean) / (1e-5 + std)

        delta = valid_length(length, kw) - length
        x = F.pad(x, (delta // 2, delta - delta // 2))
        if kw["resample"]:
            x = _resample(x, 1, 2)

        x = x.to(dtype)
        params = prepare(params, config, compute_dtype)

        saved = []
        for e in params["encoder"]:
            x = L.conv1d(x, e["conv"]["weight"], e["conv"]["bias"], stride=kw["stride"])
            if "norm" in e:
                x = L.group_norm(x, e["norm"], kw["norm_groups"])
            x = L.gelu(x)
            if "dconv" in e:
                x = _dconv(e["dconv"], x)
            if "rewrite" in e:
                x = L.conv1d(x, e["rewrite"]["weight"], e["rewrite"]["bias"])
                if "rewrite_norm" in e:
                    x = L.group_norm(x, e["rewrite_norm"], kw["norm_groups"])
                x = L.glu(x, dim=1)
            saved.append(x)

        if "lstm" in params:
            x = _blstm(params["lstm"], x)

        for i, d in enumerate(params["decoder"]):
            x = x + center_trim(saved.pop(-1), x.shape[-1])
            if "rewrite" in d:
                k = d["rewrite"]["weight"].shape[-1]
                x = L.conv1d(x, d["rewrite"]["weight"], d["rewrite"]["bias"], padding=k // 2)
                if "rewrite_norm" in d:
                    x = L.group_norm(x, d["rewrite_norm"], kw["norm_groups"])
                x = L.glu(x, dim=1)
            if "dconv" in d:
                x = _dconv(d["dconv"], x)
            x = F.conv_transpose1d(x, d["tconv"]["weight"], d["tconv"]["bias"], stride=kw["stride"])
            if "norm" in d:
                x = L.group_norm(x, d["norm"], kw["norm_groups"])
            if i < len(params["decoder"]) - 1:
                x = L.gelu(x)

        if kw["resample"]:
            x = _resample(x, 2, 1)
        x = x.float()
        if kw["normalize"]:
            x = x * std + mean
        x = center_trim(x, length)
        return x.reshape(x.shape[0], len(kw["sources"]), kw["audio_channels"], length)


# --------------------------------------------------------------------------
# torch checkpoint conversion
# --------------------------------------------------------------------------

def lstm_params(take, pfx, layers):
    """nn.LSTM(bidirectional) + Linear keys under ``pfx`` -> the BLSTM tree."""
    out = {"layers": []}
    for li in range(layers):
        def side(suffix):
            return {k: take(f"{pfx}.lstm.{k}_l{li}{suffix}")
                    for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}
        out["layers"].append({"fwd": side(""), "bwd": side("_reverse")})
    out["linear"] = {"weight": take(pfx + ".linear.weight"), "bias": take(pfx + ".linear.bias")}
    return out


def convert_torch(state_dict, config):
    """Map a demucs-package Demucs state dict onto the parameter tree.

    Sequential index scheme (demucs/demucs.py): encoder.{i} = [conv, norm,
    act, DConv?, rewrite, norm, GLU]; decoder.{i} = [rewrite, norm, GLU,
    DConv?, ConvTranspose1d, norm, act]; DConv layers = [conv, GN, act,
    BLSTM?, LocalState?, conv1x1, GN, GLU, LayerScale] (Identity norms
    below norm_starts hold their index but carry no keys). Raises
    ``ValueError`` on a key it does not consume."""
    kw = kwargs_from_config(config)
    sd = {k: torch.as_tensor(v) for k, v in state_dict.items()}
    used = set()

    def take(key):
        used.add(key)
        return sd[key].float()

    def conv(pfx):
        return {"weight": take(pfx + ".weight"), "bias": take(pfx + ".bias")}

    def dconv(pfx, attn, lstm):
        blocks = []
        for d in range(kw["dconv_depth"]):
            p = f"{pfx}.layers.{d}"
            j = 3
            blk = {"conv1": conv(p + ".0"), "gn1": conv(p + ".1")}
            if lstm:
                blk["lstm"] = lstm_params(take, f"{p}.{j}", 2)
                j += 1
            if attn:
                blk["attn"] = {name: conv(f"{p}.{j}.{name}") for name in
                               ("content", "query", "key", "query_decay", "proj")}
                j += 1
            blk["conv2"] = conv(f"{p}.{j}")
            blk["gn2"] = conv(f"{p}.{j + 1}")
            blk["scale"] = take(f"{p}.{j + 3}.scale")
            blocks.append(blk)
        return blocks

    encoder, decoder = [], []
    for index in range(kw["depth"]):
        normed = index >= kw["norm_starts"]
        attn, lstm = index >= kw["dconv_attn"], index >= kw["dconv_lstm"]

        e = {"conv": conv(f"encoder.{index}.0")}
        if normed:
            e["norm"] = conv(f"encoder.{index}.1")
        j = 3
        if kw["dconv_mode"] & 1:
            e["dconv"] = dconv(f"encoder.{index}.{j}", attn, lstm)
            j += 1
        if kw["rewrite"]:
            e["rewrite"] = conv(f"encoder.{index}.{j}")
            if normed:
                e["rewrite_norm"] = conv(f"encoder.{index}.{j + 1}")
        encoder.append(e)

        # decoder.{di}, di = depth-1-index (the reference builds it with insert(0))
        di = kw["depth"] - 1 - index
        d = {}
        j = 0
        if kw["rewrite"]:
            d["rewrite"] = conv(f"decoder.{di}.0")
            if normed:
                d["rewrite_norm"] = conv(f"decoder.{di}.1")
            j = 3
        if kw["dconv_mode"] & 2:
            d["dconv"] = dconv(f"decoder.{di}.{j}", attn, lstm)
            j += 1
        d["tconv"] = conv(f"decoder.{di}.{j}")
        if index > 0 and normed:
            d["norm"] = conv(f"decoder.{di}.{j + 1}")
        decoder.insert(0, d)

    params = {"encoder": encoder, "decoder": decoder}
    if kw["lstm_layers"]:
        params["lstm"] = lstm_params(take, "lstm", kw["lstm_layers"])

    unused = set(sd) - used
    if unused:
        raise ValueError(
            f"unconsumed demucs checkpoint keys: {sorted(unused)[:10]} "
            f"(+{max(0, len(unused) - 10)} more): the layout differs from the "
            "demucs package's Demucs; refusing to load partially.")
    return params
