"""SCNet, the sparse-compression network (counterpart of
sesa_tpu/models/scnet.py), with its ``tran`` and ``masked`` variants.

Normalised STFT -> three sparse-downsample (SD) blocks, each splitting the
spectrum into low/mid/high bands with their own strides and GLU conv
modules -> a dual-path separation net alternating frequency and time
BiLSTMs (``tran``: RoPE transformers, kernels K1 and K2 on bf16 CUDA
tensors), with an rFFT along frames after every even layer and its inverse
after every odd one -> sparse-upsample decoder blocks with GLU fusion of the
encoder skips -> complex-as-channels iSTFT. ``masked`` adds a learned
frequency embedding on the input and predicts a complex mask of the
mixture instead of the spectrum.

``compute_dtype=torch.bfloat16`` runs the encoder, separation net and
decoder in bf16; the STFT, the frame rFFTs (cuFFT takes no bf16; the JAX
functions promote to their f32 tables there too), the mask head and the
iSTFT stay f32. The BiLSTMs run in f32 on inputs and weights cast from
bf16: cuDNN's bf16 LSTM was slower on the time legs' long sequences on an
H100 (PERF.md).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from sesa_tpu_torch.models import layers as L
from sesa_tpu_torch.models import roformer_core as core
from sesa_tpu_torch.models.bs_roformer import _make_take
from sesa_tpu_torch.ops.fft import irdft_ortho, rdft_ortho
from sesa_tpu_torch.ops.prec import net_precision
from sesa_tpu_torch.ops.rope import default_freqs, rope_tables
from sesa_tpu_torch.ops.stft import hann_window, istft_ri, stft_ri
from sesa_tpu_torch.tree import tree_map


def _model_kwargs(config, variant="lstm"):
    kw = dict(
        sources=["drums", "bass", "other", "vocals"],
        audio_channels=2,
        dims=[4, 32, 64, 128],
        nfft=4096,
        hop_size=1024,
        win_size=4096,
        normalized=True,
        band_SR=[0.175, 0.392, 0.433],
        band_stride=[1, 4, 16],
        band_kernel=[3, 4, 16],
        conv_depths=[3, 2, 1],
        compress=4,
        conv_kernel=3,
        num_dplayer=6,
        expand=1,
    )
    if variant == "tran":
        kw.update(tran_rotary_embedding_dim=64, tran_depth=1, tran_heads=8,
                  tran_dim_head=64, tran_attn_dropout=0.0, tran_ff_dropout=0.0,
                  tran_flash_attn=False)
    kw.update({k: v for k, v in dict(config.model).items() if k in kw})
    kw["sources"] = list(kw["sources"])
    kw["dims"] = list(kw["dims"])
    return kw


def _window(kw, variant, device):
    """scnet and scnet_tran pass no window to torch.stft (a boxcar);
    scnet_masked a periodic Hann of length nfft."""
    if variant == "masked":
        return hann_window(kw["nfft"], device=device)
    return torch.ones(kw["win_size"], device=device)


def _band_splits(fr: int, band_sr) -> list:
    lo = math.ceil(fr * band_sr[0])
    mid = math.ceil(fr * (band_sr[0] + band_sr[1]))
    return [(0, lo), (lo, mid), (mid, fr)]


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init(generator: torch.Generator, config, variant="lstm"):
    """Random parameters drawn on the CPU from ``generator`` (the numbers
    differ from the JAX package's init)."""
    kw = _model_kwargs(config, variant)
    dims = kw["dims"]

    def uniform(shape, fan):
        return L.kaiming_uniform(shape, fan, generator)

    def conv_w(ci, co, kh, kw_):
        fan = ci * kh * kw_
        return {"weight": uniform((co, ci, kh, kw_), fan), "bias": uniform((co,), fan)}

    def conv1d_w(ci, co, k, groups=1):
        fan = (ci // groups) * k
        return {"weight": uniform((co, ci // groups, k), fan), "bias": uniform((co,), fan)}

    def norm_w(c):
        return {"weight": torch.ones(c), "bias": torch.zeros(c)}

    def lin_w(ci, co):
        return {"weight": uniform((co, ci), ci), "bias": uniform((co,), ci)}

    def lstm_dir(d, h):
        return {"weight_ih": uniform((4 * h, d), h), "weight_hh": uniform((4 * h, h), h),
                "bias_ih": uniform((4 * h,), h), "bias_hh": uniform((4 * h,), h)}

    def conv_module(c, depth):
        hidden = int(c / kw["compress"])
        k = kw["conv_kernel"]
        return [{"norm1": norm_w(c), "conv_in": conv1d_w(c, hidden * 2, k),
                 "conv_dw": conv1d_w(hidden, hidden, k, groups=hidden),
                 "norm2": norm_w(hidden), "conv_pw": conv1d_w(hidden, c, 1)}
                for _ in range(depth)]

    encoder = []
    for i in range(len(dims) - 1):
        ci, co = dims[i], dims[i + 1]
        encoder.append({
            "sd_convs": [conv_w(ci, co, k, 1) for k in kw["band_kernel"]],
            "conv_modules": [conv_module(co, d) for d in kw["conv_depths"]],
            "global_conv": conv_w(co, co, kw["conv_kernel"], kw["conv_kernel"]),
        })

    decoder = []
    for i in reversed(range(len(dims) - 1)):
        co = dims[i] if i != 0 else dims[0] * len(kw["sources"])
        decoder.append({
            "fusion_conv": conv_w(dims[i + 1] * 2, dims[i + 1] * 2, 3, 3),
            # ConvTranspose2d weights: IOHW
            "su_convs": [{"weight": uniform((dims[i + 1], co, k, 1), dims[i + 1] * k),
                          "bias": uniform((co,), dims[i + 1] * k)}
                         for k in kw["band_kernel"]],
        })

    separation = []
    c = dims[-1]
    for i in range(kw["num_dplayer"]):
        d = c * (2 if i % 2 == 1 else 1)
        h = d * kw["expand"]
        if variant == "tran":
            separation.append({
                "freq_norm": norm_w(d),
                "time_norm": norm_w(d),
                "freq_tran": core.transformer_init(generator, d, kw["tran_depth"],
                                                   kw["tran_heads"], kw["tran_dim_head"],
                                                   norm_output=True),
                "time_tran": core.transformer_init(generator, d, kw["tran_depth"],
                                                   kw["tran_heads"], kw["tran_dim_head"],
                                                   norm_output=True),
            })
        else:
            separation.append({
                name: {"norm": norm_w(d), "lstm": {"fwd": lstm_dir(d, h), "bwd": lstm_dir(d, h)},
                       "linear": lin_w(2 * h, d)}
                for name in ("freq", "time")})

    params = {"encoder": encoder, "separation": separation, "decoder": decoder}
    if variant == "tran":
        rot = kw["tran_rotary_embedding_dim"]
        params["rope_time_freqs"] = torch.from_numpy(default_freqs(rot))
        params["rope_freq_freqs"] = torch.from_numpy(default_freqs(rot))
        # declared but unused in the reference forward (scnet_tran.py:586)
        params["first_conv"] = conv_w(dims[0], dims[0], 1, 1)["weight"]
    if variant == "masked":
        n_mask = dims[0] * len(kw["sources"])
        params["pos_embed_f"] = 0.02 * torch.nn.init.trunc_normal_(
            torch.empty((1, dims[0], kw["nfft"] // 2 + 1, 1)), a=-2.0, b=2.0,
            generator=generator)
        params["mask_conv1"] = conv_w(n_mask, 64, 3, 3)
        params["mask_conv2"] = conv_w(64, n_mask, 1, 1)
    return params


def prepare(params, config, compute_dtype=None):
    """Weight preparation, done once per session and dtype: every leaf cast
    to ``compute_dtype``. :func:`apply` accepts the result in place of the
    raw tree (its own cast is then a no-op)."""
    if compute_dtype is None:
        return params
    return tree_map(lambda p: p.to(compute_dtype), params)


# --------------------------------------------------------------------------
# apply
# --------------------------------------------------------------------------

def _apply_conv_module(blocks, x):
    """(B', C, T) conformer-style GLU residual stack."""
    for blk in blocks:
        y = L.group_norm(x, blk["norm1"], 1)
        k = blk["conv_in"]["weight"].shape[-1]
        y = L.glu(L.conv1d(y, blk["conv_in"]["weight"], blk["conv_in"]["bias"], padding=k // 2),
                  dim=1)
        k = blk["conv_dw"]["weight"].shape[-1]
        y = L.conv1d(y, blk["conv_dw"]["weight"], blk["conv_dw"]["bias"], padding=k // 2,
                     groups=y.shape[1])
        y = L.swish(L.group_norm(y, blk["norm2"], 1))
        x = x + L.conv1d(y, blk["conv_pw"]["weight"], blk["conv_pw"]["bias"])
    return x


def _apply_sd_block(params, x, kw):
    """Sparse downsample: split bands, strided conv, conv modules, global conv."""
    fr = x.shape[2]
    bands, original_lengths = [], []
    for bi, (start, end) in enumerate(_band_splits(fr, kw["band_SR"])):
        conv = params["sd_convs"][bi]
        stride, kernel = kw["band_stride"][bi], kw["band_kernel"][bi]
        ext = x[:, :, start:end, :]
        original_lengths.append(end - start)
        total_pad = kernel - stride if stride == 1 else (stride - (end - start) % stride) % stride
        ext = F.pad(ext, (0, 0, total_pad // 2, total_pad - total_pad // 2))
        out = L.conv2d(ext, conv["weight"], conv["bias"], stride=(stride, 1))
        # the band's conv modules run on (B·f, C, T)
        bb, cc, ff, tt = out.shape
        flat = out.permute(0, 2, 1, 3).reshape(bb * ff, cc, tt)
        flat = _apply_conv_module(params["conv_modules"][bi], flat)
        bands.append(L.gelu(flat.reshape(bb, ff, cc, tt).permute(0, 2, 1, 3)))

    lengths = [band.shape[2] for band in bands]
    skip = torch.cat(bands, dim=2)
    k = params["global_conv"]["weight"].shape[-1]
    out = L.conv2d(skip, params["global_conv"]["weight"], params["global_conv"]["bias"],
                   padding=((k - 1) // 2, (k - 1) // 2))
    return out, skip, lengths, original_lengths


def _bilstm(y, p):
    """The BiLSTM in f32 on inputs and weights cast from the net's dtype
    (the weights keep their bf16 rounding), its output cast back."""
    return L.bilstm(y.float(), tree_map(lambda w: w.float(), p)).to(y.dtype)


def _apply_dual_path(p, x):
    """One DualPathRNN layer on (B, C, F, T) (reference separation.py:37-83)."""
    b, c, fr, t = x.shape
    y = L.group_norm(x, p["freq"]["norm"], 1)
    y = y.permute(0, 3, 2, 1).reshape(b * t, fr, c)
    y = L.linear(_bilstm(y, p["freq"]["lstm"]), p["freq"]["linear"])
    x = y.reshape(b, t, fr, c).permute(0, 3, 2, 1) + x
    y = L.group_norm(x, p["time"]["norm"], 1)
    y = y.permute(0, 2, 3, 1).reshape(b * fr, t, c)
    y = L.linear(_bilstm(y, p["time"]["lstm"]), p["time"]["linear"])
    return y.reshape(b, fr, t, c).permute(0, 3, 1, 2) + x


def _apply_dual_path_tran(p, x, rope_time, rope_freq, heads):
    """scnet_tran's DualPathTran (reference scnet_tran.py:196-247): the
    roformer stack (K1 and K2 on bf16 CUDA tensors) over the bands of every
    frame, then over the frames of every band."""
    b, c, fr, t = x.shape
    y = L.group_norm(x, p["freq_norm"], 1)
    y = y.permute(0, 3, 2, 1).reshape(b * t, fr, c)
    y = core.transformer_apply(p["freq_tran"], y, heads, rope=rope_freq)
    x = y.reshape(b, t, fr, c).permute(0, 3, 2, 1) + x
    y = L.group_norm(x, p["time_norm"], 1)
    y = y.permute(0, 2, 3, 1).reshape(b * fr, t, c)
    y = core.transformer_apply(p["time_tran"], y, heads, rope=rope_time)
    return y.reshape(b, fr, t, c).permute(0, 3, 1, 2) + x


def _feature_conversion(x, inverse):
    """Ortho rFFT along frames with channels <-> complex (separation.py:6-34):
    (B, C, F, T) -> (B, 2C, F, T//2+1) forward, the inverse back. f32 out."""
    if inverse:
        c = x.shape[1]
        ri = torch.stack([x[:, : c // 2], x[:, c // 2:]], dim=-1)  # (B, C/2, F, K, 2)
        return irdft_ortho(ri, 2 * (x.shape[-1] - 1))
    spec = rdft_ortho(x)  # (B, C, F, K, 2)
    return torch.cat([spec[..., 0], spec[..., 1]], dim=1)


def apply(params, config, x, variant="lstm", compute_dtype=None):
    """(B, ch, T) -> (B, sources, ch, T)."""
    with net_precision(compute_dtype) as dtype:
        kw = _model_kwargs(config, variant)
        b, ch, length = x.shape
        hop = kw["hop_size"]

        padding = hop - length % hop
        if (length + padding) // hop % 2 == 0:
            padding += hop
        x = F.pad(x.float(), (0, padding))
        lpad = x.shape[-1]

        window = _window(kw, variant, x.device)
        spec = stft_ri(x.reshape(-1, lpad), kw["nfft"], hop, window, win_length=window.shape[0],
                       normalized=kw["normalized"])
        # (B·ch, F, T, 2) -> (B·ch, 2, F, T) -> (B, ch·2, F, T): channels (ch major, complex minor)
        fr, t = spec.shape[1:3]
        mixture = spec.permute(0, 3, 1, 2).reshape(b, ch * 2, fr, t)
        z = mixture.to(dtype)
        if dtype != torch.float32:
            params = tree_map(lambda p: p.to(dtype), params)

        if variant == "masked":
            z = z + params["pos_embed_f"][:, :, :fr, :]

        skips, lens, olens = [], [], []
        for blk in params["encoder"]:
            z, skip, lengths, original_lengths = _apply_sd_block(blk, z, kw)
            skips.append(skip)
            lens.append(lengths)
            olens.append(original_lengths)

        # even layers rFFT the frames (channels double), odd layers invert it
        for i, layer in enumerate(params["separation"]):
            if variant == "tran":
                # angles in f32 from the (net-dtype) frequencies, tables in the net dtype
                rt = rope_tables(params["rope_time_freqs"].float(), z.shape[-1])
                rf = rope_tables(params["rope_freq_freqs"].float(), z.shape[-2])
                rt, rf = (tuple(r.to(dtype) for r in tab) for tab in (rt, rf))
                z = _apply_dual_path_tran(layer, z, rt, rf, kw["tran_heads"])
            else:
                z = _apply_dual_path(layer, z)
            z = _feature_conversion(z, inverse=(i % 2 == 1)).to(dtype)

        for blk in params["decoder"]:
            z = z + skips.pop()
            z = torch.cat([z, z], dim=1)  # repeat(1, 2, 1, 1)
            z = L.conv2d(z, blk["fusion_conv"]["weight"], blk["fusion_conv"]["bias"],
                         padding=(1, 1))
            z = L.glu(z, dim=1)
            # sparse upsample
            lengths, original_lengths = lens.pop(), olens.pop()
            splits = [(0, lengths[0]), (lengths[0], lengths[0] + lengths[1]),
                      (lengths[0] + lengths[1], z.shape[2])]
            outs = []
            for bi, (start, end) in enumerate(splits):
                conv = blk["su_convs"][bi]
                out = L.conv_transpose2d(z[:, :, start:end, :], conv["weight"], conv["bias"],
                                         stride=(kw["band_stride"][bi], 1))
                dist = abs(original_lengths[bi] - out.shape[2]) // 2
                outs.append(out[:, :, dist: dist + original_lengths[bi], :])
            z = torch.cat(outs, dim=2)

        n, n_sources = kw["dims"][0], len(kw["sources"])
        z = z.float()  # the mask head, the mask and the iSTFT run in f32

        if variant == "masked":
            # a complex mask of the tiled mixture (reference scnet_masked.py:333-415);
            # the head's weights are the net dtype's, back in f32
            c1 = tree_map(lambda a: a.float(), params["mask_conv1"])
            c2 = tree_map(lambda a: a.float(), params["mask_conv2"])
            mask = L.gelu(L.conv2d(z, c1["weight"], c1["bias"], padding=(1, 1)))
            mask = torch.tanh(L.conv2d(mask, c2["weight"], c2["bias"]))
            mr = mixture.repeat(1, n_sources, 1, 1).reshape(-1, 2, fr, t)
            mk = mask.reshape(-1, 2, fr, t)
            z = torch.stack([mr[:, 0] * mk[:, 0] - mr[:, 1] * mk[:, 1],
                             mr[:, 0] * mk[:, 1] + mr[:, 1] * mk[:, 0]], dim=-1)
        else:
            z = z.reshape(-1, 2, fr, t).permute(0, 2, 3, 1)  # (.., F, T, 2)

        wav = istft_ri(z, kw["nfft"], hop, window, win_length=window.shape[0],
                       normalized=kw["normalized"])
        wav = wav.reshape(b, n_sources, ch, -1)
        return wav[..., : wav.shape[-1] - padding]


# --------------------------------------------------------------------------
# torch checkpoint conversion
# --------------------------------------------------------------------------

def convert_torch(state_dict, config, variant="lstm"):
    """Reference SCNet state dict -> the port's tree (key scheme of
    sesa_tpu/models/scnet.py ``convert_torch``). Every key is consumed;
    leftovers raise."""
    kw = _model_kwargs(config, variant)
    dims = kw["dims"]
    sd, used, take = _make_take(state_dict)

    def wb(prefix):
        return {"weight": take(f"{prefix}.weight"), "bias": take(f"{prefix}.bias")}

    def conv_module(prefix, depth):
        return [{"norm1": wb(f"{prefix}.layers.{d}.0"), "conv_in": wb(f"{prefix}.layers.{d}.1"),
                 "conv_dw": wb(f"{prefix}.layers.{d}.3"), "norm2": wb(f"{prefix}.layers.{d}.4"),
                 "conv_pw": wb(f"{prefix}.layers.{d}.6")} for d in range(depth)]

    encoder = [{
        "sd_convs": [wb(f"encoder.{i}.SDlayer.convs.{bi}") for bi in range(3)],
        "conv_modules": [conv_module(f"encoder.{i}.conv_modules.{bi}", kw["conv_depths"][bi])
                         for bi in range(3)],
        "global_conv": wb(f"encoder.{i}.globalconv"),
    } for i in range(len(dims) - 1)]

    def lstm_params(prefix, suffix):
        return {wn: take(f"{prefix}.{wn}_l0{suffix}")
                for wn in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}

    separation = []
    for i in range(kw["num_dplayer"]):
        p = f"separation_net.dp_modules.{i}"
        if variant == "tran":
            separation.append({
                "freq_norm": wb(f"{p}.norm_layers.0"),
                "time_norm": wb(f"{p}.norm_layers.1"),
                "freq_tran": core.convert_transformer(take, f"{p}.freq_layer", kw["tran_depth"],
                                                      norm_output=True),
                "time_tran": core.convert_transformer(take, f"{p}.time_layer", kw["tran_depth"],
                                                      norm_output=True),
            })
        else:
            separation.append({name: {
                "norm": wb(f"{p}.norm_layers.{j}"),
                "lstm": {"fwd": lstm_params(f"{p}.lstm_layers.{j}", ""),
                         "bwd": lstm_params(f"{p}.lstm_layers.{j}", "_reverse")},
                "linear": wb(f"{p}.linear_layers.{j}"),
            } for j, name in enumerate(("freq", "time"))})

    decoder = [{"fusion_conv": wb(f"decoder.{i}.0.conv"),
                "su_convs": [wb(f"decoder.{i}.1.convtrs.{bi}") for bi in range(3)]}
               for i in range(len(dims) - 1)]

    params = {"encoder": encoder, "separation": separation, "decoder": decoder}
    if variant == "tran":
        params["first_conv"] = take("first_conv.weight")
        # one RotaryEmbedding per axis is shared by every attention layer, so
        # its freqs appear once per layer under
        # ...{time,freq}_layer.layers.{j}.0.rotary_embed: read one, consume all
        for axis, pname in (("time", "rope_time_freqs"), ("freq", "rope_freq_freqs")):
            keys = sorted(k for k in sd
                          if f"{axis}_layer." in k and k.endswith("rotary_embed.freqs"))
            if keys:
                params[pname] = take(keys[0])
                used.update(keys)
            else:
                params[pname] = torch.from_numpy(default_freqs(kw["tran_rotary_embedding_dim"]))
    if variant == "masked":
        params["pos_embed_f"] = take("pos_embed_f")
        params["mask_conv1"] = wb("mask_layer.0")
        params["mask_conv2"] = wb("mask_layer.2")

    unused = set(sd) - used
    if unused:
        raise ValueError(f"unconsumed checkpoint keys: {sorted(unused)[:8]} ...")
    return params
