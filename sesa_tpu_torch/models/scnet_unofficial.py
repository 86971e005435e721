"""SCNet, the unofficial reimplementation (amanteur/SCNet-PyTorch)
(counterpart of sesa_tpu/models/scnet_unofficial.py).

Unlike the official ``scnet``: a channels-last (B, F, T, C) layout,
kernel-1 strided down- and upsampling with exact output-padding
arithmetic, conv modules with SiLU, fusion by repeat + GLU over the
channels, dual-path BiLSTM layers with no residual around the RNN, an
unnormalised rFFT along the frames after every odd layer (the channels
double) and its inverse after every even one, and a Hann-windowed STFT of
``win_length``. The Mamba path (``use_mamba``) raises, as in JAX.

The model runs in f32 only: its ``apply`` takes no ``compute_dtype``, as the
JAX function has none, so a bf16 session calls it on the f32 weights
(``runtime/session.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sesa_tpu_torch.models import layers as L
from sesa_tpu_torch.models.bs_roformer import _make_take
from sesa_tpu_torch.ops.fft import irdft, rdft
from sesa_tpu_torch.ops.prec import net_precision
from sesa_tpu_torch.ops.stft import hann_window, istft_ri, stft_ri


def _kwargs(config):
    kw = dict(n_fft=4096, dims=[4, 32, 64, 128], bandsplit_ratios=[0.175, 0.392, 0.433],
              downsample_strides=[1, 4, 16], n_conv_modules=[3, 2, 1],
              n_rnn_layers=6, rnn_hidden_dim=128, n_sources=4, hop_length=1024,
              win_length=4096, stft_normalized=False, use_mamba=False)
    kw.update({k: v for k, v in dict(config.model).items() if k in kw})
    if kw["use_mamba"]:
        # the reference's own use_mamba path cannot run: it passes d_expand=
        # to mamba_ssm's Mamba, whose keyword is expand
        # (reference scnet_unofficial/modules/dualpath_rnn.py:183-184)
        raise NotImplementedError(
            "scnet_unofficial use_mamba is not supported: the reference's "
            "Mamba-v1 path is itself broken (dualpath_rnn.py:183-184 passes "
            "d_expand= to mamba_ssm.Mamba, which takes expand=) and no "
            "public checkpoint was trained with it")
    kw["dims"] = list(kw["dims"])
    return kw


def _intervals(splits):
    out, start = [], 0
    for s in splits:
        out.append((start, start + s))
        start += s
    return out


def _sd_shapes(kw):
    """compute_sd_layer_shapes (reference utils.py:86-119): each block's
    band widths before the downsampling and its bands' intervals after."""
    input_shape = kw["n_fft"] // 2 + 1
    subband_shapes, sd_intervals = [], []
    for _ in range(len(kw["dims"]) - 1):
        band_shapes = [int(r * input_shape) - int(lo * input_shape)
                       for lo, r in _intervals(kw["bandsplit_ratios"])]
        conv_shapes = [(bs - 1) // ds + 1
                       for bs, ds in zip(band_shapes, kw["downsample_strides"])]
        input_shape = sum(conv_shapes)
        subband_shapes.append(band_shapes)
        sd_intervals.append(_intervals(conv_shapes))
    return subband_shapes, sd_intervals


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init(generator: torch.Generator, config):
    """Random parameters drawn on the CPU from ``generator`` (the numbers
    differ from the JAX package's init)."""
    kw = _kwargs(config)
    dims = kw["dims"]
    n_blocks = len(dims) - 1

    def uniform(shape, fan):
        return L.kaiming_uniform(shape, fan, generator)

    def conv2d_w(ci, co, kh=1, kw_=1):
        fan = ci * kh * kw_
        return {"weight": uniform((co, ci, kh, kw_), fan), "bias": uniform((co,), fan)}

    def conv1d_w(ci, co, k, groups=1):
        return {"weight": uniform((co, ci // groups, k), (ci // groups) * k)}

    def norm_w(c):
        return {"weight": torch.ones(c), "bias": torch.zeros(c)}

    def conv_module(dim):
        hidden = dim // 4
        return {"norm": norm_w(dim), "conv_in": conv1d_w(dim, 2 * hidden, 3),
                "conv_dw": conv1d_w(hidden, hidden, 3, groups=hidden),
                "norm2": norm_w(hidden), "conv_out": conv1d_w(hidden, dim, 1)}

    sd_blocks = [{
        "layers": [{"down": conv2d_w(dims[i], dims[i + 1]),
                    "convs": [conv_module(dims[i + 1]) for _ in range(kw["n_conv_modules"][bi])]}
                   for bi in range(3)],
        "global_conv": conv2d_w(dims[i + 1], dims[i + 1]),
    } for i in range(n_blocks)]

    def lstm_dir(d, h):
        return {"weight_ih": uniform((4 * h, d), h), "weight_hh": uniform((4 * h, h), h),
                "bias_ih": uniform((4 * h,), h), "bias_hh": uniform((4 * h,), h)}

    def rnn_module(d, h):
        return {"norm": norm_w(d), "lstm": {"fwd": lstm_dir(d, h), "bwd": lstm_dir(d, h)},
                "fc": {"weight": uniform((d, 2 * h), 2 * h), "bias": uniform((d,), 2 * h)}}

    d, h = dims[-1], kw["rnn_hidden_dim"]
    dualpath = []
    for i in range(1, kw["n_rnn_layers"] + 1):
        dd, hh = (d, h) if i % 2 == 1 else (2 * d, 2 * h)
        dualpath.append({"time": rnn_module(dd, hh), "freq": rnn_module(dd, hh)})

    su_blocks = []
    for i in reversed(range(n_blocks)):
        out_dim = dims[i] if i != 0 else dims[i] * kw["n_sources"]
        su_blocks.append({
            "fusion": conv2d_w(dims[i + 1] * 2, dims[i + 1] * 2, 3, 1),
            # ConvTranspose2d weights: IOHW
            "ups": [{"weight": uniform((dims[i + 1], out_dim, 1, 1), dims[i + 1]),
                     "bias": uniform((out_dim,), dims[i + 1])} for _ in range(3)],
        })
    return {"sd_blocks": sd_blocks, "dualpath": dualpath, "su_blocks": su_blocks}


# --------------------------------------------------------------------------
# apply
# --------------------------------------------------------------------------

def _conv_module_apply(p, x):
    """(B', T, D) residual conv module (sd_encoder.py:56-135)."""
    y = x.transpose(1, 2)  # (B', D, T)
    z = L.group_norm(y, p["norm"], 1)
    z = L.glu(L.conv1d(z, p["conv_in"]["weight"], p["conv_in"].get("bias"), padding=1), dim=1)
    z = L.conv1d(z, p["conv_dw"]["weight"], p["conv_dw"].get("bias"), padding=1,
                 groups=z.shape[1])
    z = L.swish(L.group_norm(z, p["norm2"], 1))
    z = L.conv1d(z, p["conv_out"]["weight"], p["conv_out"].get("bias"))
    return (y + z).transpose(1, 2)


def _sd_block_apply(p, x, kw):
    """(B, F, T, C) -> (out, skip) (sd_encoder.py:216-285)."""
    f = x.shape[1]
    outs = []
    for bi, (lo, hi) in enumerate(_intervals(kw["bandsplit_ratios"])):
        lp = p["layers"][bi]
        xb = x[:, int(lo * f): int(hi * f)].permute(0, 3, 1, 2)  # (B, C, F', T)
        xb = L.conv2d(xb, lp["down"]["weight"], lp["down"]["bias"],
                      stride=(kw["downsample_strides"][bi], 1))
        xb = L.gelu(xb).permute(0, 2, 3, 1)  # (B, F'', T, C')
        b, ff, t, c = xb.shape
        flat = xb.reshape(b * ff, t, c)
        for cm in lp["convs"]:
            flat = _conv_module_apply(cm, flat)
        outs.append(flat.reshape(b, ff, t, c))
    skip = torch.cat(outs, dim=1)
    y = L.conv2d(skip.permute(0, 3, 1, 2), p["global_conv"]["weight"], p["global_conv"]["bias"])
    return y.permute(0, 2, 3, 1), skip


def _rnn_module_apply(p, x):
    """(B', T, D): GroupNorm -> BiLSTM -> fc, no residual (dualpath_rnn.py:62-80)."""
    y = L.group_norm(x.transpose(1, 2), p["norm"], 1).transpose(1, 2)
    return L.linear(L.bilstm(y.contiguous(), p["lstm"]), p["fc"])


def _dualpath_apply(layers, x):
    """(B, F, T, D), with the rFFT along frames after odd layers and its
    inverse after even ones (dualpath_rnn.py:203-228)."""
    time_dim = x.shape[2]
    for i, p in enumerate(layers, start=1):
        b, f, t, d = x.shape
        y = _rnn_module_apply(p["time"], x.reshape(b * f, t, d))
        x = y.reshape(b, f, t, d).transpose(1, 2)
        y = _rnn_module_apply(p["freq"], x.reshape(b * t, f, d))
        x = y.reshape(b, t, f, d).transpose(1, 2)
        if i % 2 == 1:
            # (B, F, T, D) -> (B, F, K, D, 2) -> (B, F, K, 2D), torch's default norm
            spec = rdft(x.transpose(2, 3)).permute(0, 1, 3, 2, 4)
            x = spec.reshape(b, f, -1, 2 * d)
        else:
            ri = x.reshape(b, f, t, d // 2, 2).permute(0, 1, 3, 2, 4)  # (B, F, D, K, 2)
            x = irdft(ri, time_dim).transpose(2, 3)  # (B, F, T, D)
    return x


def apply(params, config, x):
    """(B, C, T) -> (B, n_sources, C, T), in f32."""
    with net_precision(None):
        kw = _kwargs(config)
        b, ch, length = x.shape
        hop = kw["hop_length"]

        xp = F.pad(x.float(), (0, hop - length % hop))
        window = hann_window(kw["win_length"], device=x.device)
        spec = stft_ri(xp.reshape(b * ch, -1), kw["n_fft"], hop, window,
                       win_length=kw["win_length"], normalized=kw["stft_normalized"])
        f, t = spec.shape[1:3]
        # 'b c f t r -> b f t (c r)', c major
        z = spec.reshape(b, ch, f, t, 2).permute(0, 2, 3, 1, 4).reshape(b, f, t, ch * 2)

        skips = []
        for blk in params["sd_blocks"]:
            z, skip = _sd_block_apply(blk, z, kw)
            skips.append(skip)

        z = _dualpath_apply(params["dualpath"], z)

        subband_shapes, sd_intervals = _sd_shapes(kw)
        n_blocks = len(kw["dims"]) - 1
        for i, blk in enumerate(params["su_blocks"]):
            level = n_blocks - 1 - i
            # fusion: (x + skip) repeated on the channels, conv (3, 1), GLU
            y = z + skips[level]
            y = torch.cat([y, y], dim=-1).permute(0, 3, 1, 2)
            y = L.conv2d(y, blk["fusion"]["weight"], blk["fusion"]["bias"], padding=(1, 0))
            y = L.glu(y.permute(0, 2, 3, 1), dim=-1)
            outs = []
            for bi in range(3):
                lo, hi = sd_intervals[level][bi]
                target = subband_shapes[level][bi]
                up = L.conv_transpose2d(y[:, lo:hi].permute(0, 3, 1, 2), blk["ups"][bi]["weight"],
                                        stride=(kw["downsample_strides"][bi], 1))
                # ConvTranspose2d's output padding extends the output before the
                # bias is added: the extra rows carry the bias, not zeros
                if up.shape[2] < target:
                    up = F.pad(up, (0, 0, 0, target - up.shape[2]))
                up = up + blk["ups"][bi]["bias"][None, :, None, None]
                outs.append(up[:, :, :target].permute(0, 2, 3, 1))
            z = torch.cat(outs, dim=1)

        # 'b f t (c r n)' -> (b n c f t r)
        n_src = kw["n_sources"]
        z = z.reshape(b, f, t, ch, 2, n_src).permute(0, 5, 3, 1, 2, 4)
        wav = istft_ri(z.reshape(b * n_src * ch, f, t, 2), kw["n_fft"], hop, window,
                       win_length=kw["win_length"], normalized=kw["stft_normalized"])
        return wav.reshape(b, n_src, ch, -1)[..., :length]


# --------------------------------------------------------------------------
# torch checkpoint conversion
# --------------------------------------------------------------------------

def convert_torch(state_dict, config):
    """Reference scnet_unofficial state dict -> the port's tree (key scheme
    of sesa_tpu/models/scnet_unofficial.py ``convert_torch``). Every key is
    consumed; leftovers raise."""
    kw = _kwargs(config)
    n_blocks = len(kw["dims"]) - 1
    sd, used, take = _make_take(state_dict)

    def maybe_wb(prefix):
        p = {"weight": take(f"{prefix}.weight")}
        if f"{prefix}.bias" in sd:
            p["bias"] = take(f"{prefix}.bias")
        return p

    def conv_module(prefix):
        return {"norm": maybe_wb(f"{prefix}.sequential.0"),
                "conv_in": maybe_wb(f"{prefix}.sequential.1"),
                "conv_dw": maybe_wb(f"{prefix}.sequential.3"),
                "norm2": maybe_wb(f"{prefix}.sequential.4"),
                "conv_out": maybe_wb(f"{prefix}.sequential.6")}

    sd_blocks = [{
        "layers": [{"down": maybe_wb(f"sd_blocks.{i}.sd_layers.{bi}.downsample.conv"),
                    "convs": [conv_module(f"sd_blocks.{i}.sd_layers.{bi}.conv_modules.{ci}")
                              for ci in range(kw["n_conv_modules"][bi])]}
                   for bi in range(3)],
        "global_conv": maybe_wb(f"sd_blocks.{i}.global_conv2d"),
    } for i in range(n_blocks)]

    def rnn_module(prefix):
        return {"norm": maybe_wb(f"{prefix}.groupnorm"),
                "lstm": {d: {wn: take(f"{prefix}.rnn.{wn}_l0{suf}")
                             for wn in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}
                         for d, suf in (("fwd", ""), ("bwd", "_reverse"))},
                "fc": maybe_wb(f"{prefix}.fc")}

    dualpath = [{"time": rnn_module(f"dualpath_blocks.layers.{i}.0"),
                 "freq": rnn_module(f"dualpath_blocks.layers.{i}.1")}
                for i in range(kw["n_rnn_layers"])]
    su_blocks = [{"fusion": maybe_wb(f"su_blocks.{i}.fusion_layer.conv"),
                  "ups": [maybe_wb(f"su_blocks.{i}.su_layers.{bi}.upsample.conv")
                          for bi in range(3)]}
                 for i in range(n_blocks)]

    params = {"sd_blocks": sd_blocks, "dualpath": dualpath, "su_blocks": su_blocks}
    unused = set(sd) - used
    if unused:
        raise ValueError(f"unconsumed checkpoint keys: {sorted(unused)[:8]} ...")
    return params
