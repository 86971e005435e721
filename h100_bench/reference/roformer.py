"""BS-RoFormer and Mel-Band RoFormer forward passes, plain PyTorch in f32.

The forward passes of lucidrains' ``BSRoformer`` and ``MelBandRoformer`` as
ZFTurbo's Music-Source-Separation-Training runs them (``models/bs_roformer``,
``models/mel_band_roformer``), written as functions of the published
checkpoint's state dict: the module names are the checkpoint's keys. A
frozen, trimmed copy of the repository's test oracle, with its own band
layouts. Departures from the published code, neither of which changes the
mathematics:

- attention is written out (scores, softmax, weighted sum) instead of
  ``F.scaled_dot_product_attention``, so no fused kernel of lower precision
  can be picked for it;
- the imaginary parts of the DC and Nyquist bins are zeroed before the
  inverse STFT: a real signal's spectrum has none, pocketfft's inverse
  ignores them, cuFFT's does not.

Every matrix product goes through a ``products`` object: :class:`F32`, the
reference, run under :func:`strict_f32` (TF32 off for matmuls and cuDNN),
or :class:`FP8`, the control: the same forward with every product's
operands rounded to fp8 (e4m3), the precision below the configuration's
bf16. Enter ``products.context()`` around a forward.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from h100_bench.reference.mel import mel_bands


@contextlib.contextmanager
def strict_f32():
    """float32 products with TF32 off, restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


class F32:
    """Products in f32, TF32 off."""

    def context(self):
        return strict_f32()

    def linear(self, x, w, b=None):
        return F.linear(x, w, b)

    def matmul(self, a, b):
        return a @ b


class FP8(F32):
    """The control: each product's operands rounded to fp8 e4m3, one scale a
    tensor (its largest magnitude to 448, as fp8 inference scales), the
    rounded values multiplied exactly and summed in f32, then scaled back.
    fp8 values have 3 mantissa bits, so TF32's 10 multiply them exactly:
    TF32 is on for speed and changes nothing."""

    def context(self):
        return _tf32_on()

    @staticmethod
    def round(x):
        scale = x.abs().amax().clamp_min(1e-30) / 448.0
        return (x / scale).to(torch.float8_e4m3fn).to(torch.float32), scale

    def linear(self, x, w, b=None):
        (xq, sx), (wq, sw) = self.round(x), self.round(w)
        y = F.linear(xq, wq) * (sx * sw)
        return y if b is None else y + b

    def matmul(self, a, b):
        (aq, sa), (bq, sb) = self.round(a), self.round(b)
        return (aq @ bq) * (sa * sb)


@contextlib.contextmanager
def _tf32_on():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def rms_norm(x, gamma):
    """lucidrains RMSNorm: l2-normalised, times sqrt(dim) and gamma."""
    return F.normalize(x, dim=-1) * (x.shape[-1] ** 0.5) * gamma


def rotate(x, freqs):
    """rotary_embedding_torch on (..., n, d), interleaved pairs, positions 0..n-1."""
    n = x.shape[-2]
    ang = torch.outer(torch.arange(n, dtype=torch.float32, device=x.device), freqs)
    ang = ang.repeat_interleave(2, dim=-1)
    pairs = x.reshape(*x.shape[:-1], -1, 2)
    rot = torch.stack([-pairs[..., 1], pairs[..., 0]], -1).reshape(x.shape)
    return x * ang.cos() + rot * ang.sin()


def attention(mm, sd, p, x, heads, freqs, rows_per_block=256):
    """Gated multi-head attention of one Attention module; x (b, n, d)."""
    xn = rms_norm(x, sd[f"{p}.norm.gamma"])
    qkv = mm.linear(xn, sd[f"{p}.to_qkv.weight"])
    b, n, _ = qkv.shape
    q, k, v = qkv.reshape(b, n, 3, heads, -1).permute(2, 0, 3, 1, 4)
    q, k = rotate(q, freqs), rotate(k, freqs)
    scale = q.shape[-1] ** -0.5
    out = torch.empty_like(q)
    for s in range(0, b, rows_per_block):
        rows = slice(s, s + rows_per_block)
        scores = mm.matmul(q[rows], k[rows].transpose(-1, -2)) * scale
        out[rows] = mm.matmul(scores.softmax(dim=-1), v[rows])
    gates = mm.linear(xn, sd[f"{p}.to_gates.weight"], sd[f"{p}.to_gates.bias"])
    out = out * gates.transpose(1, 2).unsqueeze(-1).sigmoid()
    out = out.transpose(1, 2).reshape(b, n, -1)
    return mm.linear(out, sd[f"{p}.to_out.0.weight"])


def feed_forward(mm, sd, p, x):
    h = F.gelu(mm.linear(rms_norm(x, sd[f"{p}.net.0.gamma"]), sd[f"{p}.net.1.weight"],
                         sd[f"{p}.net.1.bias"]))
    return mm.linear(h, sd[f"{p}.net.4.weight"], sd[f"{p}.net.4.bias"])


def transformer(mm, sd, prefix, x, depth, heads, freqs, norm_output):
    for i in range(depth):
        x = attention(mm, sd, f"{prefix}.layers.{i}.0", x, heads, freqs) + x
        x = feed_forward(mm, sd, f"{prefix}.layers.{i}.1", x) + x
    if norm_output:
        x = rms_norm(x, sd[f"{prefix}.norm.gamma"])
    return x


def band_layout(model_type: str, model: dict):
    """(row index of each band feature row into the (f s) axis, features per
    band, bands per (f s) row or None for a partition)."""
    ch = 2 if model.get("stereo", False) else 1
    n_fft = model.get("stft_n_fft", 2048)
    if model_type == "mel_band_roformer":
        freqs, per_freq = mel_bands(model.get("sample_rate", 44100), n_fft,
                                    model.get("num_bands", 60))
        rows = np.concatenate([(f[:, None] * ch + np.arange(ch)).reshape(-1) for f in freqs])
        return rows, [2 * ch * len(f) for f in freqs], np.repeat(per_freq, ch)
    freqs_per_bands = model["freqs_per_bands"]
    if sum(freqs_per_bands) != n_fft // 2 + 1:
        raise ValueError("freqs_per_bands must cover every frequency bin")
    return np.arange((n_fft // 2 + 1) * ch), [2 * ch * f for f in freqs_per_bands], None


def rope_freqs(sd, prefix):
    """The rotary frequencies of the first attention layer of a transformer
    (one RotaryEmbedding module per axis, registered under every layer)."""
    return sd[f"{prefix}.layers.0.0.rotary_embed.freqs"]


@torch.no_grad()
def forward(sd, model_type: str, model: dict, x: torch.Tensor, products=None) -> torch.Tensor:
    """x (B, ch, T) f32 -> stems (B, S, ch, T); ``products``: :class:`F32`
    unless given."""
    mm = F32() if products is None else products
    mel = model_type == "mel_band_roformer"
    n_fft = model.get("stft_n_fft", 2048)
    hop = model.get("stft_hop_length", 512)
    win = model.get("stft_win_length", n_fft)
    heads, depth = model.get("heads", 8), model["depth"]
    t_depth = model.get("time_transformer_depth", 2)
    f_depth = model.get("freq_transformer_depth", 2)
    stems = model.get("num_stems", 1)
    mask_depth = model.get("mask_estimator_depth", 1 if mel else 2)
    if model.get("linear_transformer_depth", 0) or model.get("skip_connection", False):
        raise ValueError("the reference covers no linear transformer and no skip connection")
    rows, widths, bands_per_row = band_layout(model_type, model)
    rows_t = torch.as_tensor(rows, device=x.device)

    b, ch, length = x.shape
    window = torch.hann_window(win, device=x.device)
    spec = torch.stft(x.reshape(-1, length), n_fft, hop, win_length=win, window=window,
                      center=True, normalized=model.get("stft_normalized", False),
                      return_complex=True)
    spec = torch.view_as_real(spec)  # (B*ch, F, T, 2)
    fdim, frames = spec.shape[1], spec.shape[2]
    # 'b s f t c -> b (f s) t c'
    stft_repr = spec.reshape(b, ch, fdim, frames, 2).permute(0, 2, 1, 3, 4).reshape(
        b, fdim * ch, frames, 2)
    feats = stft_repr[:, rows_t].permute(0, 2, 1, 3).reshape(b, frames, -1)

    bands, off = [], 0
    for i, w in enumerate(widths):
        xi = rms_norm(feats[..., off:off + w], sd[f"band_split.to_features.{i}.0.gamma"])
        bands.append(mm.linear(xi, sd[f"band_split.to_features.{i}.1.weight"],
                               sd[f"band_split.to_features.{i}.1.bias"]))
        off += w
    z = torch.stack(bands, dim=-2)  # (B, T, NB, D)
    nb, dim = z.shape[-2:]
    t_freqs, f_freqs = rope_freqs(sd, "layers.0.0"), rope_freqs(sd, "layers.0.1")
    for d in range(depth):
        zz = z.permute(0, 2, 1, 3).reshape(b * nb, frames, dim)
        zz = transformer(mm, sd, f"layers.{d}.0", zz, t_depth, heads, t_freqs, mel)
        z = zz.reshape(b, nb, frames, dim).permute(0, 2, 1, 3)
        zz = transformer(mm, sd, f"layers.{d}.1", z.reshape(b * frames, nb, dim), f_depth,
                         heads, f_freqs, mel)
        z = zz.reshape(b, frames, nb, dim)
    if not mel:
        z = rms_norm(z, sd["final_norm.gamma"])

    # mel's MLP has mask_estimator_depth hidden layers, bs's one fewer
    n_hidden = mask_depth if mel else mask_depth - 1
    masks = []
    for s in range(stems):
        outs = []
        for i in range(nb):
            h = z[:, :, i]
            pre = f"mask_estimators.{s}.to_freqs.{i}.0"
            for li in range(n_hidden):
                h = torch.tanh(mm.linear(h, sd[f"{pre}.{2 * li}.weight"],
                                         sd[f"{pre}.{2 * li}.bias"]))
            h = mm.linear(h, sd[f"{pre}.{2 * n_hidden}.weight"], sd[f"{pre}.{2 * n_hidden}.bias"])
            outs.append(F.glu(h, dim=-1))
        masks.append(torch.cat(outs, dim=-1))
    m = torch.stack(masks, dim=1).reshape(b, stems, frames, -1, 2)
    m = torch.complex(m[..., 0], m[..., 1]).permute(0, 1, 3, 2)  # (B, S, rows, T)
    if bands_per_row is not None:  # overlapping bands: average by coverage
        summed = torch.zeros(b, stems, fdim * ch, frames, dtype=m.dtype, device=m.device)
        summed.scatter_add_(2, rows_t.view(1, 1, -1, 1).expand(b, stems, -1, frames), m)
        cover = torch.as_tensor(bands_per_row, dtype=torch.float32, device=x.device)
        m = summed / cover.clamp(min=1e-8).view(1, 1, -1, 1)
    stft_c = torch.complex(stft_repr[..., 0], stft_repr[..., 1])
    out = (stft_c.unsqueeze(1) * m).reshape(b, stems, fdim, ch, frames).permute(0, 1, 3, 2, 4)
    out = out.reshape(-1, fdim, frames).clone()
    out.imag[:, 0] = 0.0
    out.imag[:, -1] = 0.0
    wav = torch.istft(out, n_fft, hop, win_length=win, window=window, center=True,
                      normalized=model.get("stft_normalized", False), length=length)
    return wav.reshape(b, stems, ch, length)
