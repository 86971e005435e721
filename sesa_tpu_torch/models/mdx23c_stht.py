"""MDX23C with the short-time Hartley transform (counterpart of
sesa_tpu/models/mdx23c_stht.py; registry key ``experimental_mdx23c_stht``).

The TFC-TDF U-Net of ``mdx23c`` on a real transform: H(x) = Re(FFT) -
Im(FFT) with a periodic Hamming window, all n_fft bins (no dim_f crop, no
complex channels), and a window²-normalised overlap-add inverse. The
Hartley spectrum is assembled from the real DFT (``ops/fft.rdft``) by the
Hermitian identities H[k] = Re[k] - Im[k] and H[N-k] = Re[k] + Im[k].

Its ``apply`` takes no ``compute_dtype``: the model runs f32 in any
session, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from sesa_tpu_torch.models import mdx23c
from sesa_tpu_torch.ops.fft import rdft
from sesa_tpu_torch.ops.stft import frame_signal, overlap_add


def hamming_window(n: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """torch.hamming_window(n, periodic=True), computed in f64."""
    w = 0.54 - 0.46 * np.cos(2.0 * np.pi * np.arange(n) / n)
    return torch.as_tensor(w, dtype=dtype, device=device)


def hartley(frames: torch.Tensor) -> torch.Tensor:
    """(..., N) real -> (..., N) Hartley coefficients (the cas transform)."""
    n = frames.shape[-1]
    spec = rdft(frames)  # (..., N//2+1, 2)
    re, im = spec[..., 0], spec[..., 1]
    head = re - im  # k = 0 .. N/2
    tail = (re + im)[..., 1:n - n // 2]  # H[N-k] for k = 1 .. N/2-1, reversed below
    return torch.cat([head, tail.flip(-1)], dim=-1)


def stht(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(B, ch, T) -> (B, ch, n_fft, frames) (reference STHT.transform)."""
    window = hamming_window(n_fft, dtype=x.dtype, device=x.device)
    pad = n_fft // 2
    lead = x.shape[:-1]
    xp = torch.nn.functional.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect")
    frames = frame_signal(xp.reshape(lead + xp.shape[-1:]), n_fft, hop) * window
    return hartley(frames).transpose(-1, -2)


def istht(coeffs: torch.Tensor, n_fft: int, hop: int, length: int) -> torch.Tensor:
    """(..., n_fft, frames) -> (..., length), window²-normalised overlap-add."""
    window = hamming_window(n_fft, dtype=coeffs.dtype, device=coeffs.device)
    frames = hartley(coeffs.transpose(-1, -2)) / n_fft  # the inverse Hartley
    frames = frames * window

    batch_shape = frames.shape[:-2]
    n_frames = frames.shape[-2]
    sig = overlap_add(frames.reshape((-1, n_frames, n_fft)), hop)
    out_len = length + n_fft  # the reference allocates length + n_fft (center)
    sig = sig[..., :out_len]
    if sig.shape[-1] < out_len:
        sig = torch.nn.functional.pad(sig, (0, out_len - sig.shape[-1]))

    wsq = overlap_add((window * window).expand(1, n_frames, n_fft), hop)[0]
    wsq = wsq[:out_len]
    if wsq.shape[-1] < out_len:
        wsq = torch.nn.functional.pad(wsq, (0, out_len - wsq.shape[-1]))
    eps = float(np.finfo(np.float32).eps)
    sig = sig / wsq.clamp_min(eps)

    pad = n_fft // 2
    sig = sig[..., pad:-pad][..., :length]
    return sig.reshape(batch_shape + (length,))


def _transform_pair(config):
    n_fft = config.audio.n_fft
    hop = config.audio.hop_length

    def analysis(x, _config):
        return stht(x, n_fft, hop)

    def synthesis(spec, _config, length):
        batch_dims = spec.shape[:-3]
        c, f, t = spec.shape[-3:]
        wav = istht(spec.reshape((-1, f, t)), n_fft, hop, length)
        return wav.reshape(batch_dims + (c, length))

    return analysis, synthesis


def init(generator: torch.Generator, config):
    return mdx23c.init(generator, config, hartley=True)


def apply(params, config, x: torch.Tensor) -> torch.Tensor:
    return mdx23c.apply(params, config, x, transform=_transform_pair(config), hartley=True)


def convert_torch(state_dict, config):
    return mdx23c.convert_torch(state_dict, config, hartley=True)
