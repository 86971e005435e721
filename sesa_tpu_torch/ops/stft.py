"""RI-contract STFT / iSTFT (counterpart of sesa_tpu/ops/stft.py).

The JAX package builds its transform from DFT matrices because the TPU has
no FFT and no complex dtype. Here the transform is ``torch.stft`` and an
inverse real FFT with overlap-add (cuFFT on the card) on complex64, while the public contract
stays the JAX one: spectra are real tensors ``(..., F, frames, 2)`` with a
trailing (real, imag) axis, and ``istft_ri`` takes ``length=``. The inverse
ignores the imaginary parts of the DC and Nyquist bins, as the JAX one does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from sesa_tpu_torch.ops.windows import hann_window

__all__ = ["hann_window", "stft_ri", "istft_ri", "stft", "istft", "frame_signal", "overlap_add"]


def _window(window, win_length, n_fft, like):
    if win_length is None:
        win_length = n_fft if window is None else window.shape[0]
    if window is None:
        window = torch.ones(win_length, dtype=torch.float32, device=like.device)
    return window.to(device=like.device, dtype=torch.float32), win_length


def frame_signal(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """Sliding frames: ``(..., T)`` -> ``(..., n_frames, frame_length)`` with
    ``n_frames = 1 + (T - frame_length) // hop`` (a view of ``x``)."""
    return x.unfold(-1, frame_length, hop)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Overlap-add ``(B, n_frames, frame_len)`` -> ``(B, frame_len + hop *
    (n_frames - 1))``. When ``hop`` divides the frame length this is k
    slice-adds over a ``(B, n_frames + k - 1, hop)`` accumulator, in the
    order the JAX function adds; other hops fold the frames (``F.fold``,
    whose CUDA kernel sums each output sample's frames in one thread, in a
    fixed order: deterministic, as ``torch.istft``'s overlap-add is)."""
    b, n_frames, frame_len = frames.shape
    if frame_len % hop == 0:
        k = frame_len // hop
        fr = frames.reshape(b, n_frames, k, hop)
        acc = frames.new_zeros((b, n_frames + k - 1, hop))
        for s in range(k):
            acc[:, s:s + n_frames] += fr[:, :, s]
        return acc.reshape(b, (n_frames + k - 1) * hop)
    length = frame_len + hop * (n_frames - 1)
    sig = F.fold(frames.transpose(1, 2), output_size=(1, length), kernel_size=(1, frame_len),
                 stride=(1, hop))
    return sig.reshape(b, length)


def stft_ri(x: torch.Tensor, n_fft: int, hop_length: int,
            window: Optional[torch.Tensor] = None,
            win_length: Optional[int] = None, center: bool = True,
            normalized: bool = False, pad_mode: str = "reflect") -> torch.Tensor:
    """``(..., T)`` real -> ``(..., n_fft // 2 + 1, frames, 2)`` real."""
    window, win_length = _window(window, win_length, n_fft, x)
    lead = x.shape[:-1]
    spec = torch.stft(x.reshape(-1, x.shape[-1]).float(), n_fft, hop_length,
                      win_length=win_length, window=window, center=center,
                      pad_mode=pad_mode, normalized=normalized, onesided=True,
                      return_complex=True)
    ri = torch.view_as_real(spec)  # (B, F, frames, 2)
    return ri.reshape(lead + ri.shape[1:])


def istft_ri(spec: torch.Tensor, n_fft: int, hop_length: int,
             window: Optional[torch.Tensor] = None,
             win_length: Optional[int] = None, center: bool = True,
             normalized: bool = False,
             length: Optional[int] = None) -> torch.Tensor:
    """``(..., F, frames, 2)`` real -> ``(..., length)`` real."""
    window, win_length = _window(window, win_length, n_fft, spec)
    lead = spec.shape[:-3]
    f, frames = spec.shape[-3:-1]
    if f != n_fft // 2 + 1:
        raise ValueError(f"expected {n_fft // 2 + 1} freq bins, got {f}")
    # the imaginary parts of the DC and Nyquist bins have no real signal: the
    # JAX transform's sine rows are zero there and pocketfft ignores them,
    # but cuFFT's C2R at n_fft 4096 does not (a masked spectrum has them
    # nonzero), so they are zeroed here
    ri = spec.reshape((-1, f, frames, 2)).to(torch.float32, memory_format=torch.contiguous_format,
                                             copy=True)
    ri[:, 0, :, 1] = 0
    if n_fft % 2 == 0:
        ri[:, -1, :, 1] = 0
    c = torch.view_as_complex(ri)
    # torch.istft's inverse written out: torch.istft checks the window
    # envelope on the host (a .item()), which would hold every dispatch
    # behind the device's queue. Where the overlap-added square of the
    # window vanishes, the JAX function divides by 1 (sesa_tpu/ops/stft.py
    # :184-188), and so does this
    frames_t = torch.fft.irfft(c, n=n_fft, dim=1, norm="ortho" if normalized else "backward")
    win = window
    if win_length < n_fft:  # centred in the frame, as torch pads it
        left = (n_fft - win_length) // 2
        win = torch.nn.functional.pad(win, (left, n_fft - win_length - left))
    y = overlap_add((frames_t * win[:, None]).transpose(1, 2).contiguous(), hop_length)
    env = overlap_add((win * win).expand(1, frames, n_fft).contiguous(), hop_length)[0]
    start = n_fft // 2 if center else 0
    end = start + length if length is not None else y.shape[-1] - (start if center else 0)
    env = env[start:end]
    y = y[:, start:end] / torch.where(env > 1e-11, env, 1.0)
    if y.shape[-1] < end - start:  # a length past the frames: zeros, as torch.istft pads
        y = torch.nn.functional.pad(y, (0, end - start - y.shape[-1]))
    return y.reshape(lead + y.shape[-1:])


def stft(x: torch.Tensor, n_fft: int, hop_length: int, window: Optional[torch.Tensor] = None,
         **kwargs) -> torch.Tensor:
    """Complex-output wrapper over :func:`stft_ri`: ``(..., T)`` real ->
    ``(..., n_fft // 2 + 1, frames)`` complex64."""
    ri = stft_ri(x, n_fft, hop_length, window, **kwargs)
    return torch.complex(ri[..., 0], ri[..., 1])


def istft(spec: torch.Tensor, n_fft: int, hop_length: int, window: Optional[torch.Tensor] = None,
          **kwargs) -> torch.Tensor:
    """Complex-input wrapper over :func:`istft_ri`: ``(..., F, frames)``
    complex -> ``(..., length)`` real."""
    ri = torch.stack([spec.real, spec.imag], dim=-1)
    return istft_ri(ri, n_fft, hop_length, window, **kwargs)
