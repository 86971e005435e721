"""Training losses over waveforms (counterpart of sesa_tpu/losses.py).

The reference carries its objectives in two places: the roformer families'
waveform L1 + multi-resolution complex STFT L1 (reference
models/bs_roformer/bs_roformer.py:586-622, defaults at :355-359), and the
bandit family's ``SignalNoisePNormRatio`` and ``MultichannelSingleSrcNegSDR``
(reference models/bandit/core/loss/snr.py:5-80 and :84-146).

Every function is differentiable PyTorch on tensors of any device. Spectra
come from the port's RI STFT (``ops.stft.stft_ri``), so the complex modulus
is taken over the trailing (real, imag) axis, as in the JAX package.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

from sesa_tpu_torch.ops.stft import stft_ri
from sesa_tpu_torch.ops.windows import hann_window

# reference bs_roformer.py:355-358
MULTI_STFT_WINDOW_SIZES: Tuple[int, ...] = (4096, 2048, 1024, 512, 256)
MULTI_STFT_HOP = 147


def l1(recon: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean absolute error (``F.l1_loss`` with mean reduction)."""
    return torch.mean(torch.abs(recon - target))


def _complex_l1(a_ri: torch.Tensor, b_ri: torch.Tensor) -> torch.Tensor:
    """``F.l1_loss`` between complex tensors stored RI-stacked: the mean of
    the complex modulus of the difference over the COMPLEX element count.
    The 1e-24 bias keeps the sqrt's gradient finite where recon == target;
    it shifts the value by < 1e-12."""
    d = a_ri - b_ri
    return torch.mean(torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + 1e-24))


def multi_res_stft_l1(
    recon: torch.Tensor,
    target: torch.Tensor,
    stft_n_fft: int = 2048,
    window_sizes: Sequence[int] = MULTI_STFT_WINDOW_SIZES,
    hop_length: int = MULTI_STFT_HOP,
    resolution_weight: float = 1.0,
    return_breakdown: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]]:
    """Waveform L1 + weighted multi-resolution complex-STFT L1.

    ``target`` is cut to the reconstruction's length; each resolution adds
    the complex L1 of the two spectra with ``n_fft = max(window_size,
    stft_n_fft)``, a Hann window of ``window_size``, hop 147, centered, not
    normalized (reference bs_roformer.py:586-622). Leading dims of ``(...,
    T)`` fold into the STFT batch. ``return_breakdown`` also returns
    ``(waveform_l1, multi_stft_l1)``.
    """
    target = target[..., : recon.shape[-1]]
    base = l1(recon, target)

    flat_r = recon.reshape(-1, recon.shape[-1])
    flat_t = target.reshape(-1, target.shape[-1])
    multi = torch.zeros((), dtype=base.dtype, device=base.device)
    for w in window_sizes:
        n_fft = max(int(w), int(stft_n_fft))
        win = hann_window(int(w), device=flat_r.device)
        spec_r = stft_ri(flat_r, n_fft, hop_length, win, win_length=int(w))
        spec_t = stft_ri(flat_t, n_fft, hop_length, win, win_length=int(w))
        multi = multi + _complex_l1(spec_r, spec_t)

    total = base + resolution_weight * multi
    if return_breakdown:
        return total, (base, multi)
    return total


def signal_noise_pnorm_ratio(
    est: torch.Tensor,
    target: torch.Tensor,
    p: float = 1.0,
    scale_invariant: bool = False,
    take_log: bool = True,
    reduction: str = "mean",
    eps: float = 1e-3,
) -> torch.Tensor:
    """``SignalNoisePNormRatio`` (reference bandit core/loss/snr.py:5-80):
    ``10 (log10(mean|est-target|^p + eps) - log10(mean|target|^p + eps))``
    per batch element over the flattened trailing dims; ``scale_invariant``
    first rescales the target by the per-batch-element projection
    coefficient."""
    if scale_invariant:
        dot = torch.sum(est * target, dim=-1, keepdim=True)
        energy = torch.sum(target * target, dim=-1, keepdim=True)
        if target.ndim > 2:
            dims = tuple(range(1, target.ndim))
            dot = torch.sum(dot, dim=dims, keepdim=True)
            energy = torch.sum(energy, dim=dims, keepdim=True)
        target = target * (dot + 1e-8) / (energy + 1e-8)

    batch = est.shape[0]
    est = est.reshape(batch, -1)
    target = target.reshape(batch, -1)
    if p == 1:
        e_error = torch.abs(est - target).mean(dim=-1)
        e_target = torch.abs(target).mean(dim=-1)
    elif p == 2:
        e_error = torch.square(est - target).mean(dim=-1)
        e_target = torch.square(target).mean(dim=-1)
    else:
        raise NotImplementedError(f"p={p} (reference supports p in {{1, 2}})")

    if take_log:
        loss = 10.0 * (torch.log10(e_error + eps) - torch.log10(e_target + eps))
    else:
        loss = (e_error + eps) / (e_target + eps)
    return loss.mean() if reduction == "mean" else loss


def neg_sdr(
    est: torch.Tensor,
    target: torch.Tensor,
    sdr_type: str = "snr",
    p: float = 2.0,
    zero_mean: bool = True,
    take_log: bool = True,
    reduction: str = "mean",
) -> torch.Tensor:
    """``MultichannelSingleSrcNegSDR`` (reference core/loss/snr.py:84-146):
    negative SNR / SI-SDR / SD-SDR over ``(batch, channels, time)``. eps is
    1e-8 whatever the constructor says, as in the reference (snr.py:98)."""
    if sdr_type not in ("snr", "sisdr", "sdsdr"):
        raise ValueError(f"sdr_type={sdr_type!r}")
    if est.ndim != 3 or est.shape != target.shape:
        raise TypeError(
            f"Inputs must be (batch, channels, time) with equal shapes, got "
            f"{tuple(target.shape)} and {tuple(est.shape)}")
    eps = 1e-8
    if zero_mean:
        target = target - target.mean(dim=(1, 2), keepdim=True)
        est = est - est.mean(dim=(1, 2), keepdim=True)
    if sdr_type in ("sisdr", "sdsdr"):
        dot = torch.sum(est * target, dim=(1, 2), keepdim=True)
        energy = torch.sum(target ** 2, dim=(1, 2), keepdim=True) + eps
        scaled_target = dot * target / energy
    else:
        scaled_target = target
    e_noise = est - (target if sdr_type in ("sdsdr", "snr") else scaled_target)

    if p == 2.0:
        losses = torch.sum(scaled_target ** 2, dim=(1, 2)) / (
            torch.sum(e_noise ** 2, dim=(1, 2)) + eps)
    else:
        num = torch.sum(torch.abs(scaled_target) ** p, dim=(1, 2)) ** (1.0 / p)
        den = torch.sum(torch.abs(e_noise) ** p, dim=(1, 2)) ** (1.0 / p) + eps
        losses = num / den
    if take_log:
        losses = 10.0 * torch.log10(losses + eps)
    losses = losses.mean() if reduction == "mean" else losses
    return -losses
