"""Separation-quality metrics (SNR, SI-SNR, BSS-eval SDR), the chunk-median
aggregations of the reference's bandit subtree, and SQUIM's reference-free
scores (counterpart of sesa_tpu/metrics.py).

The ratio metrics are host numpy / scipy code in f64, run at evaluation
time on fetched stems; they take numpy arrays or tensors (a tensor is
copied to the host). ``squim_objective_scores`` runs the SQUIM model on the
device its parameters are on.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _as2d(x) -> np.ndarray:
    x = np.asarray(_np(x), dtype=np.float64)
    return x.reshape(-1, x.shape[-1])


def signal_noise_ratio(preds, target, zero_mean: bool = False) -> np.ndarray:
    """SNR = 10·log10(‖t‖² / ‖t − p‖²) over the last axis."""
    p, t = _as2d(preds), _as2d(target)
    if zero_mean:
        p = p - p.mean(-1, keepdims=True)
        t = t - t.mean(-1, keepdims=True)
    num = (t ** 2).sum(-1)
    den = ((t - p) ** 2).sum(-1)
    out = 10 * np.log10(np.maximum(num, 1e-30) / np.maximum(den, 1e-30))
    return out.reshape(_np(preds).shape[:-1])


def scale_invariant_signal_noise_ratio(preds, target) -> np.ndarray:
    """SI-SNR / SI-SDR: preds projected onto target before the ratio."""
    p, t = _as2d(preds), _as2d(target)
    p = p - p.mean(-1, keepdims=True)
    t = t - t.mean(-1, keepdims=True)
    alpha = (p * t).sum(-1, keepdims=True) / np.maximum((t ** 2).sum(-1, keepdims=True), 1e-30)
    s = alpha * t
    num = (s ** 2).sum(-1)
    den = ((p - s) ** 2).sum(-1)
    out = 10 * np.log10(np.maximum(num, 1e-30) / np.maximum(den, 1e-30))
    return out.reshape(_np(preds).shape[:-1])


scale_invariant_signal_distortion_ratio = scale_invariant_signal_noise_ratio


def signal_distortion_ratio(preds, target, filter_length: int = 512, zero_mean: bool = False,
                            load_diag: Optional[float] = None) -> np.ndarray:
    """BSS-eval SDR: the target may pass through any ``filter_length``-tap
    FIR filter without penalty (bss_eval's and torchmetrics' definition).
    Solves the Toeplitz system R·h = b, R the target's autocorrelation and b
    its cross-correlation with preds; a singular system gives NaN."""
    from scipy.linalg import solve_toeplitz

    p2, t2 = _as2d(preds), _as2d(target)
    if zero_mean:
        p2 = p2 - p2.mean(-1, keepdims=True)
        t2 = t2 - t2.mean(-1, keepdims=True)

    n = p2.shape[-1]
    nfft = 1 << int(np.ceil(np.log2(n + filter_length)))
    out = np.empty(p2.shape[0])
    for i in range(p2.shape[0]):
        t, p = t2[i], p2[i]
        tf = np.fft.rfft(t, nfft)
        pf = np.fft.rfft(p, nfft)
        acf = np.fft.irfft(tf * np.conj(tf), nfft)[:filter_length]
        xcorr = np.fft.irfft(pf * np.conj(tf), nfft)[:filter_length]
        if load_diag is not None:
            acf = acf.copy()
            acf[0] += load_diag
        try:
            h = solve_toeplitz(acf, xcorr)
        except np.linalg.LinAlgError:
            out[i] = np.nan
            continue
        coh = float(np.dot(xcorr, h))
        den = float((p ** 2).sum()) - coh
        out[i] = 10 * np.log10(max(coh, 1e-30) / max(den, 1e-30))
    return out.reshape(_np(preds).shape[:-1])


def chunk_median_signal_ratio(func: Callable, preds, target, window_size: int,
                              hop_size: Optional[int] = None) -> float:
    """The metric of each chunk, the nanmedian across chunks, then the mean
    across batch elements (reference snr.py:26-88: chunks shorter than the
    window are skipped; non-finite values are dropped per batch element)."""
    if hop_size is None:
        hop_size = window_size
    preds, target = _np(preds), _np(target)
    n = target.shape[-1]
    vals = []
    for start in range(0, max(n - window_size + 1, 1), hop_size):
        if n - start < window_size:
            break
        v = np.asarray(func(preds[..., start:start + window_size],
                            target[..., start:start + window_size]), dtype=np.float64)
        vals.append(np.where(np.isfinite(v), v, np.nan))
    if not vals:
        return float("nan")
    with np.errstate(invalid="ignore"):
        per_batch = np.nanmedian(np.stack(vals, axis=-1), axis=-1)
    return float(np.mean(per_batch))


def chunk_median_snr(preds, target, window_size, hop_size=None) -> float:
    return chunk_median_signal_ratio(signal_noise_ratio, preds, target, window_size, hop_size)


def chunk_median_si_snr(preds, target, window_size, hop_size=None) -> float:
    return chunk_median_signal_ratio(scale_invariant_signal_noise_ratio, preds, target,
                                     window_size, hop_size)


def chunk_median_sdr(preds, target, window_size, hop_size=None) -> float:
    return chunk_median_signal_ratio(signal_distortion_ratio, preds, target, window_size,
                                     hop_size)


def squim_objective_scores(wave, params, config=None) -> dict:
    """Reference-free objective quality through the SQUIM model: {stoi,
    pesq, sisdr} numpy arrays of shape (batch,). ``wave`` is (T,) or (B, T)
    16 kHz mono, numpy or a tensor; ``params`` is the tree of
    ``sesa_tpu_torch.models.squim.init`` / ``convert_torch``, and the model
    runs on the device that tree is on."""
    from sesa_tpu_torch.models import squim

    x = wave if isinstance(wave, torch.Tensor) else torch.from_numpy(np.asarray(wave))
    x = x.to(device=params["encoder"]["weight"].device, dtype=torch.float32)
    if x.ndim == 1:
        x = x[None]
    with torch.inference_mode():
        scores = squim.apply(params, config, x)
    return {k: v.cpu().numpy() for k, v in scores.items()}
