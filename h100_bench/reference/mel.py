"""Mel-Band RoFormer's band layout, worked out from the published recipe.

lucidrains' MelBandRoformer takes ``librosa.filters.mel(sr, n_fft, n_mels)``
(Slaney mel scale, Slaney area norm, fmin 0, fmax sr/2), forces the first
bin of the first band and the last bin of the last band on, and calls each
band's support (weight > 0) its frequencies. This file rebuilds that in
numpy, as librosa writes it, one filter at a time.
"""

from __future__ import annotations

import math

import numpy as np


def _hz_to_mel(hz: float) -> float:
    f_sp = 200.0 / 3
    if hz < 1000.0:
        return hz / f_sp
    return 1000.0 / f_sp + math.log(hz / 1000.0) / (math.log(6.4) / 27.0)


def _mel_to_hz(mel: np.ndarray) -> np.ndarray:
    f_sp = 200.0 / 3
    min_log_mel = 1000.0 / f_sp
    hz = f_sp * mel
    log_t = mel >= min_log_mel
    hz[log_t] = 1000.0 * np.exp((math.log(6.4) / 27.0) * (mel[log_t] - min_log_mel))
    return hz


def mel_weights(sample_rate: int, n_fft: int, n_mels: int) -> np.ndarray:
    """librosa.filters.mel's (n_mels, 1 + n_fft // 2) weights, float64."""
    fft_hz = np.linspace(0.0, sample_rate / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(_hz_to_mel(0.0), _hz_to_mel(sample_rate / 2.0), n_mels + 2)
    mel_hz = _mel_to_hz(mel_pts)
    fdiff = np.diff(mel_hz)
    ramps = np.subtract.outer(mel_hz, fft_hz)
    weights = np.zeros((n_mels, len(fft_hz)))
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_hz[2:n_mels + 2] - mel_hz[:n_mels])
    return weights * enorm[:, None]


def mel_bands(sample_rate: int, n_fft: int, n_mels: int):
    """(freqs of each band as int arrays, bands covering each freq)."""
    support = mel_weights(sample_rate, n_fft, n_mels) > 0
    support[0, 0] = True
    support[-1, -1] = True
    per_freq = support.sum(0)
    if (per_freq == 0).any():
        raise ValueError("a frequency bin lies in no mel band")
    return [np.nonzero(row)[0] for row in support], per_freq
