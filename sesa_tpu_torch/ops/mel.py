"""Slaney-style mel filterbank (the port's own copy of sesa_tpu/ops/mel.py),
numerically matching librosa.filters.mel defaults (htk=False,
norm='slaney'). The mel-band models build their overlapping band layout
from it. numpy only; librosa is not a dependency.
"""

from __future__ import annotations

import numpy as np

_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    mel = f / _F_SP
    log_region = f >= _MIN_LOG_HZ
    return np.where(log_region,
                    _MIN_LOG_MEL + np.log(np.maximum(f, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP, mel)


def mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f = m * _F_SP
    log_region = m >= _MIN_LOG_MEL
    return np.where(log_region, _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)), f)


def mel_frequencies(n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    mels = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels)
    return mel_to_hz(mels)


def mel_filter_bank(sr: int, n_fft: int, n_mels: int,
                    fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """(n_mels, 1 + n_fft//2) triangular slaney-normalised filterbank."""
    if fmax is None:
        fmax = sr / 2.0
    fftfreqs = np.linspace(0, sr / 2.0, 1 + n_fft // 2)
    mel_f = mel_frequencies(n_mels + 2, fmin, fmax)

    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1][:, None]
    upper = ramps[2:] / fdiff[1:][:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    enorm = 2.0 / (mel_f[2: n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)
