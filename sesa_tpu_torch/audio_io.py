"""Host-side WAV I/O on scipy and the stdlib ``wave`` module (counterpart of
sesa_tpu/audio_io.py without its native codec or soundfile).

``.flac`` output is written as ``.wav`` of the requested PCM depth, as the
JAX package does without soundfile; ``write_audio`` returns the path it
actually wrote.
"""

from __future__ import annotations

import os
import wave
from math import gcd
from typing import Optional, Tuple

import numpy as np


def read_audio(path: str, target_sr: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> ((channels, T) float32, sample_rate); mono is (1, T).
    Resamples with polyphase filtering when ``target_sr`` differs."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.ndim == 1:
        data = data[:, None]
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:  # 32-bit PCM, and 24-bit read left-justified
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    data = data.T
    if target_sr is not None and target_sr != sr:
        from scipy.signal import resample_poly

        g = gcd(target_sr, sr)
        data = resample_poly(data, target_sr // g, sr // g, axis=-1).astype(np.float32)
        sr = target_sr
    return np.ascontiguousarray(data), sr


def write_audio(path: str, audio: np.ndarray, sr: int, subtype: str = "FLOAT") -> str:
    """Write (channels, T) float32 audio as WAV. subtype: FLOAT | PCM_16 | PCM_24.

    A ``.flac`` path is written as ``.wav`` (FLOAT coerced to PCM_24, as FLAC
    cannot carry floats). Returns the path written.
    """
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 1:
        audio = audio[None]
    data = audio.T  # (T, channels)
    if os.path.splitext(path)[1].lower() == ".flac":
        path = os.path.splitext(path)[0] + ".wav"
        if subtype == "FLOAT":
            subtype = "PCM_24"
    if subtype == "FLOAT":
        from scipy.io import wavfile

        wavfile.write(path, sr, np.ascontiguousarray(data))
        return path
    clipped = np.clip(data, -1.0, 1.0)
    with wave.open(path, "wb") as w:
        w.setnchannels(data.shape[1])
        w.setframerate(sr)
        if subtype == "PCM_16":
            w.setsampwidth(2)
            w.writeframes((clipped * 32767.0).astype("<i2").tobytes())
        elif subtype == "PCM_24":
            w.setsampwidth(3)
            as_int = (clipped * 8388607.0).astype("<i4")
            b = np.frombuffer(as_int.tobytes(), dtype=np.uint8).reshape(-1, 4)
            w.writeframes(b[:, :3].tobytes())
        else:
            raise ValueError(f"unknown subtype {subtype}")
    return path
