"""Host-side audio I/O (counterpart of sesa_tpu/audio_io.py without its
native codec).

soundfile is used when it imports, as the JAX package does: it reads any
format libsndfile knows (FLAC, OGG, MP3, ...) and writes real FLAC.
Without it, WAV is read with scipy and written with scipy or the stdlib
``wave`` module, and a ``.flac`` output is written as ``.wav`` of the
requested PCM depth; ``write_audio`` returns the path it actually wrote.
``AudioReader`` and ``AudioWriter`` stream frames for the long-file paths
(the streaming ensemble).

The JAX package's ``native/`` (a WAV codec in C++, built with g++ at first
use and bound with ctypes) is not copied: the JAX package itself falls back
to scipy and ``wave`` when it cannot build it, the codec is an optional
speed-up of host reads and writes, not a separate format, and this module's
``AudioReader`` / ``AudioWriter`` already stream PCM WAV files in windows
of bounded memory. A g++ build at first use would add a
toolchain the port does not otherwise need on the host.
"""

from __future__ import annotations

import os
import wave
from math import gcd
from typing import Optional, Tuple

import numpy as np


def _soundfile():
    """The soundfile module, or None where it is not installed."""
    try:
        import soundfile
    except ImportError:
        return None
    return soundfile


def read_audio(path: str, target_sr: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Read an audio file -> ((channels, T) float32, sample_rate); mono is
    (1, T). Any format soundfile reads where it is installed, else WAV.
    Resamples with polyphase filtering when ``target_sr`` differs."""
    sf = _soundfile()
    if sf is not None:
        data, sr = sf.read(path, always_2d=True)
        return _resampled(np.asarray(data, dtype=np.float32).T, sr, target_sr)
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
    return _resampled(data.T, sr, target_sr)


def _resampled(data: np.ndarray, sr: int, target_sr: Optional[int]):
    if target_sr is not None and target_sr != sr:
        from scipy.signal import resample_poly

        g = gcd(target_sr, sr)
        data = resample_poly(data, target_sr // g, sr // g, axis=-1).astype(np.float32)
        sr = target_sr
    return np.ascontiguousarray(data), sr


def write_audio(path: str, audio: np.ndarray, sr: int, subtype: str = "FLOAT") -> str:
    """Write (channels, T) float32 audio. subtype: FLOAT | PCM_16 | PCM_24.

    FLAC cannot carry floats, so a ``.flac`` path takes FLOAT as PCM_24. With
    soundfile the file is written in its path's format; without it a
    ``.flac`` path is written as ``.wav``. Returns the path written.
    """
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 1:
        audio = audio[None]
    data = audio.T  # (T, channels)
    flac = os.path.splitext(path)[1].lower() == ".flac"
    if flac and subtype == "FLOAT":
        subtype = "PCM_24"
    sf = _soundfile()
    if sf is not None:
        sf.write(path, np.ascontiguousarray(data), sr, subtype=subtype)
        return path
    if flac:
        path = os.path.splitext(path)[0] + ".wav"
    if subtype == "FLOAT":
        from scipy.io import wavfile

        wavfile.write(path, sr, np.ascontiguousarray(data))
        return path
    with AudioWriter(path, sr, data.shape[1], subtype=subtype) as w:
        w.write(audio)
    return path


def _pcm_bytes(audio: np.ndarray, subtype: str) -> bytes:
    """(channels, n) float32 -> interleaved little-endian PCM frames."""
    data = np.clip(audio.T, -1.0, 1.0)
    if subtype == "PCM_16":
        return (data * 32767.0).astype("<i2").tobytes()
    as_int = (data * 8388607.0).astype("<i4")
    return np.frombuffer(as_int.tobytes(), dtype=np.uint8).reshape(-1, 4)[:, :3].tobytes()


class AudioReader:
    """Streaming frame reader: ``read(n) -> (channels, m) float32``.

    PCM WAV files (8, 16, 24 and 32 bits) stream through the stdlib ``wave``
    module with bounded memory, scaled as :func:`read_audio` scales them;
    anything else (float WAV, or another format through soundfile) is read
    whole by :func:`read_audio` and served in slices.
    """

    def __init__(self, path: str):
        self._pos = 0
        self._w = None
        try:
            self._w = wave.open(path, "rb")
        except wave.Error:
            data, sr = read_audio(path)
            self._data, self.samplerate = data, sr
            self.channels, self.frames = data.shape
            return
        self.samplerate = self._w.getframerate()
        self.channels = self._w.getnchannels()
        self.frames = self._w.getnframes()
        self._width = self._w.getsampwidth()

    def read(self, n: int) -> np.ndarray:
        n = min(n, self.frames - self._pos)
        if n <= 0:
            return np.zeros((self.channels, 0), dtype=np.float32)
        if self._w is None:
            out = self._data[:, self._pos:self._pos + n]
        else:
            raw = np.frombuffer(self._w.readframes(n), dtype=np.uint8)
            if self._width == 1:
                out = (raw.astype(np.float32) - 128.0) / 128.0
            elif self._width == 2:
                out = raw.view("<i2").astype(np.float32) / 32768.0
            elif self._width == 3:  # left-justified in 32 bits, as scipy reads it
                padded = np.zeros((raw.size // 3, 4), dtype=np.uint8)
                padded[:, 1:] = raw.reshape(-1, 3)
                out = padded.view("<i4")[:, 0].astype(np.float32) / 2147483648.0
            else:
                out = raw.view("<i4").astype(np.float32) / 2147483648.0
            out = out.reshape(-1, self.channels).T
        self._pos += out.shape[1]
        return np.ascontiguousarray(out)

    def close(self) -> None:
        if self._w is not None:
            self._w.close()
            self._w = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class AudioWriter:
    """Streaming PCM WAV writer: ``write((channels, n) float32)`` appends.

    ``subtype`` is PCM_16 or PCM_24 (the ``wave`` module writes PCM only); a
    ``.flac`` path is rewritten to ``.wav``, as in :func:`write_audio`.
    ``path`` is the path actually written.
    """

    def __init__(self, path: str, sr: int, channels: int, subtype: str = "PCM_24"):
        if subtype not in ("PCM_16", "PCM_24"):
            raise ValueError(f"unsupported wav subtype {subtype}")
        if path.lower().endswith(".flac"):
            path = os.path.splitext(path)[0] + ".wav"
        self.path = path
        self._subtype, self._channels = subtype, channels
        self._w = wave.open(path, "wb")
        self._w.setnchannels(channels)
        self._w.setframerate(sr)
        self._w.setsampwidth(2 if subtype == "PCM_16" else 3)

    def write(self, audio: np.ndarray) -> None:
        audio = np.asarray(audio, dtype=np.float32)
        if audio.ndim != 2 or audio.shape[0] != self._channels:
            raise ValueError(f"expected ({self._channels}, frames) audio, got {audio.shape}")
        self._w.writeframes(_pcm_bytes(audio, self._subtype))

    def close(self) -> None:
        if self._w is not None:
            self._w.close()
            self._w = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
