"""Real DFT in the JAX package's "RI" layout (counterpart of
sesa_tpu/ops/fft.py).

The JAX package computes these as GEMMs against DFT matrices because its
TPU backend has no FFT and no complex dtype. Here they are
``torch.fft.rfft`` / ``irfft`` (cuFFT on the card, pocketfft on the CPU),
while the contract stays the JAX one: a spectrum is a real tensor
``(..., N // 2 + 1, 2)`` with a trailing (real, imag) axis.

cuFFT takes no bf16 at these sizes, and the JAX functions run against f32
tables, so a bf16 input is promoted there too: every transform here takes
f32 and returns f32, whatever the input's dtype.

The inverse ignores the imaginary parts of the DC and Nyquist bins, as the
JAX matrices do (their sine rows are zero there): they are set to zero
before ``irfft`` rather than left to the library.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import numpy as np
import torch

__all__ = ["rdft", "irdft", "rdft_ortho", "irdft_ortho", "rdft_tables", "irdft_tables",
           "force_device_mats"]

_tls = threading.local()


def _min_device_n():
    """The ``min_n`` of the innermost :func:`force_device_mats` of this
    thread, or None outside one."""
    return getattr(_tls, "device_mats_min_n", None)


@contextlib.contextmanager
def force_device_mats(min_n: int = 0):
    """The JAX package's switch, kept for its callers: inside the ``with``
    block this thread's setting is ``min_n``; blocks nest, and the old value
    comes back on exit, also on an exception. Other threads do not see it.

    In sesa_tpu it makes the DFT transforms build their tables on the device
    for every n >= ``min_n`` instead of baking them into the program as
    constants, which keeps a whole-song TPU executable small enough for its
    remote compiler. The transforms here are cuFFT and read no DFT table, so
    the setting changes no result."""
    old = _min_device_n()
    _tls.device_mats_min_n = min_n
    try:
        yield
    finally:
        if old is None:
            del _tls.device_mats_min_n
        else:
            _tls.device_mats_min_n = old


def rdft(x: torch.Tensor, norm: str = "backward") -> torch.Tensor:
    """Real DFT: (..., N) real -> (..., N//2+1, 2) f32 RI spectrum."""
    return torch.view_as_real(torch.fft.rfft(x.float(), dim=-1, norm=norm))


def irdft(spec_ri: torch.Tensor, n: int, norm: str = "backward") -> torch.Tensor:
    """Inverse real DFT: (..., K, 2) RI spectrum -> (..., n) f32 real, with
    K = n//2+1."""
    spec = spec_ri.float().clone()
    spec[..., 0, 1] = 0
    if n % 2 == 0 and spec.shape[-2] > n // 2:
        spec[..., n // 2, 1] = 0
    return torch.fft.irfft(torch.view_as_complex(spec), n=n, dim=-1, norm=norm)


def rdft_ortho(x: torch.Tensor) -> torch.Tensor:
    """Ortho-normalised real DFT (torch.fft.rfft(..., norm='ortho'))."""
    return rdft(x, norm="ortho")


def irdft_ortho(spec_ri: torch.Tensor, n: int) -> torch.Tensor:
    """Ortho-normalised inverse real DFT (torch.fft.irfft(..., norm='ortho'))."""
    return irdft(spec_ri, n, norm="ortho")


@functools.lru_cache(maxsize=32)
def rdft_tables(n: int):
    """Forward rDFT matrices C, S of shape (n, n//2+1), f32 numpy, built in
    f64: X = x@C + i x@S (sesa_tpu/ops/fft.py ``_rdft_mats``)."""
    k = np.arange(n // 2 + 1)
    t = np.arange(n)
    ang = -2.0 * np.pi * np.outer(t, k) / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=32)
def irdft_tables(n: int):
    """Inverse rDFT matrices Ci, Si of shape (n//2+1, n), f32 numpy:
    x = Xr@Ci + Xi@Si (sesa_tpu/ops/fft.py ``_irdft_mats``)."""
    nk = n // 2 + 1
    k = np.arange(nk)
    t = np.arange(n)
    ang = 2.0 * np.pi * np.outer(k, t) / n
    w = np.full(nk, 2.0)
    w[0] = 1.0
    if n % 2 == 0:
        w[-1] = 1.0
    return ((w[:, None] * np.cos(ang) / n).astype(np.float32),
            (-w[:, None] * np.sin(ang) / n).astype(np.float32))
