"""Fade and Hann windows (counterpart of sesa_tpu/ops/windows.py and the
``hann_window`` of sesa_tpu/ops/stft.py).

The fade window matches the reference's linear fade (``_getWindowingArray``):
the first ``fade_size`` samples ramp 0->1, the last ramp 1->0, ones between;
``linspace`` includes both endpoints, so ``window[0] == window[-1] == 0``.
"""

from __future__ import annotations

import numpy as np
import torch

from sesa_tpu_torch import to_device


def fade_window(window_size: int, fade_size: int, dtype=torch.float32,
                device="cpu") -> torch.Tensor:
    w = np.ones(window_size, dtype=np.float64)
    if fade_size > 0:  # w[-0:] would select (and clobber) the whole array
        w[:fade_size] = np.linspace(0.0, 1.0, fade_size)
        w[-fade_size:] = np.linspace(1.0, 0.0, fade_size)
    return to_device(w, device, dtype)


def hann_window(win_length: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Periodic Hann window, identical to ``torch.hann_window(n, periodic=True)``."""
    n = np.arange(win_length)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    return to_device(w, device, dtype)
