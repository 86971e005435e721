"""PyTorch/CUDA port of sesa_tpu for NVIDIA Hopper (H100).

The JAX package ``sesa_tpu`` is the reference; this package mirrors its
module paths (``sesa_tpu_torch/ops/attention.py`` <-> ``sesa_tpu/ops/
attention.py`` ...) and imports neither JAX nor anything of ``sesa_tpu``.
Plain tensor code is PyTorch; the Pallas kernels of the main path are
hand-written CUDA kernels under ``csrc/``, built with nvcc at first use.

Entry points (``cli.main``, ``InferenceSession.create``, ``demix``) run on
CUDA unless the caller asks for the CPU; with no GPU they raise instead of
falling back.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["get_device", "to_device"]


def get_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """Resolve the device to run on: CUDA by default, the CPU only when asked.

    Raises ``RuntimeError`` when CUDA is requested (explicitly or by default)
    and no GPU is visible.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (CLI: --force_cpu) to "
            "run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_device(array, device, dtype=None) -> torch.Tensor:
    """A host array (numpy or a CPU tensor) as a tensor on ``device``. To
    CUDA it is copied from pinned memory without waiting for the device's
    queue: a copy from pageable memory synchronises the stream, and the
    constant tables that models build per call (band indices, windows) would
    then hold every dispatch behind the work queued before it."""
    t = torch.as_tensor(array, dtype=dtype)
    dev = torch.device(device)
    if dev.type != "cuda" or torch.compiler.is_compiling() or torch.compiler.is_exporting():
        return t.to(dev)  # a traced program (torch.export) keeps it as a constant
    return t.pin_memory().to(dev, non_blocking=True)

