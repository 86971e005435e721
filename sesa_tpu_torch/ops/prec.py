"""Matmul precision policy (counterpart of sesa_tpu/ops/prec.py).

The JAX package passes ``Precision.HIGHEST`` to every f32 product of a net.
The PyTorch counterpart is global state: the f32 path turns TF32 off for
both matmuls (``torch.backends.cuda.matmul.allow_tf32``) and cuDNN
convolutions (``torch.backends.cudnn.allow_tf32``, True by default), so f32
products on the card keep full f32 precision. bf16 nets leave the flags as
they are: their products run on bf16 operands with f32 accumulation.
"""

from __future__ import annotations

import torch


def net_dtype(compute_dtype) -> torch.dtype:
    """Resolve a net's compute dtype (None means f32) and, for f32, apply the
    full-precision policy above."""
    dtype = torch.float32 if compute_dtype is None else compute_dtype
    if dtype == torch.float32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dtype
