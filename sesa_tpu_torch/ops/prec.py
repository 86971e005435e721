"""Matmul precision policy (counterpart of sesa_tpu/ops/prec.py).

The JAX package picks a precision per net: ``Precision.HIGHEST`` for every
product of an f32 net, ``DEFAULT`` for the f32 work inside a bf16 net. The
PyTorch counterpart is two process-wide flags, TF32 for matmuls
(``torch.backends.cuda.matmul.allow_tf32``) and for cuDNN
(``torch.backends.cudnn.allow_tf32``). ``net_precision`` sets both for the
length of one model call, off for an f32 net and on for a bf16 net (whose
f32 cuDNN work, the SCNet and Demucs LSTMs, then runs TF32 whatever ran
before it in the process), and restores what it found.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def net_precision(compute_dtype):
    """Resolve a net's compute dtype (None means f32) and hold the TF32 flags
    at its policy inside the ``with`` block: off for f32, on otherwise."""
    dtype = torch.float32 if compute_dtype is None else compute_dtype
    tf32 = dtype != torch.float32
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield dtype
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
