"""Ahead-of-time export of a separation forward (counterpart of
sesa_tpu/convert/export.py, the parity feature for the reference's ONNX
export, pytorch_backend.py:539-590): ``torch.export`` in place of StableHLO.

The exported program takes the parameter tree as an input, as the JAX
export does, so one export serves any weights of the same shapes; shapes
are fixed at export. ``torch.export`` traces the PyTorch ops of the f32
forward; it cannot trace a ``ctypes`` call into a hand-written kernel, so
every kernel wrapper raises a ``ValueError`` that names its kernel when it
would launch under ``torch.export`` (``ops._build.refuse_export``). Every
model's f32 path launches none except bs_mamba2's, which reaches its Mamba
mixer's kernels (``ops/mamba.py``) and kernel K8 on CUDA: exporting
bs_mamba2 on the card raises naming the first, ``mamba_conv`` (on the CPU
the plain versions run and export).
"""

from __future__ import annotations

import io
from typing import Optional, Union

import torch

from sesa_tpu_torch import get_device
from sesa_tpu_torch.ops.prec import net_precision
from sesa_tpu_torch.tree import tree_map


class _Forward(torch.nn.Module):
    """``(params, chunks) -> model.apply(params, config, chunks)`` in f32."""

    def __init__(self, model_type: str, config):
        super().__init__()
        from sesa_tpu_torch.models import get_model

        self.model = get_model(model_type)
        self.config = config

    def forward(self, params, chunks):
        return self.model.apply(params, self.config, chunks)


def export_model(model_type: str, config, params, chunk_size: int, batch_size: int = 1,
                 num_channels: int = 2, path: Optional[str] = None, device=None) -> bytes:
    """Export ``apply(params, chunks)`` for chunks of ``(batch_size,
    num_channels, chunk_size)`` f32 on ``device`` (CUDA unless "cpu") with
    ``torch.export``; returns the serialised program (``torch.export.save``),
    also written to ``path`` when given. Raises ``ValueError`` for a model
    whose f32 path on ``device`` launches a hand-written kernel (bs_mamba2's
    mixer and K8 on CUDA; ``ops._build.refuse_export`` raises it where the
    wrapper would launch)."""
    dev = get_device(device)
    from sesa_tpu_torch.configs import AttrDict

    config = config if isinstance(config, AttrDict) else AttrDict(config)
    params = tree_map(lambda p: torch.as_tensor(p).to(dev, torch.float32), params)
    chunks = torch.zeros((batch_size, num_channels, chunk_size), dtype=torch.float32, device=dev)
    with torch.no_grad():
        # non-strict: the model's Python runs as it is on fake tensors (the
        # TF32 flags it sets are a side effect strict tracing flags)
        program = torch.export.export(_Forward(model_type, config), (params, chunks),
                                      strict=False)
    program.example_inputs = None  # the weights and chunks traced with: not part of the program
    buf = io.BytesIO()
    torch.export.save(program, buf)
    blob = buf.getvalue()
    if path:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def load_exported(blob_or_path: Union[bytes, str]):
    """The callable ``fn(params, chunks)`` of an exported program (bytes from
    :func:`export_model`, or a path to them); its inputs lie on the device
    it was exported on. It runs under the f32 net's TF32 policy (off), as
    the model's own apply does: the policy is a global flag that the trace
    does not keep."""
    if isinstance(blob_or_path, (bytes, bytearray)):
        program = torch.export.load(io.BytesIO(bytes(blob_or_path)))
    else:
        program = torch.export.load(blob_or_path)
    module = program.module()

    def fn(params, chunks):
        # the f32 TF32 policy the model's apply sets around itself
        # (ops/prec.py): flags are read when ops run, not traced
        with torch.no_grad(), net_precision(None):
            return module(params, chunks)

    return fn
