"""PyTorch checkpoint -> the port's parameter tree (counterpart of
sesa_tpu/convert/torch_ckpt.py).

Unwraps ``state`` / ``state_dict`` / ``model`` containers, strips
DataParallel ``module.`` prefixes, and reports files that are HTML error
pages instead of checkpoints.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Load a .pt/.ckpt/.chpt file into {key: CPU tensor} (bf16 as f32)."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint not found: {path}")
    size = os.path.getsize(path)
    if size < 1024:
        raise ValueError(f"checkpoint file is only {size} bytes, likely a failed "
                         f"download (HTML error page); re-download it: {path}")
    with open(path, "rb") as f:
        head = f.read(256).lstrip().lower()
    if head.startswith((b"<!doctype", b"<html")):
        raise ValueError(f"checkpoint is an HTML page, not model weights; the URL "
                         f"probably needs the /blob/ -> /resolve/ fix: {path}")
    sd = unwrap_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    if not isinstance(sd, dict):
        raise ValueError(f"unsupported checkpoint structure in {path}: {type(sd)}")
    return sd


def unwrap_state_dict(obj):
    """The state dict inside a ``state`` (the demucs package's htdemucs
    files), ``state_dict`` or ``model`` container, DataParallel ``module.``
    prefixes stripped, numpy arrays as tensors, other entries dropped, bf16
    as f32."""
    for key in ("state", "state_dict", "model"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
    if not isinstance(obj, dict):
        return obj
    out = {}
    for k, v in obj.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(v)
        if not isinstance(v, torch.Tensor):
            continue  # schedulers, counters, ...
        if k.startswith("module."):
            k = k[len("module."):]
        v = v.detach()
        out[k] = v.float() if v.dtype == torch.bfloat16 else v
    return out


def convert_checkpoint(model_type: str, state_dict, config):
    """Dispatch to the model's converter; ``state_dict`` may still be in its
    container (an htdemucs file's ``{"state": ...}``)."""
    from sesa_tpu_torch.models import get_model

    return get_model(model_type).convert_torch(unwrap_state_dict(state_dict), config)
