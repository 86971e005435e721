"""Shared building blocks (counterpart of sesa_tpu/models/layers.py; only
what the ported models need)."""

from __future__ import annotations

import math

import torch


def kaiming_uniform(shape, fan_in: int, generator: torch.Generator,
                    dtype=torch.float32) -> torch.Tensor:
    """torch-style fan-in uniform U(-1/sqrt(fan_in), 1/sqrt(fan_in)), drawn
    on the CPU from ``generator``."""
    bound = math.sqrt(1.0 / fan_in) if fan_in > 0 else 0.0
    u = torch.rand(tuple(shape), generator=generator, dtype=dtype)
    return (u * 2.0 - 1.0) * bound


def rms_norm(x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """lucidrains RMSNorm: F.normalize(x, dim=-1) * sqrt(dim) * gamma.

    l2-normalisation with the norm clamped at 1e-12 (torch F.normalize), not
    a mean-square norm with eps added.
    """
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / norm.clamp_min(1e-12) * (x.shape[-1] ** 0.5) * gamma


def layer_norm(x: torch.Tensor, params, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with the biased variance; ``params``
    holds ``weight`` and optionally ``bias`` (or is None)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    y = (x - mean) * torch.rsqrt(var + eps)
    if params is not None and "weight" in params:
        y = y * params["weight"]
        if "bias" in params:
            y = y + params["bias"]
    return y


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def linear(x: torch.Tensor, params) -> torch.Tensor:
    """torch nn.Linear: weight (out, in), optional bias (out,)."""
    return torch.nn.functional.linear(x, params["weight"], params.get("bias"))


def conv1d(x, weight, bias=None, stride=1, padding=0, groups=1) -> torch.Tensor:
    """torch nn.Conv1d on (B, C, T) with (O, I/g, K) weight."""
    return torch.nn.functional.conv1d(x, weight, bias, stride=stride, padding=padding,
                                      groups=groups)


def group_norm(x: torch.Tensor, params, num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """torch nn.GroupNorm on (B, C, *spatial) for any spatial rank. The
    statistics are f32 whatever the dtype of x; the normalised value is
    rounded to x's dtype before the affine."""
    b, c = x.shape[:2]
    xg = x.reshape(b, num_groups, -1).float()
    var, mean = torch.var_mean(xg, dim=-1, keepdim=True, unbiased=False)
    y = ((xg - mean) * torch.rsqrt(var + eps)).to(x.dtype).reshape(x.shape)
    shape = (1, c) + (1,) * (x.ndim - 2)
    return y * params["weight"].reshape(shape) + params["bias"].reshape(shape)
