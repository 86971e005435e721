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


def conv2d(x, weight, bias=None, stride=(1, 1), padding=(0, 0), groups=1) -> torch.Tensor:
    """torch nn.Conv2d on NCHW input with OIHW weight."""
    return torch.nn.functional.conv2d(x, weight, bias, stride=tuple(stride),
                                      padding=tuple(padding), groups=groups)


def conv_transpose2d(x, weight, bias=None, stride=(1, 1), padding=(0, 0)) -> torch.Tensor:
    """torch nn.ConvTranspose2d on NCHW with IOHW weight, no output padding:
    each spatial size comes out (n - 1)·stride + kernel - 2·padding."""
    return torch.nn.functional.conv_transpose2d(x, weight, bias, stride=tuple(stride),
                                                padding=tuple(padding))


def conv_transpose2d_block(x, weight) -> torch.Tensor:
    """torch nn.ConvTranspose2d with kernel_size == stride and no bias (IOHW
    weight): every input pixel expands to its own kernel-sized block."""
    return conv_transpose2d(x, weight, stride=weight.shape[2:])


def gelu(x: torch.Tensor) -> torch.Tensor:
    """torch nn.GELU default (the exact erf form)."""
    return torch.nn.functional.gelu(x)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def elu(x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    return torch.where(x > 0, x, alpha * (torch.exp(x) - 1.0))


def prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """torch nn.PReLU with its default single shared parameter (weight
    shape (1,)): max(0, x) + alpha·min(0, x). A per-channel alpha
    broadcasts over x's trailing axes, not over dim 1 as torch's does: a
    caller that needs that reshapes alpha itself."""
    return torch.clamp_min(x, 0) + alpha * torch.clamp_max(x, 0)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


def glu(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """torch nn.GLU: split in half along ``dim``, first · sigmoid(second)."""
    a, b = x.chunk(2, dim=dim)
    return a * torch.sigmoid(b)


_LSTM_KEYS = ("weight_ih", "weight_hh", "bias_ih", "bias_hh")


def _lstm(x, weights, bidirectional):
    """torch.lstm (cuDNN on the card) over batch-first x (B, T, D) from zero
    state; ``weights`` in nn.LSTM's flat order."""
    h = weights[1].shape[1]
    dirs = 2 if bidirectional else 1
    zero = x.new_zeros((dirs, x.shape[0], h))
    return torch.lstm(x, (zero, zero), weights, True, 1, 0.0, False, bidirectional, True)[0]


def lstm(x: torch.Tensor, params, reverse: bool = False) -> torch.Tensor:
    """Single-layer unidirectional LSTM over (B, T, D) -> (B, T, H), torch
    weight layout and gate order (input, forget, cell, output): weight_ih
    (4H, D), weight_hh (4H, H), bias_ih and bias_hh (4H,). ``reverse`` runs
    it from the last step to the first."""
    weights = [params[k] for k in _LSTM_KEYS]
    if not reverse:
        return _lstm(x, weights, False)
    return _lstm(x.flip(1), weights, False).flip(1)


def bilstm(x: torch.Tensor, params) -> torch.Tensor:
    """Bidirectional LSTM: ``params`` has ``fwd`` and ``bwd`` sub-dicts; the
    two directions' outputs are concatenated on H. One call of torch.lstm
    runs both."""
    weights = [params[d][k] for d in ("fwd", "bwd") for k in _LSTM_KEYS]
    return _lstm(x, weights, True)


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


def instance_norm2d(x: torch.Tensor, params, eps: float = 1e-5) -> torch.Tensor:
    """torch nn.InstanceNorm2d(affine=True) on NCHW, per sample and channel.
    The statistics are f32 whatever the dtype of x; the normalised value is
    rounded to x's dtype before the affine (sesa_tpu layers.instance_norm2d;
    ``F.instance_norm`` rounds elsewhere in bf16)."""
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=(2, 3), keepdim=True, unbiased=False)
    y = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    return y * params["weight"][None, :, None, None] + params["bias"][None, :, None, None]


def batch_norm2d(x: torch.Tensor, params, eps: float = 1e-5) -> torch.Tensor:
    """torch nn.BatchNorm2d in eval mode (running statistics). The folded
    scale and shift are computed in f32, then rounded to x's dtype."""
    scale = params["weight"].float() * torch.rsqrt(params["running_var"].float() + eps)
    shift = params["bias"].float() - params["running_mean"].float() * scale
    scale, shift = scale.to(x.dtype), shift.to(x.dtype)
    return x * scale[None, :, None, None] + shift[None, :, None, None]


def make_norm2d(norm_type: str):
    """(apply_fn(x, params), has_params) for the reference's norm strings
    (``BatchNorm``, ``InstanceNorm``, ``GroupNorm<g>``; anything else is the
    identity)."""
    if norm_type == "BatchNorm":
        return batch_norm2d, True
    if norm_type == "InstanceNorm":
        return instance_norm2d, True
    if norm_type and "GroupNorm" in norm_type:
        g = int(norm_type.replace("GroupNorm", ""))
        return (lambda x, p: group_norm(x, p, g)), True
    return (lambda x, p: x), False


def make_act(act_type: str):
    """The activation of the reference's act strings: ``gelu``, ``relu``,
    ``elu`` or ``elu<alpha>``."""
    if act_type == "gelu":
        return gelu
    if act_type == "relu":
        return relu
    if act_type[:3] == "elu":
        alpha = float(act_type.replace("elu", "")) if act_type != "elu" else 1.0
        return lambda x: elu(x, alpha)
    raise ValueError(f"unknown activation: {act_type}")
