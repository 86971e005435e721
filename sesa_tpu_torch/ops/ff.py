"""Fused transformer FeedForward (counterpart of sesa_tpu/ops/ff.py).

``fused_ff_residual`` is kernel K2: rms -> Linear -> tanh-GELU -> Linear
(× out_scale) -> + x over (tokens, dim). On a CUDA tensor it launches the
hand-written kernel chain of ``csrc/ff.cu``; on a CPU tensor it runs
``fused_ff_residual_plain``, which repeats the TPU kernel's arithmetic with
its bf16 rounding points.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sesa_tpu_torch.ops import _build


def fused_ff_residual_plain(x, gamma, w1, b1, w2, b2, *, out_scale=1.0):
    """Plain PyTorch K2 (rms norm, tanh-GELU) with the TPU kernel's rounding
    points: xn after norm·γ, h after the GELU (sesa_tpu/ops/ff.py:55) and y
    before the residual add (ff.py:71); products accumulate in f32."""
    dt = x.dtype
    f32 = torch.float32
    xf = x.to(f32)
    nrm = torch.linalg.vector_norm(xf, dim=-1, keepdim=True)
    xn = (xf * ((x.shape[-1] ** 0.5) / nrm.clamp_min(1e-12))).to(dt) * gamma.to(dt)
    h = xn.to(f32) @ w1.to(f32).T + b1.to(f32)
    h = F.gelu(h, approximate="tanh").to(dt)
    y = h.to(f32) @ w2.to(f32).T + b2.to(f32)
    if out_scale != 1.0:
        y = y * out_scale
    return y.to(dt) + x


def fused_ff_residual(x, gamma, w1, b1, w2, b2, *, out_scale=1.0):
    """x (tokens, dim) -> x + out_scale·(W₂·gelu_tanh(W₁·rms(x)+b₁)+b₂): kernel K2.

    Weights stay in torch (out_features, in_features) layout. CPU tensors run
    :func:`fused_ff_residual_plain`. CUDA tensors must be bf16 and contiguous
    with dim and hidden multiples of 64; anything else raises. Each call adds
    one to ``fused_ff_residual.launches``.
    """
    if x.device.type == "cpu":
        return fused_ff_residual_plain(x, gamma, w1, b1, w2, b2, out_scale=out_scale)
    tokens, dim = x.shape
    hidden = w1.shape[0]
    if dim % 64 or hidden % 64:
        raise ValueError(f"fused_ff_residual: dim {dim} and hidden {hidden} must be "
                         "multiples of 64")
    if -(-tokens // 128) > 65535:
        raise ValueError(f"fused_ff_residual: {tokens} tokens exceed one launch")
    for name, t, shape in (("x", x, (tokens, dim)), ("gamma", gamma, (dim,)),
                           ("w1", w1, (hidden, dim)), ("b1", b1, (hidden,)),
                           ("w2", w2, (dim, hidden)), ("b2", b2, (dim,))):
        _build.check_tensor("fused_ff_residual", name, t, shape, torch.bfloat16)

    lib = _build.load("ff")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    xn = torch.empty_like(x)
    h = torch.empty((tokens, hidden), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    _build.check(lib.sesa_ff_up(x.data_ptr(), gamma.data_ptr(), xn.data_ptr(), w1.data_ptr(),
                                b1.data_ptr(), h.data_ptr(), tokens, dim, hidden,
                                stream), "sesa_ff_up")
    _build.check(lib.sesa_ff_down(h.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                                  x.data_ptr(), out.data_ptr(), tokens, dim, hidden,
                                  float(out_scale), stream), "sesa_ff_down")
    fused_ff_residual.launches += 1
    return out


fused_ff_residual.launches = 0
