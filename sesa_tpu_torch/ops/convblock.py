"""Fused conformer conv module (counterpart of sesa_tpu/ops/convblock.py).

``fused_conformer_conv`` is kernel K5: LayerNorm -> 1x1 (2e) -> GLU ->
depthwise conv of k taps -> eval BatchNorm -> swish -> 1x1 -> + x over
(b, n, d). On a CUDA tensor it launches the hand-written kernel chain of
``csrc/convblock.cu``; on a CPU tensor it runs ``fused_conformer_conv_plain``,
which repeats the TPU kernel's arithmetic with its bf16 rounding points.

The depthwise padding is the lucidrains conformer's, (k // 2 before,
k // 2 - (k + 1) % 2 after), as sesa_tpu/models/conformer_core.py
``_conv_apply``; for even k the Pallas kernel's (k - 1) // 2 left offset
(convblock.py:53) is one frame off, and the port does not copy it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sesa_tpu_torch.ops import _build
from sesa_tpu_torch.ops.ff import layer_norm_rounded


def conv_pad(kernel: int):
    """(before, after) zero padding of the depthwise conv along the sequence."""
    return kernel // 2, kernel // 2 - (kernel + 1) % 2


def conv_weights(p, dtype):
    """The conv subtree ``p`` (norm/pw1/dw/bn/pw2, torch layouts) as the
    kernel takes it: w1 (2e, d), b1 (2e,), taps (k, e), the eval BatchNorm
    folded with the depthwise bias into scale, shift (e,) in f32 and rounded
    to ``dtype`` (sesa_tpu/ops/convblock.py:126-133), w2 (d, e), b2 (d,)."""
    f32 = torch.float32
    bn = p["bn"]
    scale = bn["weight"].to(f32) * torch.rsqrt(bn["running_var"].to(f32) + 1e-5)
    shift = (bn["bias"].to(f32) - bn["running_mean"].to(f32) * scale
             + p["dw"]["bias"].to(f32) * scale)
    return (p["pw1"]["weight"][:, :, 0], p["pw1"]["bias"],
            p["dw"]["weight"][:, 0, :].T, scale.to(dtype), shift.to(dtype),
            p["pw2"]["weight"][:, :, 0], p["pw2"]["bias"])


def fused_conformer_conv_plain(x, p):
    """Plain PyTorch K5 with the TPU kernel's rounding points: xn after
    LayerNorm·γ + β, the GLU output, the BN scale and shift, y after the
    swish, and the output before the residual add; products and the
    depthwise sums (in tap order) in f32."""
    dt = x.dtype
    f32 = torch.float32
    n = x.shape[-2]
    w1, b1, taps, scale, shift, w2, b2 = conv_weights(p, dt)
    xn = layer_norm_rounded(x, p["norm"]["weight"], p["norm"]["bias"])
    h = xn.to(f32) @ w1.to(f32).T + b1.to(f32)
    e = h.shape[-1] // 2
    glu = (h[..., :e] * torch.sigmoid(h[..., e:])).to(dt)
    before, after = conv_pad(taps.shape[0])
    gp = F.pad(glu.to(f32), (0, 0, before, after))
    taps = taps.to(dt).to(f32)
    acc = torch.zeros(glu.shape, dtype=f32, device=x.device)
    for t in range(taps.shape[0]):
        acc = acc + gp[..., t:t + n, :] * taps[t]
    y = acc * scale.to(f32) + shift.to(f32)
    y = (y * torch.sigmoid(y)).to(dt)
    out = (y.to(f32) @ w2.to(f32).T + b2.to(f32)).to(dt)
    return out + x


def fused_conformer_conv(x, p):
    """x (b, n, d) -> x + conv_module(x) for the conformer conv params ``p``:
    kernel K5.

    CPU tensors run :func:`fused_conformer_conv_plain`. CUDA tensors must be
    bf16 with d and e multiples of 64 and at most 32 taps; anything else
    raises. Each call adds one to ``fused_conformer_conv.launches``.
    """
    if x.device.type == "cpu":
        return fused_conformer_conv_plain(x, p)
    b, n, d = x.shape
    w1, b1, taps, scale, shift, w2, b2 = conv_weights(p, x.dtype)
    e, k = w2.shape[1], taps.shape[0]
    if d % 64 or e % 64 or k > 32 or w1.shape != (2 * e, d):
        raise ValueError(f"fused_conformer_conv: unsupported d={d}, e={e}, kernel={k} (the "
                         "kernel takes d and e multiples of 64 and at most 32 taps)")
    tokens = b * n
    if -(-tokens // 128) > 65535 or b > 65535:
        raise ValueError(f"fused_conformer_conv: {b} sequences of {n} exceed one launch")
    # interleave the a and g rows of W1 (a0, g0, a1, g1, ...): each thread of
    # the GEMM epilogue then holds one (a, g) pair
    w1i = w1.reshape(2, e, d).transpose(0, 1).reshape(2 * e, d).contiguous()
    b1i = b1.reshape(2, e).T.reshape(2 * e).contiguous()
    taps, w2 = taps.contiguous(), w2.contiguous()
    ln_w, ln_b = p["norm"]["weight"], p["norm"]["bias"]
    for name, t, shape in (("x", x, (b, n, d)), ("norm.weight", ln_w, (d,)),
                           ("norm.bias", ln_b, (d,)), ("w1", w1i, (2 * e, d)),
                           ("b1", b1i, (2 * e,)), ("taps", taps, (k, e)),
                           ("scale", scale, (e,)), ("shift", shift, (e,)),
                           ("w2", w2, (d, e)), ("b2", b2, (d,))):
        _build.check_tensor("fused_conformer_conv", name, t, shape, torch.bfloat16)

    lib = _build.load("convblock")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    xn = torch.empty((tokens, d), dtype=x.dtype, device=x.device)
    glu = torch.empty((tokens, e), dtype=x.dtype, device=x.device)
    y = torch.empty((tokens, e), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    _build.check(lib.sesa_conv_up(x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), xn.data_ptr(),
                                  w1i.data_ptr(), b1i.data_ptr(), glu.data_ptr(), tokens, d,
                                  2 * e, stream), "sesa_conv_up")
    _build.check(lib.sesa_conv_dw(glu.data_ptr(), taps.data_ptr(), scale.data_ptr(),
                                  shift.data_ptr(), y.data_ptr(), b, n, e, k, stream),
                 "sesa_conv_dw")
    _build.check(lib.sesa_conv_down(y.data_ptr(), w2.data_ptr(), b2.data_ptr(), x.data_ptr(),
                                    out.data_ptr(), tokens, d, e, stream), "sesa_conv_down")
    fused_conformer_conv.launches += 1
    return out


fused_conformer_conv.launches = 0
