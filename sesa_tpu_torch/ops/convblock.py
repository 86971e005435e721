"""Fused depthwise-conv blocks (counterpart of sesa_tpu/ops/convblock.py).

``fused_conformer_conv`` is kernel K5: LayerNorm -> 1x1 (2e) -> GLU ->
depthwise conv of k taps -> eval BatchNorm -> swish -> 1x1 -> + x over
(b, n, d). ``fused_apollo_conv`` is kernel K6, the Apollo ICB block:
depthwise conv of k taps -> RMSNorm -> 1x1 (4d) -> SiLU -> 1x1 -> + x. On a
CUDA tensor each launches its hand-written kernel chain (``csrc/convblock.cu``,
``csrc/apollo_conv.cu``); on a CPU tensor it runs its ``*_plain`` version,
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
from sesa_tpu_torch.ops.ff import ff_gemm_schedule, layer_norm_rounded


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


def fused_apollo_conv_plain(x, p, eps: float = 1e-5):
    """Plain PyTorch K6 with the TPU kernel's rounding points
    (sesa_tpu/ops/convblock.py:179-197): the taps summed in f32 in tap order,
    conv + b_dw rounded before the norm, the mean of squares in f32 over that
    rounded row, the normalised row rounded and then multiplied by γ in the
    working dtype, h after the SiLU, and the output before the residual add.
    Zero padding of (k - 1) // 2 rows at both ends of each sequence (k odd)."""
    dt = x.dtype
    f32 = torch.float32
    n = x.shape[-2]
    taps = p["dw_w"][:, 0, :].T.to(dt).to(f32)  # (k, d)
    k = taps.shape[0]
    if k % 2 == 0:
        raise ValueError(f"fused_apollo_conv: the kernel size must be odd, got {k}")
    xp = F.pad(x.to(f32), (0, 0, (k - 1) // 2, (k - 1) // 2))
    acc = torch.zeros(x.shape, dtype=f32, device=x.device)
    for t in range(k):
        acc = acc + xp[..., t:t + n, :] * taps[t]
    y = (acc + p["dw_b"].to(dt).to(f32)).to(dt)
    yf = y.to(f32)
    yn = (yf * torch.rsqrt((yf * yf).mean(dim=-1, keepdim=True) + eps)).to(dt) * p["norm"].to(dt)
    h = yn.to(f32) @ p["pw1_w"].to(dt).to(f32).T + p["pw1_b"].to(dt).to(f32)
    h = (h * torch.sigmoid(h)).to(dt)
    out = (h.to(f32) @ p["pw2_w"].to(dt).to(f32).T + p["pw2_b"].to(dt).to(f32)).to(dt)
    return out + x


def k6_gemm_grids(tokens: int, d: int, hidden: int, sms: int):
    """The persistent grids of K6's up product (tokens, hidden) at depth d and
    down product (tokens, d) at depth hidden, both on ``csrc/gemm_ws.cuh``
    (:func:`ff_gemm_schedule`)."""
    return ff_gemm_schedule(tokens, hidden, sms)[1], ff_gemm_schedule(tokens, d, sms)[1]


def fused_apollo_conv(x, p):
    """x (b, n, d) -> x + ConvActNorm(x) for an Apollo seq_net block ``p``
    (dw_w (d, 1, k), dw_b, norm, pw1_w (4d, d), pw1_b, pw2_w (d, 4d), pw2_b,
    torch layouts): kernel K6.

    CPU tensors run :func:`fused_apollo_conv_plain`. CUDA tensors must be
    bf16 with d and the hidden width multiples of 64 and an odd kernel of at
    most 31 taps; anything else raises. Each call adds one to
    ``fused_apollo_conv.launches``.
    """
    if x.device.type == "cpu":
        return fused_apollo_conv_plain(x, p)
    b, n, d = x.shape
    w1, w2 = p["pw1_w"], p["pw2_w"]
    hidden, k = w1.shape[0], p["dw_w"].shape[-1]
    if d % 64 or hidden % 64 or k % 2 == 0 or k > 31 or d > 512:
        raise ValueError(f"fused_apollo_conv: unsupported d={d}, hidden={hidden}, kernel={k} "
                         "(the kernel takes d <= 512 and hidden multiples of 64 and an odd "
                         "kernel of at most 31 taps)")
    tokens = b * n
    if -(-tokens // 128) > 65535:
        raise ValueError(f"fused_apollo_conv: {b} sequences of {n} exceed one launch")
    taps = p["dw_w"][:, 0, :].T.contiguous()  # (k, d)
    for name, t, shape in (("x", x, (b, n, d)), ("dw_w", taps, (k, d)), ("dw_b", p["dw_b"], (d,)),
                           ("norm", p["norm"], (d,)), ("pw1_w", w1, (hidden, d)),
                           ("pw1_b", p["pw1_b"], (hidden,)), ("pw2_w", w2, (d, hidden)),
                           ("pw2_b", p["pw2_b"], (d,))):
        _build.check_tensor("fused_apollo_conv", name, t, shape, torch.bfloat16)

    lib = _build.load("apollo_conv")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    up_grid, down_grid = k6_gemm_grids(tokens, d, hidden, torch.cuda.get_device_properties(
        x.device).multi_processor_count)
    xn = torch.empty((tokens, d), dtype=x.dtype, device=x.device)
    h = torch.empty((tokens, hidden), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    _build.check(lib.sesa_apollo_dw(x.data_ptr(), taps.data_ptr(), p["dw_b"].data_ptr(),
                                    p["norm"].data_ptr(), xn.data_ptr(), b, n, d, k, 1e-5,
                                    stream), "sesa_apollo_dw")
    _build.check(lib.sesa_apollo_up(xn.data_ptr(), w1.data_ptr(), p["pw1_b"].data_ptr(),
                                    h.data_ptr(), tokens, d, hidden, up_grid, stream),
                 "sesa_apollo_up")
    _build.check(lib.sesa_apollo_down(h.data_ptr(), w2.data_ptr(), p["pw2_b"].data_ptr(),
                                      x.data_ptr(), out.data_ptr(), tokens, d, hidden, down_grid,
                                      stream), "sesa_apollo_down")
    fused_apollo_conv.launches += 1
    return out


fused_apollo_conv.launches = 0
