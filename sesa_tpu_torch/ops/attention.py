"""Attention for the roformer family (counterpart of sesa_tpu/ops/attention.py).

``sdpa`` is the plain einsum pair with an f32 softmax. ``fused_attention_block``
is kernel K1: the whole roformer attention block (RMSNorm, qkv, rope,
attention, per-head gates, out projection, residual). On a CUDA tensor it
launches the hand-written kernel chain of ``csrc/attention.cu``; on a CPU
tensor it runs ``fused_attention_block_plain``, which repeats the TPU
kernel's arithmetic with its bf16 rounding points.
"""

from __future__ import annotations

from typing import Optional

import torch

from sesa_tpu_torch.ops import _build
from sesa_tpu_torch.ops.rope import apply_rope


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q·kᵀ·scale)·v over (..., heads, seq, dim_head), f32 softmax."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    sim = torch.einsum("...id,...jd->...ij", q, k) * scale
    attn = torch.softmax(sim.float(), dim=-1).to(q.dtype)
    return torch.einsum("...ij,...jd->...id", attn, v)


def l2norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """torch F.normalize semantics (norm clamped at eps)."""
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)


def fused_attention_block_plain(x, gamma, wqkv, wg, bg, wo, heads, scale, rope=None):
    """Plain PyTorch K1 with the TPU kernel's rounding points.

    x (b, n, d); weights in torch (out, in) layout: wqkv (3·h·dh, d),
    wg (h, d), bg (h,), wo (d, h·dh); rope = (cos, sin) of shape (n, w ≤ dh).
    Products accumulate in f32. In the working dtype ``dt`` the values are
    rounded where sesa_tpu/ops/attention.py ``_attn_block_kernel`` rounds
    them: xn after norm·γ, qkv after the projection, the rope products and
    sum, p before P·V, the attention output, ao ⊙ gate, and the output
    before the residual add.
    """
    dt = x.dtype
    b, n, d = x.shape
    dh = wqkv.shape[0] // (3 * heads)
    f32 = torch.float32

    xf = x.to(f32)
    nrm = torch.linalg.vector_norm(xf, dim=-1, keepdim=True)
    xn = ((xf * (d ** 0.5)) / nrm.clamp_min(1e-12)).to(dt) * gamma.to(dt)
    qkv = (xn.to(f32) @ wqkv.to(f32).T).to(dt)
    sig = torch.sigmoid(xn.to(f32) @ wg.to(f32).T + bg.to(f32))  # (b, n, h)

    q, k, v = qkv.reshape(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4)  # (b, h, n, dh)
    if rope is not None:
        cos, sin = (r.to(dt) for r in rope)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    s = (q.to(f32) @ k.to(f32).transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(dt)
    o = (p.to(f32) @ v.to(f32)).to(dt)  # (b, h, n, dh)
    ao = o * sig.to(dt).permute(0, 2, 1)[..., None]
    ao = ao.permute(0, 2, 1, 3).reshape(b, n, heads * dh)
    out = (ao.to(f32) @ wo.to(f32).T).to(dt)
    return out + x


def fused_attention_block(x, gamma, wqkv, wg, bg, wo, heads, scale, rope=None):
    """x (b, n, d) -> x + gated-attention(rms_norm(x)): kernel K1.

    CPU tensors run :func:`fused_attention_block_plain`. CUDA tensors must be
    bf16, contiguous, with d and h·dh multiples of 64 and dh in {32, 64};
    anything else raises. Each call adds one to
    ``fused_attention_block.launches``.
    """
    if x.device.type == "cpu":
        return fused_attention_block_plain(x, gamma, wqkv, wg, bg, wo, heads, scale, rope)
    b, n, d = x.shape
    hd = wqkv.shape[0] // 3
    dh = hd // heads
    if dh not in (32, 64) or d % 64 or hd % 64 or wqkv.shape[0] != 3 * hd:
        raise ValueError(f"fused_attention_block: unsupported d={d}, heads={heads}, "
                         f"dim_head={dh} (the kernel takes dim_head 32 or 64 and d, "
                         "heads * dim_head multiples of 64)")
    tokens = b * n
    if -(-tokens // 128) > 65535 or b > 65535:
        raise ValueError(f"fused_attention_block: {b} sequences of {n} exceed one launch")
    for name, t, shape in (("x", x, (b, n, d)), ("gamma", gamma, (d,)),
                           ("wqkv", wqkv, (3 * hd, d)), ("wg", wg, (heads, d)),
                           ("bg", bg, (heads,)), ("wo", wo, (d, hd))):
        _build.check_tensor("fused_attention_block", name, t, shape, torch.bfloat16)
    cos_p = sin_p = None
    w = 0
    if rope is not None:
        cos, sin = rope
        w = cos.shape[-1]
        if w % 2 or w > dh:
            raise ValueError(f"fused_attention_block: rotary width {w} must be even and <= {dh}")
        for name, t in (("cos", cos), ("sin", sin)):
            _build.check_tensor("fused_attention_block", name, t, (n, w), torch.bfloat16)
        cos_p, sin_p = cos.data_ptr(), sin.data_ptr()

    lib = _build.load("attention")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    xn = torch.empty((tokens, d), dtype=x.dtype, device=x.device)
    qkv = torch.empty((tokens, 3 * hd), dtype=x.dtype, device=x.device)
    gates = torch.empty((tokens, heads), dtype=torch.float32, device=x.device)
    ao = torch.empty((tokens, hd), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    _build.check(lib.sesa_attn_proj(x.data_ptr(), gamma.data_ptr(), xn.data_ptr(),
                                    wqkv.data_ptr(),
                                    wg.data_ptr(), bg.data_ptr(), cos_p, sin_p,
                                    qkv.data_ptr(), gates.data_ptr(), tokens, d, heads, dh,
                                    n, w, stream), "sesa_attn_proj")
    _build.check(lib.sesa_attn_core(qkv.data_ptr(), gates.data_ptr(), ao.data_ptr(), b, n,
                                    heads, dh, float(scale), stream), "sesa_attn_core")
    _build.check(lib.sesa_attn_out(ao.data_ptr(), wo.data_ptr(), x.data_ptr(),
                                   out.data_ptr(), tokens, d, hd, stream), "sesa_attn_out")
    fused_attention_block.launches += 1
    return out


fused_attention_block.launches = 0
