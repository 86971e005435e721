"""Attention for the roformer and conformer families (counterpart of
sesa_tpu/ops/attention.py).
``sdpa`` is the einsum pair with an f32 softmax; long bf16 sequences on CUDA go
to ``vmem_attention``, kernel K3: whole-sequence attention over (BH, S, D).
``fused_attention_block`` is kernel K1: the whole roformer attention block
(RMSNorm, qkv, rope, attention, per-head gates, out projection, residual),
with the value-residual modes of the experimental roformers.
``fused_conformer_attention`` is kernel K4: the conformer attention block
(LayerNorm, qkv, attention with the Shaw relative-position bias, out
projection with bias, residual). ``fused_rope_attention`` is kernel K7: rope
and attention over the qkv projection's packed output. On a CUDA tensor each
launches its hand-written kernel or chain (``csrc/attention.cu``,
``csrc/vmem_attention.cu``, ``csrc/conformer_attention.cu``,
``csrc/rope_attention.cu``); on a CPU tensor
it runs its ``*_plain`` version, which repeats the TPU kernel's arithmetic
with its bf16 rounding points.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sesa_tpu_torch.ops import _build
from sesa_tpu_torch.ops.ff import layer_norm_rounded
from sesa_tpu_torch.ops.rope import apply_rope


_K3_MIN_SEQ, _K3_MAX_SEQ = 256, 2048
_K3_DIM_HEADS = (32, 64, 128)


def use_vmem_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """The gate of kernel K3, on device, dtype and shape only: CUDA bf16
    q, k, v of one shape (..., S, D) with 256 <= S <= 2048 and D in
    {32, 64, 128}."""
    return (q.device.type == "cuda" and q.dtype == k.dtype == v.dtype == torch.bfloat16
            and q.ndim >= 3 and q.shape == k.shape == v.shape
            and _K3_MIN_SEQ <= q.shape[-2] <= _K3_MAX_SEQ and q.shape[-1] in _K3_DIM_HEADS)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q·kᵀ·scale)·v over (..., heads, seq, dim_head), f32 softmax.

    Tensors that :func:`use_vmem_attention` takes run kernel K3; everything
    else (the CPU, f32, short or very long sequences, other head widths, a
    key length that differs from the query length) runs the einsum pair.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if use_vmem_attention(q, k, v):
        return vmem_attention(q, k, v, scale)
    sim = torch.einsum("...id,...jd->...ij", q, k) * scale
    attn = torch.softmax(sim.float(), dim=-1).to(q.dtype)
    return torch.einsum("...ij,...jd->...id", attn, v)


def vmem_attention_plain(q, k, v, scale):
    """Plain PyTorch K3 with the TPU kernel's rounding points
    (sesa_tpu/ops/attention.py:119-134): q·kᵀ and the softmax in f32 (the
    einsum branch of ``sdpa`` rounds the scores to the working dtype first),
    p rounded to the working dtype before p·v, the f32 product rounded on
    the way out. Leading dims run in slices that keep the f32 scores near
    256 MB."""
    dt, f32 = q.dtype, torch.float32
    lead, (s, d) = q.shape[:-2], q.shape[-2:]
    q, k, v = (t.reshape(-1, s, d) for t in (q, k, v))
    step = max(1, 2 ** 26 // (s * s))
    outs = []
    for s0 in range(0, q.shape[0], step):
        sim = (q[s0:s0 + step].to(f32) @ k[s0:s0 + step].to(f32).transpose(-1, -2)) * scale
        p = torch.softmax(sim, dim=-1).to(dt)
        outs.append((p.to(f32) @ v[s0:s0 + step].to(f32)).to(dt))
    return torch.cat(outs).reshape(lead + (s, d))


def _bh_strides(t):
    """(batch, head, row) strides in elements of a (b, h, s, d) tensor the
    kernel can read where it lies (unit stride along d, 16-byte aligned rows
    and base), else None."""
    sb, sh, ss, sd = t.stride()
    if sd != 1 or sb % 8 or sh % 8 or ss % 8 or t.data_ptr() % 16:
        return None
    return sb, sh, ss


def vmem_attention(q, k, v, scale):
    """softmax(q·kᵀ·scale)·v over (..., S, D): kernel K3.

    CPU tensors run :func:`vmem_attention_plain`. CUDA tensors must be bf16,
    of one shape, with D in {32, 64, 128}; anything else raises. 4-D
    (b, h, s, d) tensors are read through their strides (the roformer hands
    permuted views of the qkv projection), and the output of such views is
    laid out (b, s, h, d) in memory, the layout the out projection reads,
    and returned as its (b, h, s, d) view; other inputs are copied to
    contiguous (BH, S, D) first. Each call adds one to
    ``vmem_attention.launches``.
    """
    if q.device.type == "cpu":
        return vmem_attention_plain(q, k, v, scale)
    s, d = q.shape[-2:]
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16) or not (q.shape == k.shape == v.shape) \
            or d not in _K3_DIM_HEADS or q.ndim < 3 or s < 1:
        raise ValueError(f"vmem_attention: unsupported q {q.dtype} {tuple(q.shape)}, k "
                         f"{k.dtype} {tuple(k.shape)}, v {v.dtype} {tuple(v.shape)} (the kernel "
                         "takes bf16 tensors of one shape with dim_head 32, 64 or 128)")
    strides = [_bh_strides(t) for t in (q, k, v)] if q.ndim == 4 else [None]
    if all(st is not None for st in strides) and not q.is_contiguous():
        b, h = q.shape[:2]
        out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
        ostr = (s * h * d, d, h * d)
        result = out.permute(0, 2, 1, 3)
    else:
        lead = q.shape[:-2]
        q, k, v = (t.reshape(-1, s, d).contiguous() for t in (q, k, v))
        b, h = q.shape[0], 1
        strides = [(s * d, 0, d)] * 3
        out = torch.empty_like(q)
        ostr = (s * d, 0, d)
        result = out.view(lead + (s, d))
    if b * h * -(-s // 64) > 2 ** 31 - 1 or b * h < 1:
        raise ValueError(f"vmem_attention: {b * h} sequences of {s} exceed one launch")
    lib = _build.load("vmem_attention")
    flat = [x for st in strides for x in st]
    _build.check(lib.sesa_vmem_attn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                    *flat, *ostr, b, h, s, d, float(scale),
                                    torch.cuda.current_stream(q.device).cuda_stream),
                 "sesa_vmem_attn")
    vmem_attention.launches += 1
    return result


vmem_attention.launches = 0


def l2norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """torch F.normalize semantics (norm clamped at eps)."""
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)


def fused_attention_block_plain(x, gamma, wqkv, wg, bg, wo, heads, scale, rope=None,
                                vr=None, add_residual=True):
    """Plain PyTorch K1 with the TPU kernel's rounding points.

    x (b, n, d); weights in torch (out, in) layout: wqkv (3·h·dh, d),
    wg (h, d), bg (h,), wo (d, h·dh); rope = (cos, sin) of shape (n, w ≤ dh).
    ``vr`` and ``add_residual`` as in :func:`fused_attention_block`.
    Products accumulate in f32. In the working dtype ``dt`` the values are
    rounded where sesa_tpu/ops/attention.py ``_attn_block_kernel`` rounds
    them: xn after norm·γ, qkv after the projection, the lerped V, the rope
    products and sum, p before P·V, the attention output, ao ⊙ gate, and the
    output before the residual add.
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
    v_pre = None
    if vr is not None:
        wvr, bvr, v_first = vr
        v_pre = v.permute(0, 2, 1, 3).reshape(b, n, heads * dh).clone()
        if v_first is not None:
            mix = torch.sigmoid(xn.to(f32) @ wvr.to(f32).T + bvr.to(f32))  # (b, n, h)
            vres = v_first.reshape(b, n, heads, dh).permute(0, 2, 1, 3).to(f32)
            vf = v.to(f32)
            v = (vf + (vres - vf) * mix.permute(0, 2, 1)[..., None]).to(dt)
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
    if add_residual:
        out = out + x
    return out if vr is None else (out, v_pre)


_K1_DIM_HEADS = (32, 64)


def use_fused_attention(x: torch.Tensor, heads: int, dim_head: int) -> bool:
    """The gate of kernel K1, on device, dtype and shape only: a CUDA bf16
    x (..., n, d) with dim_head in {32, 64}, d and heads·dim_head multiples
    of 64, and a token count one launch covers. The roformer stacks run the
    unfused chain (``attention_apply``) for everything else."""
    n, d = x.shape[-2:]
    seqs = x.numel() // max(n * d, 1)
    return (x.device.type == "cuda" and x.dtype == torch.bfloat16
            and dim_head in _K1_DIM_HEADS and d % 64 == 0 and (heads * dim_head) % 64 == 0
            and 1 <= seqs <= 65535 and -(-(seqs * n) // 128) <= 65535)


def fused_attention_block(x, gamma, wqkv, wg, bg, wo, heads, scale, rope=None, vr=None,
                          add_residual=True):
    """x (b, n, d) -> x + gated-attention(rms_norm(x)): kernel K1.

    ``vr`` turns on value-residual learning: ``(wvr, bvr, v_first)`` with the
    mix projection wvr (h, d), bvr (h,) and the first layer's V as
    (b, n, h·dh), or ``v_first=None`` on the first layer (wvr and bvr are
    then not read). V is lerped toward ``v_first`` by the per-head
    sigmoid(wvr·x̂ + bvr), and the call returns ``(out, v_pre_mix)``, the
    pre-mix V as (b, n, h·dh). ``add_residual=False`` leaves x out of the
    sum (the new-style forward of the experimental roformers).

    CPU tensors run :func:`fused_attention_block_plain`. CUDA tensors must be
    bf16, contiguous, with d and h·dh multiples of 64 and dh in {32, 64}
    (:func:`use_fused_attention`); anything else raises. Each call adds one
    to ``fused_attention_block.launches`` and to its mode's entry of
    ``fused_attention_block.launches_by_mode`` (0: no ``vr``, 1: ``vr``
    without ``v_first``, 2: with it).
    """
    if x.device.type == "cpu":
        return fused_attention_block_plain(x, gamma, wqkv, wg, bg, wo, heads, scale, rope,
                                           vr=vr, add_residual=add_residual)
    b, n, d = x.shape
    hd = wqkv.shape[0] // 3
    dh = hd // heads
    if not use_fused_attention(x, heads, dh) or wqkv.shape[0] != 3 * hd:
        raise ValueError(f"fused_attention_block: unsupported {x.dtype} x {tuple(x.shape)}, "
                         f"heads={heads}, dim_head={dh} (the kernel takes bf16, dim_head 32 or "
                         "64, d and heads * dim_head multiples of 64, at most 65535 sequences)")
    tokens = b * n
    tensors = [("x", x, (b, n, d)), ("gamma", gamma, (d,)), ("wqkv", wqkv, (3 * hd, d)),
               ("wg", wg, (heads, d)), ("bg", bg, (heads,)), ("wo", wo, (d, hd))]
    v_first = None
    if vr is not None and vr[2] is not None:
        wvr, bvr, v_first = vr
        tensors += [("wvr", wvr, (heads, d)), ("bvr", bvr, (heads,)),
                    ("v_first", v_first, (b, n, hd))]
    for name, t, shape in tensors:
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
    # the mix projection rides in the projection GEMM as h more gate columns
    side = heads
    if v_first is not None:
        wg, bg, side = torch.cat([wg, wvr]), torch.cat([bg, bvr]), 2 * heads

    lib = _build.load("attention")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    xn = torch.empty((tokens, d), dtype=x.dtype, device=x.device)
    qkv = torch.empty((tokens, 3 * hd), dtype=x.dtype, device=x.device)
    gates = torch.empty((tokens, side), dtype=torch.float32, device=x.device)
    ao = torch.empty((tokens, hd), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    _build.check(lib.sesa_attn_proj(x.data_ptr(), gamma.data_ptr(), xn.data_ptr(),
                                    wqkv.data_ptr(),
                                    wg.data_ptr(), bg.data_ptr(), cos_p, sin_p,
                                    qkv.data_ptr(), gates.data_ptr(), tokens, d, heads, dh,
                                    n, w, side, stream), "sesa_attn_proj")
    v_pre = None
    if vr is not None:
        v_pre = torch.empty((b, n, hd), dtype=x.dtype, device=x.device)
        _build.check(lib.sesa_attn_vr(qkv.data_ptr(), gates.data_ptr(),
                                      None if v_first is None else v_first.data_ptr(),
                                      v_pre.data_ptr(), tokens, heads, dh, side, stream),
                     "sesa_attn_vr")
    _build.check(lib.sesa_attn_core(qkv.data_ptr(), gates.data_ptr(), ao.data_ptr(), b, n,
                                    heads, dh, side, float(scale), stream), "sesa_attn_core")
    _build.check(lib.sesa_attn_out(ao.data_ptr(), wo.data_ptr(),
                                   x.data_ptr() if add_residual else None,
                                   out.data_ptr(), tokens, d, hd, stream), "sesa_attn_out")
    fused_attention_block.launches += 1
    fused_attention_block.launches_by_mode[0 if vr is None else 1 if v_first is None else 2] += 1
    return out if vr is None else (out, v_pre)


fused_attention_block.launches = 0
fused_attention_block.launches_by_mode = [0, 0, 0]


def shaw_rel_index(n: int, max_pos: int) -> np.ndarray:
    """(n, n) rows clip(i - j, -P, P) + P of the Shaw table for query i and
    key j (lucidrains conformer: the distance is i - j)."""
    seq = np.arange(n)
    return np.clip(seq[:, None] - seq[None, :], -max_pos, max_pos) + max_pos


def fused_conformer_attention_plain(x, ln_w, ln_b, wqkv, rel_pos_emb, wo, bo, heads,
                                    scale=None):
    """Plain PyTorch K4 with the TPU kernel's rounding points.

    x (b, n, d); weights in torch (out, in) layout: wqkv (3·h·dh, d) = the
    rows of to_q then to_kv, wo (d, h·dh), bo (d,); rel_pos_emb the Shaw
    table (2P + 1, dh). Products accumulate in f32. In the working dtype the
    values are rounded where sesa_tpu/ops/attention.py
    ``_conformer_attn_kernel`` rounds them: xn after LayerNorm·γ + β, qkv,
    the table, p before P·V, the attention output and the output before the
    residual add. Sequences run in slices that keep each (n, n) f32 tensor
    near 256 MB.
    """
    dt = x.dtype
    b, n, d = x.shape
    dh = wqkv.shape[0] // (3 * heads)
    if scale is None:
        scale = dh ** -0.5
    f32 = torch.float32
    max_pos = (rel_pos_emb.shape[0] - 1) // 2

    xn = layer_norm_rounded(x, ln_w, ln_b)
    qkv = (xn.to(f32) @ wqkv.to(f32).T).to(dt)
    q, k, v = qkv.reshape(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4)  # (b, h, n, dh)
    # only the table rows that the distances of n positions reach
    lo, hi = max(max_pos - (n - 1), 0), min(max_pos + n - 1, 2 * max_pos)
    table = rel_pos_emb[lo:hi + 1].to(dt).to(f32)
    idx = torch.as_tensor(shaw_rel_index(n, max_pos) - lo, device=x.device)
    step = max(1, 2 ** 26 // (heads * n * max(n, hi + 1 - lo)))
    outs = []
    for s0 in range(0, b, step):
        qs = q[s0:s0 + step].to(f32)
        s = qs @ k[s0:s0 + step].to(f32).transpose(-1, -2)
        qe = qs @ table.T  # (c, h, n, rows)
        s = s + torch.gather(qe, -1, idx.expand(qe.shape[:2] + (n, n)))
        p = torch.softmax(s * scale, dim=-1).to(dt)
        outs.append((p.to(f32) @ v[s0:s0 + step].to(f32)).to(dt))
    ao = torch.cat(outs).permute(0, 2, 1, 3).reshape(b, n, heads * dh)
    out = (ao.to(f32) @ wo.to(f32).T + bo.to(f32)).to(dt)
    return out + x


def fused_conformer_attention(x, ln_w, ln_b, wqkv, rel_pos_emb, wo, bo, heads, scale=None):
    """x (b, n, d) -> x + conformer-attention(layer_norm(x)): kernel K4.

    CPU tensors run :func:`fused_conformer_attention_plain`. CUDA tensors
    must be bf16, contiguous, with d and h·dh multiples of 64 and dh in
    {32, 64, 128}; anything else raises. P comes from the table's rows.
    Each call adds one to ``fused_conformer_attention.launches``.
    """
    if x.device.type == "cpu":
        return fused_conformer_attention_plain(x, ln_w, ln_b, wqkv, rel_pos_emb, wo, bo,
                                               heads, scale)
    b, n, d = x.shape
    hd = wqkv.shape[0] // 3
    dh = hd // heads
    if dh not in (32, 64, 128) or d % 64 or hd % 64 or wqkv.shape[0] != 3 * hd:
        raise ValueError(f"fused_conformer_attention: unsupported d={d}, heads={heads}, "
                         f"dim_head={dh} (the kernel takes dim_head 32, 64 or 128 and d, "
                         "heads * dim_head multiples of 64)")
    tokens = b * n
    if -(-tokens // 128) > 65535 or b > 65535:
        raise ValueError(f"fused_conformer_attention: {b} sequences of {n} exceed one launch")
    rows = rel_pos_emb.shape[0]
    if rows % 2 == 0:
        raise ValueError(f"fused_conformer_attention: the Shaw table has {rows} rows, "
                         "expected 2P + 1")
    if scale is None:
        scale = dh ** -0.5
    for name, t, shape in (("x", x, (b, n, d)), ("ln_w", ln_w, (d,)), ("ln_b", ln_b, (d,)),
                           ("wqkv", wqkv, (3 * hd, d)), ("rel_pos_emb", rel_pos_emb, (rows, dh)),
                           ("wo", wo, (d, hd)), ("bo", bo, (d,))):
        _build.check_tensor("fused_conformer_attention", name, t, shape, torch.bfloat16)

    lib = _build.load("conformer_attention")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    xn = torch.empty((tokens, d), dtype=x.dtype, device=x.device)
    qkv = torch.empty((tokens, 3 * hd), dtype=x.dtype, device=x.device)
    ao = torch.empty((tokens, hd), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    _build.check(lib.sesa_conf_attn_proj(x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(),
                                         xn.data_ptr(), wqkv.data_ptr(), qkv.data_ptr(),
                                         tokens, d, 3 * hd, stream), "sesa_conf_attn_proj")
    _build.check(lib.sesa_conf_attn_core(qkv.data_ptr(), rel_pos_emb.data_ptr(), ao.data_ptr(),
                                         b, n, heads, dh, (rows - 1) // 2, float(scale),
                                         stream), "sesa_conf_attn_core")
    _build.check(lib.sesa_conf_attn_out(ao.data_ptr(), wo.data_ptr(), bo.data_ptr(),
                                        x.data_ptr(), out.data_ptr(), tokens, d, hd, stream),
                 "sesa_conf_attn_out")
    fused_conformer_attention.launches += 1
    return out


fused_conformer_attention.launches = 0


def fused_rope_attention_plain(qkv, heads, scale, rope=None):
    """Plain PyTorch K7 with the TPU kernel's rounding points
    (sesa_tpu/ops/attention.py:251-271).

    qkv (b, n, 3·h·dh), component-major [q₀..q_H | k₀..k_H | v₀..v_H];
    rope = (cos, sin) of shape (n, w ≤ dh), interleaved pairs, rotating the
    leading w dims of q and k. The tables are cast to the working dtype and
    the rope products and their sum are rounded there; q·kᵀ and the softmax
    are f32, p is rounded before p·v, and the f32 product is rounded on the
    way out. Sequences run in slices that keep the f32 logits near 256 MB.
    """
    dt = qkv.dtype
    f32 = torch.float32
    b, n, packed = qkv.shape
    dh = packed // (3 * heads)
    if rope is not None:
        cos, sin = (r.to(device=qkv.device, dtype=dt) for r in rope)
    step = max(1, 2 ** 26 // (heads * n * n))
    outs = []
    for s0 in range(0, b, step):
        q, k, v = qkv[s0:s0 + step].reshape(-1, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
        if rope is not None:
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        s = (q.to(f32) @ k.to(f32).transpose(-1, -2)) * scale
        p = torch.softmax(s, dim=-1).to(dt)
        o = (p.to(f32) @ v.to(f32)).to(dt)  # (c, h, n, dh)
        outs.append(o.permute(0, 2, 1, 3).reshape(-1, n, heads * dh))
    return torch.cat(outs)


_SMEM_LIMIT = 227 * 1024  # dynamic shared memory a block can use on Hopper


def fused_rope_attention(qkv, heads, scale, rope=None):
    """Packed-qkv attention, (b, n, 3·h·dh) -> (b, n, h·dh): kernel K7.

    ``rope`` is the interleaved-convention (cos, sin) table pair of shape
    (n, w) with w ≤ dh (partial rotary rotates only the leading w dims);
    ``None`` skips it. CPU tensors run :func:`fused_rope_attention_plain`.
    CUDA tensors must be bf16 and contiguous with dh in {16, 32, 64, 128}, an
    even w, and a sequence whose q, k and v of one head fit in shared memory
    (n up to about 530 at dh 64); anything else raises. Each call adds one to
    ``fused_rope_attention.launches``.
    """
    if qkv.device.type == "cpu":
        return fused_rope_attention_plain(qkv, heads, scale, rope)
    b, n, packed = qkv.shape
    dh = packed // (3 * heads)
    if dh not in (16, 32, 64, 128) or packed != 3 * heads * dh or b < 1 or n < 1:
        raise ValueError(f"fused_rope_attention: unsupported packed width {packed} for "
                         f"{heads} heads (the kernel takes dim_head 16, 32, 64 or 128)")
    _build.check_tensor("fused_rope_attention", "qkv", qkv, (b, n, packed), torch.bfloat16)

    # heads per block: 256 bytes of each packed row where the heads allow it,
    # fewer when the three (n, group * dh) slabs would not fit in shared memory
    def smem(group):
        return 3 * (-(-n // 16) * 16) * (group * dh + 8) * 2

    group = min(heads, max(1, 128 // dh))
    while group > 1 and smem(group) > _SMEM_LIMIT:
        group -= 1
    if smem(group) > _SMEM_LIMIT:
        raise ValueError(f"fused_rope_attention: a sequence of {n} at dim_head {dh} does not "
                         "fit in shared memory")
    cos_p = sin_p = None
    w = 0
    if rope is not None:
        cos, sin = rope
        w = cos.shape[-1]
        if w % 2 or w > dh:
            raise ValueError(f"fused_rope_attention: rotary width {w} must be even and <= {dh}")
        for name, t in (("cos", cos), ("sin", sin)):
            _build.check_tensor("fused_rope_attention", name, t, (n, w), torch.bfloat16)
        cos_p, sin_p = cos.data_ptr(), sin.data_ptr()

    lib = _build.load("rope_attention")
    out = torch.empty((b, n, heads * dh), dtype=qkv.dtype, device=qkv.device)
    _build.check(lib.sesa_rope_attn(qkv.data_ptr(), cos_p, sin_p, out.data_ptr(), b, n, heads,
                                    dh, group, w, float(scale),
                                    torch.cuda.current_stream(qkv.device).cuda_stream),
                 "sesa_rope_attn")
    fused_rope_attention.launches += 1
    return out


fused_rope_attention.launches = 0
