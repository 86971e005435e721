"""Attention for the roformer and conformer families (counterpart of
sesa_tpu/ops/attention.py).
``sdpa`` is the einsum pair with an f32 softmax; long bf16 sequences on CUDA go
to ``vmem_attention``, kernel K3: whole-sequence attention over (BH, S, D).
``fused_attention_block`` is kernel K1: the whole roformer attention block
(RMSNorm, qkv, rope, attention, per-head gates, out projection, residual),
with the value-residual modes of the experimental roformers.
``fused_conformer_attention`` is kernel K4: the conformer attention block
(LayerNorm, qkv, attention with the Shaw relative-position bias, out
projection with bias, residual), planned by ``k4_plan``. ``fused_rope_attention`` is kernel K7: rope
and attention over the qkv projection's packed output. ``sdpa_int8`` is
kernel I8 (``csrc/int8_attention.cu``), the int8 attention that
``SESA_INT8_ATTN`` turns on; it replaces no TPU kernel. On a CUDA tensor each
launches its hand-written kernel or chain (``csrc/attention.cu``,
``csrc/vmem_attention.cu``, ``csrc/conformer_attention.cu``,
``csrc/rope_attention.cu``, ``csrc/int8_attention.cu``); on a CPU tensor
it runs its ``*_plain`` version, which repeats the TPU kernel's arithmetic
with its bf16 rounding points.
"""

from __future__ import annotations

import math
import os
import weakref
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from sesa_tpu_torch.ops import _build
from sesa_tpu_torch.ops.ff import ff_gemm_schedule, layer_norm_rounded, ws_smem_bytes
from sesa_tpu_torch.ops.rope import apply_rope


_K3_MIN_SEQ, _K3_MAX_SEQ = 256, 2048
# the head widths the attention cores are built for (csrc/flash_wgmma.cuh,
# flash_core.cuh, flash_shaw.cuh and conformer_attention.cu's mma core); a
# narrower head runs at the next of them, zero-padded
_CORE_WIDTHS = (32, 64, 128)


def core_width(dh: int, heads: Optional[int] = None) -> int:
    """The head width a core runs a head of ``dh`` (1 to 128) at: the
    narrowest of 32, 64 and 128 that holds dh and, for K1 and K4 (``heads``
    given), makes heads × width a multiple of 64, the k-step of their out
    product. K3 has no out product and passes no heads."""
    return next(w for w in _CORE_WIDTHS
                if w >= dh and (heads is None or heads * w % 64 == 0))


def pad_heads(t: torch.Tensor, dh: int, width: int, dim: int = -1) -> torch.Tensor:
    """``t`` with each run of ``dh`` entries along ``dim`` (one head's) followed
    by ``width - dh`` zeros, contiguous: W_qkv's rows (dim 0), W_o's columns,
    a V of (b, n, h·dh), the Shaw table's columns."""
    t = t.movedim(dim, -1)
    lead, cols = t.shape[:-1], t.shape[-1]
    t = F.pad(t.reshape(lead + (cols // dh, dh)), (0, width - dh))
    return t.reshape(lead + (cols // dh * width,)).movedim(-1, dim).contiguous()


def unpad_heads(t: torch.Tensor, dh: int, width: int) -> torch.Tensor:
    """The inverse of :func:`pad_heads` along the last dim, contiguous."""
    lead, cols = t.shape[:-1], t.shape[-1]
    return t.reshape(lead + (cols // width, width))[..., :dh].reshape(
        lead + (cols // width * dh,))


# padded weights by (identities of the source tensors, what was made of them)
_MADE = {}


def cached(tensors, tag, make):
    """``make()``, kept while the ``tensors`` it was made from live unchanged:
    keyed on their identities and checked against their version counters, so
    an in-place update makes it anew. Inference tensors carry no version, so
    for them it is made on every call."""
    if any(t.is_inference() for t in tensors):
        return make()
    key = (tuple(id(t) for t in tensors), tag)
    versions = tuple(t._version for t in tensors)
    hit = _MADE.get(key)
    if hit is not None and hit[1] == versions and all(r() is t for r, t in zip(hit[0], tensors)):
        return hit[2]
    value = make()
    drop = lambda _ref, key=key: _MADE.pop(key, None)  # noqa: E731
    _MADE[key] = (tuple(weakref.ref(t, drop) for t in tensors), versions, value)
    return value


def padded_block_weights(wqkv, wo, dh: int, width: int, table=None):
    """W_qkv (3·h·dh, d), W_o (d, h·dh) and the Shaw table (rows, dh), or None,
    padded per head to ``width`` (:func:`pad_heads`) for K1 and K4, each kept
    by :func:`cached` while its source lives unchanged."""
    pad = lambda t, dim: cached((t,), ("pad_heads", dh, width, dim),  # noqa: E731
                                lambda: pad_heads(t, dh, width, dim))
    return pad(wqkv, 0), pad(wo, 1), None if table is None else pad(table, 1)


def use_vmem_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """The gate of kernel K3, on device, dtype and shape only: CUDA bf16
    q, k, v of one shape (..., S, D) with 256 <= S <= 2048 and D <= 128."""
    return (q.device.type == "cuda" and q.dtype == k.dtype == v.dtype == torch.bfloat16
            and q.ndim >= 3 and q.shape == k.shape == v.shape
            and _K3_MIN_SEQ <= q.shape[-2] <= _K3_MAX_SEQ and 1 <= q.shape[-1] <= 128)


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


def k3_plan(q, k, v):
    """The host side of kernel K3: how it reads q, k, v (..., S, D) and
    where it writes.

    The kernel runs at the narrowest of D 32, 64 and 128 that holds D, its
    tensor maps reading heads of the real width (TMA's zero fill pads them)
    and writing only those columns; a width that is not a multiple of 8,
    whose rows could not be 16-byte multiples, is first zero-padded to one
    (a copy), and the result is the view of the real columns.

    Returns ``(tensors, rank, dims, strides, out, out_strides, result, b,
    h)``. The kernel reads each of ``tensors`` through a TMA tensor map of
    ``rank`` dims ``dims`` (innermost first) with byte strides ``strides[i]``
    of dims 1..rank-1, and writes ``out`` through element strides
    ``out_strides`` = (batch, head, row). 4-D (b, h, s, d) views whose
    strides are multiples of 16 bytes (the roformer's permuted views of its
    qkv projection) are read where they lie as (d, s, h, b) maps, and their
    output is laid out (b, s, h, d) in memory, the layout the out projection
    reads, and returned as its (b, h, s, d) view. Anything else is made
    contiguous (BH, S, D), copied where it must be, and read as (d, s, bh)
    maps: a tensor map has no dim of stride 0 for the one head."""
    s, d = q.shape[-2:]
    if d % 8:
        plan = k3_plan(*(F.pad(t, (0, -d % 8)) for t in (q, k, v)))
        return plan[:6] + (plan[6][..., :d],) + plan[7:]
    strides = [_bh_strides(t) for t in (q, k, v)] if q.ndim == 4 else [None]
    if all(st is not None for st in strides) and not q.is_contiguous():
        b, h = q.shape[:2]
        out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
        return ((q, k, v), 4, (d, s, h, b), [(2 * ss, 2 * sh, 2 * sb) for sb, sh, ss in strides],
                out, (s * h * d, d, h * d), out.permute(0, 2, 1, 3), b, h)
    lead = q.shape[:-2]
    flat = []
    for t in (q, k, v):
        t = t.reshape(-1, s, d).contiguous()
        flat.append(t.clone() if t.data_ptr() % 16 else t)
    bh = flat[0].shape[0]
    out = torch.empty_like(flat[0])
    return (tuple(flat), 3, (d, s, bh), [(2 * d, 2 * s * d)] * 3, out, (s * d, 0, d),
            out.view(lead + (s, d)), bh, 1)


def vmem_attention(q, k, v, scale):
    """softmax(q·kᵀ·scale)·v over (..., S, D): kernel K3.

    CPU tensors run :func:`vmem_attention_plain`. CUDA tensors must be bf16,
    of one shape, with D <= 128, and the scale positive; anything else
    raises. :func:`k3_plan` says how the kernel reads the tensors and
    where it writes. Each call adds one to ``vmem_attention.launches``.
    """
    if q.device.type == "cpu":
        return vmem_attention_plain(q, k, v, scale)
    _build.refuse_export("vmem_attention (K3)")
    _build.refuse_autograd("vmem_attention (K3)", q, k, v)
    s, d = q.shape[-2:]
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16) or not (q.shape == k.shape == v.shape) \
            or not 1 <= d <= 128 or q.ndim < 3 or s < 1:
        raise ValueError(f"vmem_attention: unsupported q {q.dtype} {tuple(q.shape)}, k "
                         f"{k.dtype} {tuple(k.shape)}, v {v.dtype} {tuple(v.shape)} (the kernel "
                         "takes bf16 tensors of one shape with dim_head at most 128)")
    if not scale > 0:
        raise ValueError(f"vmem_attention: the kernel takes a positive scale, got {scale}")
    (q, k, v), rank, dims, strides, out, ostr, result, b, h = k3_plan(q, k, v)
    d = dims[0]
    if b * h * -(-s // 128) > 2 ** 31 - 1 or b * h < 1:
        raise ValueError(f"vmem_attention: {b * h} sequences of {s} exceed one launch")
    lib = _build.load("vmem_attention")
    dims4 = tuple(dims) + (1,) * (4 - rank)
    flat = [x for st in strides for x in tuple(st) + (0,) * (4 - rank)]
    _build.check(lib.sesa_vmem_attn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                    rank, *dims4, *flat, *ostr, b, h, s, d, float(scale),
                                    torch.cuda.current_stream(q.device).cuda_stream),
                 "sesa_vmem_attn")
    vmem_attention.launches += 1
    return result


vmem_attention.launches = 0


def int8_attention_enabled() -> bool:
    """``SESA_INT8_ATTN`` set: every roformer attention runs :func:`sdpa_int8`
    (``models/roformer_core.py`` ``attention_apply``) and K1 is refused, as
    in the JAX package (sesa_tpu/ops/attention.py:723,
    sesa_tpu/models/roformer_core.py:137)."""
    return bool(os.environ.get("SESA_INT8_ATTN"))


def _quant_rows(x: torch.Tensor):
    """Per-row symmetric int8 codes of x as f32 values, and the f32 scales:
    s = max(max|x| / 127, 1e-8), codes clip(round_half_even(x / s), ±127).
    A non-finite row gives a non-finite scale (amax propagates NaN)."""
    xf = x.float()
    s = (xf.abs().amax(-1, keepdim=True) / 127.0).clamp_min(1e-8)
    # clamp_min keeps a NaN scale NaN; the codes stay f32 (a NaN cast to int8
    # is undefined), the scale carries the NaN into the scores
    return torch.clamp(torch.round(xf / s), -127.0, 127.0), s


def sdpa_int8_plain(q, k, v, scale=None):
    """Int8 attention in plain PyTorch with the rounding points of the JAX
    ``sdpa_int8`` (sesa_tpu/ops/attention.py:84-103): the k mean summed in
    f32 and rounded to k's dtype, k less its mean in that dtype, per-row
    int8 codes and scales of q and of the centred k, the scores as
    f32(q8·k8ᵀ)·(qs·ksᵀ)·scale, an f32 softmax rounded to v's dtype, and
    P·V in v's dtype with f32 sums. The int8 product runs as an f32 matmul
    of the codes, which is exact (TF32 included): the codes need 7 bits and
    |Σ| <= 127²·D < 2²⁴ for D <= 1040. Leading dims run in slices that keep
    the f32 scores near 256 MB."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    f32 = torch.float32
    km = k.float().mean(-2, keepdim=True).to(k.dtype)
    q8, qs = _quant_rows(q)
    k8, ks = _quant_rows(k - km)
    lead, (n, d), m = q.shape[:-2], q.shape[-2:], k.shape[-2]
    q8, qs = q8.reshape(-1, n, d), qs.reshape(-1, n, 1)
    k8, ks = k8.reshape(-1, m, d), ks.reshape(-1, m, 1)
    v3 = v.reshape(-1, m, v.shape[-1])
    step = max(1, 2 ** 26 // (n * m))
    outs = []
    for s0 in range(0, q8.shape[0], step):
        sl = slice(s0, s0 + step)
        sim = (q8[sl] @ k8[sl].transpose(-1, -2)) * (qs[sl] * ks[sl].transpose(-1, -2)) * scale
        p = torch.softmax(sim, dim=-1).to(v.dtype)
        outs.append((p.to(f32) @ v3[sl].to(f32)).to(v.dtype))
    return torch.cat(outs).reshape(lead + (n, v.shape[-1]))


def int8_attention_shape_ok(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """The inputs kernel I8 takes: bf16 q, k and v of one shape (..., n, D)
    with 1 <= D <= 128 and n >= 1, on one launch's grid."""
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16 and q.shape == k.shape == v.shape
            and q.ndim >= 3):
        return False
    n, d = q.shape[-2:]
    return 1 <= d <= 128 and n >= 1 and q.numel() // (n * d) * -(-n // 64) <= 2 ** 31 - 1


# I8's routes (csrc/int8_attention.cu): one kernel while one key tile of 64
# holds the sequence, else the pre-pass and the attention kernel over key
# tiles of 128
_I8_ROUTES = {"fused": 0, "tiles": 1}
_I8_FUSED_MAX_N, _I8_BK = 64, 128
# the pre-pass (csrc PRE_CLUSTER, PRE_STAGE_MAX): a cluster of 4 blocks a
# sequence, each keeping its rows of k in at most 48 KiB of shared memory (4
# blocks an SM); a sequence too long for that takes one block and reads k
# twice
_I8_PRE_CLUSTER, _I8_PRE_STAGE_MAX = 4, 49152


def _i8_smem(route: str, dh: int) -> dict:
    """I8's dynamic shared memory by buffer at core width ``dh``: the layouts
    of ``csrc/int8_attention.cu`` ``FusedCfg`` and ``TilesCfg`` (``total``
    adds the mbarriers and 1024 bytes of alignment slack)."""
    ncw = 2 if dh == 128 else 3
    q8, staging = 64 * dh, 64 * (dh + 8) * 2
    if route == "fused":
        stages = {32: 8, 64: 6, 128: 3}[dh]
        buffers = {"qkv stages": stages * 3 * 64 * dh * 2,
                   "q8, k8, staging": ncw * (2 * q8 + staging),
                   "scales, mean": ncw * (64 + 64 + 5 * dh) * 4}
        bars = 2 * stages
    else:
        stages, qbuf = (2, 1) if dh == 128 else (3, 2)
        buffers = {"q": qbuf * 64 * ncw * dh * 2, "k codes": stages * _I8_BK * dh,
                   "v": stages * _I8_BK * dh * 2, "q8, staging": ncw * (q8 + staging),
                   "k scales": stages * _I8_BK * 4, "q scales": ncw * 64 * 4}
        bars = 2 * qbuf + 3 * stages
    return dict(buffers, total=sum(buffers.values()) + 8 * bars + 1024)


def i8_plan(q, k, v, sms: int) -> dict:
    """The host side of kernel I8: how it reads q, k, v (..., n, D), where it
    writes, and what each launch gets on a card of ``sms`` SMs.

    q, k and v are read as :func:`k3_plan` reads them: the roformer's
    strided (b, h, n, d) views where they lie, through (d, s, h, b) tensor
    maps, with the output laid out (b, n, h, d) and returned as its (b, h,
    n, d) view; anything else contiguous (BH, n, D) through (d, s, bh) maps;
    a width that is not a multiple of 8 zero-padded to one. The kernel runs
    at ``dh``, the narrowest of 32, 64 and 128 that holds D.

    - ``route`` "fused" for n <= 64: one kernel reads bf16 q, k and v once
      and makes k's mean and both codes in shared memory; "tiles" beyond: a
      ``prepass`` (``n_kt`` key tiles of 128 each a sequence, ``codes_bytes``
      of code tile images and ``scales`` f32 key scales; a ``cluster`` of 4
      blocks a sequence, each keeping its ``rows`` of k in ``smem`` bytes of
      shared memory between its two passes, or where that passes 48 KiB one
      block a sequence reading k twice; ``grid`` blocks), then the
      attention kernel;
    - ``grid``: one persistent block per SM, never more than the ``units``
      (fused: sequences; tiles: (sequence, 64 × ``ncw`` queries) tiles);
    - ``smem``: its dynamic shared memory, ``buffers`` by buffer;
    - ``tensors``, ``rank``, ``dims``, ``strides``, ``out``,
      ``out_strides``, ``result``, ``b``, ``h``: as :func:`k3_plan` gives
      them.

    ``csrc/int8_attention.cu`` refuses a plan that does not match."""
    n = q.shape[-2]
    tensors, rank, dims, strides, out, out_strides, result, b, h = k3_plan(q, k, v)
    dh = core_width(dims[0])
    route = "fused" if n <= _I8_FUSED_MAX_N else "tiles"
    ncw = 2 if dh == 128 else 3
    seqs = b * h
    units = seqs if route == "fused" else seqs * -(-n // (64 * ncw))
    smem = _i8_smem(route, dh)
    plan = dict(route=route, route_id=_I8_ROUTES[route], dh=dh, ncw=ncw, units=units,
                grid=min(units, sms), smem=smem["total"],
                buffers={k_: v_ for k_, v_ in smem.items() if k_ != "total"},
                tensors=tensors, rank=rank, dims=dims, strides=strides, out=out,
                out_strides=out_strides, result=result, b=b, h=h, prepass=None)
    if route == "tiles":
        n_kt = -(-n // _I8_BK)
        row, head, batch = strides[1] if rank == 4 else (strides[1][0], 0, strides[1][1])
        # a block's share of the rows, in whole passes of its 256 threads
        per_pass, share = 256 // (dh // 16), -(-n_kt * _I8_BK // _I8_PRE_CLUSTER)
        rows = -(-share // per_pass) * per_pass
        cluster = _I8_PRE_CLUSTER if rows * dh * 2 <= _I8_PRE_STAGE_MAX else 1
        if cluster == 1:
            rows = n_kt * _I8_BK
        plan["prepass"] = dict(grid=seqs * cluster, cluster=cluster, rows=rows,
                               smem=rows * dh * 2 if cluster > 1 else 0, n_kt=n_kt,
                               codes_bytes=seqs * n_kt * _I8_BK * dh,
                               scales=seqs * n_kt * _I8_BK, k_strides=(row, head, batch))
    return plan


def _i8_launches(q, k, v, scale):
    """The C calls of one I8 run on CUDA q, k, v: ([(stage name, launch)],
    the result to return). The wrapper runs them in turn; ``chip_smoke.py``
    times each stage alone."""
    if not int8_attention_shape_ok(q, k, v) or not scale > 0:
        raise ValueError(f"sdpa_int8: unsupported q {q.dtype} {tuple(q.shape)}, k {k.dtype} "
                         f"{tuple(k.shape)}, v {v.dtype} {tuple(v.shape)}, scale {scale} (the "
                         "kernel takes bf16 tensors of one shape, dim_head 1 to 128)")
    if not q.device.type == k.device.type == v.device.type == "cuda":
        raise ValueError(f"sdpa_int8: q, k and v must lie on CUDA; got {q.device}, "
                         f"{k.device}, {v.device}")
    dev = q.device
    n = q.shape[-2]
    plan = i8_plan(q, k, v, torch.cuda.get_device_properties(dev).multi_processor_count)
    (qt, kt, vt), rank, dims = plan["tensors"], plan["rank"], plan["dims"]
    b, h, dh = plan["b"], plan["h"], plan["dh"]
    lib = _build.load("int8_attention")
    stream = torch.cuda.current_stream(dev).cuda_stream
    codes = scales = None
    stages = []
    pre = plan["prepass"]
    if pre is not None:
        codes = torch.empty((pre["codes_bytes"],), dtype=torch.int8, device=dev)
        scales = torch.empty((pre["scales"],), dtype=torch.float32, device=dev)
        stages.append(("prepass", lambda: _build.check(lib.sesa_i8_prepass(
            kt.data_ptr(), codes.data_ptr(), scales.data_ptr(), *pre["k_strides"], b, h, n,
            dims[0], dh, pre["n_kt"], pre["cluster"], pre["rows"], pre["smem"], stream),
            "sesa_i8_prepass")))
    dims4 = tuple(dims) + (1,) * (4 - rank)
    flat = [x for st in plan["strides"] for x in tuple(st) + (0,) * (4 - rank)]
    out = plan["out"]
    stages.append(("attention", lambda: _build.check(lib.sesa_i8_attn(
        plan["route_id"], qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), out.data_ptr(),
        None if codes is None else codes.data_ptr(), None if scales is None else scales.data_ptr(),
        rank, *dims4, *flat, *plan["out_strides"], b, h, n, dh, float(scale), plan["grid"],
        plan["smem"], stream), "sesa_i8_attn")))
    return stages, plan["result"]


def sdpa_int8(q, k, v, scale=None):
    """Int8 attention over (..., heads, seq, dim_head), the SageAttention
    analogue (reference attend_sage.py): kernel I8 (``csrc/int8_attention.cu``),
    which stands beside K3 and replaces no TPU kernel (the JAX ``sdpa_int8``
    is plain JAX).

    CPU tensors run :func:`sdpa_int8_plain`. On CUDA, f32 inputs also run
    the plain version: an explicit dtype gate, as K1's gate refuses f32 in
    both packages (f32 is the parity and rescue mode). bf16 inputs must be a
    shape :func:`int8_attention_shape_ok` takes; anything else raises. The
    kernel rounds the probabilities to bf16 before normalising them (an
    online softmax, as K3's core), where JAX and the plain version round
    after: about one bf16 ulp apart. :func:`i8_plan` says how the kernel
    reads q, k and v (the roformer's strided views where they lie) and where
    it writes: for those views the output lies (b, n, h, d) in memory, the
    layout the out projection reads, and is returned as its (b, h, n, d)
    view. Each call adds one to ``sdpa_int8.launches``.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu" or (q.dtype == torch.float32 and k.dtype == torch.float32
                                  and v.dtype == torch.float32):
        return sdpa_int8_plain(q, k, v, scale)
    _build.refuse_export("sdpa_int8 (I8)")
    _build.refuse_autograd("sdpa_int8 (I8)", q, k, v)
    stages, result = _i8_launches(q, k, v, scale)
    for _, launch in stages:
        launch()
    sdpa_int8.launches += 1
    return result


def sdpa_int8_stages(q, k, v, scale=None):
    """I8's launches on CUDA bf16 q, k, v as [(stage name, launch)]: the
    pre-pass and the attention kernel on the tiles route, the attention
    kernel alone on the fused route; each call of a launch runs that C entry
    point once on buffers made here. For timing the stages apart; nothing is
    counted in ``sdpa_int8.launches``."""
    return _i8_launches(q, k, v, q.shape[-1] ** -0.5 if scale is None else scale)[0]


sdpa_int8.launches = 0


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


# the core's routes (csrc/attention.cu K1CoreRoute): the persistent
# flash_wgmma core on (sequence, 192-query) tiles (128-query at dim_head 128),
# or for n <= 64 one block of flash_core<dh, 64> per (sequence, head)
_K1_ROUTES = {"tiles": 0, "short": 1}
_K1_SHORT_MAX_N = 64


def _k1_consumers(dh: int) -> int:
    """Consumer warpgroups of K1's tiles route (``csrc/attention.cu``
    ``k1_ncw``): three at dim_head 32 and 64, two at 128."""
    return 2 if dh == 128 else 3


def _flash_smem(dh: int, ncw: int) -> int:
    """Dynamic shared memory of ``flash_wgmma_kernel<dh, ncw>``: the layout of
    ``csrc/flash_wgmma.cuh`` ``FlashCfg`` (Q buffers, K and V stages, the
    output staging tiles, the mbarriers, 1024 bytes of alignment slack)."""
    stages, qbuf = (2, 1) if dh == 128 else (3, 2)
    q_bytes, kv_bytes = 64 * ncw * dh * 2, 128 * dh * 2
    bars = qbuf * q_bytes + 2 * stages * kv_bytes + ncw * 64 * (dh + 8) * 2
    return bars + 8 * (2 * qbuf + 3 * stages) + 1024


def _flash_core_smem(dh: int, bq: int = 64) -> int:
    """Dynamic shared memory of ``attn_core_kernel<dh, bq>``: the Q tile and two
    K and two V buffers of 64 keys, rows padded by 8 (``csrc/flash_core.cuh``
    ``flash_core_smem_bytes``)."""
    return (bq + 4 * 64) * (dh + 8) * 2


def k1_plan(b: int, n: int, d: int, heads: int, dh: int, sms: int, mix: bool = False) -> dict:
    """The host side of kernel K1: what each of its launches gets.

    For ``b`` sequences of ``n`` tokens of width ``d``, ``heads`` × ``dh``,
    on a card of ``sms`` SMs, with the value-residual mix (mode 2) or not:

    - ``norm``: the gate columns ``side`` that the norm pass computes beside
      xn, the heads' gates and with ``mix`` the heads' mix after them;
    - ``proj`` and ``out``: the persistent GEMMs (``csrc/gemm_ws.cuh``) over
      (b·n, 3·h·dh) at depth d and (b·n, d) at depth h·dh, each with its
      ``tiles``, ``grid`` (:func:`ff_gemm_schedule`) and ``smem``;
    - ``core``: the gated attention core, its ``route`` and ``route_id``:
      "tiles" for n > 64 (``csrc/flash_wgmma.cuh``, persistent: ``tiles`` of
      (sequence, 192 queries; 128 at dh 128), ``grid`` one block per SM and
      never more than tiles), "short" for n ≤ 64 (``csrc/flash_core.cuh``: one block per
      (sequence, head), ``tiles`` = ``grid`` = b·h); ``smem``; the qkv
      buffer as the tiles route's three tensor maps read it, (d, s, h, b)
      with ``dims`` (dh, n, h, b), byte ``strides`` of dims 1-3 (a row of
      qkv, a head, a sequence) and element ``offsets`` of q, k and v; and the
      element ``out_strides`` (batch, head, row) of the (b, n, h, dh)
      output.

    ``dh`` is a width the cores are built for (32, 64 or 128: the wrapper
    pads other widths, :func:`core_width`). ``csrc/attention.cu`` refuses a
    plan that does not match its layouts."""
    tokens, hd = b * n, heads * dh
    plan = {"norm": dict(side=(2 if mix else 1) * heads)}
    for name, cols, depth in (("proj", 3 * hd, d), ("out", d, hd)):
        tiles, grid = ff_gemm_schedule(tokens, cols, sms)
        plan[name] = dict(tiles=tiles, grid=grid, smem=ws_smem_bytes(depth))
    if n <= _K1_SHORT_MAX_N:
        route, tiles, grid, smem = "short", b * heads, b * heads, _flash_core_smem(dh)
    else:
        ncw = _k1_consumers(dh)
        tiles = b * heads * -(-n // (64 * ncw))
        route, grid, smem = "tiles", min(tiles, sms), _flash_smem(dh, ncw)
    plan["core"] = dict(route=route, route_id=_K1_ROUTES[route], tiles=tiles, grid=grid, smem=smem,
                        dims=(dh, n, heads, b), strides=(2 * 3 * hd, 2 * dh, 2 * n * 3 * hd),
                        offsets=(0, hd, 2 * hd), out_strides=(n * hd, dh, hd))
    return plan


def attention_block_shape_ok(b: int, n: int, d: int, heads: int, dh: int) -> bool:
    """The shapes kernel K1 takes: dim_head from 1 to 128 (other than 32, 64
    and 128 zero-padded per head to the next of them, :func:`core_width`), d
    a multiple of 64, and b sequences of n tokens one launch covers.
    :func:`fused_attention_block` raises on a CUDA tensor exactly where this
    is false."""
    return (1 <= dh <= 128 and heads >= 1 and d % 64 == 0 and 1 <= b <= 65535 and n >= 1
            and -(-(b * n) // 128) <= 65535)


def use_fused_attention(x: torch.Tensor, heads: int, dim_head: int) -> bool:
    """The gate of kernel K1, on device, dtype and shape only: a CUDA bf16
    x (..., n, d) of a shape :func:`attention_block_shape_ok` takes, unless
    ``SESA_INT8_ATTN`` is set (:func:`int8_attention_enabled`: the int8
    attention runs unfused, as the JAX gate ``_use_fused`` refuses K1 then).
    The roformer stacks run the unfused chain (``attention_apply``) for
    everything else."""
    n, d = x.shape[-2:]
    return (x.device.type == "cuda" and x.dtype == torch.bfloat16
            and not int8_attention_enabled()
            and attention_block_shape_ok(x.numel() // max(n * d, 1), n, d, heads, dim_head))


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
    bf16, contiguous, of a shape :func:`attention_block_shape_ok` takes;
    anything else raises. A head width other than 32, 64 or 128 runs at
    :func:`core_width`, W_qkv and W_o padded per head (kept while they live
    unchanged), v_first padded and the pre-mix V unpadded. Each call adds one
    to ``fused_attention_block.launches`` and to its mode's entry of
    ``fused_attention_block.launches_by_mode`` (0: no ``vr``, 1: ``vr``
    without ``v_first``, 2: with it).
    """
    if x.device.type == "cpu":
        return fused_attention_block_plain(x, gamma, wqkv, wg, bg, wo, heads, scale, rope,
                                           vr=vr, add_residual=add_residual)
    _build.refuse_export("fused_attention_block (K1)")
    _build.refuse_autograd("fused_attention_block (K1)", x, gamma, wqkv, wg, bg, wo, rope, vr)
    b, n, d = x.shape
    hd = wqkv.shape[0] // 3
    dh = hd // heads
    if x.dtype != torch.bfloat16 or not attention_block_shape_ok(b, n, d, heads, dh) \
            or wqkv.shape[0] != 3 * hd or hd != heads * dh:
        raise ValueError(f"fused_attention_block: unsupported {x.dtype} x {tuple(x.shape)}, "
                         f"heads={heads}, dim_head={dh} (the kernel takes bf16, dim_head 1 to "
                         "128, d a multiple of 64, at most 65535 sequences)")
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
    rot = 0
    if rope is not None:
        cos, sin = rope
        rot = cos.shape[-1]
        if rot % 2 or rot > dh:
            raise ValueError(f"fused_attention_block: rotary width {rot} must be even and "
                             f"<= {dh}")
        for name, t in (("cos", cos), ("sin", sin)):
            _build.check_tensor("fused_attention_block", name, t, (n, rot), torch.bfloat16)
        cos_p, sin_p = cos.data_ptr(), sin.data_ptr()
    real_dh, width = dh, core_width(dh, heads)
    if width != dh:
        wqkv, wo, _ = padded_block_weights(wqkv, wo, dh, width)
        if v_first is not None:
            v_first = pad_heads(v_first, dh, width)
        dh, hd = width, heads * width
    # the norm pass computes the mix beside the gates: h more rows of W_g
    plan = k1_plan(b, n, d, heads, dh, torch.cuda.get_device_properties(x.device)
                   .multi_processor_count, mix=v_first is not None)
    core, side = plan["core"], plan["norm"]["side"]
    if v_first is not None:
        wg, bg = torch.cat([wg, wvr]), torch.cat([bg, bvr])

    lib = _build.load("attention")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    xn = torch.empty((tokens, d), dtype=x.dtype, device=x.device)
    qkv = torch.empty((tokens, 3 * hd), dtype=x.dtype, device=x.device)
    gates = torch.empty((tokens, side), dtype=torch.float32, device=x.device)
    ao = torch.empty((tokens, hd), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    _build.check(lib.sesa_attn_proj(x.data_ptr(), gamma.data_ptr(), xn.data_ptr(),
                                    wqkv.data_ptr(), wg.data_ptr(), bg.data_ptr(), cos_p, sin_p,
                                    qkv.data_ptr(), gates.data_ptr(), tokens, d, heads, dh, n,
                                    rot, side, plan["proj"]["grid"], plan["proj"]["smem"],
                                    stream), "sesa_attn_proj")
    v_pre = None
    if vr is not None:
        v_pre = torch.empty((b, n, hd), dtype=x.dtype, device=x.device)
        _build.check(lib.sesa_attn_vr(qkv.data_ptr(), gates.data_ptr(),
                                      None if v_first is None else v_first.data_ptr(),
                                      v_pre.data_ptr(), tokens, heads, dh, side, stream),
                     "sesa_attn_vr")
    _build.check(lib.sesa_attn_core(qkv.data_ptr(), gates.data_ptr(), ao.data_ptr(), b, n,
                                    heads, dh, side, float(scale), core["route_id"],
                                    *core["dims"], *core["strides"], *core["out_strides"],
                                    core["grid"], core["smem"], stream), "sesa_attn_core")
    _build.check(lib.sesa_attn_out(ao.data_ptr(), wo.data_ptr(),
                                   x.data_ptr() if add_residual else None,
                                   out.data_ptr(), tokens, d, hd, plan["out"]["grid"],
                                   plan["out"]["smem"], stream), "sesa_attn_out")
    fused_attention_block.launches += 1
    fused_attention_block.launches_by_mode[0 if vr is None else 1 if v_first is None else 2] += 1
    if v_pre is not None and real_dh != dh:
        v_pre = unpad_heads(v_pre, real_dh, dh)
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
    table (2P + 1, dh). The bias of query i and key j is q_i · E[clip(i − j,
    −P, P) + P], the distance i − j as the JAX code computes it
    (sesa_tpu/models/conformer_core.py:119, the expanded table of
    sesa_tpu/ops/attention.py:668; the comment at :573 there writes j − i).
    Products accumulate in f32. In the working dtype the values are rounded
    where sesa_tpu/ops/attention.py ``_conformer_attn_kernel`` rounds them:
    xn after LayerNorm·γ + β, qkv, the table, p before P·V, the attention
    output and the output before the residual add. Sequences run in slices
    that keep each (n, n) f32 tensor near 256 MB.
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


# the core's routes (csrc/conformer_attention.cu K4CoreRoute): the persistent
# flash_shaw core on (sequence, 128-query) tiles for n > 64 at dim_head 32 or
# 64, or the mma.sync core, one block per (sequence, head, 64-query tile),
# for n <= 64 (the freq leg) and for dim_head 128, whose table box does not
# fit beside the q.E tiles; a padded width takes the route of the width it
# is padded to
_K4_ROUTES = {"tiles": 0, "mma": 1}
_K4_MMA_MAX_N = 64
_K4_TILE_DIM_HEADS = (32, 64)


def _shaw_buffers(dh: int) -> dict:
    """Shared memory of ``flash_shaw_kernel<dh>`` by buffer: the layout of
    ``csrc/flash_shaw.cuh`` ``ShawCfg`` (one Q buffer of 128 rows, two stages
    of K and V of 128 keys and of the 256-row table box, eight warps' f32 q.E
    tiles of 16 x 152, the mbarriers, 1024 bytes of alignment slack)."""
    return dict(q=128 * dh * 2, k=2 * 128 * dh * 2, v=2 * 128 * dh * 2, table=2 * 256 * dh * 2,
                qe=8 * 16 * 152 * 4, barriers=8 * 8, slack=1024)


def _conf_mma_buffers(dh: int) -> dict:
    """Shared memory of ``conf_attn_core_kernel<dh>`` by buffer
    (``csrc/conformer_attention.cu`` ``conf_attn_smem_bytes``): the Q tile,
    two K and two V buffers of 64 keys and two table buffers of 128 rows, rows
    padded by 8, and four warps' f32 q.E tiles of 16 x 84."""
    row = (dh + 8) * 2
    return dict(q=64 * row, k=2 * 64 * row, v=2 * 64 * row, table=2 * 128 * row,
                qe=4 * 16 * 84 * 4)


def k4_plan(b: int, n: int, d: int, heads: int, dh: int, sms: int) -> dict:
    """The host side of kernel K4: what each of its launches gets.

    For ``b`` sequences of ``n`` tokens of width ``d``, ``heads`` × ``dh``,
    on a card of ``sms`` SMs:

    - ``proj`` and ``out``: the persistent GEMMs (``csrc/gemm_ws.cuh``) over
      (b·n, 3·h·dh) at depth d and (b·n, d) at depth h·dh, each with its
      ``tiles``, ``grid`` (:func:`ff_gemm_schedule`) and ``smem``;
    - ``core``: the attention core with the Shaw bias, its ``route`` and
      ``route_id``: "tiles" for n > 64 at dh 32 or 64
      (``csrc/flash_shaw.cuh``, persistent: ``tiles`` of (sequence, 128
      queries), ``grid`` one block per SM and never more than tiles), "mma"
      otherwise (one block per (sequence, head, 64 queries): ``tiles`` =
      ``grid``); ``buffers``, the shared memory of each buffer, and their
      sum ``smem``; the qkv buffer as the tiles route's three tensor maps
      read it (q, k and v at columns 0, h·dh and 2·h·dh), (d, s, h, b) with
      ``dims`` (dh, n, h, b) and byte ``strides`` of dims 1-3; the element
      ``out_strides`` (batch, head, row) of the (b, n, h, dh) output; and
      the expanded table of the tiles route (:func:`shaw_table`):
      ``table_rows`` (2·n_pad, n_pad = n rounded up to 128; 0 on the mma
      route) and ``box_origin``, the first row of the 256-row box of the
      tile pair (q0, k0) being q0 - k0 + ``box_origin``.

    ``dh`` is a width the cores are built for (32, 64 or 128: the wrapper
    pads other widths, :func:`core_width`). ``csrc/conformer_attention.cu``
    refuses a plan that does not match its layouts."""
    tokens, hd = b * n, heads * dh
    plan = {}
    for name, cols, depth in (("proj", 3 * hd, d), ("out", d, hd)):
        tiles, grid = ff_gemm_schedule(tokens, cols, sms)
        plan[name] = dict(tiles=tiles, grid=grid, smem=ws_smem_bytes(depth))
    n_pad = -(-n // 128) * 128
    if n > _K4_MMA_MAX_N and dh in _K4_TILE_DIM_HEADS:
        route, tiles = "tiles", b * heads * -(-n // 128)
        grid, buffers, table_rows = min(tiles, sms), _shaw_buffers(dh), 2 * n_pad
    else:
        route, tiles = "mma", b * heads * -(-n // 64)
        grid, buffers, table_rows = tiles, _conf_mma_buffers(dh), 0
    plan["core"] = dict(route=route, route_id=_K4_ROUTES[route], tiles=tiles, grid=grid,
                        buffers=buffers, smem=sum(buffers.values()),
                        dims=(dh, n, heads, b), strides=(2 * 3 * hd, 2 * dh, 2 * n * 3 * hd),
                        out_strides=(n * hd, dh, hd), table_rows=table_rows,
                        box_origin=n_pad - 128)
    return plan


def conformer_attention_shape_ok(b: int, n: int, d: int, heads: int, dh: int) -> bool:
    """The shapes kernel K4 takes: dim_head from 1 to 128 (other than 32, 64
    and 128 zero-padded per head to the next of them, :func:`core_width`), d
    a multiple of 64, and b sequences of n tokens one launch covers.
    :func:`fused_conformer_attention` raises on a CUDA tensor exactly where
    this is false."""
    return (1 <= dh <= 128 and heads >= 1 and d % 64 == 0 and 1 <= b <= 65535 and n >= 1
            and b * heads * -(-n // 64) <= 2 ** 31 - 1)


def shaw_table(rel_pos_emb: torch.Tensor, n: int) -> torch.Tensor:
    """K4's expanded Shaw table for sequences of ``n``, built where
    ``rel_pos_emb`` (2P + 1, dh) lies: (2·n_pad, dh) with n_pad = n rounded
    up to 128 and row r = rel_pos_emb[clip(r - (n_pad - 1), -P, P) + P], the
    row of distance i - j at i - j + n_pad - 1. The distances of any (query
    tile, key tile) pair of the tiles route are then one run of rows (the
    JAX wrapper's ``e_exp`` holds the same rows in the opposite order)."""
    max_pos = (rel_pos_emb.shape[0] - 1) // 2
    n_pad = -(-n // 128) * 128
    idx = torch.arange(2 * n_pad, device=rel_pos_emb.device) - (n_pad - 1)
    return rel_pos_emb.index_select(0, idx.clamp(-max_pos, max_pos) + max_pos)


def fused_conformer_attention(x, ln_w, ln_b, wqkv, rel_pos_emb, wo, bo, heads, scale=None):
    """x (b, n, d) -> x + conformer-attention(layer_norm(x)): kernel K4.

    CPU tensors run :func:`fused_conformer_attention_plain`. CUDA tensors
    must be bf16, contiguous and of a shape
    :func:`conformer_attention_shape_ok` takes; anything else raises. P
    comes from the table's rows. A head width other than 32, 64 or 128 runs
    at :func:`core_width`, W_qkv, the table and W_o padded per head (kept
    while they live unchanged). :func:`k4_plan` plans the launches. Each
    call adds one to ``fused_conformer_attention.launches``.
    """
    if x.device.type == "cpu":
        return fused_conformer_attention_plain(x, ln_w, ln_b, wqkv, rel_pos_emb, wo, bo,
                                               heads, scale)
    _build.refuse_export("fused_conformer_attention (K4)")
    _build.refuse_autograd("fused_conformer_attention (K4)", x, ln_w, ln_b, wqkv, rel_pos_emb,
                           wo, bo)
    b, n, d = x.shape
    hd = wqkv.shape[0] // 3
    dh = hd // heads
    if not conformer_attention_shape_ok(b, n, d, heads, dh) or wqkv.shape[0] != 3 * hd \
            or hd != heads * dh:
        raise ValueError(f"fused_conformer_attention: unsupported {b} sequences of {n}, d={d}, "
                         f"heads={heads}, dim_head={dh} (the kernel takes dim_head 1 to 128, d "
                         "a multiple of 64, at most 65535 sequences)")
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
    width = core_width(dh, heads)
    if width != dh:
        wqkv, wo, rel_pos_emb = padded_block_weights(wqkv, wo, dh, width, rel_pos_emb)
        dh, hd = width, heads * width
    plan = k4_plan(b, n, d, heads, dh,
                   torch.cuda.get_device_properties(x.device).multi_processor_count)
    core = plan["core"]
    table = shaw_table(rel_pos_emb, n) if core["route"] == "tiles" else None

    lib = _build.load("conformer_attention")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    tokens = b * n
    xn = torch.empty((tokens, d), dtype=x.dtype, device=x.device)
    qkv = torch.empty((tokens, 3 * hd), dtype=x.dtype, device=x.device)
    ao = torch.empty((tokens, hd), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    _build.check(lib.sesa_conf_attn_proj(x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(),
                                         xn.data_ptr(), wqkv.data_ptr(), qkv.data_ptr(),
                                         tokens, d, 3 * hd, plan["proj"]["grid"],
                                         plan["proj"]["smem"], stream), "sesa_conf_attn_proj")
    _build.check(lib.sesa_conf_attn_core(qkv.data_ptr(), None if table is None else
                                         table.data_ptr(), rel_pos_emb.data_ptr(), ao.data_ptr(),
                                         b, n, heads, dh, (rows - 1) // 2, float(scale),
                                         core["route_id"], *core["dims"], *core["strides"],
                                         *core["out_strides"], core["table_rows"], core["grid"],
                                         core["smem"], stream), "sesa_conf_attn_core")
    _build.check(lib.sesa_conf_attn_out(ao.data_ptr(), wo.data_ptr(), bo.data_ptr(),
                                        x.data_ptr(), out.data_ptr(), tokens, d, hd,
                                        plan["out"]["grid"], plan["out"]["smem"], stream),
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
# K7 (csrc/rope_attention.cu): TMA boxes of 64 columns (128 bytes, the
# 128-byte swizzle's span) and at most 256 rows, a ring of at most 4 stages
_K7_BOX_COLS, _K7_BOX_ROWS, _K7_MAX_STAGES = 64, 256, 4


def _k7_warps(dh: int):
    """The rope and attention warps of ``rope_attn_kernel<dh>`` (``RaCfg``),
    one producer warp beside them: 4 and 11 at dim_head ≤ 32, 3 and 8 up to
    64, 2 and 5 beyond."""
    return (4 if dh <= 32 else 3 if dh <= 64 else 2), (11 if dh <= 32 else 8 if dh <= 64 else 5)


def k7_widths(dh: int):
    """The packed head widths K7 may run a head of ``dh`` (1 to 128) at, in
    the order :func:`k7_plan` tries them: dh itself where it is a multiple
    of 8 (rows of 16-byte chunks, read as they lie), else dh rounded up to
    one; then the next multiple of 16, whose heads fill whole boxes in
    fewer heads (8 heads of 120 need 15 boxes a stage, 1 head of 128 two)."""
    w8, w16 = -(-dh // 8) * 8, -(-dh // 16) * 16
    return (w8,) if w8 == w16 else (w8, w16)


def _k7_plan_at(b: int, n: int, heads: int, width: int, rot: int, sms: int):
    """:func:`k7_plan` at a packed head width that is a multiple of 8."""
    n16 = -(-n // 16) * 16
    nbox = -(-n16 // _K7_BOX_ROWS)
    box_rows = -(-(-(-n16 // nbox)) // 8) * 8  # ⌈⌈n16 / nbox⌉ / 8⌉ · 8
    rows = nbox * box_rows
    g0 = _K7_BOX_COLS // math.gcd(width, _K7_BOX_COLS)  # fewest heads of whole boxes
    widest = max(1, 2 * _K7_BOX_COLS // (g0 * width)) if heads > g0 else 1

    # the cos and sin tables staged in rows of an odd number of 16-byte
    # chunks, so that 8 consecutive rows of a chunk lie in 8 bank groups
    staged = 2 * n * (-(-rot * 2 // 32) * 32 + 16) if rot else 0

    def stages_of(group, table):  # ring stages that fit: q, k, v slabs and 3 mbarriers each
        stage_bytes = 3 * (group * width // _K7_BOX_COLS) * rows * 128
        return min(_K7_MAX_STAGES, (_SMEM_LIMIT - 1024 - table) // (stage_bytes + 24))

    # the tables in shared memory where they fit, then the widest group with
    # two stages, else the widest with one
    fits = [(stages_of(g, table), g, table) for table in ((staged, 0) if staged else (0,))
            for least in (2, 1) for g in range(widest * g0, 0, -g0)
            if stages_of(g, table) >= least]
    if not fits:
        return None
    stages, group, table = fits[0]
    boxes = group * width // _K7_BOX_COLS
    stage_bytes = 3 * boxes * rows * 128
    groups = -(-heads // group)
    items = b * groups
    if items > 2 ** 31 - 1:
        return None
    slab = stages * boxes * rows * 128
    buffers = dict(q=slab, k=slab, v=slab, barriers=24 * stages, table=table, slack=1024)
    inst = -(-width // 16) * 16
    rope_warps, attn_warps = _k7_warps(inst)
    return dict(width=width, inst=inst, group=group, groups=groups, boxes=boxes, nbox=nbox,
                box_rows=box_rows, rows=rows, stages=stages, stage_bytes=stage_bytes,
                table=table, items=items, grid=min(items, sms), rope_warps=rope_warps,
                attn_warps=attn_warps, threads=32 * (1 + rope_warps + attn_warps),
                buffers=buffers, smem=sum(buffers.values()))


def k7_plan(b: int, n: int, heads: int, dh: int, rot: int, sms: int = 132):
    """The host side of kernel K7 for ``b`` sequences of ``n`` tokens, ``heads``
    × ``dh``, a rotary width ``rot`` (0: no rope), on a card of ``sms`` SMs;
    None for a shape the kernel cannot take.

    - ``width``, the packed head width the kernel runs (:func:`k7_widths`:
      the first that fits), ``repack`` = width ≠ dh (the wrapper then copies
      q, k and v to heads of ``width`` columns, zeros past dh, and the
      output back), and ``inst`` = width rounded up to 16, the width of the
      kernel's products (``rope_attn_kernel<width>`` runs its heads in
      16-column mma steps, the half of the last past width zeroed in q, and
      takes its warps by ``inst``);
    - ``group`` heads per item: their q, k and v columns are ``boxes`` whole
      64-column TMA boxes (the fewest heads that fill whole boxes, widened to
      128 columns where that takes several heads; the widest such group
      with two stages, else the widest with one);
      ``groups`` = ⌈heads / group⌉, the last one partial;
    - ``nbox`` boxes of ``box_rows`` rows (a multiple of 8, at most 256)
      along the sequence, ``rows`` in all, at least n rounded up to 16;
    - ``stages`` ring stages of q, k and v slabs, ``stage_bytes`` each, as
      many as fit up to 4 beside ``table``, the bytes of the cos and sin
      tables staged in shared memory (rows padded to an odd number of 16-byte
      chunks; 0: read from device memory, where staging them would leave no
      stage);
    - ``items`` = b · groups, the persistent ``grid`` (one block per SM,
      never more blocks than items; block i takes items i, i + grid, ...),
      ``rope_warps`` and ``attn_warps`` beside one producer warp
      (``threads``);
    - ``buffers``, the dynamic shared memory by buffer, and their sum
      ``smem`` (``csrc/rope_attention.cu`` ``ra_smem_bytes``).

    Every dim_head from 1 to 128 (the JAX gate ``_use_fused_band_attn`` fuses
    any). None where the rotary width is odd or wider than dim_head, or one
    stage does not fit in a block's shared memory at any of the widths (n
    beyond about 600 at 64 columns a group). ``csrc/rope_attention.cu``
    refuses a plan that does not match its layout."""
    if b < 1 or n < 1 or heads < 1 or not 1 <= dh <= 128 or rot < 0 or rot % 2 or rot > dh:
        return None
    for width in k7_widths(dh):
        plan = _k7_plan_at(b, n, heads, width, rot, sms)
        if plan is not None:
            return dict(plan, repack=width != dh)
    return None


def fused_rope_attention(qkv, heads, scale, rope=None):
    """Packed-qkv attention, (b, n, 3·h·dh) -> (b, n, h·dh): kernel K7.

    ``rope`` is the interleaved-convention (cos, sin) table pair of shape
    (n, w) with w ≤ dh (partial rotary rotates only the leading w dims);
    ``None`` skips it. ``scale`` multiplies q·kᵀ (the caller's, e.g. the
    real dh ** -0.5). CPU tensors run :func:`fused_rope_attention_plain`.
    CUDA tensors must be bf16 and contiguous, of a shape :func:`k7_plan`
    takes (any dim_head up to 128, an even w); anything else raises. A plan
    that runs the heads wider than dh (``repack``: dh not a multiple of 8,
    or 8 heads of 72, 88, 104 or 120 at Apollo's 80 bands) copies q, k and v
    to heads of the plan's width, zero-padded, and the output back: two
    more passes over the qkv bytes, which a caller avoids by padding its
    projection per head (Apollo's band layer). Each call adds one to
    ``fused_rope_attention.launches``.
    """
    if qkv.device.type == "cpu":
        return fused_rope_attention_plain(qkv, heads, scale, rope)
    _build.refuse_export("fused_rope_attention (K7)")
    _build.refuse_autograd("fused_rope_attention (K7)", qkv, rope)
    b, n, packed = qkv.shape
    dh = packed // (3 * heads)
    w = 0 if rope is None else rope[0].shape[-1]
    if packed != 3 * heads * dh or k7_plan(b, n, heads, dh, w) is None:
        raise ValueError(f"fused_rope_attention: unsupported {b} sequences of {n}, packed width "
                         f"{packed} for {heads} heads, rotary width {w} (the kernel takes "
                         "dim_head up to 128, an even rotary width up to dim_head, and "
                         "sequences whose q, k and v fit in shared memory)")
    _build.check_tensor("fused_rope_attention", "qkv", qkv, (b, n, packed), torch.bfloat16)
    cos_p = sin_p = None
    if rope is not None:
        for name, t in zip(("cos", "sin"), rope):
            _build.check_tensor("fused_rope_attention", name, t, (n, w), torch.bfloat16)
        cos_p, sin_p = rope[0].data_ptr(), rope[1].data_ptr()
    plan = k7_plan(b, n, heads, dh, w,
                   torch.cuda.get_device_properties(qkv.device).multi_processor_count)
    width = plan["width"]
    if plan["repack"]:
        qkv = pad_heads(qkv, dh, width)

    lib = _build.load("rope_attention")
    out = torch.empty((b, n, heads * width), dtype=qkv.dtype, device=qkv.device)
    _build.check(lib.sesa_rope_attn(qkv.data_ptr(), cos_p, sin_p, out.data_ptr(), b, n, heads,
                                    width, plan["group"], w, plan["nbox"], plan["box_rows"],
                                    plan["stages"], plan["table"], plan["grid"], plan["smem"],
                                    float(scale),
                                    torch.cuda.current_stream(qkv.device).cuda_stream),
                 "sesa_rope_attn")
    fused_rope_attention.launches += 1
    return unpad_heads(out, dh, width) if plan["repack"] else out


fused_rope_attention.launches = 0
