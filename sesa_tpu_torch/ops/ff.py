"""Fused transformer FeedForward (counterpart of sesa_tpu/ops/ff.py).

``fused_ff_residual`` is kernel K2: norm -> Linear -> act -> Linear
(× out_scale) -> + x over (tokens, dim), in two forms: the roformer's
(RMSNorm, tanh-GELU) and the conformer's (LayerNorm with γ and β, SiLU,
out_scale 0.5). On a CUDA tensor it launches the hand-written kernel chain
of ``csrc/ff.cu`` (a norm pass and two persistent GEMMs, ``csrc/gemm_ws.cuh``,
whose grid :func:`ff_gemm_schedule` sets); on a CPU tensor it runs
``fused_ff_residual_plain``, which repeats the TPU kernel's arithmetic with
its bf16 rounding points.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sesa_tpu_torch.ops import _build

_FORMS = {("rms", "gelu"): 0, ("ln", "swish"): 1}


def layer_norm_rounded(x, gamma, beta):
    """The TPU kernels' LayerNorm (ff.py:44-48, attention.py:594-599,
    convblock.py:77-82): f32 mean and biased variance, eps 1e-5,
    xn = bf16((x - μ)·rsqrt(σ² + eps)) · γ + β in the working dtype."""
    dt = x.dtype
    xf = x.to(torch.float32)
    xc = xf - xf.mean(dim=-1, keepdim=True)
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return (xc * torch.rsqrt(var + 1e-5)).to(dt) * gamma.to(dt) + beta.to(dt)


def fused_ff_residual_plain(x, gamma, w1, b1, w2, b2, *, beta=None, norm="rms",
                            act="gelu", out_scale=1.0):
    """Plain PyTorch K2 with the TPU kernel's rounding points: xn after
    the norm and γ (β), h after the activation (sesa_tpu/ops/ff.py:55-57)
    and y before the residual add (ff.py:71); products accumulate in f32."""
    dt = x.dtype
    f32 = torch.float32
    xf = x.to(f32)
    if norm == "rms":
        nrm = torch.linalg.vector_norm(xf, dim=-1, keepdim=True)
        xn = (xf * ((x.shape[-1] ** 0.5) / nrm.clamp_min(1e-12))).to(dt) * gamma.to(dt)
    else:
        xn = layer_norm_rounded(x, gamma, torch.zeros_like(gamma) if beta is None else beta)
    h = xn.to(f32) @ w1.to(f32).T + b1.to(f32)
    h = (F.gelu(h, approximate="tanh") if act == "gelu" else h * torch.sigmoid(h)).to(dt)
    y = h.to(f32) @ w2.to(f32).T + b2.to(f32)
    if out_scale != 1.0:
        y = y * out_scale
    return y.to(dt) + x


# output tile of K2's persistent GEMM (csrc/gemm_ws.cuh WS_BM x WS_BN)
_TILE = 128


def ws_smem_bytes(k: int) -> int:
    """Dynamic shared memory of a persistent GEMM at depth ``k``: the layout
    of ``csrc/gemm_ws.cuh`` ``WsLayout`` (at k ≤ 512 the B slice resident, 8
    k-steps of 16 KB, and a ring of 4 A stages; else a ring of 5 A + B
    stages; two 16 KB staging tiles, the mbarriers, 1024 bytes of alignment
    slack)."""
    slice_bytes = 128 * 64 * 2
    if k <= 8 * 64:
        stages, ring = 4, 8 * slice_bytes + 4 * slice_bytes
    else:
        stages, ring = 5, 5 * 2 * slice_bytes
    return ring + 2 * 64 * _TILE * 2 + 8 * (2 * stages + 3) + 1024


def ff_gemm_schedule(tokens: int, n: int, sms: int):
    """The persistent grid of one of K2's products over a (tokens, n) output:
    ``(tiles, grid)``, with ⌈tokens / 128⌉ · ⌈n / 128⌉ tiles of 128 × 128 and
    as many blocks as fit one per SM in a multiple of the ⌈n / 128⌉ column
    blocks, never more blocks than tiles. Block ``b`` takes tiles ``b, b +
    grid, ...`` (its first consumer warpgroup the even ones of that list, its
    second the odd ones); tile ``i`` covers rows ``128·(i // n_tiles)`` and
    columns ``128·(i % n_tiles)``, so each block keeps one column block of
    the weights and walks along the rows."""
    n_tiles = -(-n // _TILE)
    tiles = -(-tokens // _TILE) * n_tiles
    return tiles, min(tiles, max(1, sms // n_tiles) * n_tiles)


def ff_shape_ok(tokens: int, dim: int, hidden: int) -> bool:
    """The shapes kernel K2 takes: dim and hidden multiples of 64 and a token
    count one launch covers. :func:`fused_ff_residual` raises on a CUDA
    tensor exactly where this is false."""
    return dim % 64 == 0 and hidden % 64 == 0 and -(-tokens // _TILE) <= 65535


def use_fused_ff(x: torch.Tensor, w1: torch.Tensor) -> bool:
    """The gate of kernel K2 for the roformer stacks, on device, dtype and
    shape only: a CUDA bf16 x (..., dim) of a shape :func:`ff_shape_ok`
    takes."""
    dim = x.shape[-1]
    return (x.device.type == "cuda" and x.dtype == torch.bfloat16
            and ff_shape_ok(x.numel() // dim, dim, w1.shape[0]))


def fused_ff_residual(x, gamma, w1, b1, w2, b2, *, beta=None, norm="rms", act="gelu",
                      out_scale=1.0):
    """x (tokens, dim) -> x + out_scale·(W₂·act(W₁·norm(x)+b₁)+b₂): kernel K2.

    ``norm="rms", act="gelu"`` is the roformer form; ``norm="ln"`` (with
    ``beta``), ``act="swish"`` and ``out_scale=0.5`` the conformer's.
    Weights stay in torch (out_features, in_features) layout. CPU tensors
    run :func:`fused_ff_residual_plain`. CUDA tensors must be bf16 and
    contiguous with dim and hidden multiples of 64; anything else raises.
    Each call adds one to ``fused_ff_residual.launches``.
    """
    if (norm, act) not in _FORMS:
        raise ValueError(f"fused_ff_residual: unsupported form norm={norm!r}, act={act!r}; "
                         f"the kernel takes {sorted(_FORMS)}")
    if x.device.type == "cpu":
        return fused_ff_residual_plain(x, gamma, w1, b1, w2, b2, beta=beta, norm=norm,
                                       act=act, out_scale=out_scale)
    _build.refuse_export("fused_ff_residual (K2)")
    _build.refuse_autograd("fused_ff_residual (K2)", x, gamma, w1, b1, w2, b2, beta)
    tokens, dim = x.shape
    hidden = w1.shape[0]
    if not ff_shape_ok(tokens, dim, hidden):
        raise ValueError(f"fused_ff_residual: unsupported {tokens} tokens of dim {dim}, hidden "
                         f"{hidden} (the kernel takes dim and hidden multiples of 64 and at "
                         f"most {65535 * _TILE} tokens)")
    if norm == "ln" and beta is None:
        beta = torch.zeros_like(gamma)
    checks = [("x", x, (tokens, dim)), ("gamma", gamma, (dim,)), ("w1", w1, (hidden, dim)),
              ("b1", b1, (hidden,)), ("w2", w2, (dim, hidden)), ("b2", b2, (dim,))]
    if norm == "ln":
        checks.append(("beta", beta, (dim,)))
    for name, t, shape in checks:
        _build.check_tensor("fused_ff_residual", name, t, shape, torch.bfloat16)

    lib = _build.load("ff")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    xn = torch.empty_like(x)
    h = torch.empty((tokens, hidden), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    _build.check(lib.sesa_ff_up(x.data_ptr(), gamma.data_ptr(),
                                beta.data_ptr() if norm == "ln" else None, xn.data_ptr(),
                                w1.data_ptr(), b1.data_ptr(), h.data_ptr(), tokens, dim, hidden,
                                _FORMS[(norm, act)], ff_gemm_schedule(tokens, hidden, sms)[1],
                                stream), "sesa_ff_up")
    _build.check(lib.sesa_ff_down(h.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                                  x.data_ptr(), out.data_ptr(), tokens, dim, hidden,
                                  float(out_scale), ff_gemm_schedule(tokens, dim, sms)[1],
                                  stream), "sesa_ff_down")
    fused_ff_residual.launches += 1
    return out


fused_ff_residual.launches = 0
