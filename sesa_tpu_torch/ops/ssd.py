"""Mamba-2 SSD (state-space dual) chunked scan (counterpart of
sesa_tpu/ops/ssd.py).

The sequence is cut into chunks; inside a chunk the outputs use a
lower-triangular decay mask, each chunk's final state is decayed and carried
to the next chunk, and the carried state's contribution is added back per
position. ``ssd`` dispatches: ``ssd_einsum`` is the math spec as batched
einsums, the path of the CPU and of every shape the kernel's gate refuses,
and ``ssd_fused`` is kernel K8
(``csrc/ssd.cu``): one pass that keeps the (P, N) state of a (batch, head)
pair on chip across the chunks, or, for one-chunk sequences, computes C·Bᵀ
once for a batch row's heads; ``k8_plan`` is its launch plan. ``ssd_plain``
repeats the kernel's arithmetic chunk by chunk in PyTorch.
"""

from __future__ import annotations

import torch

from sesa_tpu_torch.ops import _build

# the one (head_dim P, state N, chunk Q) the kernel is built for: Mamba-2's
# sizes in TS-BS-Mamba2
_K8_SIZES = (64, 128, 64)
# shared memory a block may opt into on the H100
_SMEM_BLOCK_MAX = 232448
# heads whose decay sums the one-chunk kernel scans at once (one per warp)
_K8_HEAD_GROUP = 8


def segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment sum: (..., T) -> (..., T, T) with entry [i, j] =
    sum_{k=j+1..i} x[k] on the lower triangle, -inf above the diagonal."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def use_fused_ssd(x, a, b, c, chunk_size) -> bool:
    """The gate of kernel K8, on device, dtype and shape only: CUDA tensors of
    one dtype (f32 or bf16), B and C shared by the heads (G = 1), L a
    multiple of the chunk, and (P, N, chunk) = (64, 128, 64)."""
    return (x.device.type == "cuda" and x.dtype in (torch.float32, torch.bfloat16)
            and x.dtype == a.dtype == b.dtype == c.dtype
            and b.shape[-2] == 1 and x.shape[1] % chunk_size == 0 and x.shape[1] > 0
            and (x.shape[-1], b.shape[-1], chunk_size) == _K8_SIZES)


def ssd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
        chunk_size: int = 64) -> torch.Tensor:
    """Chunked SSD scan.

    Args:
      x: (B, L, H, P) inputs (already scaled by dt)
      a: (B, L, H) log-decay per step (A * dt, negative)
      b: (B, L, G, N) input projections (G groups, broadcast over heads)
      c: (B, L, G, N) output projections
    Returns:
      y: (B, L, H, P)
    L must be a multiple of chunk_size (pad upstream). Tensors that
    :func:`use_fused_ssd` takes run kernel K8; everything else runs
    :func:`ssd_einsum`.
    """
    if use_fused_ssd(x, a, b, c, chunk_size):
        return ssd_fused(x, a, b, c, chunk_size=chunk_size)
    return ssd_einsum(x, a, b, c, chunk_size=chunk_size)


def ssd_einsum(x, a, b, c, chunk_size: int = 64):
    """The chunked SSD scan as batched einsums: the math spec (same contract
    as :func:`ssd`)."""
    bsz, l, h, p = x.shape
    g, n = b.shape[-2], b.shape[-1]
    if l % chunk_size:
        raise ValueError(f"ssd: length {l} is not a multiple of the chunk {chunk_size}")
    nc = l // chunk_size

    x = x.reshape(bsz, nc, chunk_size, h, p)
    b = b.reshape(bsz, nc, chunk_size, g, n)
    c = c.reshape(bsz, nc, chunk_size, g, n)
    a = a.reshape(bsz, nc, chunk_size, h).permute(0, 3, 1, 2)  # (B, H, nc, Q)
    a_cumsum = torch.cumsum(a, dim=-1)

    # 1. intra-chunk (diagonal blocks)
    ldecay = torch.exp(segsum(a))  # (B, H, nc, Q, Q)
    y_diag = torch.einsum("bclgn,bcsgn,bhcls,bcshp->bclhp", c, b, ldecay, x)

    # 2. per-chunk final states
    decay_states = torch.exp(a_cumsum[..., -1:] - a_cumsum)  # (B, H, nc, Q)
    states = torch.einsum("bclgn,bhcl,bclhp->bchpn", b, decay_states, x)

    # 3. inter-chunk recurrence over chunk boundaries
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    chunk_decay = torch.exp(segsum(torch.nn.functional.pad(a_cumsum[..., -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", chunk_decay, states)[:, :-1]

    # 4. state -> output per position
    y_off = torch.einsum("bclgn,bchpn,bhcl->bclhp", c, states, torch.exp(a_cumsum))

    return (y_diag + y_off).reshape(bsz, l, h, p)


def ssd_plain(x, a, b, c, chunk_size: int = 64):
    """Plain PyTorch K8: the kernel's arithmetic, chunk by chunk, with the
    (H, P, N) state carried in f32 (sesa_tpu/ops/ssd.py ``_ssd_kernel``).
    Inputs are cast to f32, every product and sum is f32, and the result is
    rounded to the input dtype on the way out. G must be 1."""
    bsz, l, h, p = x.shape
    n = b.shape[-1]
    if b.shape[-2] != 1 or l % chunk_size:
        raise ValueError(f"ssd_plain: needs G = 1 and L a multiple of {chunk_size}; got "
                         f"G = {b.shape[-2]}, L = {l}")
    f32 = torch.float32
    q = chunk_size
    tril = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    state = torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
    out = torch.empty((bsz, l, h, p), dtype=x.dtype, device=x.device)
    for t0 in range(0, l, q):
        xq = x[:, t0:t0 + q].to(f32).permute(0, 2, 1, 3)  # (B, H, Q, P)
        bq = b[:, t0:t0 + q, 0].to(f32)  # (B, Q, N)
        cq = c[:, t0:t0 + q, 0].to(f32)
        ah = torch.cumsum(a[:, t0:t0 + q].to(f32).permute(0, 2, 1), dim=-1)  # (B, H, Q)
        a_last = ah[..., -1:]
        cbt = cq @ bq.transpose(-1, -2)  # (B, Q, Q), shared by the heads
        # the masked upper triangle is clamped so that the exp never overflows
        diff = (ah[..., :, None] - ah[..., None, :]).clamp_max(0.0)
        lmat = torch.where(tril, torch.exp(diff), torch.zeros((), dtype=f32, device=x.device))
        y = (lmat * cbt[:, None]) @ xq  # (B, H, Q, P)
        y = y + torch.exp(ah)[..., None] * (cq[:, None] @ state.transpose(-1, -2))
        out[:, t0:t0 + q] = y.permute(0, 2, 1, 3).to(x.dtype)
        wb = torch.exp(a_last - ah)[..., None] * bq[:, None]  # (B, H, Q, N)
        state = torch.exp(a_last)[..., None] * state + xq.transpose(-1, -2) @ wb
    return out


def k8_plan(bsz: int, l: int, h: int, dtype) -> dict:
    """The host side of kernel K8: which of its two kernels runs and how.

    L = 64 (one chunk: no state) takes "rows", which gives each block one
    batch row, whose heads it walks computing C·Bᵀ once; any longer L takes
    "carried", which gives each block one (batch row, head) pair, whose
    chunks it walks with the state in registers. Returns the variant, the
    heads per block, the grid, the dynamic shared memory in bytes (the sizes
    ``csrc/ssd.cu`` lays out, which it checks) and the blocks per SM that the
    kernel's launch bounds plan for (two, but one carried block in f32),
    which the shared memory must let fit."""
    rows = l == _K8_SIZES[2]
    p, n, q = _K8_SIZES
    el = 2 if dtype == torch.bfloat16 else 4
    ldx, ldn, ldy = (p + 8 if el == 2 else p + 4), n + 8, q + 8
    x_tile, bc_tile = q * ldx * el, q * ldn * el
    if rows:
        # B, C, two stages of x, the decay sums of a group of heads
        smem = 2 * bc_tile + 2 * x_tile + _K8_HEAD_GROUP * q * 4
        heads, grid = h, bsz
    else:
        # x, B and C (two stages in f32, which copies the next chunk's while
        # this one's run; one in bf16, which fits two blocks per SM instead);
        # the two halves of C·stateᵀ and one of the decayed C·Bᵀ·X; two
        # stages of three decay vectors
        stages = 1 if el == 2 else 2
        smem = stages * (x_tile + 2 * bc_tile) + 3 * p * ldy * 4 + 2 * 3 * q * 4
        heads, grid = 1, bsz * h
    return dict(variant="rows" if rows else "carried", heads_per_block=heads, grid=grid,
                smem=smem, blocks_per_sm=2 if rows or el == 2 else 1)


def ssd_fused(x, a, b, c, chunk_size: int = 64):
    """Chunked SSD scan, same contract as :func:`ssd` with G = 1: kernel K8.

    CPU tensors run :func:`ssd_plain`. CUDA tensors must be f32 or bf16 (all
    four of one dtype) with G = 1, L a multiple of the chunk and
    (P, N, chunk) = (64, 128, 64); anything else raises. x and a are read
    contiguous; b and c are read where they lie when their rows are
    contiguous and 16-byte aligned (they reach the scan as column slices of
    the conv output), else copied. :func:`k8_plan` picks the kernel. Each
    call adds one to ``ssd_fused.launches`` and to
    ``ssd_fused.launches_by_dtype``.
    """
    if x.device.type == "cpu":
        return ssd_plain(x, a, b, c, chunk_size)
    _build.refuse_autograd("ssd_fused (K8)", x, a, b, c)
    if not use_fused_ssd(x, a, b, c, chunk_size):
        raise ValueError(f"ssd_fused: unsupported x {x.dtype} {tuple(x.shape)}, a "
                         f"{a.dtype} {tuple(a.shape)}, b {b.dtype} {tuple(b.shape)}, chunk "
                         f"{chunk_size} (the kernel takes f32 or bf16, G = 1, L a multiple of "
                         f"the chunk and (P, N, chunk) = {_K8_SIZES})")
    bsz, l, h, p = x.shape
    n = b.shape[-1]
    if tuple(a.shape) != (bsz, l, h) or tuple(b.shape) != (bsz, l, 1, n) or b.shape != c.shape:
        raise ValueError(f"ssd_fused: a {tuple(a.shape)}, b {tuple(b.shape)}, c "
                         f"{tuple(c.shape)} do not fit x {tuple(x.shape)}")
    plan = k8_plan(bsz, l, h, x.dtype)
    if plan["grid"] > 2 ** 31 - 1 or plan["smem"] > _SMEM_BLOCK_MAX:
        raise ValueError(f"ssd_fused: batch {bsz} x heads {h} exceed one launch ({plan})")
    x, a = x.contiguous(), a.contiguous()
    per16 = 16 // x.element_size()

    def rows(t):
        if t.stride(3) != 1 or t.stride(0) % per16 or t.stride(1) % per16 or t.data_ptr() % 16:
            t = t.contiguous()
        return t

    b, c = rows(b), rows(c)
    for name, t in (("x", x), ("a", a)):
        _build.check_tensor("ssd_fused", name, t, t.shape, x.dtype)
    y = torch.empty_like(x)
    lib = _build.load("ssd")
    _build.check(lib.sesa_ssd(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                              y.data_ptr(), b.stride(0), b.stride(1), c.stride(0), c.stride(1),
                              bsz, l, h, int(x.dtype == torch.bfloat16),
                              int(plan["variant"] == "rows"), plan["smem"], plan["grid"],
                              torch.cuda.current_stream(x.device).cuda_stream), "sesa_ssd")
    ssd_fused.launches += 1
    ssd_fused.launches_by_dtype["bf16" if x.dtype == torch.bfloat16 else "f32"] += 1
    return y


ssd_fused.launches = 0
ssd_fused.launches_by_dtype = {"bf16": 0, "f32": 0}
