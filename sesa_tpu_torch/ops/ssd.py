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
once for a batch row's heads; ``k8_plan`` is its launch plan. The kernel is
built for (P, N, chunk) = (64, 128, 64) and the wrapper takes every (P, N,
chunk) the JAX gate fuses around it: P zero-padded to 64-column
pseudo-heads, L to whole chunks of 64, and N in slices of 128 summed in f32.
``ssd_plain`` repeats the kernel's arithmetic chunk by chunk in PyTorch, and
``ssd_fused_plain`` the whole wrapper's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sesa_tpu_torch.ops import _build

# the (head_dim P, state N, chunk Q) the kernel is built for: Mamba-2's
# sizes in TS-BS-Mamba2; other sizes are run as pseudo-heads of 64 columns,
# slices of 128 state columns and chunks of 64
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
    multiple of the chunk, P a multiple of 8, N of 128 and the chunk of 8:
    every shape the JAX gate ``use_pallas_ssd`` fuses
    (sesa_tpu/ops/ssd.py:190-210)."""
    return (x.device.type == "cuda" and x.dtype in (torch.float32, torch.bfloat16)
            and x.dtype == a.dtype == b.dtype == c.dtype and b.shape[-2] == 1
            and chunk_size > 0 and chunk_size % 8 == 0 and x.shape[1] % chunk_size == 0
            and x.shape[1] > 0 and x.shape[-1] > 0 and x.shape[-1] % 8 == 0
            and b.shape[-1] > 0 and b.shape[-1] % 128 == 0)


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


def k8_plan(bsz: int, l: int, h: int, dtype, p: int = 64, n: int = 128,
            chunk: int = 64) -> dict:
    """The host side of kernel K8: how the wrapper lays (B, L, H, P) with
    state N and ``chunk`` out for the kernel's (64, 128, 64), and which of
    its two kernels runs and how.

    The layout: ``head_cols`` = P rounded up to 64 (x zero-padded per head),
    ``pseudo_heads`` = H · head_cols / 64 heads of 64 columns, each with its
    head's decays; ``steps`` = L rounded up to 64 (x, a, b and c
    zero-padded: an exact no-op for the steps before), scanned in chunks of
    64 whatever ``chunk`` (the scan's result does not depend on it);
    ``slices`` = N / 128 launches, one per 128 state columns, their f32 y
    summed in an f32 buffer of ``scratch`` bytes (0 for one slice) and
    rounded once.

    The kernel: ``steps`` = 64 (one chunk: no state) takes "rows", which
    gives each block one batch row, whose heads it walks computing C·Bᵀ
    once; longer takes "carried", which gives each block one (batch row,
    pseudo-head) pair, whose chunks it walks with the state in registers.
    Returns the variant, the heads per block, the grid, the dynamic shared
    memory in bytes (the sizes ``csrc/ssd.cu`` lays out, which it checks)
    and the blocks per SM that the kernel's launch bounds plan for (two, but
    one carried block in f32), which the shared memory must let fit."""
    kp, kn, q = _K8_SIZES
    head_cols = -(-p // kp) * kp
    heads_run = h * head_cols // kp
    steps = -(-l // q) * q
    slices = -(-n // kn)
    rows = steps == q
    el = 2 if dtype == torch.bfloat16 else 4
    ldx, ldn, ldy = (kp + 8 if el == 2 else kp + 4), kn + 8, q + 8
    x_tile, bc_tile = q * ldx * el, q * ldn * el
    if rows:
        # B, C, two stages of x, the decay sums of a group of heads
        smem = 2 * bc_tile + 2 * x_tile + _K8_HEAD_GROUP * q * 4
        heads, grid = heads_run, bsz
    else:
        # x, B and C (two stages in f32, which copies the next chunk's while
        # this one's run; one in bf16, which fits two blocks per SM instead);
        # the two halves of C·stateᵀ and one of the decayed C·Bᵀ·X; two
        # stages of three decay vectors
        stages = 1 if el == 2 else 2
        smem = stages * (x_tile + 2 * bc_tile) + 3 * kp * ldy * 4 + 2 * 3 * q * 4
        heads, grid = 1, bsz * heads_run
    scratch = 0 if slices == 1 else bsz * steps * heads_run * kp * 4
    return dict(variant="rows" if rows else "carried", heads_per_block=heads, grid=grid,
                smem=smem, blocks_per_sm=2 if rows or el == 2 else 1, head_cols=head_cols,
                pseudo_heads=heads_run, steps=steps, chunk=q, slices=slices, scratch=scratch)


def _k8_layout(x, a, b, c, plan):
    """x, a, b, c laid out as :func:`k8_plan` says: P padded per head to
    ``head_cols`` and viewed as ``pseudo_heads`` of 64 columns (a repeated
    for each), L padded with zeros to ``steps``. x and a come out
    contiguous; b and c as they were where L needs no padding."""
    bsz, l, h, p = x.shape
    cols, steps = plan["head_cols"], plan["steps"]
    if cols != p:
        x = F.pad(x, (0, cols - p))
    if steps != l:
        x = F.pad(x, (0, 0, 0, 0, 0, steps - l))
        a = F.pad(a, (0, 0, 0, steps - l))
        b, c = (F.pad(t, (0, 0, 0, 0, 0, steps - l)) for t in (b, c))
    x = x.contiguous().reshape(bsz, steps, plan["pseudo_heads"], _K8_SIZES[0])
    if cols > _K8_SIZES[0]:
        a = a.repeat_interleave(cols // _K8_SIZES[0], dim=2)
    return x, a.contiguous(), b, c


def _k8_unlayout(y, shape, plan):
    """The kernel's (B, steps, pseudo_heads, 64) y as the caller's (B, L, H,
    P), contiguous."""
    bsz, l, h, p = shape
    y = y.reshape(bsz, plan["steps"], h, plan["head_cols"])
    if plan["steps"] != l or plan["head_cols"] != p:
        y = y[:, :l, :, :p].contiguous()
    return y


def ssd_fused_plain(x, a, b, c, chunk_size: int = 64):
    """Plain PyTorch K8 as the wrapper runs it: the layout of :func:`k8_plan`
    (64-column pseudo-heads, L padded to chunks of 64) around
    :func:`ssd_plain` at chunk 64, with all N at once (the kernel sums its
    128-column slices in f32: another association of the same f32 sums)."""
    bsz, l, h, p = x.shape
    plan = k8_plan(bsz, l, h, x.dtype, p, b.shape[-1], chunk_size)
    y = ssd_plain(*_k8_layout(x, a, b, c, plan), chunk_size=plan["chunk"])
    return _k8_unlayout(y, x.shape, plan)


def ssd_fused(x, a, b, c, chunk_size: int = 64):
    """Chunked SSD scan, same contract as :func:`ssd` with G = 1: kernel K8.

    CPU tensors run :func:`ssd_fused_plain`. CUDA tensors must be f32 or
    bf16 (all four of one dtype) with G = 1, L a multiple of the chunk, P a
    multiple of 8, N of 128 and the chunk of 8 (:func:`use_fused_ssd`);
    anything else raises. :func:`k8_plan` lays the shape out for the
    kernel's (64, 128, 64) and picks the kernel; the kernel runs once per
    128 state columns. x and a are read contiguous (copies where P or L are
    padded); b and c are read where they lie when their rows are contiguous
    and 16-byte aligned (they reach the scan as column slices of the conv
    output), else copied. Each call adds one to ``ssd_fused.launches`` and to
    ``ssd_fused.launches_by_dtype``.
    """
    if x.device.type == "cpu":
        return ssd_fused_plain(x, a, b, c, chunk_size)
    _build.refuse_export("ssd_fused (K8)")
    _build.refuse_autograd("ssd_fused (K8)", x, a, b, c)
    if not use_fused_ssd(x, a, b, c, chunk_size):
        raise ValueError(f"ssd_fused: unsupported x {x.dtype} {tuple(x.shape)}, a "
                         f"{a.dtype} {tuple(a.shape)}, b {b.dtype} {tuple(b.shape)}, chunk "
                         f"{chunk_size} (the kernel takes f32 or bf16, G = 1, L a multiple of "
                         "the chunk, P a multiple of 8, N of 128 and the chunk of 8)")
    bsz, l, h, p = x.shape
    n = b.shape[-1]
    if tuple(a.shape) != (bsz, l, h) or tuple(b.shape) != (bsz, l, 1, n) or b.shape != c.shape:
        raise ValueError(f"ssd_fused: a {tuple(a.shape)}, b {tuple(b.shape)}, c "
                         f"{tuple(c.shape)} do not fit x {tuple(x.shape)}")
    plan = k8_plan(bsz, l, h, x.dtype, p, n, chunk_size)
    if plan["grid"] > 2 ** 31 - 1 or plan["smem"] > _SMEM_BLOCK_MAX:
        raise ValueError(f"ssd_fused: batch {bsz} x heads {plan['pseudo_heads']} exceed one "
                         f"launch ({plan})")
    shape = x.shape
    x, a, b, c = _k8_layout(x, a, b, c, plan)
    per16 = 16 // x.element_size()

    def rows(t):
        if t.stride(3) != 1 or t.stride(0) % per16 or t.stride(1) % per16 or t.data_ptr() % 16:
            t = t.contiguous()
        return t

    b, c = rows(b), rows(c)
    for name, t in (("x", x), ("a", a)):
        _build.check_tensor("ssd_fused", name, t, t.shape, x.dtype)
    y = torch.empty_like(x)
    slices, bf16 = plan["slices"], x.dtype == torch.bfloat16
    ysum = torch.empty(y.shape, dtype=torch.float32, device=y.device) if slices > 1 else None
    lib = _build.load("ssd")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    step = _K8_SIZES[1] * x.element_size()  # bytes of a slice's 128 columns
    for s in range(slices):
        part = 0 if slices == 1 else 1 if s == 0 else 3 if s == slices - 1 else 2
        _build.check(lib.sesa_ssd(x.data_ptr(), a.data_ptr(), b.data_ptr() + s * step,
                                  c.data_ptr() + s * step, y.data_ptr(),
                                  None if ysum is None else ysum.data_ptr(), part,
                                  b.stride(0), b.stride(1), c.stride(0), c.stride(1), bsz,
                                  plan["steps"], plan["pseudo_heads"], int(bf16),
                                  int(plan["variant"] == "rows"), plan["smem"], plan["grid"],
                                  stream), "sesa_ssd")
    ssd_fused.launches += 1
    ssd_fused.launches_by_dtype["bf16" if bf16 else "f32"] += 1
    return _k8_unlayout(y, shape, plan)


ssd_fused.launches = 0
ssd_fused.launches_by_dtype = {"bf16": 0, "f32": 0}
