"""K1 (fused attention block) of the port held against sesa_tpu's Pallas
kernel run in interpret mode on the CPU, with the cases of
tests/test_fused_attention.py, plus the plain einsum ``sdpa`` and the host
side of kernel K3 (the TMA tensor maps it reads its inputs through)."""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sesa_tpu.ops.attention import fused_attention_block as jax_fused_attention_block
from sesa_tpu.ops.attention import sdpa as jax_sdpa
from sesa_tpu_torch.ops import attention as attn_ops
from sesa_tpu_torch.ops.attention import (fused_attention_block,
                                          fused_attention_block_plain, k1_plan, k3_plan, sdpa)
from sesa_tpu_torch.ops.rope import default_freqs, rope_tables


def _inputs(b, n, heads, dh, rot, seed):
    rng = np.random.default_rng(seed)
    d = heads * dh
    mk = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    arrays = [mk(b, n, d), mk(d), mk(3 * d, d, sc=0.1), mk(heads, d, sc=0.1), mk(heads),
              mk(d, d, sc=0.1)]
    rope_np = None
    if rot is not None:
        rope_np = tuple(np.asarray(r) for r in rope_tables(torch.from_numpy(default_freqs(rot)), n))
    return arrays, rope_np


def _both(arrays, rope_np, heads, dh, dtype_t, dtype_j):
    got = fused_attention_block_plain(
        *(torch.from_numpy(a).to(dtype_t) for a in arrays), heads, dh ** -0.5,
        rope=None if rope_np is None else tuple(torch.from_numpy(r).to(dtype_t) for r in rope_np))
    ref = jax_fused_attention_block(
        *(jnp.asarray(a, dtype_j) for a in arrays), heads, dh ** -0.5,
        rope=None if rope_np is None else tuple(jnp.asarray(r, dtype_j) for r in rope_np),
        interpret=True)
    return got.float().numpy(), np.asarray(ref, np.float32)


# the cases and f32 tolerance of tests/test_fused_attention.py
@pytest.mark.parametrize("b,n,heads,dh,rot", [
    (3, 40, 2, 16, 16),    # full rotary
    (2, 33, 3, 32, 8),     # partial rotary
    (13, 12, 2, 8, None),  # short seq, no rope
])
def test_plain_matches_pallas_f32(b, n, heads, dh, rot):
    arrays, rope_np = _inputs(b, n, heads, dh, rot, n + b)
    got, ref = _both(arrays, rope_np, heads, dh, torch.float32, jnp.float32)
    np.testing.assert_allclose(got, ref, atol=3e-5, rtol=2e-5)


@pytest.mark.parametrize("b,n,heads,dh,rot", [(3, 40, 2, 16, 16), (2, 62, 2, 32, 32)])
def test_plain_matches_pallas_bf16(b, n, heads, dh, rot):
    """Both round to bf16 at the same points; only the f32 summation order of
    the products differs, which can flip a rounded value by one bf16 ulp
    (2**-8 relative). Bound: max error <= 2% of the output's largest value,
    and 99% of elements within one output ulp."""
    arrays, rope_np = _inputs(b, n, heads, dh, rot, 7 * n)
    got, ref = _both(arrays, rope_np, heads, dh, torch.bfloat16, jnp.bfloat16)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 0.02 * scale
    ulp = np.maximum(np.abs(ref), 1e-3) * 2.0 ** -7
    assert np.mean(np.abs(got - ref) <= ulp) >= 0.99


def test_wrapper_runs_plain_on_cpu():
    arrays, rope_np = _inputs(2, 20, 2, 16, 16, 1)
    ts = [torch.from_numpy(a) for a in arrays]
    rope = tuple(torch.from_numpy(r) for r in rope_np)
    before = fused_attention_block.launches
    got = fused_attention_block(*ts, 2, 0.25, rope=rope)
    assert torch.equal(got, fused_attention_block_plain(*ts, 2, 0.25, rope=rope))
    assert fused_attention_block.launches == before  # no kernel on the CPU


@pytest.mark.parametrize("seq,dim_head", [(50, 16), (690, 64)])
def test_sdpa_matches_jax(seq, dim_head):
    rng = np.random.default_rng(seq)
    q, k, v = (rng.standard_normal((2, 2, seq, dim_head)).astype(np.float32) for _ in range(3))
    got = sdpa(*(torch.from_numpy(a) for a in (q, k, v)))
    ref = jax_sdpa(*(jnp.asarray(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)


def _k3_inputs(case, b=2, n=300, h=4, d=64):
    """q, k, v (b, h, n, d) as the callers of K3 hand them over."""
    g = torch.Generator().manual_seed(0)
    if case == "strided":  # the roformer's permuted views of its qkv projection
        qkv = torch.randn((b * n, 3 * h * d), generator=g).to(torch.bfloat16)
        return tuple(qkv.reshape(b, n, 3, h, d).permute(2, 0, 3, 1, 4))
    if case == "contiguous":
        return tuple(torch.randn((b, h, n, d), generator=g).to(torch.bfloat16) for _ in range(3))
    if case == "flat":  # (BH, S, D)
        return tuple(torch.randn((b * h, n, d), generator=g).to(torch.bfloat16) for _ in range(3))
    if case == "padded":  # a head width the kernel pads: d = 20, not a multiple of 8
        return tuple(torch.randn((b, h, n, 20), generator=g).to(torch.bfloat16) for _ in range(3))
    # "unaligned": rows 36 elements apart, not a multiple of 16 bytes
    return tuple(torch.randn((b, h, n, d + 4), generator=g).to(torch.bfloat16)[..., :d]
                 for _ in range(3))


@pytest.mark.parametrize("case", ["strided", "contiguous", "flat", "unaligned", "strided48",
                                  "padded"])
def test_k3_plan_tensor_maps(case):
    """Strided 4-D views are read where they lie through (d, s, h, b) maps
    with their byte strides and written (b, s, h, d); everything else is read
    as contiguous (BH, S, D) through (d, s, bh) maps, copied only where the
    strides are not multiples of 16 bytes. A head width of 48 is read where
    it lies too (the kernel's 64-wide boxes zero-fill the rest); a width
    that is not a multiple of 8 is zero-padded to one (a copy), and the
    result is the view of the real columns."""
    b, n, h, d = 2, 300, 4, 48 if case == "strided48" else 64
    q, k, v = _k3_inputs(case.replace("48", ""), b, n, h, d)
    if case == "padded":
        tensors, rank, dims, strides, out, ostr, result, nb, nh = k3_plan(q, k, v)
        assert (rank, dims, nb, nh) == (3, (24, n, b * h), b * h, 1)
        assert strides == [(48, 48 * n)] * 3 and out.shape == (b * h, n, 24)
        for t, src in zip(tensors, (q, k, v)):
            assert torch.equal(t[..., :20], src.reshape(b * h, n, 20)) and not t[..., 20:].any()
        assert result.shape == q.shape and result.data_ptr() == out.data_ptr()
        return
    tensors, rank, dims, strides, out, ostr, result, nb, nh = k3_plan(q, k, v)
    assert result.shape == q.shape
    if case.startswith("strided"):
        assert (rank, dims, nb, nh) == (4, (d, n, h, b), b, h)
        assert strides == [(2 * 3 * h * d, 2 * d, 2 * n * 3 * h * d)] * 3
        assert all(t.data_ptr() == src.data_ptr() for t, src in zip(tensors, (q, k, v)))
        assert out.shape == (b, n, h, d) and ostr == (n * h * d, d, h * d)
        assert result.data_ptr() == out.data_ptr() and result.stride() == (n * h * d, d, h * d, 1)
    else:
        assert (rank, dims, nb, nh) == (3, (d, n, b * h), b * h, 1)
        assert strides == [(2 * d, 2 * n * d)] * 3
        assert out.shape == (b * h, n, d) and ostr == (n * d, 0, d)
        for t, src in zip(tensors, (q, k, v)):
            assert t.is_contiguous() and t.shape == (b * h, n, d)
            assert torch.equal(t, src.reshape(b * h, n, d))
            assert (t.data_ptr() == src.data_ptr()) == (case != "unaligned")
    assert all(x % 16 == 0 for st in strides for x in st)
    assert all(t.data_ptr() % 16 == 0 for t in tensors)


# (b, n, d, heads, dim_head): the flagship's time and freq legs, dim_head 32,
# ragged sequences on either side of the short route's n <= 64, one token;
# dim_head 128 on both routes (the flagship's legs at 4 heads x 128)
K1_PLAN_CASES = [(372, 690, 512, 8, 64), (4140, 62, 512, 8, 64), (6, 300, 256, 8, 32),
                 (3, 65, 128, 2, 64), (5, 64, 192, 3, 64), (7, 1, 64, 2, 32),
                 (2, 257, 1024, 16, 64), (372, 690, 512, 4, 128), (4140, 62, 512, 4, 128),
                 (3, 129, 128, 1, 128)]
SMEM_BLOCK_MAX = 232_448  # the H100's opt-in shared memory per block


def _schedule(tiles, grid):
    """The tiles each block of a persistent launch takes: b, b + grid, ..."""
    return [np.arange(block, tiles, grid) for block in range(grid)]


@pytest.mark.parametrize("mix", [False, True], ids=["mode01", "mode2"])
@pytest.mark.parametrize("b,n,d,heads,dh", K1_PLAN_CASES)
def test_k1_plan(b, n, d, heads, dh, mix):
    """K1's launch plan: the norm pass's gate columns (the mix's h more in
    mode 2); the core's route by n (short iff n <= 64), its three (d, s, h,
    b) maps over the qkv buffer with 16-byte-multiple byte strides and
    16-byte aligned bases, the (b, n, h, dh) output strides, one block per
    SM never above the tiles, shared memory within a block's limit."""
    hd = heads * dh
    plan = k1_plan(b, n, d, heads, dh, 132, mix=mix)
    assert plan["norm"]["side"] == (2 if mix else 1) * heads
    core = plan["core"]
    short = n <= 64
    assert core["route"] == ("short" if short else "tiles")
    rows = 128 if dh == 128 else 192  # two consumer warpgroups at 128, three below
    assert core["tiles"] == (b * heads if short else b * heads * -(-n // rows))
    assert core["grid"] == (b * heads if short else min(core["tiles"], 132))
    assert core["dims"] == (dh, n, heads, b)
    assert core["strides"] == (2 * 3 * hd, 2 * dh, 2 * n * 3 * hd)
    assert all(st % 16 == 0 for st in core["strides"])
    assert core["offsets"] == (0, hd, 2 * hd) and all(2 * o % 16 == 0 for o in core["offsets"])
    assert core["out_strides"] == (n * hd, dh, hd)
    for name, cols, depth in (("proj", 3 * hd, d), ("out", d, hd)):
        g = plan[name]
        assert g["tiles"] == -(-b * n // 128) * -(-cols // 128)
        assert g["grid"] % -(-cols // 128) == 0 and 1 <= g["grid"] <= g["tiles"]
        assert g["smem"] == (230_488 if depth <= 512 else 197_736)
    assert all(plan[k]["smem"] <= SMEM_BLOCK_MAX for k in ("proj", "out", "core"))


@pytest.mark.parametrize("b,n,d,heads,dh", K1_PLAN_CASES)
def test_k1_plan_covers_every_tile_once(b, n, d, heads, dh):
    """Both GEMMs' grids hand every 128 x 128 output tile to one block, each
    block keeping one column block; the core's tiles cover every (sequence,
    head, query row) once: with the tiles route (sequence, 192-query) tiles
    (128-query at dim_head 128) walked by a persistent grid, a consumer
    warpgroup's 64 rows each; with the short route one block per (sequence,
    head)."""
    hd = heads * dh
    plan = k1_plan(b, n, d, heads, dh, 132)
    for name, cols in (("proj", 3 * hd), ("out", d)):
        g = plan[name]
        n_tiles = -(-cols // 128)
        seen = np.zeros(g["tiles"], np.int64)
        for mine in _schedule(g["tiles"], g["grid"]):
            assert len(set(mine % n_tiles)) <= 1
            seen[mine] += 1
        assert (seen == 1).all()
    core = plan["core"]
    covered = np.zeros((b * heads, n), np.int64)
    if core["route"] == "short":
        covered[np.arange(core["grid"])] += 1  # block (., head, sequence), 64 >= n rows
    else:
        ncw = 2 if dh == 128 else 3
        q_tiles = -(-n // (64 * ncw))
        for mine in _schedule(core["tiles"], core["grid"]):
            for tile in mine:
                for c in range(ncw):  # consumer warpgroup c
                    seq, r0 = tile // q_tiles, (tile % q_tiles) * 64 * ncw + 64 * c
                    covered[seq, r0:min(r0 + 64, n)] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("dh,route,smem", [(64, "tiles", 176_232), (64, "short", 46_080),
                                           (32, "tiles", 90_216), (32, "short", 25_600),
                                           (128, "tiles", 199_744), (128, "short", 87_040)])
def test_k1_plan_is_the_kernels_layout(dh, route, smem):
    """The plan's shared memory and route ids are what csrc/flash_wgmma.cuh
    (FlashCfg), csrc/flash_core.cuh (flash_core_smem_bytes) and
    csrc/attention.cu (K1CoreRoute, K1_SHORT_MAX_N) lay out and check: a
    change to either side shows here."""
    n = 62 if route == "short" else 690
    assert k1_plan(4, n, 512, 8, dh, 132)["core"]["smem"] == smem
    src = open(os.path.join(os.path.dirname(attn_ops.__file__), "..", "csrc",
                            "attention.cu")).read()
    enum = re.search(r"enum K1CoreRoute \{ K1_CORE_TILES = (\d+), K1_CORE_SHORT = (\d+) \}", src)
    assert enum and {"tiles": int(enum.group(1)), "short": int(enum.group(2))} == attn_ops._K1_ROUTES
    assert int(re.search(r"K1_SHORT_MAX_N = (\d+);", src).group(1)) == attn_ops._K1_SHORT_MAX_N
