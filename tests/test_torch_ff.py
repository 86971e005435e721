"""K2 (fused feed-forward) of the port held against sesa_tpu's Pallas kernel
run in interpret mode on the CPU, with the cases of tests/test_fused_ff.py,
plus the tile arithmetic of K2's persistent grid."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sesa_tpu.ops.ff import fused_ff_residual as jax_fused_ff_residual
from sesa_tpu_torch.ops.ff import (ff_gemm_schedule, fused_ff_residual,
                                   fused_ff_residual_plain)


def _inputs(tokens, dim, hidden, seed, w_scale=0.05, b_scale=1.0):
    rng = np.random.default_rng(seed)
    mk = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    return [mk(tokens, dim), mk(dim), mk(hidden, dim, sc=w_scale), mk(hidden, sc=b_scale),
            mk(dim, hidden, sc=w_scale), mk(dim, sc=b_scale)]


def _both(arrays, dtype_t, dtype_j):
    got = fused_ff_residual_plain(*(torch.from_numpy(a).to(dtype_t) for a in arrays))
    ref = jax_fused_ff_residual(*(jnp.asarray(a, dtype_j) for a in arrays), tile=32,
                                interpret=True)
    return got.float().numpy(), np.asarray(ref, np.float32)


def test_plain_matches_pallas_f32():
    # tests/test_fused_ff.py's case and tolerance; 70 tokens exercise the pad
    got, ref = _both(_inputs(70, 64, 256, 0), torch.float32, jnp.float32)
    assert got.shape == (70, 64)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def test_plain_matches_pallas_bf16():
    """Same rounding points in both; only the f32 summation order differs,
    which can flip a rounded value by one bf16 ulp. Bound: 99% of elements
    within one output ulp, none beyond 2% of the output's largest value."""
    got, ref = _both(_inputs(64, 128, 512, 1, b_scale=0.1), torch.bfloat16, jnp.bfloat16)
    assert np.abs(got - ref).max() <= 0.02 * np.abs(ref).max()
    ulp = np.maximum(np.abs(ref), 1e-3) * 2.0 ** -7
    assert np.mean(np.abs(got - ref) <= ulp) >= 0.99


def test_out_scale_matches_pallas():
    arrays = _inputs(40, 64, 256, 2)
    got = fused_ff_residual_plain(*(torch.from_numpy(a) for a in arrays), out_scale=0.5)
    ref = jax_fused_ff_residual(*(jnp.asarray(a) for a in arrays), out_scale=0.5, tile=32,
                                interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_wrapper_runs_plain_on_cpu():
    ts = [torch.from_numpy(a) for a in _inputs(30, 32, 128, 3)]
    before = fused_ff_residual.launches
    assert torch.equal(fused_ff_residual(*ts), fused_ff_residual_plain(*ts))
    assert fused_ff_residual.launches == before  # no kernel on the CPU


@pytest.mark.parametrize("tokens", [1, 127, 257, 248_400])
def test_ff_gemm_schedule_covers_every_tile_once(tokens):
    """Both products' persistent grids (hidden 1536 up, dim 384 down; and
    512 / 2048) hand every 128 x 128 tile to exactly one block, split
    between the block's two consumer warpgroups; each block keeps one
    column block (the kernel holds that slice of the weights), and the
    tiles cover the ragged last rows."""
    for n in (384, 512, 1536, 2048):
        m_tiles, n_tiles = -(-tokens // 128), n // 128
        for sms in (132, 7):
            tiles, grid = ff_gemm_schedule(tokens, n, sms)
            assert tiles == m_tiles * n_tiles
            assert 1 <= grid <= tiles and grid % n_tiles == 0
            assert grid <= max(sms, n_tiles) and (grid == tiles or grid + n_tiles > sms)
            seen = np.zeros(tiles, np.int64)
            for block in range(grid):
                mine = np.arange(block, tiles, grid)
                assert np.array_equal(np.sort(np.concatenate([mine[0::2], mine[1::2]])), mine)
                assert len(set(mine % n_tiles)) == 1
                seen[mine] += 1
            assert (seen == 1).all()
            rows = 128 * (np.arange(tiles) // n_tiles)
            cols = 128 * (np.arange(tiles) % n_tiles)
            assert rows.max() < tokens <= rows.max() + 128 and cols.max() + 128 == n
