"""K2 (fused feed-forward) of the port held against sesa_tpu's Pallas kernel
run in interpret mode on the CPU, with the cases of tests/test_fused_ff.py."""

import numpy as np
import torch

import jax.numpy as jnp

from sesa_tpu.ops.ff import fused_ff_residual as jax_fused_ff_residual
from sesa_tpu_torch.ops.ff import fused_ff_residual, fused_ff_residual_plain


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
