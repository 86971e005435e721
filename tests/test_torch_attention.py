"""K1 (fused attention block) of the port held against sesa_tpu's Pallas
kernel run in interpret mode on the CPU, with the cases of
tests/test_fused_attention.py, plus the plain einsum ``sdpa``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sesa_tpu.ops.attention import fused_attention_block as jax_fused_attention_block
from sesa_tpu.ops.attention import sdpa as jax_sdpa
from sesa_tpu_torch.ops.attention import (fused_attention_block,
                                          fused_attention_block_plain, sdpa)
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
