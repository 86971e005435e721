"""The port's int8 attention (``sdpa_int8``: kernel I8 on bf16 CUDA tensors,
``sdpa_int8_plain`` everywhere else) held against sesa_tpu's ``sdpa_int8``
on the CPU, and the ``SESA_INT8_ATTN`` switch in both packages' roformer
stacks."""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sesa_tpu.models import roformer_core as jcore
from sesa_tpu.ops.attention import sdpa_int8 as jax_sdpa_int8
from sesa_tpu_torch.models import roformer_core as pcore
from sesa_tpu_torch.ops import attention as pattn
from sesa_tpu_torch.ops.attention import _quant_rows, sdpa_int8, sdpa_int8_plain
from sesa_tpu_torch.tree import tree_map

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the tier-1 run's six workers share eight cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _jax_codes(x, center):
    """The JAX function's quantisation (sesa_tpu/ops/attention.py:89-98) of
    q (``center`` False) or of k less its mean."""
    if center:
        x = x - x.mean(axis=-2, keepdims=True)
    xf = x.astype(jnp.float32)
    s = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True) / 127.0, 1e-8)
    return np.asarray(jnp.clip(jnp.round(xf / s), -127, 127)), np.asarray(s)


@pytest.mark.parametrize("shape", [(2, 4, 50, 32), (2, 4, 130, 64)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_matches_jax(shape, dtype):
    """The int8 codes differ by at most 1 in at most 0.1% of entries (the k
    mean's sums run in another order); the outputs agree within 1e-5 of
    max |out| in f32 and 1% (about 2.5 bf16 ulps) in bf16."""
    jdt, pdt = DTYPES[dtype]
    q, k, v = _qkv(shape)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    pq, pk, pv = (torch.from_numpy(a).to(pdt) for a in (q, k, v))
    for jx, px, center in ((jq, pq, False), (jk, pk, True)):
        codes, scales = _jax_codes(jx, center)
        if center:
            px = px - px.float().mean(-2, keepdim=True).to(px.dtype)
        pcodes, pscales = _quant_rows(px)
        diff = np.abs(pcodes.numpy() - codes)
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
        np.testing.assert_allclose(pscales.numpy(), scales, rtol=1e-2)
    ref = np.asarray(jax_sdpa_int8(jq, jk, jv).astype(jnp.float32))
    got = sdpa_int8(pq, pk, pv)  # a CPU tensor: the plain version
    assert got.dtype == pdt and got.shape == shape
    tol = (1e-5 if dtype == "f32" else 1e-2) * np.abs(ref).max()
    np.testing.assert_allclose(got.float().numpy(), ref, atol=tol)


def test_k_mean_smoothing_is_softmax_invariant():
    """A large common component added to k leaves the output within the
    JAX test's 2e-2 (tests/test_int8_attention.py)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv((2, 4, 50, 32), seed=1))
    np.testing.assert_allclose(sdpa_int8_plain(q, k + 7.5, v).numpy(),
                               sdpa_int8_plain(q, k, v).numpy(), atol=2e-2, rtol=2e-2)


def test_transformer_with_int8_attention_matches_jax(monkeypatch):
    """SESA_INT8_ATTN set (monkeypatched) in both packages: the port's
    transformer stack, on weights carried from JAX, runs sdpa_int8 in every
    layer and equals the JAX stack within 1e-4 in f32 (the codes of a
    softmax input may flip by one step where the k mean's sums differ); it
    stays within the JAX test's 5% of the default path."""
    params = jax.jit(lambda key: jcore.transformer_init(key, 64, 2, 4, 16))(
        jax.random.PRNGKey(0))
    tparams = tree_map(lambda a: torch.from_numpy(np.array(a)), jax.tree.map(np.asarray, params))
    x = (np.random.default_rng(2).standard_normal((2, 40, 64)) * 0.3).astype(np.float32)
    plain = pcore.transformer_apply(tparams, torch.from_numpy(x), 4).numpy()
    monkeypatch.setenv("SESA_INT8_ATTN", "1")
    ref = np.asarray(jcore.transformer_apply(params, jnp.asarray(x), 4))
    calls = []
    real = pcore.sdpa_int8
    monkeypatch.setattr(pcore, "sdpa_int8", lambda *a: calls.append(1) or real(*a))
    got = pcore.transformer_apply(tparams, torch.from_numpy(x), 4).numpy()
    assert len(calls) == 2
    np.testing.assert_allclose(got, ref, atol=1e-4)
    assert np.abs(got - plain).max() < 0.05 * np.abs(plain).max()


def test_use_fused_attention_refuses_k1_under_the_switch(monkeypatch):
    """K1's gate takes a bf16 CUDA block of the flagship's shape, and refuses
    it once SESA_INT8_ATTN is set, as the JAX gate ``_use_fused`` does."""
    x = types.SimpleNamespace(shape=torch.Size((372, 690, 512)), dtype=torch.bfloat16,
                              device=torch.device("cuda"), numel=lambda: 372 * 690 * 512)
    monkeypatch.delenv("SESA_INT8_ATTN", raising=False)
    assert pattn.use_fused_attention(x, 8, 64)
    monkeypatch.setenv("SESA_INT8_ATTN", "1")
    assert pattn.int8_attention_enabled()
    assert not pattn.use_fused_attention(x, 8, 64)
