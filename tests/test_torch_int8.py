"""The port's int8 attention (``sdpa_int8``: kernel I8 on bf16 CUDA tensors,
``sdpa_int8_plain`` everywhere else) held against sesa_tpu's ``sdpa_int8``
on the CPU, and the ``SESA_INT8_ATTN`` switch in both packages' roformer
stacks."""

import os
import re
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
from sesa_tpu_torch.ops.attention import (_quant_rows, i8_plan, int8_attention_shape_ok,
                                          sdpa_int8, sdpa_int8_plain)
from sesa_tpu_torch.ops.rope import apply_rope, default_freqs, rope_tables
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


# ---------------------------------------------------------------------------
# i8_plan: the host side of kernel I8 (csrc/int8_attention.cu)
# ---------------------------------------------------------------------------

SMEM_BLOCK_MAX = 232_448  # the H100's opt-in shared memory per block


def _views(b, n, h, d):
    """q, k, v (b, h, n, d) as the roformer hands them to I8: permuted views
    of a qkv projection, q and k through rope (laid out (b, n, h, d))."""
    qkv = torch.zeros((b * n, 3 * h * d), dtype=torch.bfloat16)
    rope = tuple(r.to(torch.bfloat16) for r in rope_tables(torch.from_numpy(default_freqs(d)), n))
    q, k, v = qkv.reshape(b, n, 3, h, d).permute(2, 0, 3, 1, 4)
    return apply_rope(q, *rope), apply_rope(k, *rope), v


@pytest.mark.parametrize("n", [1, 7, 62, 64, 65, 690, 2048])
def test_i8_plan_route(n):
    """One kernel while one key tile of 64 holds the sequence; beyond it the
    pre-pass (ceil(n / 128) key tiles of 128 rows of dh code bytes and 128
    scales each; a cluster of 4 blocks a sequence, each keeping its share of
    k's rows in at most 48 KiB of shared memory, or one block where the
    share would not fit) and the attention kernel."""
    b, h, d = 3, 2, 64
    plan = i8_plan(*_views(b, n, h, d), 132)
    fused = n <= 64
    assert (plan["route"], plan["route_id"]) == (("fused", 0) if fused else ("tiles", 1))
    if fused:
        assert plan["prepass"] is None
    else:
        n_kt = -(-n // 128)
        # 4 blocks a sequence, each a whole number of 64-row passes, in 48 KiB
        rows = -(-n_kt * 32 // 64) * 64
        cluster = 4 if rows * d * 2 <= 49152 else 1
        rows = rows if cluster == 4 else n_kt * 128
        assert rows * cluster >= n_kt * 128
        assert plan["prepass"] == dict(grid=b * h * cluster, cluster=cluster, rows=rows,
                                       smem=rows * d * 2 if cluster == 4 else 0, n_kt=n_kt,
                                       codes_bytes=b * h * n_kt * 128 * d,
                                       scales=b * h * n_kt * 128,
                                       k_strides=(2 * h * d, 2 * d, 2 * n * h * d))
        assert (cluster == 4) == (n <= 1536)


@pytest.mark.parametrize("case", ["views", "flat"])
@pytest.mark.parametrize("n", [62, 690])
def test_i8_plan_tensor_maps(case, n):
    """The roformer's strided views are read where they lie through (d, s,
    h, b) maps at their byte strides (q and k out of rope laid out (b, n, h,
    d), v a view of the qkv projection) and written (b, n, h, d), returned as
    the (b, h, n, d) view; 3-D contiguous (BH, n, D) input through (d, s, bh)
    maps, its output contiguous. Every stride is a multiple of 16 bytes."""
    b, h, d = 4, 8, 64
    if case == "views":
        q, k, v = _views(b, n, h, d)
    else:
        q, k, v = (torch.zeros((b * h, n, d), dtype=torch.bfloat16) for _ in range(3))
    plan = i8_plan(q, k, v, 132)
    if case == "views":
        assert (plan["rank"], plan["dims"], plan["b"], plan["h"]) == (4, (d, n, h, b), b, h)
        rope_out = (2 * h * d, 2 * d, 2 * n * h * d)
        assert plan["strides"] == [rope_out, rope_out, (2 * 3 * h * d, 2 * d, 2 * n * 3 * h * d)]
        assert all(t.data_ptr() == src.data_ptr() for t, src in zip(plan["tensors"], (q, k, v)))
        assert plan["out"].shape == (b, n, h, d)
        assert plan["out_strides"] == (n * h * d, d, h * d)
        assert plan["result"].shape == (b, h, n, d)
        assert plan["result"].stride() == (n * h * d, d, h * d, 1)
    else:
        assert (plan["rank"], plan["dims"], plan["b"], plan["h"]) == (3, (d, n, b * h), b * h, 1)
        assert plan["strides"] == [(2 * d, 2 * n * d)] * 3
        assert plan["out_strides"] == (n * d, 0, d) and plan["result"].is_contiguous()
        if plan["prepass"] is not None:
            assert plan["prepass"]["k_strides"] == (2 * d, 0, 2 * n * d)
    assert all(x % 16 == 0 for st in plan["strides"] for x in st)
    assert plan["result"].data_ptr() == plan["out"].data_ptr()


@pytest.mark.parametrize("dh,route,smem", [(32, "fused", 130_560), (64, "fused", 206_176),
                                           (128, "fused", 222_256), (32, "tiles", 86_376),
                                           (64, "tiles", 166_248), (128, "tiles", 184_896)])
def test_i8_plan_shared_memory(dh, route, smem):
    """Each route's shared memory at D 32, 64 and 128 is what
    csrc/int8_attention.cu lays out (FusedCfg, TilesCfg) and checks, every
    buffer and their sum within a block's limit, the fused route's stages of
    q, k and v and the tiles route's key stages on 1024-byte multiples (the
    swizzled tiles' alignment)."""
    n = 62 if route == "fused" else 690
    plan = i8_plan(*_views(2, n, 2, dh), 132)
    assert plan["route"] == route and plan["dh"] == dh and plan["smem"] == smem
    assert all(0 < v <= SMEM_BLOCK_MAX for v in plan["buffers"].values())
    assert sum(plan["buffers"].values()) < plan["smem"] <= SMEM_BLOCK_MAX
    tiles = ("qkv stages", "q8, k8, staging") if route == "fused" else (
        "q", "k codes", "v", "q8, staging")
    assert all(plan["buffers"][name] % 1024 == 0 for name in tiles)
    src = open(os.path.join(os.path.dirname(pattn.__file__), "..", "csrc",
                            "int8_attention.cu")).read()
    assert int(re.search(r"FUSED_MAX_N = (\d+);", src).group(1)) == pattn._I8_FUSED_MAX_N
    assert int(re.search(r"constexpr int BK = (\d+);", src).group(1)) == pattn._I8_BK


@pytest.mark.parametrize("b,n,h,d,sms", [(372, 690, 8, 64, 132), (4140, 62, 8, 64, 132),
                                         (1, 130, 2, 128, 132), (3, 7, 2, 32, 132),
                                         (2, 300, 3, 64, 1)])
def test_i8_plan_grid(b, n, h, d, sms):
    """One persistent block per SM, never more than the work units: the
    sequences on the fused route, (sequence, 64 x NCW queries) tiles on the
    tiles route (NCW three consumer warpgroups, two at D 128); walked b, b +
    grid, ..., the units cover every (sequence, query row) once."""
    plan = i8_plan(*_views(b, n, h, d), sms)
    ncw = 2 if d == 128 else 3
    q_tiles = 1 if n <= 64 else -(-n // (64 * ncw))
    assert plan["ncw"] == ncw and plan["units"] == b * h * q_tiles
    assert plan["grid"] == min(plan["units"], sms)
    if b * h * n > 10 ** 6:
        return
    covered = np.zeros((b * h, n), np.int64)
    for block in range(plan["grid"]):
        for unit in range(block, plan["units"], plan["grid"]):
            seq, r0 = unit // q_tiles, (unit % q_tiles) * 64 * ncw
            covered[seq, r0:min(r0 + 64 * (1 if n <= 64 else ncw), n)] += 1
    assert (covered == 1).all()


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case", ["wide", "shapes", "f16", "2d", "scale", "not_cuda"])
def test_sdpa_int8_refusals(case):
    """Off the CPU, sdpa_int8 raises on what I8 does not take (D above 128,
    q, k and v of other shapes, a dtype other than bf16 and f32, fewer than
    3 dims, a scale that is not positive) and on tensors that do not lie on
    CUDA (meta tensors stand in for the card here); nothing is counted."""
    q = k = v = _meta(2, 4, 50, 64)
    scale = None
    if case == "wide":
        q = k = v = _meta(2, 4, 50, 136)
    elif case == "shapes":
        k = _meta(2, 4, 51, 64)
    elif case == "f16":
        q = k = v = _meta(2, 4, 50, 64, dtype=torch.float16)
    elif case == "2d":
        q = k = v = _meta(50, 64)
    elif case == "scale":
        scale = 0.0
    assert int8_attention_shape_ok(q, k, v) == (case in ("scale", "not_cuda"))
    before = sdpa_int8.launches
    with pytest.raises(ValueError, match="must lie on CUDA" if case == "not_cuda" else
                       "unsupported"):
        sdpa_int8(q, k, v, scale)
    assert sdpa_int8.launches == before


def test_sdpa_int8_f32_off_the_cpu_runs_the_plain_version():
    """f32 inputs take the plain version wherever they lie (the f32 gate):
    no launch is counted."""
    before = sdpa_int8.launches
    out = sdpa_int8(*(_meta(2, 4, 50, 64, dtype=torch.float32) for _ in range(3)))
    assert out.shape == (2, 4, 50, 64) and out.dtype == torch.float32
    assert sdpa_int8.launches == before
