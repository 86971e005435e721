"""The shapes K5, K7 and K8 take past their first contracts, on the CPU: the
plain versions against the Pallas kernels in interpret mode (or the JAX
package's unfused conv at even k) at K5's taps past 32, K7's head widths that
are not multiples of 16, and K8's (P, N, chunk) other than (64, 128, 64); the
padding routes that lay those shapes out for the kernels against the unpadded
plain versions; the launch plans ``k5_plan``, ``k7_plan`` and ``k8_plan`` at
the new shapes, and K7's index arithmetic at dim_head % 16 = 8 replayed in
numpy. The JAX references are built once per module."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sesa_tpu.models import apollo as jax_apollo
from sesa_tpu.models import conformer_core as jax_cc
from sesa_tpu.ops.attention import fused_rope_attention as jax_fused_rope_attention
from sesa_tpu.ops.convblock import fused_conformer_conv as jax_fused_conformer_conv
from sesa_tpu.ops.rope import default_freqs, rope_tables
from sesa_tpu.ops.ssd import ssd_pallas
from sesa_tpu_torch.models import apollo
from sesa_tpu_torch.ops import ssd as ssd_ops
from sesa_tpu_torch.ops.attention import (fused_rope_attention, fused_rope_attention_plain,
                                          k7_plan, k7_widths, pad_heads, unpad_heads)
from sesa_tpu_torch.ops.convblock import (conformer_conv_shape_ok, fused_conformer_conv,
                                          fused_conformer_conv_plain, k5_plan)
from sesa_tpu_torch.ops.ssd import k8_plan, ssd_fused, ssd_fused_plain, ssd_plain
from sesa_tpu_torch.tree import tree_map


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch, as the other port test files."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


HI = jax.lax.Precision.HIGHEST


def _within_one_ulp(got, ref):
    """The bf16 rule of the port's tests: the two sides round at the same
    points and differ only in f32 summation order, which can flip a rounded
    value by one bf16 ulp (2**-8 relative). Bound: max error <= 2% of the
    output's largest value, and 99% of elements within one output ulp."""
    assert np.abs(got - ref).max() <= 0.02 * np.abs(ref).max()
    ulp = np.maximum(np.abs(ref), 1e-3) * 2.0 ** -7
    assert np.mean(np.abs(got - ref) <= ulp) >= 0.99


def _to_t(tree, dtype=torch.float32):
    return tree_map(lambda a: torch.from_numpy(np.asarray(a, np.float32).copy()).to(dtype), tree)


def _to_j(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


# --------------------------------------------------------------------------
# K5 at k > 32
# --------------------------------------------------------------------------

def _conv_params(seed, dim, kernel, expansion=2):
    """tests/test_torch_conformer.py's conv tree: N(0, 0.05²), norm and BN
    weights near 1, BN variances positive."""
    rng = np.random.default_rng(seed)
    e = dim * expansion
    r = lambda *s: (rng.standard_normal(s) * 0.05).astype(np.float32)  # noqa: E731
    return {"norm": {"weight": 1.0 + 2 * r(dim), "bias": r(dim)},
            "pw1": {"weight": r(2 * e, dim, 1), "bias": r(2 * e)},
            "dw": {"weight": r(e, 1, kernel), "bias": r(e)},
            "bn": {"weight": 1.0 + 2 * r(e), "bias": r(e), "running_mean": r(e),
                   "running_var": np.abs(1.0 + 4 * r(e))},
            "pw2": {"weight": r(dim, e, 1), "bias": r(dim)}}


# (b, n, dim, k, dtypes): the odd counts past one and two register blocks of
# taps, against the Pallas kernel, a sequence longer and one shorter than the
# kernel; 65 taps in f32 only (the interpreted Pallas kernel unrolls its taps:
# 17 s in f32, 23 s more in bf16)
K5_ODD = [(2, 60, 64, 33, ("f32", "bf16")), (1, 40, 64, 65, ("f32",))]
_JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


@pytest.fixture(scope="module")
def k5_refs():
    """The Pallas K5 in interpret mode at K5_ODD, once."""
    out = {}
    for b, n, dim, k, dtypes in K5_ODD:
        p = _conv_params(n + k, dim, k)
        x = np.random.default_rng(n + k).standard_normal((b, n, dim)).astype(np.float32)
        for dt in dtypes:
            ref = jax_fused_conformer_conv(jnp.asarray(x, _JDT[dt]), _to_j(p, _JDT[dt]),
                                           interpret=True)
            out[(k, dt)] = (p, x, np.asarray(ref.astype(jnp.float32)))
    return out


@pytest.mark.parametrize("b,n,dim,k,dtypes", K5_ODD)
def test_k5_plain_matches_pallas_past_32_taps(k5_refs, b, n, dim, k, dtypes):
    """f32 at tests/test_torch_conformer.py's tolerance for K5 (atol 3e-5,
    rtol 1e-4), bf16 within one output ulp."""
    p, x, ref = k5_refs[(k, "f32")]
    got = fused_conformer_conv_plain(torch.from_numpy(x), _to_t(p)).numpy()
    np.testing.assert_allclose(got, ref, atol=3e-5, rtol=1e-4)
    if "bf16" in dtypes:
        p, x, ref = k5_refs[(k, "bf16")]
        got = fused_conformer_conv_plain(torch.from_numpy(x).to(torch.bfloat16),
                                         _to_t(p, torch.bfloat16)).float().numpy()
        _within_one_ulp(got, ref)


@pytest.mark.parametrize("kernel", [64, 34])
def test_k5_plain_matches_conv_apply_at_even_taps_past_32(kernel):
    """Even k past 32 against the JAX package's unfused ``_conv_apply`` (the
    lucidrains padding, which the Pallas kernel's (k - 1) // 2 offset misses
    at even k), and the port's own unfused conv."""
    from sesa_tpu_torch.models import conformer_core as cc

    p = _conv_params(kernel, 64, kernel)
    x = np.random.default_rng(kernel).standard_normal((2, 50, 64)).astype(np.float32)
    ref = np.asarray(jax_cc._conv_apply(_to_j(p), jnp.asarray(x), HI) + x)
    got = fused_conformer_conv_plain(torch.from_numpy(x), _to_t(p)).numpy()
    np.testing.assert_allclose(got, ref, atol=3e-5, rtol=1e-4)
    port = (cc._conv_apply(_to_t(p), torch.from_numpy(x)) + torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(port, ref, atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("b,n,d,e,k", [(360, 690, 384, 768, 33), (4140, 60, 384, 768, 65),
                                       (360, 690, 384, 768, 129), (2, 40, 64, 128, 257)])
def test_k5_plan_at_taps_past_32(b, n, d, e, k):
    """k5_plan at the mel-band conformer's legs and a short sequence: one
    step a block of 32 taps, each staging a box of the tile's rows and 31
    (within TMA's 256 rows and the static shared memory), the products'
    plans as at 31 taps; the predicate takes the shape, the wrapper with it
    on the CPU (its plain version), and no sequence count limits it."""
    plan, base = k5_plan(b, n, d, e, 132, k), k5_plan(b, n, d, e, 132, 31)
    dw = plan["dw"]
    assert dw["tap_blocks"] == -(-k // 32) and dw["steps"] == dw["items"] * dw["tap_blocks"]
    assert dw["box_rows"] == dw["rows"] + 31 <= 256 and dw["smem"] <= 48 * 1024
    assert {key: plan[key] for key in ("up", "down")} == {key: base[key] for key in ("up", "down")}
    assert {key: dw[key] for key in ("rows", "items", "grid")} == \
        {key: base["dw"][key] for key in ("rows", "items", "grid")}
    assert conformer_conv_shape_ok(b, n, d, e, k)
    assert conformer_conv_shape_ok(70_000, 60, d, e, k)  # past 65535 sequences
    assert not conformer_conv_shape_ok(2 ** 22, 1024, d, e, k)  # b·n past int
    assert not conformer_conv_shape_ok(b, n, d + 32, e, k) and not conformer_conv_shape_ok(
        b, n, d, e, 0)


def test_k5_wrapper_runs_plain_on_cpu_past_32_taps():
    p = _to_t(_conv_params(1, 64, 65))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 33, 64)).astype(np.float32))
    before = fused_conformer_conv.launches
    assert torch.equal(fused_conformer_conv(x, p), fused_conformer_conv_plain(x, p))
    assert fused_conformer_conv.launches == before


# --------------------------------------------------------------------------
# K7 at head widths that are not multiples of 16
# --------------------------------------------------------------------------

# (b, n, heads, dim_head, rotary width): 8 heads of 24 and 40 (Apollo at
# feature_dim 192 and 320), of 25 (feature_dim 200, rope 24: one column
# unrotated), a partial group of 3 x 24, and 8 x 12 (feature_dim 96); bf16 at
# the first three
K7_WIDTHS = [(3, 33, 8, 24, 24), (2, 80, 8, 40, 40), (3, 33, 8, 25, 24), (3, 20, 3, 24, 8),
             (2, 17, 8, 12, 12)]
K7_BF16 = (24, 40, 25)


def _rope(rot, n):
    rope_j = rope_tables(jnp.asarray(default_freqs(rot)), n)
    return rope_j, tuple(torch.from_numpy(np.asarray(t).copy()) for t in rope_j)


@pytest.fixture(scope="module")
def k7_refs():
    """The Pallas K7 in interpret mode at K7_WIDTHS, f32 and bf16, once."""
    out = {}
    for b, n, heads, dh, rot in K7_WIDTHS:
        qkv = np.random.default_rng(dh * n).standard_normal((b, n, 3 * heads * dh)).astype(
            np.float32)
        rope_j, _ = _rope(rot, n)
        bf16 = dh in K7_BF16 and heads == 8
        for jdt in (jnp.float32, jnp.bfloat16) if bf16 else (jnp.float32,):
            ref = jax_fused_rope_attention(jnp.asarray(qkv, jdt), heads, dh ** -0.5,
                                           rope=rope_j, interpret=True)
            out[(dh, n, heads, jdt)] = (qkv, np.asarray(ref.astype(jnp.float32)))
    return out


@pytest.mark.parametrize("b,n,heads,dh,rot", K7_WIDTHS)
def test_k7_plain_matches_pallas_at_other_widths(k7_refs, b, n, heads, dh, rot):
    """f32 at tests/test_torch_apollo.py's K7 tolerance (atol 2e-5, rtol
    1e-5), bf16 within one output ulp; the wrapper on the CPU is its plain
    version."""
    _, rope_t = _rope(rot, n)
    qkv, ref = k7_refs[(dh, n, heads, jnp.float32)]
    got = fused_rope_attention(torch.from_numpy(qkv), heads, dh ** -0.5, rope=rope_t).numpy()
    assert got.shape == (b, n, heads * dh)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)
    if (dh, n, heads, jnp.bfloat16) not in k7_refs:
        return
    qkv, ref = k7_refs[(dh, n, heads, jnp.bfloat16)]
    rope_b = tuple(t.to(torch.bfloat16) for t in rope_t)
    got = fused_rope_attention_plain(torch.from_numpy(qkv).to(torch.bfloat16), heads,
                                     dh ** -0.5, rope=rope_b).float().numpy()
    _within_one_ulp(got, ref)


@pytest.mark.parametrize("dh,rot", [(25, 24), (12, 12), (1, 0), (72, 72)])
def test_k7_padded_heads_are_the_unpadded_plain_version(dh, rot):
    """The repack of K7's wrapper (q, k and v zero-padded per head to the
    plan's width, the output's padded columns dropped) through the plain
    version, against the unpadded plain version in f32: the zero columns add
    exact zeros to q·kᵀ (the sums' order may differ, so within 1e-6), and
    the dropped output columns are zero."""
    n, heads = 19, 8
    width = k7_plan(7, 80, heads, dh, rot)["width"]
    assert width in k7_widths(dh) and width > dh
    qkv = torch.from_numpy(np.random.default_rng(dh).standard_normal((2, n, 3 * heads * dh))
                           .astype(np.float32))
    rope = _rope(rot, n)[1] if rot else None
    want = fused_rope_attention_plain(qkv, heads, dh ** -0.5, rope)
    wide = fused_rope_attention_plain(pad_heads(qkv, dh, width), heads, dh ** -0.5, rope)
    assert not wide.reshape(2, n, heads, width)[..., dh:].any()
    np.testing.assert_allclose(unpad_heads(wide, dh, width).numpy(), want.numpy(), atol=1e-6,
                               rtol=1e-6)


def _band_params(n, seed):
    rng = np.random.default_rng(seed)
    r = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)  # noqa: E731
    return {"input_norm": 1.0 + r(n), "qkv_w": r(3 * n, n), "out_w": r(n, n),
            "mlp_norm": 1.0 + r(n), "mlp_in": r(8 * n, n), "mlp_out": r(n, 4 * n)}


@pytest.mark.parametrize("feature_dim", [200, 96])
def test_apollo_band_layer_at_padded_heads_matches_jax(feature_dim):
    """Apollo's band layer at a dim_head that is not a multiple of 8 (25:
    feature_dim 200; 12: 96): W_qkv and W_o padded per head to K7's width,
    the kernel's plain version on the padded heads, against the JAX folded
    layer through the Pallas K7 in interpret mode (its rope 2·(dh // 2)
    wide), f32 at the K7 band test's atol 2e-5 (tests/test_torch_apollo.py)
    and bf16 within 2% of the largest output (the bf16 band layer's
    projections and MLP round at the same points, in another order)."""
    p = _band_params(feature_dim, feature_dim)
    feat = np.random.default_rng(1).standard_normal((1, 80, 2, feature_dim)).astype(np.float32)
    ref = np.asarray(jax_apollo._roformer_apply_folded(_to_j(p), jnp.asarray(feat),
                                                       precision=HI, interpret=True))
    got = apollo._roformer_apply_folded(_to_t(p), torch.from_numpy(feat)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)
    ref16 = np.asarray(jax_apollo._roformer_apply_folded(
        _to_j(p, jnp.bfloat16), jnp.asarray(feat, jnp.bfloat16), interpret=True)
        .astype(jnp.float32))
    got16 = apollo._roformer_apply_folded(_to_t(p, torch.bfloat16),
                                          torch.from_numpy(feat).to(torch.bfloat16))
    assert np.abs(got16.float().numpy() - ref16).max() <= 0.02 * np.abs(ref16).max()


def test_apollo_kernels_asks_k7_at_the_models_rope_width():
    """At dh 25 the model's rope is 24 wide: the choice takes K7 (asked at
    rope 25, an odd width no rope has, it refused before); the band layer's
    plan runs 8 heads of 32, instance 32."""
    assert "K7" in apollo.apollo_kernels("cuda", torch.bfloat16, 4, 1901, 80, 200)
    assert k7_plan(4 * 1901, 80, 8, 25, 25) is None
    plan = k7_plan(4 * 1901, 80, 8, 25, 24)
    assert (plan["width"], plan["inst"], plan["repack"]) == (32, 32, True)


@pytest.mark.parametrize("dh,heads,n", [(24, 8, 80), (40, 8, 80), (8, 8, 33), (56, 8, 17),
                                        (24, 3, 20)])
def test_k7_task_addresses_at_half_steps(dh, heads, n):
    """rope_attention.cu's ra_task at dim_head % 16 = 8 (run at the instance
    of the next multiple of 16), replayed on one stage's slab with TMA's
    128-byte swizzle: the q fragments' lanes read only their head's
    columns, the upper half of the last 16-column step clamped to its lower
    half and zeroed; the key and value addresses stay inside the head; the
    output words are a bijection onto the head's dh columns of the tile's
    rows, none on another head's."""
    plan = k7_plan(7, n, heads, dh, 0, 132)
    inst, rows, width = plan["inst"], plan["rows"], plan["group"] * dh
    assert plan["width"] == dh and inst == dh + 8 and width == 64 * plan["boxes"]
    lanes = np.arange(32)
    a_row, a_col = (lanes & 7) + ((lanes >> 3) & 1) * 8, (lanes >> 4) * 8
    b_row, b_col = (lanes & 7) + (lanes >> 4) * 8, ((lanes >> 3) & 1) * 8
    g, t = lanes >> 2, lanes & 3

    def swz(row, col):  # ra_swz: the 16-byte chunk of (row, col), col % 8 = 0
        return ((col >> 6) * rows + row) * 128 + ((((col >> 3) ^ row) & 7) << 4)

    def col(hc, kk, c):  # ra_task's clamp
        return hc + kk * 16 + (c if kk * 16 + c < dh else 0)

    for hc in range(0, width, dh):
        head = set(range(hc, hc + dh))
        for kk in range(inst // 16):
            zeroed = kk * 16 + 8 >= dh
            assert zeroed == (kk == inst // 16 - 1)
            for i in lanes:
                for c0 in (col(hc, kk, a_col[i]), col(hc, kk, b_col[i])):
                    assert set(range(c0, c0 + 8)) <= head
        q0 = 16 * ((n - 1) // 16)
        words = [swz(q0 + g[i] + 8 * r, hc + 8 * j) + 4 * t[i]
                 for i in lanes for r in range(2) for j in range(inst // 8) if 8 * j < dh]
        want = {swz(q0 + rr, c) + (c % 8) * 2 // 4 * 4 for rr in range(16)
                for c in range(hc, hc + dh, 2)}
        assert len(words) == len(set(words)) == 16 * dh // 2 and set(words) == want


# --------------------------------------------------------------------------
# K8 at other (P, N, chunk)
# --------------------------------------------------------------------------

# f32 at tests/test_torch_ssd.py's tolerance for K8
ATOL, RTOL = 2e-4, 1e-3
# (H, P, N, chunk, L): band_rnn's h·P = 512 cut down, at each (P, N, chunk)
# the JAX gate fuses beside (64, 128, 64): P 32 and 8 (padded to a 64-column
# pseudo-head), 72 (two pseudo-heads, the second part padded), N 256 and 384
# (two and three slices), chunks 32, 176 and 8 (run at 64; L padded from 72
# and 176 to 128 and 192), and band_comm's one chunk at chunk 32; bf16 at
# P 32, N 256 and chunk 8
K8_SHAPES = [(4, 32, 128, 64, 128), (2, 64, 256, 64, 128), (2, 64, 128, 32, 96),
             (2, 64, 128, 176, 176), (8, 8, 128, 8, 72), (2, 72, 128, 8, 64),
             (2, 16, 384, 32, 64), (2, 64, 128, 32, 64)]


def _ssd_inputs(h, p, n, l, seed, bsz=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, l, h, p)).astype(np.float32) * 0.5
    a = -np.abs(rng.standard_normal((bsz, l, h)).astype(np.float32))
    b = rng.standard_normal((bsz, l, 1, n)).astype(np.float32) * 0.3
    c = rng.standard_normal((bsz, l, 1, n)).astype(np.float32) * 0.3
    return x, a, b, c


@pytest.fixture(scope="module")
def k8_refs():
    """The Pallas K8 in interpret mode at K8_SHAPES, at the asked chunk, f32
    and bf16, once."""
    out = {}
    for h, p, n, chunk, l in K8_SHAPES:
        arrays = _ssd_inputs(h, p, n, l, seed=p + n + chunk)
        bf16 = p == 32 or n == 256 or (p, chunk) == (8, 8)
        for jdt in (jnp.float32, jnp.bfloat16) if bf16 else (jnp.float32,):
            ref = ssd_pallas(*(jnp.asarray(v, jdt) for v in arrays), chunk_size=chunk,
                             interpret=True)
            out[(h, p, n, chunk, l, jdt)] = (arrays, np.asarray(ref.astype(jnp.float32)))
    return out


@pytest.mark.parametrize("h,p,n,chunk,l", K8_SHAPES)
def test_k8_plain_matches_pallas_at_other_sizes(k8_refs, h, p, n, chunk, l):
    """The wrapper's plain version (the kernel's layout around ssd_plain at
    chunk 64), which the wrapper runs on the CPU, against ssd_pallas at the
    asked chunk: f32 at atol 2e-4, rtol 1e-3; bf16 in and out within one
    bf16 ulp of the largest value (tests/test_torch_ssd.py's bf16 bound)."""
    arrays, ref = k8_refs[(h, p, n, chunk, l, jnp.float32)]
    ts = [torch.from_numpy(v) for v in arrays]
    before = ssd_fused.launches
    got = ssd_fused(*ts, chunk_size=chunk)
    assert ssd_fused.launches == before and got.shape == (2, l, h, p)
    assert torch.equal(got, ssd_fused_plain(*ts, chunk_size=chunk))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)
    if (h, p, n, chunk, l, jnp.bfloat16) not in k8_refs:
        return
    arrays, ref16 = k8_refs[(h, p, n, chunk, l, jnp.bfloat16)]
    got16 = ssd_fused_plain(*(t.to(torch.bfloat16) for t in ts), chunk_size=chunk)
    assert got16.dtype == torch.bfloat16
    scale = max(float(np.abs(ref).max()), 1.0)
    assert np.abs(got16.float().numpy() - ref16).max() <= 2.0 ** -8 * scale


@pytest.mark.parametrize("p", [8, 32, 72, 128])
def test_k8_pseudo_heads_are_the_unpadded_plain_version(p):
    """P zero-padded per head to 64-column pseudo-heads, each with its
    head's decays (repeated for P past 64), through ssd_plain, against
    ssd_plain on the unpadded heads in f32: every column of x has its own
    state rows, so the padding adds exact zeros (within 1e-6 for the
    products' order) and its columns come out zero."""
    x, a, b, c = (torch.from_numpy(v) for v in _ssd_inputs(3, p, 128, 128, seed=p))
    plan = k8_plan(2, 128, 3, torch.float32, p, 128, 64)
    assert plan["head_cols"] == -(-p // 64) * 64 and plan["pseudo_heads"] == 3 * (-(-p // 64))
    lx, la, lb, lc = ssd_ops._k8_layout(x, a, b, c, plan)
    assert lx.shape == (2, 128, plan["pseudo_heads"], 64) and la.shape == lx.shape[:3]
    wide = ssd_plain(lx, la, lb, lc)
    assert not wide.reshape(2, 128, 3, plan["head_cols"])[..., p:].any()
    np.testing.assert_allclose(ssd_ops._k8_unlayout(wide, x.shape, plan).numpy(),
                               ssd_plain(x, a, b, c).numpy(), atol=1e-6, rtol=1e-6)


def test_k8_sequence_padding_is_an_exact_no_op():
    """Steps appended with x = a = b = c = 0 leave every output before them
    unchanged, bit for bit in f32 (the chunks before are the same
    arithmetic), and come out zero."""
    x, a, b, c = (torch.from_numpy(v) for v in _ssd_inputs(2, 64, 128, 128, seed=9))
    pad = lambda t: torch.cat([t, torch.zeros((2, 64) + t.shape[2:])], dim=1)  # noqa: E731
    long = ssd_plain(pad(x), pad(a), pad(b), pad(c))
    assert torch.equal(long[:, :128], ssd_plain(x, a, b, c))
    assert not long[:, 128:].any()


def test_k8_state_slices_sum_to_the_whole_state():
    """N = 256 as the kernel runs it, two 128-column slices of B and C, each
    a scan with its own state, their f32 outputs summed: the same sums as
    the whole state in another association, within the f32 tolerance."""
    x, a, b, c = (torch.from_numpy(v) for v in _ssd_inputs(2, 64, 256, 192, seed=3))
    whole = ssd_plain(x, a, b, c)
    parts = sum(ssd_plain(x, a, b[..., s:s + 128], c[..., s:s + 128]) for s in (0, 128))
    np.testing.assert_allclose(parts.numpy(), whole.numpy(), atol=ATOL, rtol=RTOL)
    assert k8_plan(2, 192, 2, torch.float32, 64, 256, 64)["slices"] == 2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("bsz,l,h,p,n,chunk", [
    (684, 704, 16, 32, 128, 64), (684, 704, 8, 64, 256, 64), (684, 704, 8, 64, 128, 32),
    (684, 704, 8, 64, 128, 176), (684, 704, 64, 8, 128, 8), (8280, 64, 8, 64, 128, 32),
    (3, 72, 2, 72, 384, 8)])
def test_k8_plan_at_other_sizes(bsz, l, h, p, n, chunk, dtype):
    """k8_plan at the chip's new K8 rows: pseudo-heads, steps padded to
    chunks of 64, one launch per 128 state columns with an f32 sum in a
    buffer of its own, and the kernel's plan at the laid-out shape, as at
    (64, 128, 64)."""
    plan = k8_plan(bsz, l, h, dtype, p, n, chunk)
    cols = -(-p // 64) * 64
    steps = -(-l // 64) * 64
    assert (plan["head_cols"], plan["pseudo_heads"], plan["steps"], plan["chunk"]) == \
        (cols, h * cols // 64, steps, 64)
    assert plan["slices"] == n // 128
    assert plan["scratch"] == (bsz * steps * plan["pseudo_heads"] * 64 * 4
                               if plan["slices"] > 1 else 0)
    base = k8_plan(bsz, steps, plan["pseudo_heads"], dtype)
    kernel = ("variant", "heads_per_block", "grid", "smem", "blocks_per_sm")
    assert {k: plan[k] for k in kernel} == {k: base[k] for k in kernel}
