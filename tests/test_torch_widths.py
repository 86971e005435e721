"""The head widths the attention cores were not built for, and K6 above d 512,
on the CPU. On the card K1 and K4 run a head of dim_head other than 32, 64
or 128 at the next of them, with W_qkv, W_o (and K4's Shaw table) padded per
head by ``padded_block_weights`` and V by ``pad_heads``; K3 reads q, k and v
of any width up to 128 and pads a width that is not a multiple of 8. Here
those helpers, followed by the kernels' plain versions at the padded width,
are held against the JAX package's Pallas kernels in interpret mode at the
real width (K3 against its plain version unpadded: the Pallas kernel has no
interpret mode), and K6's plain version at d 768 against its Pallas kernel.
The JAX references are built once, by module-scoped fixtures. Last, the
head widths of the model paths that the card's ``GATE_PATHS``
(chip_smoke.py) run through the kernels: the routes the host plans take
there, and the roformer at 16 x 32 and 8 x 96 and the mel-band conformer at
12 x 32 and 3 x 128 against the JAX models in f32."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_collections import ConfigDict

from sesa_tpu.models import bs_roformer as jax_bs
from sesa_tpu.models import mel_band_conformer as jax_mbc
from sesa_tpu.ops.attention import fused_attention_block as jax_fused_attention_block
from sesa_tpu.ops.attention import fused_conformer_attention as jax_fused_conformer_attention
from sesa_tpu.ops.convblock import fused_apollo_conv as jax_fused_apollo_conv
from sesa_tpu_torch.configs import AttrDict
from sesa_tpu_torch.models import bs_roformer, mel_band_conformer
from sesa_tpu_torch.ops import attention as attn_ops
from sesa_tpu_torch.ops.attention import (core_width, fused_attention_block_plain,
                                          fused_conformer_attention_plain, k1_plan, k3_plan,
                                          k4_plan, pad_heads, padded_block_weights, unpad_heads,
                                          vmem_attention_plain)
from sesa_tpu_torch.ops.convblock import fused_apollo_conv_plain
from sesa_tpu_torch.ops.rope import default_freqs, rope_tables
from tests.oracles.layout_keygen import mel_band_conformer_state_dict
from tests.test_roformer import bs_model_cfg, export_state_dict
from tests.test_torch_conformer import _melconf_cfg, _random_bn


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# dim_head -> heads: 3 x 8 pads to 64 (3 x 32 would leave 96 columns, not a
# multiple of the out product's 64), the others to the next core width;
# 128 runs unpadded
HEADS = {8: 3, 24: 2, 48: 2, 96: 1, 120: 1, 128: 1}
D, B, N, MAX_POS = 64, 2, 20, 8  # P 8 < n: the Shaw distances clip


def _within_one_ulp(got, ref):
    """The bf16 rule of the port's tests (tests/test_torch_attention.py): max
    error <= 2% of the output's largest value, 99% of elements within one
    output ulp."""
    assert np.abs(got - ref).max() <= 0.02 * np.abs(ref).max()
    ulp = np.maximum(np.abs(ref), 1e-3) * 2.0 ** -7
    assert np.mean(np.abs(got - ref) <= ulp) >= 0.99


def test_core_width():
    """The narrowest of 32, 64 and 128 that holds dim_head with heads x width
    a multiple of 64 (one head of 8 or 32 runs at 64); K3, without heads,
    takes the narrowest that holds it."""
    assert [core_width(dh, 8) for dh in (8, 24, 32, 40, 48, 64, 72, 96, 120, 128)] == \
        [32, 32, 32, 64, 64, 64, 128, 128, 128, 128]
    assert [core_width(dh, 3) for dh in (8, 32, 48, 64, 96)] == [64, 64, 64, 64, 128]
    assert [core_width(dh, 1) for dh in (8, 32, 48, 64, 96)] == [64, 64, 64, 64, 128]
    assert [core_width(dh) for dh in (1, 20, 33, 48, 65, 128)] == [32, 32, 64, 64, 128, 128]
    for dh, heads in HEADS.items():
        assert heads * core_width(dh, heads) % 64 == 0


def test_pad_heads_round_trip():
    """Each head's columns first, zeros after them, along any dim."""
    t = torch.arange(2 * 3 * 6, dtype=torch.float32).reshape(2, 18)
    p = pad_heads(t, 6, 8)
    assert p.shape == (2, 24) and p.is_contiguous()
    assert torch.equal(p.reshape(2, 3, 8)[..., :6], t.reshape(2, 3, 6))
    assert not p.reshape(2, 3, 8)[..., 6:].any()
    assert torch.equal(unpad_heads(p, 6, 8), t)
    assert torch.equal(pad_heads(t.T, 6, 8, dim=0), p.T)


def test_padded_weights_are_kept_while_unchanged():
    """The padded weights are made once per source tensor and made anew after
    an in-place update of it; inference tensors are padded on every call."""
    w = torch.randn(3 * 2 * 48, 64)
    wo = torch.randn(64, 2 * 48)
    first = padded_block_weights(w, wo, 48, 64)
    assert all(a is b for a, b in zip(first[:2], padded_block_weights(w, wo, 48, 64)[:2]))
    w.mul_(2)
    again = padded_block_weights(w, wo, 48, 64)
    assert again[0] is not first[0] and torch.equal(again[0], 2 * first[0])
    assert again[1] is first[1]
    with torch.inference_mode():
        wi = torch.randn(3 * 2 * 48, 64)
        assert padded_block_weights(wi, wo, 48, 64)[0] is not \
            padded_block_weights(wi, wo, 48, 64)[0]
    n_made = len(attn_ops._MADE)
    del w, first, again
    assert len(attn_ops._MADE) < n_made  # dropped with the tensor they came from


def _k1_arrays(dh):
    heads = HEADS[dh]
    rng = np.random.default_rng(dh)
    mk = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    hd = heads * dh
    arrays = [mk(B, N, D), mk(D), mk(3 * hd, D, sc=0.1), mk(heads, D, sc=0.1),
              mk(heads), mk(D, hd, sc=0.1), mk(heads, D, sc=0.1), mk(heads)]
    rot = dh - dh % 16 if dh > 16 else dh  # partial rope where dh is not a multiple of 16
    rope = tuple(np.asarray(r) for r in rope_tables(torch.from_numpy(default_freqs(rot)), N))
    return arrays, rope, heads


def _k1_jax(dh, jdt):
    """Modes 0, 1 and 2 (V lerped toward mode 1's pre-mix V, no residual)."""
    arrays, rope, heads = _k1_arrays(dh)
    j = [jnp.asarray(a, jdt) for a in arrays]
    jrope = tuple(jnp.asarray(r, jdt) for r in rope)
    run = lambda **kw: jax_fused_attention_block(*j[:6], heads, dh ** -0.5, rope=jrope,  # noqa: E731
                                                 interpret=True, **kw)
    out0 = run()
    out1, v1 = run(vr=(None, None, None))
    out2, v2 = run(vr=(j[6], j[7], v1), add_residual=False)
    return [np.asarray(a, np.float32) for a in (out0, out1, v1, out2, v2)]


@pytest.fixture(scope="module")
def k1_refs():
    refs = {(dh, "f32"): _k1_jax(dh, jnp.float32) for dh in HEADS}
    refs.update({(dh, "bf16"): _k1_jax(dh, jnp.bfloat16)[:1] for dh in HEADS})
    return refs


def _k1_padded(dh, tdt):
    """The wrapper's padded route with the plain version in its kernel's place."""
    arrays, rope, heads = _k1_arrays(dh)
    t = [torch.from_numpy(a).to(tdt) for a in arrays]
    trope = tuple(torch.from_numpy(r).to(tdt) for r in rope)
    width = core_width(dh, heads)
    wqkv, wo, _ = padded_block_weights(t[2], t[5], dh, width)
    run = lambda **kw: fused_attention_block_plain(t[0], t[1], wqkv, t[3], t[4], wo, heads,  # noqa: E731
                                                   dh ** -0.5, rope=trope, **kw)
    out0 = run()
    out1, v1 = run(vr=(None, None, None))
    out2, v2 = run(vr=(t[6], t[7], v1), add_residual=False)  # v1 as the kernel leaves it, padded
    got = [out0, out1, unpad_heads(v1, dh, width), out2, unpad_heads(v2, dh, width)]
    return [g.float().numpy() for g in got]


@pytest.mark.parametrize("dh", list(HEADS))
def test_k1_padded_matches_pallas_f32(k1_refs, dh):
    """Modes 0, 1 and 2 and both pre-mix Vs at the f32 tolerance of
    tests/test_torch_attention.py."""
    for got, ref in zip(_k1_padded(dh, torch.float32), k1_refs[(dh, "f32")]):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=3e-5, rtol=2e-5)


@pytest.mark.parametrize("dh", list(HEADS))
def test_k1_padded_matches_pallas_bf16(k1_refs, dh):
    _within_one_ulp(_k1_padded(dh, torch.bfloat16)[0], k1_refs[(dh, "bf16")][0])


def _k4_arrays(dh):
    heads = HEADS[dh]
    rng = np.random.default_rng(100 + dh)
    r = lambda *s: (rng.standard_normal(s) * 0.05).astype(np.float32)  # noqa: E731
    return [rng.standard_normal((B, N, D)).astype(np.float32), 1.0 + 2 * r(D), r(D),
            r(3 * heads * dh, D), r(2 * MAX_POS + 1, dh) * 10, r(D, heads * dh), r(D)], heads


K4_BF16 = (48, 96)


@pytest.fixture(scope="module")
def k4_refs():
    refs = {}
    for dh in HEADS:
        arrays, heads = _k4_arrays(dh)
        for name, jdt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
            if name == "bf16" and dh not in K4_BF16:
                continue
            refs[(dh, name)] = np.asarray(jax_fused_conformer_attention(
                *(jnp.asarray(a, jdt) for a in arrays), heads, interpret=True), np.float32)
    return refs


def _k4_padded(dh, tdt):
    arrays, heads = _k4_arrays(dh)
    x, ln_w, ln_b, wqkv, rel, wo, bo = (torch.from_numpy(a).to(tdt) for a in arrays)
    wqkv, wo, rel = padded_block_weights(wqkv, wo, dh, core_width(dh, heads), rel)
    return fused_conformer_attention_plain(x, ln_w, ln_b, wqkv, rel, wo, bo, heads,
                                           dh ** -0.5).float().numpy()


@pytest.mark.parametrize("dh", list(HEADS))
def test_k4_padded_matches_pallas(k4_refs, dh):
    """f32 at the tolerance of tests/test_torch_conformer.py's K4 cases; bf16
    at dim_head 48 and 96 within one ulp."""
    np.testing.assert_allclose(_k4_padded(dh, torch.float32), k4_refs[(dh, "f32")],
                               atol=3e-5, rtol=2e-5)
    if dh in K4_BF16:
        _within_one_ulp(_k4_padded(dh, torch.bfloat16), k4_refs[(dh, "bf16")])


@pytest.mark.parametrize("dh", [48, 96, 20])
def test_k3_padded_matches_plain(dh):
    """K3's inputs as its plan hands them to the kernel, run at the core width
    with zeros beyond the real columns, against the plain version on the
    unpadded tensors: exactly equal in f32 (zero columns add exact zeros),
    and the plan's result is the real columns."""
    g = torch.Generator().manual_seed(dh)
    q, k, v = (torch.randn((2, 3, 300, dh), generator=g) for _ in range(3))
    if dh % 8 == 0:  # the kernel's boxes zero-fill what TMA reads past the real width
        qp, kp, vp = (_pad_to(t, core_width(dh)) for t in (q, k, v))
    else:
        (qp, kp, vp), *_ = k3_plan(q, k, v)
        qp, kp, vp = (_pad_to(t, core_width(dh)) for t in (qp, kp, vp))
    want = vmem_attention_plain(q, k, v, dh ** -0.5)
    got = vmem_attention_plain(qp, kp, vp, dh ** -0.5)
    assert not got[..., dh:].any()
    torch.testing.assert_close(got[..., :dh].reshape(want.shape), want, atol=0, rtol=0)


def _pad_to(t, width):
    return torch.nn.functional.pad(t, (0, width - t.shape[-1]))


@pytest.fixture(scope="module")
def k6_case():
    rng = np.random.default_rng(768)
    d = 768
    r = lambda *s: rng.standard_normal(s).astype(np.float32) * 0.05  # noqa: E731
    p = {"dw_w": r(d, 1, 7), "dw_b": r(d), "norm": 1.0 + 0.1 * r(d), "pw1_w": r(4 * d, d),
         "pw1_b": r(4 * d), "pw2_w": r(d, 4 * d), "pw2_b": r(d)}
    x = rng.standard_normal((2, 70, d)).astype(np.float32)
    refs = {name: np.asarray(jax_fused_apollo_conv(jnp.asarray(x, jdt),
                                                   {k: jnp.asarray(v, jdt) for k, v in p.items()},
                                                   interpret=True).astype(jnp.float32))
            for name, jdt in (("f32", jnp.float32), ("bf16", jnp.bfloat16))}
    return p, x, refs


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_k6_plain_at_d768_matches_pallas(k6_case, dtype):
    """K6 at Apollo's feature_dim 768 (hidden 3072, k 7, a sequence across a
    64-row boundary): f32 at the tolerance of tests/test_torch_apollo.py,
    bf16 within one ulp."""
    p, x, refs = k6_case
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    got = fused_apollo_conv_plain(torch.from_numpy(x).to(tdt),
                                  {k: torch.from_numpy(v).to(tdt) for k, v in p.items()})
    got = got.float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, refs["f32"], atol=3e-5, rtol=1e-4)
    else:
        _within_one_ulp(got, refs["bf16"])


# ---------------------------------------------------------------------------
# the head widths of the card's model paths (chip_smoke.py GATE_PATHS)
# ---------------------------------------------------------------------------

# (b, n, d, heads, dim_head, core width, route): the flagship's legs (372 x
# 690 frames, 4140 x 62 bands) at 16 x 32 and 8 x 96, the mel-band
# conformer's (360 x 690, 4140 x 60) at 12 x 32 and 3 x 128
K1_MODEL_ROUTES = [(372, 690, 512, 16, 32, 32, "tiles"), (4140, 62, 512, 16, 32, 32, "short"),
                   (372, 690, 512, 8, 96, 128, "tiles"), (4140, 62, 512, 8, 96, 128, "short")]
K4_MODEL_ROUTES = [(360, 690, 384, 12, 32, 32, "tiles"), (4140, 60, 384, 12, 32, 32, "mma"),
                   (360, 690, 384, 3, 128, 128, "mma"), (4140, 60, 384, 3, 128, 128, "mma")]


@pytest.mark.parametrize("b,n,d,heads,dh,width,route", K1_MODEL_ROUTES)
def test_k1_route_at_the_model_widths(b, n, d, heads, dh, width, route):
    """K1 at 16 x 32 on its 32-wide cores (flash_wgmma for n > 64, flash_core
    for n <= 64) and at 8 x 96 padded to 128."""
    assert core_width(dh, heads) == width
    assert k1_plan(b, n, d, heads, width, 132)["core"]["route"] == route


@pytest.mark.parametrize("b,n,d,heads,dh,width,route", K4_MODEL_ROUTES)
def test_k4_route_at_the_model_widths(b, n, d, heads, dh, width, route):
    """K4 at 12 x 32 on flash_shaw's tiles for n > 64 and mma.sync for n <= 64;
    at 3 x 128 on mma.sync at any n."""
    assert core_width(dh, heads) == width
    assert k4_plan(b, n, d, heads, width, 132)["core"]["route"] == route


# end-to-end f32 tolerance of the JAX package against its torch oracles
# (BASELINE.md:88), as tests/test_torch_bs_roformer.py and
# tests/test_torch_conformer.py state it
MODEL_ATOL, MODEL_RTOL = 5e-4, 1e-3


@pytest.mark.parametrize("heads,dh", [(16, 32), (8, 96)])
def test_bs_roformer_at_model_head_widths_matches_jax(heads, dh):
    mcfg = bs_model_cfg(depth=1, heads=heads, dim_head=dh)
    jcfg, cfg = ConfigDict({"model": mcfg}), AttrDict({"model": mcfg})
    jparams = jax_bs.init(jax.random.PRNGKey(heads), jcfg)
    sd = export_state_dict(jparams, jax_bs.spec_from_config(mcfg),
                           transformer_norm_output=False, final_norm=True)
    x = np.random.default_rng(1).standard_normal((2, 2, 2048)).astype(np.float32) * 0.3
    ref = np.asarray(jax.jit(lambda p, a: jax_bs.apply(p, jcfg, a))(
        jax_bs.convert_torch({k: v.numpy() for k, v in sd.items()}, jcfg), jnp.asarray(x)))
    got = bs_roformer.apply(bs_roformer.convert_torch(sd, cfg), cfg, torch.from_numpy(x))
    assert got.shape == ref.shape == (2, mcfg["num_stems"], 2, 2048)
    np.testing.assert_allclose(got.numpy(), ref, atol=MODEL_ATOL, rtol=MODEL_RTOL)


@pytest.mark.parametrize("heads,dh", [(12, 32), (3, 128)])
def test_mel_band_conformer_at_model_head_widths_matches_jax(heads, dh):
    mcfg = _melconf_cfg(depth=1, heads=heads, dim_head=dh)
    jcfg, cfg = ConfigDict({"model": mcfg}), AttrDict({"model": mcfg})
    sd = _random_bn(mel_band_conformer_state_dict(jcfg, seed=heads), 3)
    x = np.random.default_rng(1).standard_normal((2, 2, 1280)).astype(np.float32) * 0.3
    ref = np.asarray(jax.jit(lambda p, a: jax_mbc.apply(p, jcfg, a))(
        jax_mbc.convert_torch(sd, jcfg), jnp.asarray(x)))
    params = mel_band_conformer.convert_torch({k: torch.from_numpy(np.array(v))
                                               for k, v in sd.items()}, cfg)
    got = mel_band_conformer.apply(params, cfg, torch.from_numpy(x))
    assert got.shape == ref.shape == (2, 1, 2, 1280)
    np.testing.assert_allclose(got.numpy(), ref, atol=MODEL_ATOL, rtol=MODEL_RTOL)
