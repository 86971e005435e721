"""The port's conformer kernels (K4, K5, K2's LayerNorm/SiLU form), the
conformer block and mel_band_conformer held against sesa_tpu on the CPU: the
plain versions against the Pallas kernels in interpret mode, the models in
f32 against the JAX models loaded from the same state dict."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_collections import ConfigDict

from sesa_tpu.models import conformer_core as jax_cc
from sesa_tpu.models import mel_band_conformer as jax_mbc
from sesa_tpu.ops.attention import fused_conformer_attention as jax_fused_conformer_attention
from sesa_tpu.ops.convblock import fused_conformer_conv as jax_fused_conformer_conv
from sesa_tpu.ops.ff import fused_ff_residual as jax_fused_ff_residual
from sesa_tpu_torch.configs import AttrDict
from sesa_tpu_torch.convert.from_jax import params_from_jax
from sesa_tpu_torch.models import conformer_core as cc
from sesa_tpu_torch.models import mel_band_conformer
from sesa_tpu_torch.ops.attention import (fused_conformer_attention,
                                          fused_conformer_attention_plain)
from sesa_tpu_torch.ops.convblock import fused_conformer_conv, fused_conformer_conv_plain
from sesa_tpu_torch.ops.ff import fused_ff_residual, fused_ff_residual_plain
from sesa_tpu_torch.tree import tree_map
from tests.oracles.layout_keygen import mel_band_conformer_state_dict


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch: with the tier-1 run's six workers on
    eight cores, torch's thread pools spin against each other (a session
    test of 0.5 s alone took 40 s beside five busy processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


HI = jax.lax.Precision.HIGHEST
# end-to-end f32 tolerance of the JAX package against its torch oracles
# (BASELINE.md:88)
ATOL, RTOL = 5e-4, 1e-3


def _rng_tree(tree, seed):
    """numpy copies of a nested dict of arrays, drawn N(0, 0.05²) (norm
    weights near 1, BN variances positive) from ``seed``."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        r = rng.standard_normal(np.shape(a)).astype(np.float32) * 0.05
        if path.endswith(("norm/weight", "bn/weight")):
            return 1.0 + 2 * r
        if path.endswith("running_var"):
            return np.abs(1.0 + 4 * r)
        return r

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, f"{path}/{i}") for i, v in enumerate(t)]
        return draw(path, t)

    return walk(tree, "")


def _to_t(tree, dtype=torch.float32):
    return tree_map(lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dtype), tree)


def _to_j(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _within_one_ulp(got, ref):
    """The bf16 rule of the port's tests: the two sides round at the same
    points and differ only in f32 summation order, which can flip a rounded
    value by one bf16 ulp (2**-8 relative). Bound: max error <= 2% of the
    output's largest value, and 99% of elements within one output ulp."""
    assert np.abs(got - ref).max() <= 0.02 * np.abs(ref).max()
    ulp = np.maximum(np.abs(ref), 1e-3) * 2.0 ** -7
    assert np.mean(np.abs(got - ref) <= ulp) >= 0.99


# --------------------------------------------------------------------------
# K4: fused_conformer_attention
# --------------------------------------------------------------------------

def _attn_inputs(b, n, dim, heads, dh, max_pos, seed):
    rng = np.random.default_rng(seed)
    r = lambda *s: (rng.standard_normal(s) * 0.05).astype(np.float32)  # noqa: E731
    x = rng.standard_normal((b, n, dim)).astype(np.float32)
    return [x, 1.0 + 2 * r(dim), r(dim), r(3 * heads * dh, dim), r(2 * max_pos + 1, dh),
            r(dim, heads * dh), r(dim)]


def _attn_both(arrays, heads, dtype_t, dtype_j):
    got = fused_conformer_attention_plain(*(torch.from_numpy(a).to(dtype_t) for a in arrays),
                                          heads)
    ref = jax_fused_conformer_attention(*(jnp.asarray(a, dtype_j) for a in arrays), heads,
                                        interpret=True)
    return got.float().numpy(), np.asarray(ref, np.float32)


# the cases and f32 tolerance of tests/test_fused_conformer.py
@pytest.mark.parametrize("n,dim,heads,dh,max_pos", [
    (50, 64, 2, 16, 512),   # short seq, no clipping
    (130, 64, 2, 16, 64),   # clipping engaged (n - 1 > max_pos)
    (70, 128, 4, 32, 512),  # unaligned seq crossing the 64 pad
])
def test_k4_plain_matches_pallas_f32(n, dim, heads, dh, max_pos):
    arrays = _attn_inputs(3, n, dim, heads, dh, max_pos, n)
    got, ref = _attn_both(arrays, heads, torch.float32, jnp.float32)
    assert got.shape == (3, n, dim)
    np.testing.assert_allclose(got, ref, atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("n,max_pos", [(60, 512), (130, 64)])
def test_k4_plain_matches_pallas_bf16(n, max_pos):
    arrays = _attn_inputs(2, n, 64, 2, 32, max_pos, 3 * n)
    _within_one_ulp(*_attn_both(arrays, 2, torch.bfloat16, jnp.bfloat16))


def test_k4_plain_matches_unfused_attention():
    """The Shaw sign convention (dist = i - j) of the unfused _attn_apply."""
    n, dim, heads, dh, max_pos = 40, 32, 2, 8, 16
    x, lnw, lnb, wqkv, rel, wo, bo = _attn_inputs(2, n, dim, heads, dh, max_pos, 9)
    p = {"norm": {"weight": lnw, "bias": lnb}, "to_q": {"weight": wqkv[:heads * dh]},
         "to_kv": {"weight": wqkv[heads * dh:]}, "to_out": {"weight": wo, "bias": bo},
         "rel_pos_emb": rel}
    ref = jax_cc._attn_apply(_to_j(p), jnp.asarray(x), heads, HI) + x
    got = fused_conformer_attention_plain(*(torch.from_numpy(a) for a in
                                            (x, lnw, lnb, wqkv, rel, wo, bo)), heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-5, rtol=1e-4)
    port = cc._attn_apply(_to_t(p), torch.from_numpy(x), heads) + torch.from_numpy(x)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=3e-5, rtol=1e-4)


def test_k4_wrapper_runs_plain_on_cpu():
    ts = [torch.from_numpy(a) for a in _attn_inputs(2, 20, 64, 2, 16, 8, 1)]
    before = fused_conformer_attention.launches
    assert torch.equal(fused_conformer_attention(*ts, 2),
                       fused_conformer_attention_plain(*ts, 2))
    assert fused_conformer_attention.launches == before  # no kernel on the CPU


# --------------------------------------------------------------------------
# K5: fused_conformer_conv
# --------------------------------------------------------------------------

def _conv_params(seed, dim, kernel, expansion=2):
    e = dim * expansion
    z = np.zeros
    zeros = {"norm": {"weight": z(dim), "bias": z(dim)},
             "pw1": {"weight": z((2 * e, dim, 1)), "bias": z(2 * e)},
             "dw": {"weight": z((e, 1, kernel)), "bias": z(e)},
             "bn": {"weight": z(e), "bias": z(e), "running_mean": z(e), "running_var": z(e)},
             "pw2": {"weight": z((dim, e, 1)), "bias": z(dim)}}
    return _rng_tree(zeros, seed)


def _conv_both(p, x, dtype_t, dtype_j):
    got = fused_conformer_conv_plain(torch.from_numpy(x).to(dtype_t), _to_t(p, dtype_t))
    ref = jax_fused_conformer_conv(jnp.asarray(x, dtype_j), _to_j(p, dtype_j), interpret=True)
    return got.float().numpy(), np.asarray(ref, np.float32)


# the cases and tolerance of tests/test_fused_convblock.py
@pytest.mark.parametrize("b,n,dim,kernel", [
    (3, 60, 64, 31),    # short pad: the Pallas wrap masks active
    (2, 90, 64, 31),    # long pad: masks skipped
    (1, 130, 128, 7),   # small kernel
    (2, 64, 64, 31),    # zero pad: every wrap masked
])
def test_k5_plain_matches_pallas_f32(b, n, dim, kernel):
    p = _conv_params(n + dim, dim, kernel)
    x = np.random.default_rng(n).standard_normal((b, n, dim)).astype(np.float32)
    got, ref = _conv_both(p, x, torch.float32, jnp.float32)
    np.testing.assert_allclose(got, ref, atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("n,kernel", [(60, 31), (130, 7)])
def test_k5_plain_matches_pallas_bf16(n, kernel):
    p = _conv_params(n, 64, kernel)
    x = np.random.default_rng(n + 1).standard_normal((2, n, 64)).astype(np.float32)
    _within_one_ulp(*_conv_both(p, x, torch.bfloat16, jnp.bfloat16))


@pytest.mark.parametrize("kernel", [8, 31])
def test_k5_plain_matches_conv_apply(kernel):
    """The lucidrains padding (k // 2, k // 2 - (k + 1) % 2) of _conv_apply,
    which the Pallas kernel's (k - 1) // 2 offset misses for even k."""
    p = _conv_params(kernel, 64, kernel)
    x = np.random.default_rng(kernel).standard_normal((2, 50, 64)).astype(np.float32)
    ref = np.asarray(jax_cc._conv_apply(_to_j(p), jnp.asarray(x), HI) + x)
    got = fused_conformer_conv_plain(torch.from_numpy(x), _to_t(p)).numpy()
    np.testing.assert_allclose(got, ref, atol=3e-5, rtol=1e-4)
    port = (cc._conv_apply(_to_t(p), torch.from_numpy(x)) + torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(port, ref, atol=3e-5, rtol=1e-4)


def test_k5_wrapper_runs_plain_on_cpu():
    p = _to_t(_conv_params(0, 64, 31))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 33, 64)).astype(np.float32))
    before = fused_conformer_conv.launches
    assert torch.equal(fused_conformer_conv(x, p), fused_conformer_conv_plain(x, p))
    assert fused_conformer_conv.launches == before


# --------------------------------------------------------------------------
# K2, LayerNorm / SiLU / 0.5 form
# --------------------------------------------------------------------------

def _ff_inputs(tokens, dim, mult, seed, x_scale=0.25):
    rng = np.random.default_rng(seed)
    r = lambda *s: (rng.standard_normal(s) * 0.05).astype(np.float32)  # noqa: E731
    return ([r(tokens, dim) * (x_scale / 0.05), 1.0 + 2 * r(dim), r(dim * mult, dim),
             r(dim * mult), r(dim, dim * mult), r(dim)], r(dim))


def _ff_both(arrays, beta, dtype_t, dtype_j):
    kw = dict(norm="ln", act="swish", out_scale=0.5)
    got = fused_ff_residual_plain(*(torch.from_numpy(a).to(dtype_t) for a in arrays),
                                  beta=torch.from_numpy(beta).to(dtype_t), **kw)
    ref = jax_fused_ff_residual(*(jnp.asarray(a, dtype_j) for a in arrays),
                                beta=jnp.asarray(beta, dtype_j), tile=64, interpret=True, **kw)
    return got.float().numpy(), np.asarray(ref, np.float32)


def test_k2_ln_plain_matches_pallas_f32():
    # the case and tolerance of tests/test_fused_conformer.py:62
    got, ref = _ff_both(*_ff_inputs(300, 128, 4, 0), torch.float32, jnp.float32)
    np.testing.assert_allclose(got, ref, atol=3e-5, rtol=1e-4)


def test_k2_ln_plain_matches_pallas_bf16():
    _within_one_ulp(*_ff_both(*_ff_inputs(64, 128, 4, 1, x_scale=1.0),
                              torch.bfloat16, jnp.bfloat16))


def test_k2_ln_matches_conformer_ff():
    arrays, beta = _ff_inputs(40, 64, 4, 2)
    x, g, w1, b1, w2, b2 = arrays
    p = {"norm": {"weight": g, "bias": beta}, "lin1": {"weight": w1, "bias": b1},
         "lin2": {"weight": w2, "bias": b2}}
    ref = np.asarray(jax_cc._ff_apply(_to_j(p), jnp.asarray(x), HI) + x)
    got = fused_ff_residual(*(torch.from_numpy(a) for a in arrays), beta=torch.from_numpy(beta),
                            norm="ln", act="swish", out_scale=0.5)
    np.testing.assert_allclose(got.numpy(), ref, atol=3e-5, rtol=1e-4)
    port = cc._ff_apply(_to_t(p), torch.from_numpy(x)) + torch.from_numpy(x)
    np.testing.assert_allclose(port.numpy(), ref, atol=3e-5, rtol=1e-4)


def test_k2_rejects_unknown_form():
    ts = [torch.from_numpy(a) for a in _ff_inputs(8, 64, 4, 3)[0]]
    with pytest.raises(ValueError, match="unsupported form"):
        fused_ff_residual(*ts, norm="ln", act="gelu")


# --------------------------------------------------------------------------
# conformer block, mel_band_conformer
# --------------------------------------------------------------------------

def _block_tree(dim, heads, dh, kernel, max_pos, seed):
    jp = jax_cc.conformer_block_init(jax.random.PRNGKey(0), dim, dim_head=dh, heads=heads,
                                     ff_mult=4, conv_kernel_size=kernel)
    tree = _rng_tree(jax.tree.map(np.asarray, jp), seed)
    tree["attn"]["rel_pos_emb"] = tree["attn"]["rel_pos_emb"][512 - max_pos:512 + max_pos + 1]
    return tree


@pytest.mark.parametrize("n,max_pos,kernel", [(37, 512, 31), (45, 16, 8)])
def test_conformer_block_matches_jax_f32(n, max_pos, kernel):
    tree = _block_tree(64, 2, 16, kernel, max_pos, n)
    x = np.random.default_rng(n).standard_normal((3, n, 64)).astype(np.float32)
    ref = jax_cc.conformer_block_apply(_to_j(tree), jnp.asarray(x), 2)
    got = cc.conformer_block_apply(_to_t(tree), torch.from_numpy(x), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_fused_gate_is_a_shape_test():
    tree = _to_t(_block_tree(64, 2, 16, 31, 512, 0))
    x = torch.zeros((2, 30, 64))
    assert not cc.use_fused_conformer(x, tree, 2)  # the CPU runs the plain chain
    assert cc.fused_conformer_shape_ok(2048, 128, 384)
    assert not cc.fused_conformer_shape_ok(2049, 64, 384)
    assert not cc.fused_conformer_shape_ok(690, 256, 384)
    assert not cc.fused_conformer_shape_ok(690, 64, 96)


def _melconf_cfg(**over):
    cfg = dict(dim=32, depth=2, stereo=True, num_stems=1, time_conformer_depth=1,
               freq_conformer_depth=1, num_bands=8, dim_head=8, heads=4, ff_mult=2,
               conv_expansion_factor=2, conv_kernel_size=7, sample_rate=44100,
               stft_n_fft=128, stft_hop_length=32, stft_win_length=128, mask_estimator_depth=1)
    cfg.update(over)
    return cfg


def _random_bn(sd, seed):
    """Eval BatchNorm statistics away from the identity init, in place."""
    rng = np.random.default_rng(seed)
    for k in sd:
        if k.endswith(("net.5.running_mean", "net.5.bias")):
            sd[k] = (rng.standard_normal(sd[k].shape) * 0.1).astype(np.float32)
        elif k.endswith(("net.5.running_var", "net.5.weight")):
            sd[k] = (1.0 + 0.2 * np.abs(rng.standard_normal(sd[k].shape))).astype(np.float32)
    return sd


@pytest.mark.parametrize("over", [{}, {"stereo": False, "num_stems": 2,
                                       "mask_estimator_depth": 2}])
def test_mel_band_conformer_matches_jax_f32(over):
    mcfg = _melconf_cfg(**over)
    jcfg, cfg = ConfigDict({"model": mcfg}), AttrDict({"model": mcfg})
    sd = _random_bn(mel_band_conformer_state_dict(jcfg, seed=2), 3)
    ch = 2 if mcfg["stereo"] else 1
    x = np.random.default_rng(1).standard_normal((2, ch, 1280)).astype(np.float32) * 0.3

    jparams = jax_mbc.convert_torch(sd, jcfg)
    ref = np.asarray(jax_mbc.apply(jparams, jcfg, jnp.asarray(x)))
    params = mel_band_conformer.convert_torch({k: torch.from_numpy(np.array(v))
                                               for k, v in sd.items()}, cfg)
    got = mel_band_conformer.apply(params, cfg, torch.from_numpy(x))
    assert got.shape == ref.shape == (2, mcfg["num_stems"], ch, 1280)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)

    copied = params_from_jax(jax.tree.map(np.asarray, jparams), "mel_band_conformer", cfg)
    got2 = mel_band_conformer.apply(copied, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got2.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_params_from_jax_rejects_wrong_melconf_tree():
    mcfg = _melconf_cfg()
    tree = jax.tree.map(np.asarray, jax_mbc.init(jax.random.PRNGKey(0),
                                                 ConfigDict({"model": mcfg})))
    del tree["layers"][0]["time"]["layers"][0]["conv"]["bn"]["running_var"]
    with pytest.raises(ValueError, match="does not match"):
        params_from_jax(tree, "mel_band_conformer", AttrDict({"model": mcfg}))


def test_melconf_convert_raises_on_leftover_key():
    mcfg = _melconf_cfg()
    sd = mel_band_conformer_state_dict(ConfigDict({"model": mcfg}))
    sd["layers.0.0.layers.0.attn.fn.extra.weight"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="unconsumed"):
        mel_band_conformer.convert_torch(sd, AttrDict({"model": mcfg}))


def test_melconf_convert_raises_on_missing_key():
    mcfg = _melconf_cfg()
    sd = mel_band_conformer_state_dict(ConfigDict({"model": mcfg}))
    del sd["layers.1.1.layers.0.conv.net.5.running_var"]
    with pytest.raises(KeyError, match="running_var"):
        mel_band_conformer.convert_torch(sd, AttrDict({"model": mcfg}))


def test_melconf_key_map_recovers_renamed_checkpoint(tmp_path, monkeypatch):
    mcfg = _melconf_cfg(depth=1)
    cfg = AttrDict({"model": mcfg})
    sd = mel_band_conformer_state_dict(ConfigDict({"model": mcfg}))
    expected = mel_band_conformer.convert_torch(sd, cfg)
    renamed = {k.replace(".conv.net.", ".conv_module.seq."): v for k, v in sd.items()}
    with pytest.raises(KeyError, match="conv_module"):  # names the closest present keys
        mel_band_conformer.convert_torch(renamed, cfg)
    path = tmp_path / "map.json"
    path.write_text(json.dumps({f"layers.0.{j}.layers.0.conv_module.seq.":
                                f"layers.0.{j}.layers.0.conv.net." for j in (0, 1)}))
    monkeypatch.setenv("SESA_CONFORMER_KEY_MAP", str(path))
    got = mel_band_conformer.convert_torch(renamed, cfg)
    flat_e, flat_g = [], []
    tree_map(flat_e.append, expected)
    tree_map(flat_g.append, got)
    assert len(flat_e) == len(flat_g)
    assert all(torch.equal(a, b) for a, b in zip(flat_e, flat_g))


def test_melconf_seeded_init_is_deterministic():
    cfg = AttrDict({"model": _melconf_cfg(depth=1)})
    a, b = [], []
    tree_map(a.append, mel_band_conformer.init(torch.Generator().manual_seed(4), cfg))
    tree_map(b.append, mel_band_conformer.init(torch.Generator().manual_seed(4), cfg))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
