"""The port's TS-BS-Mamba2 held against sesa_tpu's on the CPU in f32: the
Mamba-2 block, TAC, ResMamba and the whole separator on the same numpy
inputs and the same parameters, and the checkpoint converter."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_collections import ConfigDict

from sesa_tpu.models import bs_mamba2 as jax_mamba
from sesa_tpu_torch.configs import AttrDict
from sesa_tpu_torch.convert.from_jax import params_from_jax
from sesa_tpu_torch.models import bs_mamba2, get_model, layers
from sesa_tpu_torch.tree import tree_map


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch: with the tier-1 run's six workers on
    eight cores, torch's thread pools spin against each other (a session
    test of 0.5 s alone took 40 s beside five busy processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# f32 on both sides; the sums run in different orders
ATOL = 5e-4

TINY = dict(sr=44100, win=2048, stride=512, feature_dim=16, num_repeat_mask=1,
            num_repeat_map=1, num_output=2)  # tests/test_bs_mamba2.py:70-76


def _randomized(tree, seed):
    """A JAX init tree with its identity norms replaced by random values, so
    that every parameter matters."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda v: jnp.asarray(
        np.asarray(v) + 0.1 * rng.standard_normal(np.shape(v)).astype(np.float32)), tree)


def _to_torch(tree):
    return tree_map(lambda v: torch.from_numpy(np.array(v, dtype=np.float32)),
                    jax.tree.map(np.asarray, tree))


def test_band_widths():
    widths = bs_mamba2.band_widths(44100, 2048)
    assert widths == jax_mamba.band_widths(44100, 2048)
    assert len(widths) == 57 and sum(widths) == 1025
    assert sorted(set(widths)) == [2, 4, 11, 23, 46, 92, 121]


@pytest.mark.parametrize("length", [100, 128])  # ragged (padded to 128) and chunk-aligned
def test_mamba2_apply_matches_jax(length):
    jp = _randomized(jax_mamba.mamba2_init(jax.random.PRNGKey(0), 32), 1)
    u = np.random.default_rng(2).standard_normal((2, length, 32)).astype(np.float32) * 0.3
    ref = np.asarray(jax_mamba.mamba2_apply(jp, jnp.asarray(u)))
    got = bs_mamba2.mamba2_apply(_to_torch(jp), torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=1e-3)


def test_res_mamba_matches_jax():
    jp = _randomized(jax_mamba._res_mamba_init(jax.random.PRNGKey(1), 16), 2)
    x = np.random.default_rng(3).standard_normal((3, 16, 70)).astype(np.float32)
    ref = np.asarray(jax_mamba._res_mamba_apply(jp, jnp.asarray(x)))
    got = bs_mamba2._res_mamba_apply(_to_torch(jp), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=1e-3)


def test_tac_matches_jax():
    jp = _randomized(jax_mamba._tac_init(jax.random.PRNGKey(2), 16, 48), 3)
    x = np.random.default_rng(4).standard_normal((2, 3, 16, 40)).astype(np.float32)
    ref = np.asarray(jax_mamba._tac_apply(jp, jnp.asarray(x)))
    got = bs_mamba2._tac_apply(_to_torch(jp), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=1e-3)


def test_group_norm_matches_jax():
    from sesa_tpu.models import layers as jax_layers

    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 8, 5, 7)).astype(np.float32) * 2 + 1
    w, b = (rng.standard_normal(8).astype(np.float32) for _ in range(2))
    for groups in (1, 4):
        ref = np.asarray(jax_layers.group_norm(
            jnp.asarray(x), {"weight": jnp.asarray(w), "bias": jnp.asarray(b)}, groups))
        got = layers.group_norm(torch.from_numpy(x), {"weight": torch.from_numpy(w),
                                                      "bias": torch.from_numpy(b)}, groups)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_whole_model_matches_jax_through_params_from_jax():
    jp = _randomized(jax_mamba.init(jax.random.PRNGKey(0), ConfigDict({"model": TINY})), 6)
    x = np.random.default_rng(2).standard_normal((1, 2, 8192)).astype(np.float32) * 0.1
    ref = np.asarray(jax_mamba.apply(jp, ConfigDict({"model": TINY}), jnp.asarray(x)))
    cfg = AttrDict({"model": TINY})
    params = params_from_jax(jax.tree.map(np.asarray, jp), "bs_mamba2", cfg)
    got = get_model("bs_mamba2").apply(params, cfg, torch.from_numpy(x))
    assert got.shape == ref.shape == (1, 2, 2, 8192)
    assert np.abs(ref).max() > 1e-3
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=1e-3)


def _state_dict(params, prefix=""):
    """The port's tree written out under the reference checkpoint's keys."""
    sd = {}

    def wb(key, p, unsqueeze=False):
        sd[f"{key}.weight"] = p["weight"][..., None] if unsqueeze else p["weight"]
        sd[f"{key}.bias"] = p["bias"]

    def mamba(key, p):
        for name, k in (("in_proj.weight", "in_proj"), ("conv1d.weight", "conv_w"),
                        ("conv1d.bias", "conv_b"), ("dt_bias", "dt_bias"), ("A_log", "A_log"),
                        ("D", "D"), ("norm.weight", "norm_w"), ("out_proj.weight", "out_proj")):
            sd[f"{key}.{name}"] = p[k]

    for branch, key in (("separator_mask", "separator_mask"), ("separator_map", "separator_map")):
        for i, bs in enumerate(params[branch]):
            for rm in ("band_rnn", "band_comm"):
                wb(f"{key}.{i}.{rm}.norm", bs[rm]["norm"])
                mamba(f"{key}.{i}.{rm}.rnn.forward_mamba2", bs[rm]["mamba"]["forward"])
                mamba(f"{key}.{i}.{rm}.rnn.backward_mamba2", bs[rm]["mamba"]["backward"])
                wb(f"{key}.{i}.{rm}.proj", bs[rm]["proj"])
            tac = bs["channel_comm"]
            wb(f"{key}.{i}.channel_comm.input_norm", tac["norm"])
            for name, k in (("TAC_input", "input"), ("TAC_mean", "mean"), ("TAC_output", "output")):
                wb(f"{key}.{i}.channel_comm.{name}.0", tac[k])
    for i in range(len(params["bn_mask"])):
        for key, branch in (("BN_mask", "bn_mask"), ("BN_map", "bn_map")):
            wb(f"{key}.{i}.0", params[branch][i]["norm"])
            wb(f"{key}.{i}.1", params[branch][i]["conv"], unsqueeze=True)
        for key in ("mask", "map"):
            h = params[key][i]
            wb(f"{key}.{i}.0", h["norm"])
            wb(f"{key}.{i}.1", h["conv1"], unsqueeze=True)
            wb(f"{key}.{i}.3", h["conv2"])
            wb(f"{key}.{i}.5", h["conv3"])
    wb("in_conv", params["in_conv"], unsqueeze=True)
    return sd


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_convert_torch_consumes_every_key_and_agrees_with_jax():
    cfg = AttrDict({"model": TINY})
    params = bs_mamba2.init(torch.Generator().manual_seed(3), cfg)
    sd = _state_dict(params)
    back = bs_mamba2.convert_torch(sd, cfg)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(params), _leaves(back)))
    # one state dict loads into both packages
    jback = jax_mamba.convert_torch({k: v.numpy() for k, v in sd.items()},
                                    ConfigDict({"model": TINY}))
    for a, b in zip(_leaves(back), jax.tree.leaves(jback)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    sd["separator_mask.0.extra.weight"] = torch.zeros(2)
    with pytest.raises(ValueError, match="unconsumed"):
        bs_mamba2.convert_torch(sd, cfg)


def test_seeded_init_is_deterministic_and_has_the_jax_tree():
    cfg = AttrDict({"model": TINY})
    a = bs_mamba2.init(torch.Generator().manual_seed(5), cfg)
    b = bs_mamba2.init(torch.Generator().manual_seed(5), cfg)
    assert all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))
    jp = jax_mamba.init(jax.random.PRNGKey(0), ConfigDict({"model": TINY}))
    assert [tuple(v.shape) for v in _leaves(a)] == [np.shape(v) for v in jax.tree.leaves(jp)]
