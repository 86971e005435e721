"""The port's bs_roformer held against sesa_tpu's on the CPU in f32: the same
random community state dict loaded through both ``convert_torch``s, the
JAX -> port parameter copy, and the converter's loud failures."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_collections import ConfigDict

from sesa_tpu.models import bs_roformer as jax_bs
from sesa_tpu_torch.configs import AttrDict
from sesa_tpu_torch.convert.from_jax import params_from_jax
from sesa_tpu_torch.models import bs_roformer, get_model
from tests.test_roformer import bs_model_cfg, export_state_dict

# end-to-end f32 tolerance of the JAX package against its torch oracles
# (BASELINE.md:88)
ATOL = 5e-4


def _community_sd(mcfg, seed=0):
    spec = jax_bs.spec_from_config(mcfg)
    params = jax_bs.init(jax.random.PRNGKey(seed), ConfigDict({"model": mcfg}))
    return params, export_state_dict(params, spec, transformer_norm_output=False,
                                     final_norm=True)


@pytest.mark.parametrize("over", [
    {},
    {"linear_transformer_depth": 1, "skip_connection": True},
    {"stereo": False, "num_stems": 1, "mask_estimator_depth": 1},
])
def test_apply_matches_jax_f32(over):
    mcfg = bs_model_cfg(**over)
    _, sd = _community_sd(mcfg)
    ch = 2 if mcfg["stereo"] else 1
    x = np.random.default_rng(1).standard_normal((2, ch, 2048)).astype(np.float32) * 0.3

    jparams = jax_bs.convert_torch({k: v.numpy() for k, v in sd.items()},
                                   ConfigDict({"model": mcfg}))
    ref = jax_bs.apply(jparams, ConfigDict({"model": mcfg}), jnp.asarray(x))
    cfg = AttrDict({"model": mcfg})
    params = bs_roformer.convert_torch(sd, cfg)
    got = bs_roformer.apply(params, cfg, torch.from_numpy(x))
    assert got.shape == ref.shape == (2, mcfg["num_stems"], ch, 2048)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=1e-3)


def _sorted_leaves(tree):
    """Leaves in jax.tree.leaves order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _sorted_leaves(v)]
    return [tree]


def test_params_from_jax_round_trip():
    mcfg = bs_model_cfg(linear_transformer_depth=1)
    jparams, sd = _community_sd(mcfg, seed=3)
    spec = bs_roformer.spec_from_config(mcfg)
    copied = params_from_jax(jax.tree.map(np.asarray, jparams), spec)
    converted = bs_roformer.convert_torch(sd, AttrDict({"model": mcfg}))
    flat_j = jax.tree.leaves(jparams)
    assert len(_sorted_leaves(copied)) == len(flat_j) == len(_sorted_leaves(converted))
    for a, b, c in zip(_sorted_leaves(copied), flat_j, _sorted_leaves(converted)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(a.numpy(), c.numpy())


def test_params_from_jax_rejects_wrong_tree():
    mcfg = bs_model_cfg()
    jparams, _ = _community_sd(mcfg)
    tree = jax.tree.map(np.asarray, jparams)
    del tree["final_norm_gamma"]
    with pytest.raises(ValueError, match="does not match"):
        params_from_jax(tree, bs_roformer.spec_from_config(mcfg))


def test_convert_raises_on_leftover_key():
    mcfg = bs_model_cfg()
    _, sd = _community_sd(mcfg)
    sd["layers.0.0.layers.0.0.extra.weight"] = torch.zeros(3)
    with pytest.raises(ValueError, match="unconsumed"):
        bs_roformer.convert_torch(sd, AttrDict({"model": mcfg}))


def test_convert_raises_on_missing_key():
    mcfg = bs_model_cfg()
    _, sd = _community_sd(mcfg)
    del sd["final_norm.gamma"]
    with pytest.raises(KeyError, match="final_norm.gamma"):
        bs_roformer.convert_torch(sd, AttrDict({"model": mcfg}))


@pytest.mark.parametrize("flag", [{"use_fno": True}, {"use_value_residual_learning": True},
                                  {"num_residual_streams": 2}])
def test_unported_variants_raise(flag):
    """Every variant is ported now. ``use_fno`` matches sesa_tpu's
    bs_roformer in f32 on the same weights; the value residual and the
    residual streams build and run."""
    cfg = AttrDict({"model": bs_model_cfg(**flag)})
    gen = torch.Generator().manual_seed(0)
    if "use_fno" in flag:
        mcfg = bs_model_cfg(**flag)
        jparams = jax_bs.init(jax.random.PRNGKey(4), ConfigDict({"model": mcfg}))
        x = np.random.default_rng(5).standard_normal((1, 2, 1280)).astype(np.float32) * 0.1
        ref = jax.jit(lambda p, a: jax_bs.apply(p, ConfigDict({"model": mcfg}), a))(
            jparams, jnp.asarray(x))
        params = params_from_jax(jax.tree.map(np.asarray, jparams),
                                 bs_roformer.spec_from_config(mcfg))
        assert all("fno" in layer for layer in params["layers"])
        got = bs_roformer.apply(params, cfg, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=1e-3)
        return
    params = bs_roformer.init(gen, cfg)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 2, 1280))
                         .astype(np.float32) * 0.1)
    out = bs_roformer.apply(params, cfg, x)
    assert out.shape == (1, 2, 2, 1280) and bool(torch.isfinite(out).all())
    assert float(out.abs().max()) > 0


def test_registry_knows_only_ported_models():
    """Every key of the JAX registry resolves in the port, to the module of
    the same name; a key the JAX registry lacks raises."""
    from sesa_tpu.models.registry import MODEL_TYPES as JAX_TYPES
    from sesa_tpu_torch.models import MODEL_TYPES, mel_band_conformer, mel_band_roformer

    assert get_model("bs_roformer") is bs_roformer
    assert get_model("mel_band_roformer") is mel_band_roformer
    assert get_model("mel_band_conformer") is mel_band_conformer
    assert set(MODEL_TYPES) == set(JAX_TYPES) and len(JAX_TYPES) == 21
    for key, path in JAX_TYPES.items():
        assert get_model(key).__name__ == path.replace("sesa_tpu.", "sesa_tpu_torch.", 1), key
    with pytest.raises(ValueError, match="unknown model type"):
        get_model("swin_unet")


def test_seeded_init_is_deterministic():
    cfg = AttrDict({"model": bs_model_cfg(depth=1)})
    a = bs_roformer.init(torch.Generator().manual_seed(5), cfg)
    b = bs_roformer.init(torch.Generator().manual_seed(5), cfg)
    assert all(torch.equal(x, y) for x, y in zip(_sorted_leaves(a), _sorted_leaves(b)))
