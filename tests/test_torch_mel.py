"""The port's mel machinery and mel_band_roformer held against sesa_tpu on the
CPU: the Slaney filterbank, the mel band layout, overlapping-band mask
averaging, and the whole model in f32 from the same state dict."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_collections import ConfigDict

from sesa_tpu.models import mel_band_roformer as jax_mbr
from sesa_tpu.ops import bands as JB
from sesa_tpu.ops.mel import mel_filter_bank as jax_mel_filter_bank
from sesa_tpu_torch.configs import AttrDict
from sesa_tpu_torch.convert.from_jax import params_from_jax
from sesa_tpu_torch.models import get_model, mel_band_roformer
from sesa_tpu_torch.ops import bands as B
from sesa_tpu_torch.ops.mel import mel_filter_bank
from tests.test_roformer import export_state_dict, mel_model_cfg

# end-to-end f32 tolerance of the JAX package against its torch oracles
# (BASELINE.md:88)
ATOL = 5e-4


@pytest.mark.parametrize("sr,n_fft,n_mels,fmax", [(44100, 2048, 60, None),
                                                   (44100, 128, 8, None),
                                                   (16000, 512, 40, 7000.0)])
def test_mel_filter_bank_matches_jax(sr, n_fft, n_mels, fmax):
    got = mel_filter_bank(sr, n_fft, n_mels, fmax=fmax)
    ref = jax_mel_filter_bank(sr, n_fft, n_mels, fmax=fmax)
    assert got.shape == (n_mels, n_fft // 2 + 1)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("num_bands,n_fft,stereo", [(60, 2048, True), (8, 128, False)])
def test_mel_band_feats_match_jax(num_bands, n_fft, stereo):
    got = mel_band_roformer.mel_band_feats(num_bands, 44100, n_fft, stereo)
    assert got == jax_mbr.mel_band_feats(num_bands, 44100, n_fft, stereo)
    covered = np.zeros((n_fft // 2 + 1) * (2 if stereo else 1) * 2, bool)
    covered[np.concatenate([np.asarray(f) for f in got])] = True
    assert covered.all()


def test_overlapping_mask_averaging_matches_jax():
    feats = [np.asarray(f, np.int32)
             for f in mel_band_roformer.mel_band_feats(8, 44100, 128, True)]
    nf = 65 * 2 * 2
    plan, jplan = B.make_band_plan(feats, nf), JB.make_band_plan(feats, nf)
    assert plan.coverage.max() > 1  # the mel bands overlap
    np.testing.assert_array_equal(plan.coverage, jplan.coverage)

    rng = np.random.default_rng(7)
    dim = 16
    mk = lambda *s: rng.standard_normal(s).astype(np.float32) * 0.3  # noqa: E731
    me = {"hidden": [{"weight": mk(plan.num_bands, dim, 4 * dim),
                      "bias": mk(plan.num_bands, 4 * dim)}],
          "groups": [{"weight": mk(m, 4 * dim, 2 * w), "bias": mk(m, 2 * w)}
                     for m, w in (idx.shape for idx in plan.group_feat_idx)]}
    h = mk(2, 5, plan.num_bands, dim)
    got = B.mask_estimator_apply(plan, jax.tree.map(torch.from_numpy, me), torch.from_numpy(h))
    ref = JB.mask_estimator_apply(jplan, jax.tree.map(jnp.asarray, me), jnp.asarray(h))
    assert got.shape == (2, 5, nf)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def _community_sd(mcfg, seed=1):
    spec = jax_mbr.spec_from_config(mcfg)
    params = jax_mbr.init(jax.random.PRNGKey(seed), ConfigDict({"model": mcfg}))
    return params, export_state_dict(params, spec, transformer_norm_output=True,
                                     final_norm=False)


@pytest.mark.parametrize("over", [{}, {"stereo": False, "num_stems": 2,
                                       "mask_estimator_depth": 2}])
def test_mel_band_roformer_matches_jax_f32(over):
    mcfg = mel_model_cfg(**over)
    jparams, sd = _community_sd(mcfg)
    ch = 2 if mcfg["stereo"] else 1
    x = np.random.default_rng(1).standard_normal((2, ch, 1280)).astype(np.float32) * 0.3

    ref = np.asarray(jax_mbr.apply(jparams, ConfigDict({"model": mcfg}), jnp.asarray(x)))
    cfg = AttrDict({"model": mcfg})
    params = mel_band_roformer.convert_torch(sd, cfg)
    got = mel_band_roformer.apply(params, cfg, torch.from_numpy(x))
    assert got.shape == ref.shape == (2, mcfg["num_stems"], ch, 1280)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=1e-3)

    spec = mel_band_roformer.spec_from_config(mcfg)
    copied = params_from_jax(jax.tree.map(np.asarray, jparams), spec)
    got2 = mel_band_roformer.apply(copied, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got2.numpy(), ref, atol=ATOL, rtol=1e-3)


def test_mel_spec_uses_the_mel_mlp_convention():
    spec = mel_band_roformer.spec_from_config(mel_model_cfg(mask_estimator_depth=2))
    jspec = jax_mbr.spec_from_config(mel_model_cfg(mask_estimator_depth=2))
    assert spec.mask_hidden_layers == jspec.mask_hidden_layers == 2
    assert spec.band_feats == jspec.band_feats


def test_mel_convert_raises_on_leftover_and_missing_keys():
    mcfg = mel_model_cfg()
    cfg = AttrDict({"model": mcfg})
    _, sd = _community_sd(mcfg)
    extra = dict(sd, **{"layers.0.0.layers.0.0.extra.weight": torch.zeros(3)})
    with pytest.raises(ValueError, match="unconsumed"):
        mel_band_roformer.convert_torch(extra, cfg)
    del sd["layers.1.1.norm.gamma"]
    with pytest.raises(KeyError, match="layers.1.1.norm.gamma"):
        mel_band_roformer.convert_torch(sd, cfg)


def test_mel_params_from_jax_rejects_bs_tree():
    """A mel tree checked against the bs spec (final norm, one hidden layer
    fewer) is refused."""
    from sesa_tpu_torch.models import bs_roformer

    jparams, _ = _community_sd(mel_model_cfg())
    bs_spec = bs_roformer.RoformerSpec(**{**vars(mel_band_roformer.spec_from_config(
        mel_model_cfg())), "mel_mlp_convention": False})
    with pytest.raises(ValueError, match="does not match"):
        params_from_jax(jax.tree.map(np.asarray, jparams), bs_spec)


def test_registry_resolves_mel_models():
    from sesa_tpu_torch.models import mel_band_conformer

    assert get_model("mel_band_roformer") is mel_band_roformer
    assert get_model("mel_band_conformer") is mel_band_conformer
