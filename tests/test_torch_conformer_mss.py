"""The port's ConformerMSS, the session's dispatch on the model's signature,
bs_roformer_custom and its FNO stage held against sesa_tpu on the CPU, on
the same numpy inputs and weights. JAX references run under ``jax.jit``."""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_collections import ConfigDict

from sesa_tpu.models import bs_roformer as jax_bs
from sesa_tpu.models import bs_roformer_custom as jax_custom
from sesa_tpu.models import conformer as jax_conformer
from sesa_tpu_torch.configs import AttrDict
from sesa_tpu_torch.convert.from_jax import params_from_jax
from sesa_tpu_torch.models import bs_roformer, bs_roformer_custom, conformer, get_model
from sesa_tpu_torch.runtime.session import InferenceSession
from tests.oracles.layout_keygen import conformer_state_dict
from tests.test_roformer import bs_model_cfg, export_state_dict
from tests.test_torch_bs_roformer import _sorted_leaves

# end-to-end f32 tolerance of the JAX package against its torch oracles
# (BASELINE.md:88)
ATOL, RTOL = 5e-4, 1e-3
MSS_MODEL = dict(in_channels=2, sources=2, freq_bins=129, embed_dim=64, depth=2, dim_head=16,
                 heads=4, ff_mult=2, conv_expansion_factor=2, conv_kernel_size=7)
MSS_STFT = dict(n_fft=256, hop_length=64, win_length=256, center=True)



@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch: these models run as thousands of small
    ops (LSTM steps, narrow convolutions), and with the tier-1 run's six
    workers on eight cores torch's thread pools spin against each other (a
    session test of 0.3 s alone took 40 s beside five busy processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _mss_cfg():
    return {"model": dict(MSS_MODEL), "stft": dict(MSS_STFT)}


def _mss_state_dict(seed):
    """A ConformerMSS state dict with batch-norm statistics away from 0 and 1."""
    sd = conformer_state_dict(ConfigDict(_mss_cfg()), seed=seed)
    rng = np.random.default_rng(seed)
    for k in sd:
        if k.endswith("running_mean"):
            sd[k] = (0.1 * rng.standard_normal(sd[k].shape)).astype(np.float32)
        elif k.endswith("running_var"):
            sd[k] = (1 + 0.3 * rng.random(sd[k].shape)).astype(np.float32)
    return sd


# --------------------------------------------------------------------------
# ConformerMSS
# --------------------------------------------------------------------------

def test_conformer_mss_matches_jax_f32():
    jcfg, cfg = ConfigDict(_mss_cfg()), AttrDict(_mss_cfg())
    sd = _mss_state_dict(0)
    jparams = jax_conformer.convert_torch(sd, jcfg)
    x = np.random.default_rng(1).standard_normal((2, 2, 4096)).astype(np.float32) * 0.3
    ref = np.asarray(jax.jit(lambda p, a: jax_conformer.apply(p, jcfg, a))(jparams,
                                                                           jnp.asarray(x)))
    params = conformer.convert_torch({k: torch.from_numpy(v) for k, v in sd.items()}, cfg)
    got = conformer.apply(params, cfg, torch.from_numpy(x))
    assert got.shape == ref.shape == (2, 2, 2, 4096)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)
    # the converted tree is the JAX tree, leaf for leaf
    copied = params_from_jax(jax.tree.map(np.asarray, jparams), "conformer", cfg)
    for a, b in zip(_sorted_leaves(params), _sorted_leaves(copied)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_conformer_mss_convert_raises_on_leftover_key():
    sd = _mss_state_dict(1)
    sd["window"] = np.zeros(256, np.float32)  # the STFT window buffer is skipped
    conformer.convert_torch(dict(sd), AttrDict(_mss_cfg()))
    sd["core.model.layers.0.attn.fn.extra.weight"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="unconsumed"):
        conformer.convert_torch(sd, AttrDict(_mss_cfg()))


def test_conformer_mss_checks_freq_bins():
    cfg = _mss_cfg()
    cfg["stft"]["n_fft"] = 512
    with pytest.raises(ValueError, match="freq_bins"):
        conformer.init(torch.Generator().manual_seed(0), AttrDict(cfg))


# --------------------------------------------------------------------------
# the session's dispatch on the model's signature
# --------------------------------------------------------------------------

def _session_cfg(model_type):
    instruments = ["drums", "bass", "other", "vocals"]
    if model_type == "conformer":
        cfg, instruments = _mss_cfg(), ["vocals", "other"]
    elif model_type == "scnet_unofficial":
        from tests.test_scnet_unofficial import tiny_config

        cfg = {"model": dict(tiny_config().model, n_sources=4)}
    else:
        from tests.test_scnet import tiny_kwargs

        cfg = {"model": tiny_kwargs()}
    # one model call of every chunk: on a loaded CPU the per-op overhead of
    # the LSTMs, not their arithmetic, sets these tests' time
    cfg.update(audio={"chunk_size": 2048, "num_channels": 2},
               inference={"batch_size": 8, "num_overlap": 2},
               training={"instruments": instruments})
    return cfg


def _separate(model_type, compute_dtype, mix):
    s = InferenceSession.create(model_type, _session_cfg(model_type), device="cpu",
                                compute_dtype=compute_dtype, seed=3)
    out = s.separate(mix)
    return s, np.stack([out[k] for k in s.instruments])


@pytest.mark.parametrize("model_type", ["conformer", "scnet_unofficial"])
def test_bf16_session_runs_f32_only_models_in_f32(model_type):
    """A model whose apply takes no compute_dtype is called without one, on
    the f32 weights: a bf16 session gives the f32 session's output."""
    assert "compute_dtype" not in inspect.signature(get_model(model_type).apply).parameters
    mix = np.random.default_rng(4).standard_normal((2, 5000)).astype(np.float32) * 0.1
    s16, bf16 = _separate(model_type, torch.bfloat16, mix)
    _, f32 = _separate(model_type, None, mix)
    assert s16.rescues == 0 and not s16._prepared
    assert np.isfinite(bf16).all() and float(np.abs(bf16).max()) > 0
    np.testing.assert_array_equal(bf16, f32)


def test_bf16_session_passes_dtype_to_dtype_models():
    """scnet takes compute_dtype: its bf16 session runs bf16 on weights
    prepared once, and differs from the f32 session by bf16 rounding."""
    mix = np.random.default_rng(5).standard_normal((2, 5000)).astype(np.float32) * 0.1
    s16, bf16 = _separate("scnet", torch.bfloat16, mix)
    _, f32 = _separate("scnet", None, mix)
    assert list(s16._prepared) == [torch.bfloat16]
    assert not np.array_equal(bf16, f32)
    assert np.abs(bf16 - f32).max() < 0.12 * np.abs(f32).max()


def test_model_errors_surface_through_the_session(monkeypatch):
    """The dispatch inspects the signature; it does not retry on TypeError."""
    def broken(params, config, x):
        raise TypeError("inside the model")

    monkeypatch.setattr(conformer, "apply", broken)
    s = InferenceSession.create("conformer", _session_cfg("conformer"), device="cpu", seed=0)
    with pytest.raises(TypeError, match="inside the model"):
        s.separate(np.zeros((2, 5000), np.float32))


# --------------------------------------------------------------------------
# bs_roformer_custom and the FNO stage
# --------------------------------------------------------------------------

def _fno_cfg(**over):
    return bs_model_cfg(depth=2, num_stems=1, use_fno=True, fno_modes=5, **over)


@pytest.mark.parametrize("over", [{}, {"use_value_residual_learning": True}])
def test_custom_fno_matches_jax_f32(over):
    """The FNO variant through the experimental forward, and with value
    residual learning on top: both trees through both converters."""
    mcfg = _fno_cfg(**over)
    jcfg, cfg = ConfigDict({"model": mcfg}), AttrDict({"model": mcfg})
    jparams = jax_custom.init(jax.random.PRNGKey(11), jcfg)
    spec = jax_bs.spec_from_config(mcfg)
    sd = export_state_dict(jparams, spec, transformer_norm_output=False, final_norm=True)
    x = np.random.default_rng(12).standard_normal((1, 2, 1280)).astype(np.float32) * 0.1
    ref = np.asarray(jax.jit(lambda p, a: jax_custom.apply(p, jcfg, a))(jparams,
                                                                        jnp.asarray(x)))
    params = bs_roformer_custom.convert_torch(sd, cfg)
    got = bs_roformer_custom.apply(params, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)
    copied = params_from_jax(jax.tree.map(np.asarray, jparams), "bs_roformer_custom", cfg)
    assert "fno" in copied["layers"][1]
    for a, b in zip(_sorted_leaves(params), _sorted_leaves(copied)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("entry", ["init", "apply", "convert_torch"])
def test_custom_unknown_knob_raises(entry):
    cfg = AttrDict({"model": _fno_cfg(use_mystery_block=True)})
    args = {"init": (torch.Generator().manual_seed(0), cfg),
            "apply": ({}, cfg, torch.zeros(1, 2, 1280)),
            "convert_torch": ({}, cfg)}[entry]
    with pytest.raises(bs_roformer_custom.UnsupportedCustomArchitecture,
                       match="use_mystery_block"):
        getattr(bs_roformer_custom, entry)(*args)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fno_stage_matches_jax(dtype):
    """The FNO stage alone against the JAX stage on the same inputs. In bf16
    both round the truncated DFT tables, the weights and every product to
    bf16; they differ only by the order of the f32 sums inside each product,
    so the bound is a few bf16 ulps of the output's scale."""
    rng = np.random.default_rng(9)
    d, modes = 16, 5
    p = {"w_re": rng.standard_normal((modes, d, d)) / d, "w_im": rng.standard_normal((modes, d, d)) / d,
         "bypass_w": rng.standard_normal((d, d)) / d, "bypass_b": 0.1 * rng.standard_normal(d)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 23, 7, d)).astype(np.float32)
    tdt, jdt = (torch.float32, jnp.float32) if dtype == "f32" else (torch.bfloat16, jnp.bfloat16)
    ref = np.asarray(jax_bs._fno_apply({k: jnp.asarray(v, jdt) for k, v in p.items()},
                                       jnp.asarray(x, jdt), precision=jax.lax.Precision.HIGHEST),
                     dtype=np.float32)
    got = bs_roformer._fno_apply({k: torch.from_numpy(v).to(tdt) for k, v in p.items()},
                                 torch.from_numpy(x).to(tdt)).float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    else:
        assert np.abs(got - ref).max() <= 4 * 2 ** -8 * np.abs(ref).max()


def test_registry_resolves_conformer_and_custom():
    assert get_model("conformer") is conformer
    assert get_model("bs_roformer_custom") is bs_roformer_custom
