"""The port's SCNet family (scnet, scnet_tran, scnet_masked,
scnet_unofficial), its real DFTs (``ops/fft.py``) and the layers they added
(``lstm``/``bilstm``, ``conv2d``/``conv_transpose2d``) held against sesa_tpu
on the CPU, on the same numpy inputs and weights (``params_from_jax``).

Every whole-model JAX reference is built once, under ``jax.jit``, by a
module-scoped fixture, at two dual-path layers and 4096 samples: the JAX
SCNet takes tens of seconds eagerly on a CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_collections import ConfigDict

from sesa_tpu.models import layers as JL
from sesa_tpu.models import scnet_unofficial as jax_unofficial
from sesa_tpu.ops import fft as jax_fft
from sesa_tpu_torch.configs import AttrDict
from sesa_tpu_torch.convert.from_jax import params_from_jax
from sesa_tpu_torch.models import get_model
from sesa_tpu_torch.models import layers as L
from sesa_tpu_torch.models import scnet, scnet_masked, scnet_tran, scnet_unofficial
from sesa_tpu_torch.ops import fft
from tests.test_scnet import export_state_dict, export_state_dict_tran, tiny_kwargs, tiny_tran_kwargs
from tests.test_scnet_unofficial import export_state_dict as export_unofficial
from tests.test_scnet_unofficial import tiny_config as unofficial_config
from tests.test_torch_bs_roformer import _sorted_leaves

SAMPLES = 4096
# the JAX package's oracle tolerances: SCNet (tests/test_scnet.py:131) and
# scnet_unofficial, whose unnormalised frame rFFT amplifies rounding
# (tests/test_scnet_unofficial.py:188)
TOL = {"scnet": (5e-4, 1e-3), "scnet_tran": (5e-4, 1e-3), "scnet_masked": (5e-4, 1e-3),
       "scnet_unofficial": (8e-3, 1e-2)}
# bf16 against f32, relative to max |f32| (tests/test_compute_dtype.py:65-75,
# 110-130)
BF16_BOUND = {"scnet": 0.12, "scnet_tran": 0.15, "scnet_masked": 0.15}



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

def _model_cfg(model_type):
    if model_type == "scnet_unofficial":
        return dict(unofficial_config().model)
    return tiny_tran_kwargs() if model_type == "scnet_tran" else tiny_kwargs()


def _jax_module(model_type):
    import importlib

    return importlib.import_module(f"sesa_tpu.models.{model_type}")


_REFS = {}


@pytest.fixture(scope="module")
def jax_ref():
    """model type -> (JAX params as numpy, input, JAX f32 output), built
    once per type under jax.jit."""
    def get(model_type):
        if model_type not in _REFS:
            jm = _jax_module(model_type)
            cfg = ConfigDict({"model": _model_cfg(model_type)})
            params = jm.init(jax.random.PRNGKey(0), cfg)
            x = np.random.default_rng(1).standard_normal((1, 2, SAMPLES)).astype(np.float32)
            x *= 0.1
            out = jax.jit(lambda p, a: jm.apply(p, cfg, a))(params, jnp.asarray(x))
            _REFS[model_type] = (jax.tree.map(np.asarray, params), x, np.asarray(out))
        return _REFS[model_type]
    return get


# --------------------------------------------------------------------------
# whole models
# --------------------------------------------------------------------------

@pytest.mark.parametrize("model_type", ["scnet", "scnet_tran", "scnet_masked",
                                        "scnet_unofficial"])
def test_model_matches_jax_f32(jax_ref, model_type):
    jparams, x, ref = jax_ref(model_type)
    cfg = AttrDict({"model": _model_cfg(model_type)})
    params = params_from_jax(jparams, model_type, cfg)
    got = get_model(model_type).apply(params, cfg, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    atol, rtol = TOL[model_type]
    np.testing.assert_allclose(got.numpy(), ref, atol=atol, rtol=rtol)


@pytest.mark.parametrize("model_type", ["scnet", "scnet_tran", "scnet_masked"])
def test_model_bf16_tracks_f32(jax_ref, model_type):
    """The port in bf16 (weights cast once by ``prepare``, as the session
    does) against the JAX f32 output, at the JAX package's bf16 bounds."""
    jparams, x, ref = jax_ref(model_type)
    cfg = AttrDict({"model": _model_cfg(model_type)})
    model = get_model(model_type)
    params = model.prepare(params_from_jax(jparams, model_type, cfg), cfg, torch.bfloat16)
    got = model.apply(params, cfg, torch.from_numpy(x), compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    scale = max(np.abs(ref).max(), 1e-3)
    err = np.abs(got.numpy() - ref).max()
    assert err < BF16_BOUND[model_type] * scale, (err, scale)


def _state_dict(model_type, jparams):
    """A reference state dict of the JAX tree, in the layout the JAX
    converter reads."""
    kw = _model_cfg(model_type)
    if model_type == "scnet_unofficial":
        return export_unofficial(jparams, jax_unofficial._kwargs(unofficial_config()))
    if model_type == "scnet_tran":
        return export_state_dict_tran(jparams, kw)
    sd = export_state_dict(jparams, kw)
    if model_type == "scnet_masked":
        sd["pos_embed_f"] = torch.from_numpy(np.array(jparams["pos_embed_f"]))
        for key, name in (("mask_layer.0", "mask_conv1"), ("mask_layer.2", "mask_conv2")):
            for leaf in ("weight", "bias"):
                sd[f"{key}.{leaf}"] = torch.from_numpy(np.array(jparams[name][leaf]))
    return sd


@pytest.mark.parametrize("model_type", ["scnet", "scnet_tran", "scnet_masked",
                                        "scnet_unofficial"])
def test_convert_torch_matches_jax(model_type):
    kw = _model_cfg(model_type)
    jcfg, cfg = ConfigDict({"model": kw}), AttrDict({"model": kw})
    jm = _jax_module(model_type)
    jparams = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(2), jcfg))
    sd = _state_dict(model_type, jparams)
    ref = jm.convert_torch({k: v.numpy() for k, v in sd.items()}, jcfg)
    got = get_model(model_type).convert_torch(sd, cfg)
    copied = params_from_jax(jax.tree.map(np.asarray, ref), model_type, cfg)
    a, b = _sorted_leaves(got), _sorted_leaves(copied)
    assert len(a) == len(b) == len(jax.tree.leaves(ref))
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u.numpy(), v.numpy())


@pytest.mark.parametrize("model_type", ["scnet", "scnet_unofficial"])
def test_convert_raises_on_leftover_key(model_type):
    kw = _model_cfg(model_type)
    jparams = jax.tree.map(np.asarray, _jax_module(model_type).init(
        jax.random.PRNGKey(3), ConfigDict({"model": kw})))
    sd = _state_dict(model_type, jparams)
    sd["extra.weight"] = torch.zeros(3)
    with pytest.raises(ValueError, match="unconsumed"):
        get_model(model_type).convert_torch(sd, AttrDict({"model": kw}))


def test_unofficial_mamba_raises():
    cfg = AttrDict({"model": dict(_model_cfg("scnet_unofficial"), use_mamba=True)})
    with pytest.raises(NotImplementedError, match="use_mamba"):
        scnet_unofficial.init(torch.Generator().manual_seed(0), cfg)


def test_registry_resolves_the_family():
    assert get_model("scnet") is scnet
    assert get_model("scnet_tran") is scnet_tran
    assert get_model("scnet_masked") is scnet_masked
    assert get_model("scnet_unofficial") is scnet_unofficial
    # the f32-only model takes no compute_dtype; the others do, and the
    # session dispatches on that (runtime/session.py)
    import inspect

    assert "compute_dtype" not in inspect.signature(scnet_unofficial.apply).parameters
    assert all("compute_dtype" in inspect.signature(m.apply).parameters
               for m in (scnet, scnet_tran, scnet_masked))


# --------------------------------------------------------------------------
# ops/fft.py
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [16, 17, 346])
@pytest.mark.parametrize("ortho", [False, True])
def test_rdft_matches_jax(n, ortho):
    x = np.random.default_rng(n).standard_normal((3, 5, n)).astype(np.float32)
    jfn, fn = (jax_fft.rdft_ortho, fft.rdft_ortho) if ortho else (jax_fft.rdft, fft.rdft)
    ref = np.asarray(jfn(jnp.asarray(x)))
    got = fn(torch.from_numpy(x))
    assert got.shape == ref.shape == (3, 5, n // 2 + 1, 2)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5 * np.sqrt(n), rtol=1e-4)


@pytest.mark.parametrize("n", [16, 17, 346])
@pytest.mark.parametrize("ortho", [False, True])
def test_irdft_matches_jax(n, ortho):
    """Arbitrary spectra, DC and Nyquist imaginary parts included: the JAX
    matrices ignore those, and so must the port."""
    spec = np.random.default_rng(n).standard_normal((3, n // 2 + 1, 2)).astype(np.float32)
    jfn, fn = (jax_fft.irdft_ortho, fft.irdft_ortho) if ortho else (jax_fft.irdft, fft.irdft)
    ref = np.asarray(jfn(jnp.asarray(spec), n))
    got = fn(torch.from_numpy(spec), n)
    assert got.shape == ref.shape == (3, n)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5 * np.sqrt(n), rtol=1e-4)


def test_rdft_promotes_bf16_to_f32():
    x = torch.randn((2, 64), generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    got = fft.rdft_ortho(x)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, fft.rdft_ortho(x.float()), rtol=0, atol=0)
    assert fft.irdft_ortho(got.to(torch.bfloat16), 64).dtype == torch.float32


@pytest.mark.parametrize("n", [8, 9])
def test_dft_tables_match_jax(n):
    for got, ref in zip(fft.rdft_tables(n) + fft.irdft_tables(n),
                        jax_fft._rdft_mats(n) + jax_fft._irdft_mats(n)):
        np.testing.assert_array_equal(got, ref)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def _lstm_params(rng, d, h):
    return {k: rng.standard_normal(s).astype(np.float32) * 0.3
            for k, s in (("weight_ih", (4 * h, d)), ("weight_hh", (4 * h, h)),
                         ("bias_ih", (4 * h,)), ("bias_hh", (4 * h,)))}


def _t(tree):
    return {k: _t(v) if isinstance(v, dict) else torch.from_numpy(v) for k, v in tree.items()}


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_matches_jax(reverse):
    rng = np.random.default_rng(0)
    p = _lstm_params(rng, 12, 10)
    x = rng.standard_normal((3, 17, 12)).astype(np.float32)
    ref = np.asarray(JL.lstm(jnp.asarray(x), jax.tree.map(jnp.asarray, p), reverse=reverse))
    got = L.lstm(torch.from_numpy(x), _t(p), reverse=reverse)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("d,h", [(12, 12), (8, 16)])
def test_bilstm_matches_jax(d, h):
    rng = np.random.default_rng(d + h)
    p = {"fwd": _lstm_params(rng, d, h), "bwd": _lstm_params(rng, d, h)}
    x = rng.standard_normal((4, 9, d)).astype(np.float32)
    ref = np.asarray(JL.bilstm(jnp.asarray(x), jax.tree.map(jnp.asarray, p)))
    got = L.bilstm(torch.from_numpy(x), _t(p))
    assert got.shape == ref.shape == (4, 9, 2 * h)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("stride,kernel", [(1, 3), (4, 4), (16, 16), (2, 5)])
def test_conv_transpose2d_matches_jax(stride, kernel):
    rng = np.random.default_rng(kernel)
    x = rng.standard_normal((2, 6, 11, 7)).astype(np.float32)
    w = rng.standard_normal((6, 4, kernel, 1)).astype(np.float32) * 0.2
    b = rng.standard_normal(4).astype(np.float32)
    ref = np.asarray(JL.conv_transpose2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                         stride=(stride, 1)))
    got = L.conv_transpose2d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                             stride=(stride, 1))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("stride,padding,groups", [((1, 1), (1, 1), 1), ((4, 1), (0, 0), 1),
                                                   ((1, 1), (1, 0), 2)])
def test_conv2d_matches_jax(stride, padding, groups):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 6, 13, 9)).astype(np.float32)
    w = rng.standard_normal((8, 6 // groups, 3, 3)).astype(np.float32) * 0.2
    b = rng.standard_normal(8).astype(np.float32)
    ref = np.asarray(JL.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride,
                               padding=padding, groups=groups))
    got = L.conv2d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                   stride=stride, padding=padding, groups=groups)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=1e-4)


def test_glu_and_gelu_match_jax():
    x = np.random.default_rng(3).standard_normal((4, 6, 5)).astype(np.float32)
    np.testing.assert_allclose(L.glu(torch.from_numpy(x), dim=1).numpy(),
                               np.asarray(JL.glu(jnp.asarray(x), axis=1)), atol=1e-6)
    np.testing.assert_allclose(L.gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(JL.gelu(jnp.asarray(x))), atol=1e-6)


def test_istft_ignores_dc_and_nyquist_imag_like_jax():
    """A masked spectrum has nonzero imaginary parts at DC and Nyquist; the
    JAX inverse ignores them, and so does the port's on every device (they
    are zeroed before torch.istft: cuFFT's C2R does not ignore them)."""
    from sesa_tpu.ops.stft import hann_window as jax_hann
    from sesa_tpu.ops.stft import istft_ri as jax_istft_ri
    from sesa_tpu_torch.ops.stft import hann_window, istft_ri

    spec = np.random.default_rng(4).standard_normal((2, 129, 9, 2)).astype(np.float32)
    ref = np.asarray(jax_istft_ri(jnp.asarray(spec), 256, 64, jax_hann(256), length=512))
    got = istft_ri(torch.from_numpy(spec), 256, 64, hann_window(256), length=512)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=1e-4)
    zeroed = spec.copy()
    zeroed[:, [0, -1], :, 1] = 0
    torch.testing.assert_close(istft_ri(torch.from_numpy(zeroed), 256, 64, hann_window(256),
                                        length=512), got, rtol=0, atol=0)
