"""The port's demix engine and InferenceSession held against sesa_tpu's on the
CPU in f32, with the same small bs_roformer weights, on songs a few chunks
long: reflect border, reflected and zero-padded tails, ``affine``, TTA."""

import importlib
import json

import numpy as np
import pytest
import torch

import jax

from ml_collections import ConfigDict

from sesa_tpu.models import bs_roformer as jax_bs
from sesa_tpu.runtime.session import InferenceSession as JaxSession
from sesa_tpu_torch.configs import AttrDict
from sesa_tpu_torch.models import bs_roformer
from sesa_tpu_torch.runtime.session import InferenceSession
from tests.test_roformer import bs_model_cfg, export_state_dict


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch: with the tier-1 run's six workers on
    eight cores, torch's thread pools spin against each other (a session
    test of 0.5 s alone took 40 s beside five busy processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# both runtime packages re-export a function named demix over the module name
jax_demix = importlib.import_module("sesa_tpu.runtime.demix")
port_demix = importlib.import_module("sesa_tpu_torch.runtime.demix")

# demix averages f32 model outputs: the model's end-to-end bound (BASELINE.md:88)
ATOL = 5e-4
CHUNK = 4096


@pytest.fixture(scope="module")
def model():
    mcfg = bs_model_cfg(num_stems=1, depth=1)
    jcfg, cfg = ConfigDict({"model": mcfg}), AttrDict({"model": mcfg})
    jparams = jax_bs.init(jax.random.PRNGKey(0), jcfg)
    sd = export_state_dict(jparams, jax_bs.spec_from_config(mcfg), False, True)

    def jax_apply(p, chunks):
        return jax_bs.apply(p, jcfg, chunks)

    def port_apply(p, chunks):
        return bs_roformer.apply(p, cfg, chunks)

    return dict(mcfg=mcfg, sd=sd, jparams=jparams, jax_apply=jax_apply,
                params=bs_roformer.convert_torch(sd, cfg), port_apply=port_apply)


def _song(length, seed=0):
    t = np.arange(length) / 44100.0
    rng = np.random.default_rng(seed)
    tone = 0.3 * np.sin(2 * np.pi * 330 * t)
    return np.stack([tone, -0.5 * tone]).astype(np.float32) + \
        0.05 * rng.standard_normal((2, length)).astype(np.float32)


# 13788: last chunk reflects its tail (more than half a chunk remains);
# 9000: last chunk is zero-padded; 3000: shorter than two borders, no padding
@pytest.mark.parametrize("length,affine", [(13788, None), (9000, (0.1, 0.5)), (3000, None)])
def test_demix_matches_jax(model, length, affine):
    mix = _song(length)
    jspec = jax_demix.DemixSpec(chunk_size=CHUNK, num_overlap=2, batch_size=2)
    ref = jax_demix.demix(model["jax_apply"], model["jparams"], mix, jspec, affine=affine)
    spec = port_demix.DemixSpec(chunk_size=CHUNK, num_overlap=2, batch_size=2)
    got = port_demix.demix(model["port_apply"], model["params"], mix, spec, device="cpu",
                           affine=affine)
    assert got.shape == ref.shape == (1, 2, length)
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_tta_matches_jax(model):
    mix = _song(9000, seed=1)
    jspec = jax_demix.DemixSpec(chunk_size=CHUNK, num_overlap=2, batch_size=2)
    spec = port_demix.DemixSpec(chunk_size=CHUNK, num_overlap=2, batch_size=2)
    jstems = jax_demix.demix(model["jax_apply"], model["jparams"], mix, jspec)
    ref = jax_demix.apply_tta(model["jax_apply"], model["jparams"], mix, jstems, jspec)
    stems = port_demix.demix(model["port_apply"], model["params"], mix, spec, device="cpu")
    got = port_demix.apply_tta(model["port_apply"], model["params"], mix, stems, spec,
                               device="cpu")
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_int16_transport_is_not_ported(model):
    """The int16 slab transport, ported since this test's name was given:
    the port's int16 stems against the JAX engine's int16 stems, each
    within one quantisation step of its slab's peak (max / 32767) plus the
    model's bound."""
    mix = _song(5000)
    jspec = jax_demix.DemixSpec(chunk_size=CHUNK, num_overlap=2, batch_size=2)
    spec = port_demix.DemixSpec(chunk_size=CHUNK, num_overlap=2, batch_size=2)
    ref = jax_demix.demix(model["jax_apply"], model["jparams"], mix, jspec, transport="int16")
    got = port_demix.demix(model["port_apply"], model["params"], mix, spec, device="cpu",
                           transport="int16")
    assert got.dtype == np.float32 and got.shape == ref.shape == (1, 2, 5000)
    np.testing.assert_allclose(got, ref, atol=ATOL + 2 * np.abs(ref).max() / 32767)


@pytest.fixture(scope="module")
def sessions(model, tmp_path_factory):
    d = tmp_path_factory.mktemp("sess")
    cfg = {
        "audio": {"chunk_size": CHUNK, "num_channels": 2, "sample_rate": 44100},
        "model": {k: (list(v) if isinstance(v, tuple) else v) for k, v in model["mcfg"].items()},
        "training": {"instruments": ["vocals", "other"], "target_instrument": "vocals"},
        "inference": {"num_overlap": 2, "batch_size": 2, "normalize": True},
    }
    cfg_path, ckpt = str(d / "config.json"), str(d / "model.ckpt")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)  # JSON is YAML, so the JAX loader reads it too
    torch.save(model["sd"], ckpt)
    jax_s = JaxSession.create("bs_roformer", cfg_path, ckpt, compute_dtype=None)
    port_s = InferenceSession.create("bs_roformer", cfg_path, ckpt, compute_dtype=None,
                                     device="cpu")
    return jax_s, port_s


def test_session_separate_matches_jax(sessions):
    jax_s, port_s = sessions
    mix = _song(11000, seed=2) + 0.2  # offset: the normalisation matters
    ref = jax_s.separate_with_extras(mix, extract_instrumental=True)
    got = port_s.separate_with_extras(mix, extract_instrumental=True)
    assert list(got) == list(ref) == ["vocals", "instrumental"]
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=ATOL)
    assert port_s.rescues == 0


def test_session_counts_bf16_rescue(sessions):
    _, port_s = sessions
    mix = _song(6000, seed=3)
    want = port_s.separate(mix)["vocals"]
    s = InferenceSession(port_s.model_type, port_s.config, port_s.params, port_s.spec,
                         port_s.device, compute_dtype=torch.bfloat16)
    real = s._model_apply

    def poisoned(dtype):  # the bf16 model gives NaN, the f32 rerun is clean
        fn = real(dtype)
        return (lambda p, c: fn(p, c) * float("nan")) if dtype is not None else fn

    s._model_apply = poisoned
    got = s.separate(mix)["vocals"]
    assert s.rescues == 1 and s.compute_dtype is None
    np.testing.assert_array_equal(got, want)
