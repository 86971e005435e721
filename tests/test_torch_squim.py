"""The port's SQUIM model and metrics.py held against sesa_tpu on the CPU, on
the same numpy inputs and weights: SQUIM at the small config of
``tests/test_squim.py`` on the state dict of its torch reconstruction
(``tests/oracles/torch_squim.py``), converted by both packages; every
metric of ``metrics.py`` on seeded signals, given as numpy arrays and as
tensors. The JAX SQUIM runs under ``jax.jit``, built once per length by a
module-scoped fixture."""

import numpy as np
import pytest
import torch

import jax
from ml_collections import ConfigDict

from sesa_tpu import metrics as jax_metrics
from sesa_tpu.models import squim as jax_squim
from sesa_tpu_torch import metrics
from sesa_tpu_torch.configs import AttrDict
from sesa_tpu_torch.models import layers as L
from sesa_tpu_torch.models import squim
from tests.test_squim import SMALL, _oracle
from tests.test_torch_mdx23c import _leaves

# the JAX package's tolerance against the torch reconstruction (tests/test_squim.py:47)
ATOL = 2e-4
# the metrics: f64 host code in both packages
METRIC_RTOL = 1e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_REFS = {}


@pytest.fixture(scope="module")
def squim_ref():
    """samples -> (state dict, JAX params, input, JAX scores), built once."""
    def get(samples):
        if samples not in _REFS:
            config = ConfigDict({"model": dict(SMALL)})
            sd = {k: v.numpy() for k, v in _oracle(dict(SMALL)).state_dict().items()}
            params = jax_squim.convert_torch(sd, config)
            x = (0.2 * np.random.default_rng(samples).standard_normal((2, samples))).astype(np.float32)
            ref = jax.jit(lambda p, a: jax_squim.apply(p, config, a))(params, x)
            _REFS[samples] = (sd, params, x, {k: np.asarray(v) for k, v in ref.items()})
        return _REFS[samples]
    return get


CONFIG = AttrDict({"model": dict(SMALL)})


@pytest.mark.parametrize("samples", [3210, 4096])
def test_squim_matches_jax(squim_ref, samples):
    sd, _, x, ref = squim_ref(samples)
    got = squim.apply(squim.convert_torch(sd, CONFIG), CONFIG, torch.from_numpy(x))
    assert set(got) == set(squim.METRICS) == set(ref)
    for m in squim.METRICS:
        assert got[m].shape == (2,)
        np.testing.assert_allclose(got[m].numpy(), ref[m], atol=ATOL, err_msg=m)


def test_squim_convert_matches_jax(squim_ref):
    sd, params, _, _ = squim_ref(3210)
    got, ref = _leaves(squim.convert_torch(sd, CONFIG)), _leaves(params)
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (path, g), (_, r) in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=path)


def test_squim_convert_is_strict(squim_ref):
    sd = dict(squim_ref(3210)[0])
    sd["branches.0.0.bogus"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="unconsumed"):
        squim.convert_torch(sd, CONFIG)


def test_squim_init_tree_and_ranges():
    params = squim.init(torch.Generator().manual_seed(0), CONFIG)
    ref = jax.eval_shape(lambda: jax_squim.init(jax.random.PRNGKey(0), ConfigDict(CONFIG)))
    assert [p for p, _ in _leaves(params)] == [p for p, _ in _leaves(ref)]
    assert all(tuple(a.shape) == b.shape for (_, a), (_, b) in zip(_leaves(params), _leaves(ref)))
    out = squim.apply(params, CONFIG, torch.full((3, 2000), 0.1))
    assert 0.0 <= float(out["stoi"].min()) and float(out["stoi"].max()) <= 1.0
    assert float(out["pesq"].min()) >= 1.0
    with pytest.raises(ValueError, match="batch, time"):
        squim.apply(params, CONFIG, torch.zeros(2000))


@pytest.mark.parametrize("seq", [40, 46])
def test_chunking_and_merging_match_jax(seq):
    """chunk 13, stride 6: at 46 frames (6 + 46 mod 13) is a multiple of 13,
    so ``rest`` is 13, not 0, as in the reference."""
    x = np.random.default_rng(seq).standard_normal((2, 3, seq)).astype(np.float32)
    got, rest = squim._chunking(torch.from_numpy(x), 13, 6)
    ref, ref_rest = jax_squim._chunking(x, 13, 6)
    assert rest == ref_rest == (13 if seq == 46 else 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(squim._merging(got, rest, 13, 6).numpy(),
                                  np.asarray(jax_squim._merging(ref, rest, 13, 6)))


def test_prelu_matches_jax():
    from sesa_tpu.models import layers as JL

    x = np.random.default_rng(0).standard_normal((4, 5)).astype(np.float32)
    alpha = np.array([0.3], np.float32)
    np.testing.assert_array_equal(L.prelu(torch.from_numpy(x), torch.from_numpy(alpha)).numpy(),
                                  np.asarray(JL.prelu(x, alpha)))


# --------------------------------------------------------------------------
# metrics.py
# --------------------------------------------------------------------------

def _signals(seed=0, shape=(2, 3, 4000)):
    rng = np.random.default_rng(seed)
    target = rng.standard_normal(shape).astype(np.float32)
    preds = (0.8 * target + 0.3 * rng.standard_normal(shape) + 0.05).astype(np.float32)
    return preds, target


RATIOS = [("signal_noise_ratio", {}), ("signal_noise_ratio", {"zero_mean": True}),
          ("scale_invariant_signal_noise_ratio", {}),
          ("scale_invariant_signal_distortion_ratio", {}),
          ("signal_distortion_ratio", {"filter_length": 64}),
          ("signal_distortion_ratio", {"filter_length": 32, "zero_mean": True,
                                       "load_diag": 1e-3})]


@pytest.mark.parametrize("name,kw", RATIOS, ids=[f"{n}-{i}" for i, (n, _) in enumerate(RATIOS)])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_ratio_metrics_match_jax(name, kw, as_tensor):
    preds, target = _signals()
    ref = getattr(jax_metrics, name)(preds, target, **kw)
    args = (torch.from_numpy(preds), torch.from_numpy(target)) if as_tensor else (preds, target)
    got = getattr(metrics, name)(*args, **kw)
    assert isinstance(got, np.ndarray) and got.shape == ref.shape == (2, 3)
    np.testing.assert_allclose(got, ref, rtol=METRIC_RTOL)


def test_sdr_of_a_singular_system_is_nan():
    zeros = np.zeros((1, 512), np.float32)
    got, ref = (m.signal_distortion_ratio(zeros, zeros, filter_length=16)
                for m in (metrics, jax_metrics))
    assert np.isnan(got).all() and np.isnan(ref).all()


@pytest.mark.parametrize("name", ["chunk_median_snr", "chunk_median_si_snr", "chunk_median_sdr"])
@pytest.mark.parametrize("hop", [None, 300])
def test_chunk_medians_match_jax(name, hop):
    preds, target = _signals(1, (2, 2500))
    if name != "chunk_median_sdr":  # (scipy's Toeplitz solver refuses NaN)
        preds[0, 1000:1100] = np.nan  # a non-finite chunk of one batch element
    ref = getattr(jax_metrics, name)(preds, target, 800, hop)
    got = getattr(metrics, name)(torch.from_numpy(preds), target, 800, hop)
    assert np.isfinite(ref)
    np.testing.assert_allclose(got, ref, rtol=METRIC_RTOL)
    assert np.isnan(getattr(metrics, name)(preds[..., :500], target[..., :500], 800))


@pytest.mark.parametrize("as_tensor", [False, True])
def test_squim_objective_scores_match_jax(squim_ref, as_tensor):
    sd, params, x, _ = squim_ref(3210)
    wave = x[0]  # (T,): a batch of one
    ref = jax_metrics.squim_objective_scores(wave, params, ConfigDict(CONFIG))
    got = metrics.squim_objective_scores(torch.from_numpy(wave) if as_tensor else wave,
                                         squim.convert_torch(sd, CONFIG), CONFIG)
    assert set(got) == set(ref)
    for m in ref:
        assert isinstance(got[m], np.ndarray) and got[m].shape == ref[m].shape == (1,)
        np.testing.assert_allclose(got[m], ref[m], atol=ATOL, err_msg=m)
