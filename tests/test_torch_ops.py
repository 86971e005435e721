"""sesa_tpu_torch ops held against their sesa_tpu counterparts on the CPU:
STFT / iSTFT, windows, rope, rms_norm, band split and mask estimator.
Inputs are made with numpy from a seed and handed to both packages."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sesa_tpu.models.layers import rms_norm as jax_rms_norm
from sesa_tpu.ops import bands as JB
from sesa_tpu.ops import rope as JR
from sesa_tpu.ops.windows import fade_window as jax_fade_window
from sesa_tpu.runtime.demix import DemixSpec as JaxDemixSpec
from sesa_tpu.runtime.demix import _windows as jax_windows
from sesa_tpu_torch.models.layers import rms_norm
from sesa_tpu_torch.ops import bands as B
from sesa_tpu_torch.ops import rope as R
from sesa_tpu_torch.ops.stft import istft_ri, stft_ri
from sesa_tpu_torch.ops.windows import fade_window, hann_window
from sesa_tpu_torch.runtime.demix import DemixSpec, _windows

# sesa_tpu.ops re-exports a function named stft over the module name
JS = importlib.import_module("sesa_tpu.ops.stft")


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# STFT tolerances are tests/test_stft.py's own (f32 DFT-as-GEMM vs cuFFT/pocketfft)
@pytest.mark.parametrize("n_fft,hop,t,win,normalized", [
    (2048, 512, 44100, None, False),
    (512, 128, 5000, None, False),
    (2048, 441, 20000, None, False),
    (4096, 1024, 16384, None, True),
    (2048, 512, 8192, 1024, False),  # win_length < n_fft
])
def test_stft_ri_matches_jax(n_fft, hop, t, win, normalized):
    x = np.random.default_rng(t).standard_normal((3, t)).astype(np.float32)
    w = np.array(JS.hann_window(win or n_fft))
    ref = JS.stft_ri(jnp.asarray(x), n_fft, hop, jnp.asarray(w), win_length=win,
                     normalized=normalized)
    got = stft_ri(torch.from_numpy(x), n_fft, hop, torch.from_numpy(w),
                  win_length=win, normalized=normalized)
    assert got.shape == ref.shape
    atol = 2e-5 if normalized else 2e-4
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=atol, rtol=1e-4)


@pytest.mark.parametrize("normalized,length", [(False, 22050), (True, 22050), (False, None)])
def test_istft_ri_matches_jax(normalized, length):
    rng = np.random.default_rng(3)
    n_fft, hop = 2048, 512
    spec = rng.standard_normal((2, n_fft // 2 + 1, 44, 2)).astype(np.float32)
    w = np.array(JS.hann_window(n_fft))
    ref = JS.istft_ri(jnp.asarray(spec), n_fft, hop, jnp.asarray(w),
                      normalized=normalized, length=length)
    got = istft_ri(torch.from_numpy(spec), n_fft, hop, torch.from_numpy(w),
                   normalized=normalized, length=length)
    assert got.shape == ref.shape
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=5e-5, rtol=1e-4)


def test_istft_ri_non_dividing_hop_matches_jax():
    """A hop that does not divide n_fft (441 into 2048) takes the folded
    overlap-add; the same spectrum gives the JAX result and the same bits on
    a second call."""
    rng = np.random.default_rng(5)
    n_fft, hop = 2048, 441
    spec = rng.standard_normal((2, n_fft // 2 + 1, 30, 2)).astype(np.float32)
    w = np.array(JS.hann_window(n_fft))
    ref = JS.istft_ri(jnp.asarray(spec), n_fft, hop, jnp.asarray(w), length=12000)
    got = istft_ri(torch.from_numpy(spec), n_fft, hop, torch.from_numpy(w), length=12000)
    assert got.shape == ref.shape
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=5e-5, rtol=1e-4)
    again = istft_ri(torch.from_numpy(spec), n_fft, hop, torch.from_numpy(w), length=12000)
    assert torch.equal(got, again)


def test_stft_round_trip():
    x = np.random.default_rng(4).standard_normal((2, 2, 44100)).astype(np.float32)
    w = hann_window(2048)
    back = istft_ri(stft_ri(torch.from_numpy(x), 2048, 512, w), 2048, 512, w, length=44100)
    np.testing.assert_allclose(_np(back), x, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("size,fade", [(1000, 100), (352800, 35280), (64, 0)])
def test_windows_match_jax(size, fade):
    np.testing.assert_array_equal(_np(fade_window(size, fade)),
                                  np.asarray(jax_fade_window(size, fade)))
    np.testing.assert_array_equal(_np(hann_window(size)), np.asarray(JS.hann_window(size)))
    if fade:
        np.testing.assert_array_equal(_windows(DemixSpec(size)),
                                      jax_windows(JaxDemixSpec(size)))


@pytest.mark.parametrize("dim_head,rot,n", [(64, 64, 690), (64, 64, 62), (32, 8, 33)])
def test_rope_matches_jax(dim_head, rot, n):
    freqs = R.default_freqs(rot)
    np.testing.assert_array_equal(freqs, JR.default_freqs(rot))
    cos, sin = R.rope_tables(torch.from_numpy(freqs), n)
    jcos, jsin = JR.rope_tables(jnp.asarray(freqs), n)
    np.testing.assert_allclose(_np(cos), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(_np(sin), np.asarray(jsin), atol=1e-6)
    x = np.random.default_rng(n).standard_normal((2, 3, n, dim_head)).astype(np.float32)
    got = R.apply_rope(torch.from_numpy(x), cos, sin)
    ref = JR.apply_rope(jnp.asarray(x), jcos, jsin)
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("scale", [1.0, 1e-14])  # the second hits the 1e-12 norm clamp
def test_rms_norm_matches_jax(scale):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((4, 7, 48)) * scale).astype(np.float32)
    g = rng.standard_normal(48).astype(np.float32)
    got = rms_norm(torch.from_numpy(x), torch.from_numpy(g))
    ref = jax_rms_norm(jnp.asarray(x), jnp.asarray(g))
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-5, rtol=1e-5)


def _band_layout(stereo):
    fpb = (2, 2, 2, 2, 4, 4, 4, 8, 5, 2)  # ragged widths, out-of-order groups
    ch = 2 if stereo else 1
    widths = [2 * f * ch for f in fpb]
    feats = B.contiguous_band_feats(widths)
    return feats, sum(widths)


@pytest.mark.parametrize("stereo", [True, False])
def test_band_split_and_mask_estimator_match_jax(stereo):
    feats, nf = _band_layout(stereo)
    plan = B.make_band_plan(feats, nf)
    jplan = JB.make_band_plan(feats, nf)
    assert plan.group_band_ids == jplan.group_band_ids
    np.testing.assert_array_equal(plan.band_perm, jplan.band_perm)

    rng = np.random.default_rng(6)
    dim, n_hidden = 16, 1
    mk = lambda *s: rng.standard_normal(s).astype(np.float32) * 0.3  # noqa: E731
    bs = {"groups": [{"norm_gamma": mk(m, w), "weight": mk(m, w, dim), "bias": mk(m, dim)}
                     for m, w in (idx.shape for idx in plan.group_feat_idx)]}
    me = {"hidden": [{"weight": mk(plan.num_bands, dim, 4 * dim),
                      "bias": mk(plan.num_bands, 4 * dim)} for _ in range(n_hidden)],
          "groups": [{"weight": mk(m, 4 * dim, 2 * w), "bias": mk(m, 2 * w)}
                     for m, w in (idx.shape for idx in plan.group_feat_idx)]}
    to_t = lambda tr: {k: [{kk: torch.from_numpy(v) for kk, v in g.items()}  # noqa: E731
                           for g in vs] for k, vs in tr.items()}
    to_j = lambda tr: {k: [{kk: jnp.asarray(v) for kk, v in g.items()}  # noqa: E731
                           for g in vs] for k, vs in tr.items()}

    x = mk(2, 5, nf)
    got = B.band_split_apply(plan, to_t(bs), torch.from_numpy(x))
    ref = JB.band_split_apply(jplan, to_j(bs), jnp.asarray(x))
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-5, rtol=1e-5)

    h = mk(2, 5, plan.num_bands, dim)
    got = B.mask_estimator_apply(plan, to_t(me), torch.from_numpy(h))
    ref = JB.mask_estimator_apply(jplan, to_j(me), jnp.asarray(h))
    assert got.shape == (2, 5, nf)
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-5, rtol=1e-5)
