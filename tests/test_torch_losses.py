"""The port's training losses held against sesa_tpu.losses on the CPU in
f32: values and gradients on the same numpy inputs, the gradient finite
where recon == target, and the same input checks."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sesa_tpu import losses as jl
from sesa_tpu_torch import losses as tl

# f32 means over a few thousand elements; the spectral terms go through a
# DFT-matrix STFT in JAX and pocketfft in the port
RTOL = 1e-5
# gradients against jax.grad, relative to the largest JAX gradient
GRAD_REL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(shape, seed=0, scale=0.3):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(shape) * scale).astype(np.float32),
            (rng.standard_normal(shape) * scale).astype(np.float32))


def _grads(jfn, tfn, est, target):
    """(JAX grad, port grad) of the loss with respect to ``est``."""
    gj = np.asarray(jax.grad(lambda e: jfn(e, jnp.asarray(target)))(jnp.asarray(est)))
    e = torch.from_numpy(est).requires_grad_(True)
    tfn(e, torch.from_numpy(target)).backward()
    return gj, e.grad.numpy()


# (name, JAX function, port function, kwargs, input shape)
CASES = [
    ("l1", jl.l1, tl.l1, {}, (2, 2, 2, 1000)),
    ("multi_res_default", jl.multi_res_stft_l1, tl.multi_res_stft_l1, {}, (1, 1, 2, 4410)),
    ("multi_res_small", jl.multi_res_stft_l1, tl.multi_res_stft_l1,
     {"window_sizes": (256, 128), "stft_n_fft": 256, "resolution_weight": 0.5}, (2, 2, 2, 1000)),
    ("pnorm_p1", jl.signal_noise_pnorm_ratio, tl.signal_noise_pnorm_ratio, {}, (3, 2, 500)),
    ("pnorm_p2_si_nolog", jl.signal_noise_pnorm_ratio, tl.signal_noise_pnorm_ratio,
     {"p": 2, "scale_invariant": True, "take_log": False}, (3, 2, 500)),
    ("pnorm_si_none", jl.signal_noise_pnorm_ratio, tl.signal_noise_pnorm_ratio,
     {"scale_invariant": True, "reduction": "none"}, (3, 2, 2, 250)),
    ("neg_snr", jl.neg_sdr, tl.neg_sdr, {}, (3, 2, 500)),
    ("neg_sisdr", jl.neg_sdr, tl.neg_sdr, {"sdr_type": "sisdr", "zero_mean": False}, (3, 2, 500)),
    ("neg_sdsdr_p1", jl.neg_sdr, tl.neg_sdr, {"sdr_type": "sdsdr", "p": 1.0}, (3, 2, 500)),
    ("neg_snr_nolog_none", jl.neg_sdr, tl.neg_sdr, {"take_log": False, "reduction": "none"},
     (3, 2, 500)),
]


@pytest.mark.parametrize("name,jfn,tfn,kw,shape", CASES, ids=[c[0] for c in CASES])
def test_loss_and_gradient_match_jax(name, jfn, tfn, kw, shape):
    est, target = _pair(shape)
    ref = np.asarray(jfn(jnp.asarray(est), jnp.asarray(target), **kw))
    got = tfn(torch.from_numpy(est), torch.from_numpy(target), **kw).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=RTOL)

    def reduce(fn):
        return lambda e, t: fn(e, t, **kw).sum()

    gj, gt = _grads(reduce(jfn), reduce(tfn), est, target)
    assert np.abs(gt - gj).max() <= GRAD_REL * np.abs(gj).max()


def test_multi_res_breakdown_and_truncated_target():
    est, _ = _pair((1, 2, 3000))
    _, target = _pair((1, 2, 3200), seed=1)
    kw = {"window_sizes": (512, 256), "stft_n_fft": 512, "return_breakdown": True}
    ref_total, (ref_base, ref_multi) = jl.multi_res_stft_l1(jnp.asarray(est),
                                                            jnp.asarray(target), **kw)
    total, (base, multi) = tl.multi_res_stft_l1(torch.from_numpy(est),
                                                torch.from_numpy(target), **kw)
    for a, b in ((total, ref_total), (base, ref_base), (multi, ref_multi)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL)
    np.testing.assert_allclose(float(total), float(base) + float(multi), rtol=1e-6)


@pytest.mark.parametrize("kw", [{}, {"window_sizes": (256,), "stft_n_fft": 256}])
def test_multi_res_gradient_finite_where_recon_equals_target(kw):
    """The 1e-24 bias inside the complex modulus keeps sqrt's gradient finite
    at a zero difference (sqrt(0) alone gives inf · 0 = nan)."""
    x, _ = _pair((1, 2, 4410))
    e = torch.from_numpy(x.copy()).requires_grad_(True)
    loss = tl.multi_res_stft_l1(e, torch.from_numpy(x), **kw)
    loss.backward()
    assert float(loss) < 1e-9
    assert bool(torch.isfinite(e.grad).all())
    d = torch.zeros((3, 4, 2), requires_grad=True)
    tl._complex_l1(d, torch.zeros_like(d)).backward()
    assert bool(torch.isfinite(d.grad).all())


def test_input_checks_match_jax():
    a = torch.zeros((2, 3, 10))
    with pytest.raises(ValueError):
        tl.neg_sdr(a, a, sdr_type="bogus")
    with pytest.raises(TypeError):
        tl.neg_sdr(a[0], a[0])
    with pytest.raises(TypeError):
        tl.neg_sdr(a, a[:, :2])
    with pytest.raises(NotImplementedError):
        tl.signal_noise_pnorm_ratio(a, a, p=3)
    assert tl.MULTI_STFT_WINDOW_SIZES == jl.MULTI_STFT_WINDOW_SIZES
    assert tl.MULTI_STFT_HOP == jl.MULTI_STFT_HOP
