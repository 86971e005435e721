"""The port's MDX23C and its STHT variant (``experimental_mdx23c_stht``),
the STFT's ``frame_signal`` / ``overlap_add`` and the 2-D norms and
activations they added, held against sesa_tpu on the CPU, on the same numpy
inputs and weights (``params_from_jax`` or one converted state dict).

Every whole-model JAX reference is built once, under ``jax.jit``, by a
module-scoped fixture, at the tiny config of ``tests/test_mdx23c.py``.

The bf16 forwards run with oneDNN off: with torch 2.13+cpu on some x86 CPUs
oneDNN's bf16 convolution returns wrong values for some shapes (a (16, 8, 8)
kernel over 8 channels came out 100% off), a library fault that cuDNN on the
card does not share; PyTorch's own CPU convolution is right there."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sesa_tpu.models import layers as JL
from sesa_tpu.models import mdx23c as jax_mdx23c
from sesa_tpu.models import mdx23c_stht as jax_stht
from sesa_tpu.ops.stft import frame_signal as jax_frame_signal
from sesa_tpu.ops.stft import overlap_add as jax_overlap_add
from sesa_tpu_torch.configs import AttrDict
from sesa_tpu_torch.convert import convert_checkpoint
from sesa_tpu_torch.convert.from_jax import params_from_jax
from sesa_tpu_torch.models import get_model
from sesa_tpu_torch.models import layers as L
from sesa_tpu_torch.models import mdx23c, mdx23c_stht
from sesa_tpu_torch.ops.stft import frame_signal, overlap_add
from sesa_tpu_torch.runtime.demix import DemixSpec, demix
from tests.test_mdx23c import export_torch_state_dict, tiny_config

SAMPLES = 8064
# ROADMAP's end-to-end tolerance of the port against the JAX package (f32)
ATOL = 5e-4
# bf16 against the JAX package's bf16, relative to max |JAX bf16|
# (tests/test_compute_dtype.py:23-45)
BF16_REL = 0.08


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch: with the tier-1 run's six workers on
    eight cores, torch's thread pools spin against each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(model_type="mdx23c", norm="InstanceNorm", act="gelu", target=None):
    return tiny_config(norm=norm, act=act, target=target)


def _jax_module(model_type):
    return jax_stht if model_type == "experimental_mdx23c_stht" else jax_mdx23c


def _input(seed=1):
    return (np.random.default_rng(seed).standard_normal((1, 2, SAMPLES)) * 0.1).astype(np.float32)


def _with_running_stats(params, seed):
    """Batch-norm running statistics away from (0, 1), so the fold is tested."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        if isinstance(tree, dict):
            out = {k: walk(v) for k, v in tree.items()}
            if "running_var" in out:
                c = out["running_var"].shape
                out["running_mean"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
                out["running_var"] = (0.5 + rng.random(c)).astype(np.float32)
            return out
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return tree

    return walk(params)


def _leaves(tree, path=""):
    """(path, leaf) pairs in sorted key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, f"{path}/{i}")]
    return [(path, tree)]


_REFS = {}


@pytest.fixture(scope="module")
def jax_ref():
    """(model type, norm, act, target, bf16) -> (JAX params as numpy, input,
    JAX output), built once per key under jax.jit."""
    def get(model_type="mdx23c", norm="InstanceNorm", act="gelu", target=None, bf16=False):
        key = (model_type, norm, act, target, bf16)
        if key not in _REFS:
            jm, cfg = _jax_module(model_type), _cfg(model_type, norm, act, target)
            params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), cfg))
            params = _with_running_stats(params, 3)
            kw = {"compute_dtype": jnp.bfloat16} if bf16 else {}
            x = _input()
            out = jax.jit(lambda p, a: jm.apply(p, cfg, a, **kw))(params, jnp.asarray(x))
            _REFS[key] = (params, x, np.asarray(out))
        return _REFS[key]
    return get


# --------------------------------------------------------------------------
# whole models
# --------------------------------------------------------------------------

@pytest.mark.parametrize("norm,act", [("InstanceNorm", "gelu"), ("BatchNorm", "elu"),
                                      ("GroupNorm2", "relu")])
def test_mdx23c_matches_jax_f32(jax_ref, norm, act):
    jparams, x, ref = jax_ref(norm=norm, act=act)
    cfg = AttrDict(_cfg(norm=norm, act=act).to_dict())
    got = mdx23c.apply(params_from_jax(jparams, "mdx23c", cfg), cfg, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == ref.shape == (1, 2, 2, SAMPLES)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("norm", ["InstanceNorm", "BatchNorm"])
def test_mdx23c_bf16_tracks_jax_bf16(jax_ref, norm):
    """The port in bf16 (weights cast once by ``prepare``, as the session
    does) against the JAX package in bf16."""
    jparams, x, ref = jax_ref(norm=norm, act="gelu", bf16=True)
    cfg = AttrDict(_cfg(norm=norm).to_dict())
    params = mdx23c.prepare(params_from_jax(jparams, "mdx23c", cfg), cfg, torch.bfloat16)
    with torch.backends.mkldnn.flags(enabled=False):
        got = mdx23c.apply(params, cfg, torch.from_numpy(x), compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    err, scale = np.abs(got.numpy() - ref).max(), np.abs(ref).max()
    assert err < BF16_REL * scale, (err, scale)


def test_target_instrument_gives_one_stem(jax_ref):
    jparams, x, ref = jax_ref(target="vocals")
    cfg = AttrDict(_cfg(target="vocals").to_dict())
    assert mdx23c.num_target_instruments(cfg) == 1
    got = mdx23c.apply(params_from_jax(jparams, "mdx23c", cfg), cfg, torch.from_numpy(x))
    assert got.shape == ref.shape == (1, 1, 2, SAMPLES)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


def test_stht_model_matches_jax(jax_ref):
    jparams, x, ref = jax_ref(model_type="experimental_mdx23c_stht")
    cfg = AttrDict(_cfg().to_dict())
    params = params_from_jax(jparams, "experimental_mdx23c_stht", cfg)
    got = mdx23c_stht.apply(params, cfg, torch.from_numpy(x))
    assert got.shape == ref.shape == (1, 2, 2, SAMPLES)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("model_type", ["mdx23c", "experimental_mdx23c_stht"])
def test_converter_matches_jax(model_type):
    """One reference state dict through both converters (in its
    ``state_dict`` container on the port's side); a stray key raises."""
    cfg = _cfg(norm="BatchNorm")
    jm = _jax_module(model_type)
    sd = export_torch_state_dict(jm.init(jax.random.PRNGKey(1), cfg), cfg)
    for key in [k for k in sd if k.endswith("running_var")]:
        sd[key.replace("running_var", "num_batches_tracked")] = torch.tensor(7)
    jparams = jax.tree.map(np.asarray, jm.convert_torch(sd, cfg))
    tcfg = AttrDict(cfg.to_dict())
    got = convert_checkpoint(model_type, {"state_dict": sd}, tcfg)
    want = params_from_jax(jparams, model_type, tcfg)
    assert [k for k, _ in _leaves(got)] == [k for k, _ in _leaves(want)]
    for (_, a), (_, b) in zip(_leaves(got), _leaves(want)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(ValueError, match="unconsumed"):
        get_model(model_type).convert_torch(dict(sd, **{"first_conv.bias": torch.zeros(8)}), tcfg)


def test_demix_of_mdx23c_matches_jax():
    """The slice as a whole on the CPU: a short song through the port's demix
    and the JAX package's, the same weights."""
    from sesa_tpu.runtime import DemixSpec as JaxSpec
    from sesa_tpu.runtime import demix as jax_demix

    cfg = _cfg()
    jparams = jax.tree.map(np.asarray, jax_mdx23c.init(jax.random.PRNGKey(3), cfg))
    mix = (np.random.default_rng(4).standard_normal((2, 20000)) * 0.1).astype(np.float32)
    apply = jax.tree_util.Partial(lambda p, c: jax_mdx23c.apply(p, cfg, c))
    ref = jax_demix(apply, jparams, mix,
                    JaxSpec(chunk_size=SAMPLES, num_overlap=2, batch_size=2, num_stems=2))
    tcfg = AttrDict(cfg.to_dict())
    params = params_from_jax(jparams, "mdx23c", tcfg)
    got = demix(lambda p, c: mdx23c.apply(p, tcfg, c), params, mix,
                DemixSpec(chunk_size=SAMPLES, num_overlap=2, batch_size=2, num_stems=2),
                device="cpu")
    assert got.shape == (2, 2, 20000)
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL)


def test_registry_resolves_the_family():
    assert get_model("mdx23c") is mdx23c
    assert get_model("experimental_mdx23c_stht") is mdx23c_stht
    cfg = AttrDict(_cfg().to_dict())
    params = mdx23c_stht.init(torch.Generator().manual_seed(0), cfg)
    jparams = jax_stht.init(jax.random.PRNGKey(0), _cfg())
    assert [(k, tuple(t.shape)) for k, t in _leaves(params)] == \
        [(k, tuple(np.shape(a))) for k, a in _leaves(jparams)]


# --------------------------------------------------------------------------
# the transforms and layers the family added
# --------------------------------------------------------------------------

def test_hartley_matches_jax():
    x = np.random.default_rng(0).standard_normal((3, 256)).astype(np.float32)
    got = mdx23c_stht.hartley(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_stht.hartley(jnp.asarray(x))), atol=1e-4)
    # the cas transform against torch.fft (tests/test_mdx23c_stht.py's oracle)
    fft = torch.fft.fft(torch.from_numpy(x).double())
    np.testing.assert_allclose(got, (fft.real - fft.imag).numpy(), atol=1e-4)


@pytest.mark.parametrize("n_fft,hop,t", [(256, 64, 2048), (512, 128, 3000)])
def test_stht_and_istht_match_jax(n_fft, hop, t):
    x = np.random.default_rng(1).standard_normal((1, 2, t)).astype(np.float32)
    got = mdx23c_stht.stht(torch.from_numpy(x), n_fft, hop)
    ref = np.asarray(jax_stht.stht(jnp.asarray(x), n_fft, hop))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)
    flat = got.reshape(-1, n_fft, got.shape[-1])
    back = mdx23c_stht.istht(flat, n_fft, hop, t)
    ref_back = np.asarray(jax_stht.istht(jnp.asarray(ref.reshape(flat.shape)), n_fft, hop, t))
    np.testing.assert_allclose(back.numpy(), ref_back, atol=1e-5)
    np.testing.assert_allclose(back.numpy().reshape(x.shape), x, atol=1e-4)


@pytest.mark.parametrize("frame_length,hop", [(256, 64), (200, 64), (7, 3)])
def test_frame_signal_and_overlap_add_match_jax(frame_length, hop):
    x = np.random.default_rng(2).standard_normal((2, 3, 1000)).astype(np.float32)
    frames = frame_signal(torch.from_numpy(x), frame_length, hop)
    ref = np.asarray(jax_frame_signal(jnp.asarray(x), frame_length, hop))
    np.testing.assert_array_equal(frames.numpy(), ref)
    flat = ref.reshape(-1, ref.shape[-2], frame_length)
    got = overlap_add(torch.from_numpy(flat.copy()), hop)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_overlap_add(jnp.asarray(flat), hop)),
                               atol=1e-5)


@pytest.mark.parametrize("norm", ["InstanceNorm", "BatchNorm", "GroupNorm2", ""])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_norm2d_matches_jax(norm, dtype):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 4, 6, 10)) * 3 + 1).astype(np.float32)
    p = {"weight": rng.standard_normal(4).astype(np.float32),
         "bias": rng.standard_normal(4).astype(np.float32),
         "running_mean": rng.standard_normal(4).astype(np.float32),
         "running_var": (0.5 + rng.random(4)).astype(np.float32)}
    jfn, jhas = JL.make_norm2d(norm)
    fn, has = L.make_norm2d(norm)
    assert has == jhas
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    ref = np.asarray(jfn(jnp.asarray(x, jdt), {k: jnp.asarray(v, jdt) for k, v in p.items()}),
                     dtype=np.float32)
    got = fn(torch.from_numpy(x).to(tdt), {k: torch.from_numpy(v).to(tdt) for k, v in p.items()})
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), ref, atol=1e-5 if dtype == "f32" else 0.05)


@pytest.mark.parametrize("act", ["gelu", "relu", "elu", "elu0.5"])
def test_make_act_matches_jax(act):
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    np.testing.assert_allclose(L.make_act(act)(torch.from_numpy(x)).numpy(),
                               np.asarray(JL.make_act(act)(jnp.asarray(x))), atol=1e-6)


def test_conv_transpose2d_block_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 5, 7)).astype(np.float32)
    w = rng.standard_normal((6, 3, 2, 2)).astype(np.float32)
    got = L.conv_transpose2d_block(torch.from_numpy(x), torch.from_numpy(w))
    ref = np.asarray(JL.conv_transpose2d_block(jnp.asarray(x), jnp.asarray(w)))
    assert got.shape == ref.shape == (2, 3, 10, 14)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
