"""The port's public surface against the JAX package's, on the CPU.

Every public function and class that a ``sesa_tpu`` module defines (read
from its source, re-imports left out) exists in the port's module of the
same path, under its own name or under a rename listed in RENAMES;
``native/`` is not ported (``sesa_tpu_torch/audio_io.py`` says why). The
names the port took last are held to their JAX functions on seeded inputs:
``configs.config_from_dict``, the complex ``ops.stft.stft`` / ``istft``,
``ops.fft.force_device_mats``, ``models.layers.tanh`` and the re-exports of
``sesa_tpu/ops/__init__.py``."""

import ast
import importlib
import os
import sys
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ml_collections import ConfigDict

from sesa_tpu.models import layers as jax_layers
from sesa_tpu_torch.configs import AttrDict, config_from_dict, load_config
from sesa_tpu_torch.models import layers
from sesa_tpu_torch.ops.fft import _min_device_n, force_device_mats
from sesa_tpu_torch.ops.stft import istft, stft
from sesa_tpu_torch.postprocess import ensemble_phase_fix_device

# the module, not the function that ``sesa_tpu.ops`` re-exports under its name
jax_stft_module = importlib.import_module("sesa_tpu.ops.stft")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "sesa_tpu")

# (JAX module, name) -> what the port has in its place, each (module, name)
RENAMES = {
    # the TPU gate of K5 and K6 (bf16 on a TPU, d and e multiples of 128):
    # the port asks each model's choice of kernels, which asks the wrappers'
    # shape predicates
    ("sesa_tpu.ops.convblock", "use_fused_conv"): (
        ("sesa_tpu_torch.models.conformer_core", "conformer_kernels"),
        ("sesa_tpu_torch.models.apollo", "apollo_kernels"),
        ("sesa_tpu_torch.ops.convblock", "conformer_conv_shape_ok"),
        ("sesa_tpu_torch.ops.convblock", "apollo_conv_shape_ok")),
    # K8's gate and its Pallas kernel: the CUDA kernel's gate and wrapper
    ("sesa_tpu.ops.ssd", "use_pallas_ssd"): (("sesa_tpu_torch.ops.ssd", "use_fused_ssd"),),
    ("sesa_tpu.ops.ssd", "ssd_pallas"): (("sesa_tpu_torch.ops.ssd", "ssd_fused"),),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_modules():
    """Every module of the JAX package but ``native/``, by dotted name."""
    mods = []
    for root, dirs, files in os.walk(JAX_PKG):
        dirs[:] = sorted(d for d in dirs if d not in ("native", "__pycache__", "assets"))
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3].replace(os.sep, ".")
                mods.append(rel[:-len(".__init__")] if rel.endswith(".__init__") else rel)
    return mods


def _defined_public_names(module):
    """The public functions and classes the module's source defines at top
    level (what it imports is not its own)."""
    path = os.path.join(REPO, *module.split("."))
    path = os.path.join(path, "__init__.py") if os.path.isdir(path) else path + ".py"
    with open(path) as f:
        tree = ast.parse(f.read())
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not n.name.startswith("_")]


@pytest.mark.parametrize("module", _jax_modules())
def test_every_public_name_has_a_port(module):
    port = importlib.import_module("sesa_tpu_torch" + module[len("sesa_tpu"):])
    missing = []
    for name in _defined_public_names(module):
        if (module, name) in RENAMES:
            for mod, new in RENAMES[module, name]:
                if not hasattr(importlib.import_module(mod), new):
                    missing.append(f"{name} -> {mod}.{new}")
        elif not hasattr(port, name):
            missing.append(name)
    assert not missing, f"{module}: no port of {missing}"


def test_the_renames_name_what_the_jax_package_defines():
    for module, name in RENAMES:
        assert name in _defined_public_names(module)


def test_native_is_the_only_package_left_out():
    assert os.path.isdir(os.path.join(JAX_PKG, "native"))
    mods = _jax_modules()
    assert len(mods) >= 80 and not any(".native" in m for m in mods)


# ---------------------------------------------------------------------------
# the names ported last, against their JAX functions
# ---------------------------------------------------------------------------

CONFIG = {"audio": {"chunk_size": 8064, "num_channels": 2, "sample_rate": 44100},
          "model": {"dim": 64, "freqs_per_bands": [2, 2, 4], "stereo": True,
                    "mask": {"depth": 2}},
          "training": {"instruments": ["vocals", "other"], "target_instrument": None}}


def test_config_from_dict_reads_as_the_jax_config():
    jax_cfg = importlib.import_module("sesa_tpu.configs").config_from_dict(CONFIG)
    cfg = config_from_dict(CONFIG)
    assert isinstance(cfg, AttrDict) and isinstance(jax_cfg, ConfigDict)
    for path in ("audio.chunk_size", "audio.sample_rate", "model.dim", "model.freqs_per_bands",
                 "model.stereo", "model.mask.depth", "training.instruments",
                 "training.target_instrument"):
        got, ref = cfg, jax_cfg
        for key in path.split("."):
            got, ref = getattr(got, key), getattr(ref, key)
        assert got == ref, path
    assert isinstance(cfg.model.mask, AttrDict)
    assert cfg == load_config("bs_roformer", CONFIG)
    with pytest.raises(AttributeError):
        cfg.model.heads  # noqa: B018


N_FFT, HOP = 256, 64


@pytest.fixture(scope="module")
def stft_refs():
    """The JAX complex pair on seeded f32 audio: spectra with and without a
    window, and the inverses at the signal's length and a shorter one."""
    x = np.random.default_rng(0).standard_normal((2, 3, 2000)).astype(np.float32)
    win = np.array(jax_stft_module.hann_window(N_FFT))
    spec = jax_stft_module.stft(jnp.asarray(x), N_FFT, HOP, jnp.asarray(win))
    spec_nowin = jax_stft_module.stft(jnp.asarray(x), N_FFT, HOP)
    return dict(x=x, win=win, spec=np.array(spec), spec_nowin=np.asarray(spec_nowin),
                back=np.asarray(jax_stft_module.istft(spec, N_FFT, HOP, jnp.asarray(win),
                                                      length=2000)),
                short=np.asarray(jax_stft_module.istft(spec, N_FFT, HOP, jnp.asarray(win),
                                                       length=1500)))


def test_stft_matches_jax(stft_refs):
    x, win = torch.from_numpy(stft_refs["x"]), torch.from_numpy(stft_refs["win"])
    spec = stft(x, N_FFT, HOP, win)
    assert spec.dtype == torch.complex64 and spec.shape == stft_refs["spec"].shape
    np.testing.assert_allclose(spec.numpy(), stft_refs["spec"], atol=1e-4)
    np.testing.assert_allclose(stft(x, N_FFT, HOP).numpy(), stft_refs["spec_nowin"], atol=1e-4)


@pytest.mark.parametrize("length", [2000, 1500])
def test_istft_matches_jax(stft_refs, length):
    spec = torch.from_numpy(stft_refs["spec"])
    got = istft(spec, N_FFT, HOP, torch.from_numpy(stft_refs["win"]), length=length)
    ref = stft_refs["back" if length == 2000 else "short"]
    assert got.dtype == torch.float32 and got.shape == ref.shape == (2, 3, length)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)
    if length == 2000:  # the round trip returns the signal
        np.testing.assert_allclose(got.numpy(), stft_refs["x"], atol=1e-4)


def test_tanh_matches_jax():
    x = np.random.default_rng(1).standard_normal((4, 33)).astype(np.float32) * 3
    np.testing.assert_allclose(layers.tanh(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_layers.tanh(jnp.asarray(x))), rtol=1e-6,
                               atol=1e-7)


JAX_OPS_NAMES = ("rdft", "irdft", "net_precision", "stft", "istft", "stft_ri", "istft_ri",
                 "hann_window", "fade_window")


@pytest.mark.parametrize("name", JAX_OPS_NAMES)
def test_ops_reexports_the_jax_names(name):
    """``sesa_tpu_torch.ops`` re-exports what ``sesa_tpu.ops`` does, each the
    object its submodule defines."""
    import sesa_tpu.ops as jax_ops
    import sesa_tpu_torch.ops as ops

    home = {"rdft": "fft", "irdft": "fft", "net_precision": "prec", "fade_window": "windows",
            "hann_window": "windows"}.get(name, "stft")
    assert hasattr(jax_ops, name)
    assert getattr(ops, name) is getattr(sys.modules[f"sesa_tpu_torch.ops.{home}"], name)


def test_ops_reexports_nothing_else_of_the_jax_init():
    with open(os.path.join(JAX_PKG, "ops", "__init__.py")) as f:
        tree = ast.parse(f.read())
    names = {a.asname or a.name for n in tree.body if isinstance(n, ast.ImportFrom)
             for a in n.names}
    assert names == set(JAX_OPS_NAMES)
    import sesa_tpu_torch.ops as ops

    # as in the JAX package, the package's ``stft`` is the function
    assert callable(ops.stft) and not isinstance(ops.stft, type(ops))


def test_force_device_mats_nests_restores_and_stays_in_its_thread():
    assert _min_device_n() is None
    seen = {}
    with force_device_mats(1024):
        assert _min_device_n() == 1024
        with force_device_mats():
            assert _min_device_n() == 0
            worker = threading.Thread(target=lambda: seen.update(other=_min_device_n()))
            worker.start()
            worker.join(timeout=30)
            assert not worker.is_alive()
        assert _min_device_n() == 1024
        with pytest.raises(ValueError):
            with force_device_mats(4096):
                raise ValueError("inside")
        assert _min_device_n() == 1024
    assert _min_device_n() is None
    assert seen == {"other": None}


def test_force_device_mats_changes_no_result():
    """The port's transforms read no DFT table: the device ensemble and phase
    fix give the same bits inside and outside the switch."""
    rng = np.random.default_rng(3)
    mix = torch.from_numpy(rng.standard_normal((2, 44100)).astype(np.float32))
    waves = [mix * 0.5 + 0.01 * torch.from_numpy(rng.standard_normal((2, 44100))
                                                 .astype(np.float32)) for _ in range(2)]
    out = ensemble_phase_fix_device(mix, waves, 44100)
    with force_device_mats(0):
        inside = ensemble_phase_fix_device(mix, waves, 44100)
    assert torch.equal(out, inside)
