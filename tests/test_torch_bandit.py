"""The port's band-split RNNs, BandIt v1 (``bandit``) and v2 (``bandit_v2``),
held against sesa_tpu on the CPU, on the same numpy inputs and weights
(``params_from_jax`` or one converted state dict), at the tiny configs of
``tests/test_bandit_v1.py`` and ``tests/test_bandit_v2.py``.

Every whole-model JAX reference is built once, under ``jax.jit``, by a
module-scoped fixture. The parts (band split, one seq-band module, one
stem's mask head) are held against the JAX module's lines, composed from
sesa_tpu's layers on the same spectrum."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_collections import ConfigDict

from sesa_tpu.models import bandit as jax_v1
from sesa_tpu.models import bandit_v2 as jax_v2
from sesa_tpu.models import layers as JL
from sesa_tpu.ops.stft import hann_window as jax_hann
from sesa_tpu.ops.stft import stft_ri as jax_stft_ri
from sesa_tpu_torch.audio_io import read_audio, write_audio
from sesa_tpu_torch.cli import main as cli_main
from sesa_tpu_torch.configs import AttrDict
from sesa_tpu_torch.convert.from_jax import params_from_jax
from sesa_tpu_torch.models import bandit, bandit_v2, get_model
from sesa_tpu_torch.runtime.session import InferenceSession
from tests.test_bandit_v1 import export_state_dict as export_v1
from tests.test_bandit_v1 import tiny_config as tiny_v1
from tests.test_bandit_v2 import export_state_dict as export_v2
from tests.test_bandit_v2 import tiny_config as tiny_v2
from tests.test_torch_mdx23c import _leaves

SAMPLES = 4096
# ROADMAP's end-to-end tolerance of the port against the JAX package (f32)
ATOL = 5e-4
# the parts, each a few f32 products deep
PART_ATOL = 1e-5

VERSIONS = {"bandit": (jax_v1, bandit, tiny_v1, export_v1),
            "bandit_v2": (jax_v2, bandit_v2, tiny_v2, export_v2)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch: these models run as hundreds of small
    ops (per-band norms and products, LSTM steps), and with the tier-1 run's
    six workers on eight cores torch's thread pools spin against each
    other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _input(seed=0):
    return (np.random.default_rng(seed).standard_normal((1, 2, SAMPLES)) * 0.1).astype(np.float32)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    return np.asarray(tree)


def _params(version, seed=0):
    """Parameters as numpy (the port's init; the trees are the same), with
    the norms' affines away from (1, 0)."""
    _, tm, cfg_fn, _ = VERSIONS[version]
    tree = _numpy_tree(tm.init(torch.Generator().manual_seed(seed), AttrDict(cfg_fn().to_dict())))
    rng = np.random.default_rng(seed + 1)

    def walk(t):
        if isinstance(t, dict):
            out = {k: walk(v) for k, v in t.items()}
            if set(out) == {"weight", "bias"} and out["weight"].ndim == 1:
                c = out["weight"].shape
                out["weight"] = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
                out["bias"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
            return out
        if isinstance(t, list):
            return [walk(v) for v in t]
        return t

    return walk(tree)


_REFS = {}


@pytest.fixture(scope="module")
def jax_ref():
    """version -> (params as numpy, input, JAX output), built once under jax.jit."""
    def get(version):
        if version not in _REFS:
            jm, _, cfg_fn, _ = VERSIONS[version]
            cfg, params, x = cfg_fn(), _params(version), _input()
            out = jax.jit(lambda p, a: jm.apply(p, cfg, a))(params, jnp.asarray(x))
            _REFS[version] = (params, x, np.asarray(out))
        return _REFS[version]
    return get


def _torch_cfg(version):
    return AttrDict(VERSIONS[version][2]().to_dict())


def _kw_specs(version):
    jm, _, cfg_fn, _ = VERSIONS[version]
    kw = jm._kwargs(cfg_fn())
    return kw, jax_v2.musical_band_specs(kw["n_fft"], kw["fs"], kw["n_bands"])


# --------------------------------------------------------------------------
# band layout
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_fft,fs,n_bands", [(2048, 44100, 64), (256, 8000, 6)])
def test_musical_band_specs_match_jax(n_fft, fs, n_bands):
    specs, weights = bandit_v2.musical_band_specs(n_fft, fs, n_bands)
    ref_specs, ref_weights = jax_v2.musical_band_specs(n_fft, fs, n_bands)
    assert specs == ref_specs and len(specs) == n_bands
    assert len(weights) == len(ref_weights)
    for w, r in zip(weights, ref_weights):
        assert w.dtype == np.float32
        np.testing.assert_array_equal(w, r)


# --------------------------------------------------------------------------
# the parts, against the JAX module's lines
# --------------------------------------------------------------------------

def _spectrum(version):
    """The window-energy-normalised spectrum (B', F, T, 2) of the JAX module."""
    kw, _ = _kw_specs(version)
    x = _input()
    window = jax_hann(kw["win_length"], dtype=jnp.float32)
    scale = 1.0 / jnp.sqrt(jnp.sum(window * window))
    spec = jax_stft_ri(jnp.asarray(x.reshape(2, -1)), kw["n_fft"], kw["hop_length"], window,
                       win_length=kw["win_length"], pad_mode="constant") * scale
    return np.array(spec)


def _jax_band_split(version, params, spec, specs):
    bsz, _, tf, _ = spec.shape
    zs = []
    for i, (s, e) in enumerate(specs):
        if version == "bandit_v2":  # bandit_v2.py:170-176: (bandwidth, re/im)
            xb = jnp.transpose(spec[:, None][:, :, s:e], (0, 3, 1, 2, 4)).reshape(bsz, tf, -1)
        else:  # bandit.py:117-121: (re/im, bandwidth)
            xb = jnp.transpose(spec, (0, 2, 3, 1))[..., s:e].reshape(bsz, tf, -1)
        p = params["band_split"][i]
        zs.append(JL.linear(JL.layer_norm(xb, p["norm"]), p["fc"]))
    return np.asarray(jnp.stack(zs, axis=1))


@pytest.mark.parametrize("version", ["bandit", "bandit_v2"])
def test_band_split_matches_jax(version):
    _, tm, _, _ = VERSIONS[version]
    params = _params(version)
    spec = _spectrum(version)
    _, (specs, _) = _kw_specs(version)
    ref = _jax_band_split(version, params, jnp.asarray(spec), specs)
    got = bandit_v2.band_split(params_from_jax(params, version, _torch_cfg(version)),
                               torch.from_numpy(spec), specs, tm.band_features)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=PART_ATOL)


def test_band_packings_differ():
    """v1 packs (re/im, bandwidth), v2 (bandwidth, re/im): one helper for
    both would get one of them wrong."""
    spec = torch.arange(2 * 5 * 3 * 2, dtype=torch.float32).reshape(2, 5, 3, 2)
    v1, v2 = bandit.band_features(spec, 1, 4), bandit_v2.band_features(spec, 1, 4)
    assert v1.shape == v2.shape == (2, 3, 6)
    assert v1[0, 0].tolist() == spec[0, 1:4, 0, 0].tolist() + spec[0, 1:4, 0, 1].tolist()
    assert v2[0, 0].tolist() == spec[0, 1:4, 0].reshape(-1).tolist()


@pytest.mark.parametrize("version", ["bandit", "bandit_v2"])
def test_one_seqband_module_matches_jax(version):
    """LayerNorm -> BiLSTM -> Linear, residual, then the (1, 2) transpose
    (bandit_v2.py:180-193)."""
    params = _params(version)
    p = params["seqband"][0]
    z = (np.random.default_rng(3).standard_normal((2, 6, 9, 16)) * 0.5).astype(np.float32)
    zn = JL.layer_norm(jnp.asarray(z), p["norm"])
    out = JL.linear(JL.bilstm(zn.reshape(12, 9, 16), p["lstm"]), p["fc"])
    ref = np.asarray(jnp.swapaxes(jnp.asarray(z) + out.reshape(2, 6, 9, 16), 1, 2))
    tp = params_from_jax(params, version, _torch_cfg(version))
    got = bandit_v2.seqband_apply(tp["seqband"][:1], torch.from_numpy(z))
    assert got.shape == ref.shape == (2, 9, 6, 16)
    np.testing.assert_allclose(got.numpy(), ref, atol=PART_ATOL)


@pytest.mark.parametrize("version", ["bandit", "bandit_v2"])
def test_one_mask_head_matches_jax(version):
    """LayerNorm -> tanh(Linear) -> Linear -> GLU, unpacked as (bandwidth,
    re/im) (bandit_v2.py:202-212, bandit.py:144-152)."""
    params = _params(version)
    kw, (specs, _) = _kw_specs(version)
    i, stem = 3, kw["stems"][0]
    bw = specs[i][1] - specs[i][0]
    p = params["mask_estim"][stem][i]
    qb = (np.random.default_rng(4).standard_normal((2, 9, 16))).astype(np.float32)
    h = jnp.tanh(JL.linear(JL.layer_norm(jnp.asarray(qb), p["norm"]), p["hidden"]))
    a, g = jnp.split(JL.linear(h, p["output"]), 2, axis=-1)
    o = (a * jax.nn.sigmoid(g)).reshape(2, 9, 1, bw, 2)
    ref = np.asarray(jnp.transpose(o, (0, 2, 3, 1, 4))[:, 0])
    tp = params_from_jax(params, version, _torch_cfg(version))
    got = bandit_v2.mask_head(tp["mask_estim"][stem][i], torch.from_numpy(qb), bw)
    assert got.shape == ref.shape == (2, bw, 9, 2)
    np.testing.assert_allclose(got.numpy(), ref, atol=PART_ATOL)


# --------------------------------------------------------------------------
# whole models
# --------------------------------------------------------------------------

@pytest.mark.parametrize("version", ["bandit", "bandit_v2"])
def test_whole_model_matches_jax_f32(jax_ref, version):
    params, x, ref = jax_ref(version)
    cfg = _torch_cfg(version)
    tm = VERSIONS[version][1]
    got = tm.apply(params_from_jax(params, version, cfg), cfg, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == ref.shape == (1, 2, 2, SAMPLES)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("version", ["bandit", "bandit_v2"])
def test_apply_takes_no_compute_dtype(version):
    import inspect

    assert "compute_dtype" not in inspect.signature(VERSIONS[version][1].apply).parameters


# --------------------------------------------------------------------------
# converters
# --------------------------------------------------------------------------

def _state_dict(version, seed=1):
    jm, _, cfg_fn, export = VERSIONS[version]
    kw, (specs, _) = _kw_specs(version)
    return export(_params(version, seed), kw, specs)


@pytest.mark.parametrize("version", ["bandit", "bandit_v2"])
def test_convert_torch_matches_jax(version):
    jm, tm, cfg_fn, _ = VERSIONS[version]
    sd = _state_dict(version)
    ref = jm.convert_torch({k: v.numpy() for k, v in sd.items()}, cfg_fn())
    got = tm.convert_torch(sd, _torch_cfg(version))
    ref_l, got_l = _leaves(ref), _leaves(got)
    assert [p for p, _ in got_l] == [p for p, _ in ref_l]
    for (path, g), (_, r) in zip(got_l, ref_l):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=path)


def test_convert_torch_v2_skips_aliases_and_buffers():
    """v2 checkpoints carry the mask heads twice (attributes and
    ``combined``) and the freq_weights buffers: both are skipped."""
    sd = _state_dict("bandit_v2")
    extra = dict(sd)
    for k, v in sd.items():
        if ".norm_mlp." in k and ".combined.0." in k:
            extra[k.replace(".combined.0.", ".norm.")] = v
    extra["mask_estim.speech.freq_weights/0"] = torch.ones(3)
    extra["stft.window"] = torch.ones(256)
    got = bandit_v2.convert_torch(extra, _torch_cfg("bandit_v2"))
    for (_, a), (_, b) in zip(_leaves(got), _leaves(bandit_v2.convert_torch(sd, _torch_cfg(
            "bandit_v2")))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("version", ["bandit", "bandit_v2"])
def test_convert_torch_refuses_unconsumed_keys(version):
    sd = dict(_state_dict(version))
    sd[next(iter(sd)).replace(".weight", ".stray")] = torch.zeros(1)
    with pytest.raises(ValueError, match="unconsumed"):
        VERSIONS[version][1].convert_torch(sd, _torch_cfg(version))
    sd = dict(_state_dict(version))
    del sd[next(k for k in sd if k.endswith("rnn.weight_hh_l0"))]
    with pytest.raises(KeyError):
        VERSIONS[version][1].convert_torch(sd, _torch_cfg(version))


def test_v2_refuses_two_input_channels():
    cfg = tiny_v2().to_dict()
    cfg["kwargs"]["in_channels"] = 2
    with pytest.raises(NotImplementedError, match="in_channels=2"):
        bandit_v2.init(torch.Generator().manual_seed(0), AttrDict(cfg))
    with pytest.raises(NotImplementedError):
        jax_v2._kwargs(ConfigDict(cfg))


def test_v1_refuses_a_non_musical_layout():
    cfg = tiny_v1().to_dict()
    cfg["model"]["band_specs"] = "dnr:vox7"
    with pytest.raises(NotImplementedError, match="musical"):
        bandit.init(torch.Generator().manual_seed(0), AttrDict(cfg))
    with pytest.raises(AssertionError):
        jax_v1._specs(jax_v1._kwargs(ConfigDict(cfg)))


def test_v2_reads_model_when_kwargs_is_absent():
    cfg = tiny_v2().to_dict()
    model_cfg = AttrDict({"model": cfg["kwargs"]})
    assert bandit_v2._kwargs(model_cfg) == jax_v2._kwargs(ConfigDict(cfg))


# --------------------------------------------------------------------------
# registry, session and CLI
# --------------------------------------------------------------------------

def test_registry_resolves_bandits():
    assert get_model("bandit") is bandit
    assert get_model("bandit_v2") is bandit_v2


def _session_files(tmp_path, version):
    cfg = VERSIONS[version][2]().to_dict()
    stems = (cfg.get("kwargs") or cfg["model"])["stems"]
    cfg.update({"audio": {"chunk_size": 8192, "num_channels": 2, "sample_rate": 8000},
                "training": {"instruments": list(stems)},
                "inference": {"num_overlap": 2, "batch_size": 2, "normalize": False}})
    cfg_path = str(tmp_path / f"{version}.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    return cfg_path, stems


def test_bf16_session_runs_bandit_v2_f32_like_jax(tmp_path):
    """A bf16 session calls bandit_v2 on the f32 weights (no prepared bf16
    copy); its stems match the JAX session's on one checkpoint file."""
    from sesa_tpu.runtime.session import InferenceSession as JaxSession

    cfg_path, stems = _session_files(tmp_path, "bandit_v2")
    ckpt = str(tmp_path / "bandit_v2.ckpt")
    torch.save(_state_dict("bandit_v2"), ckpt)
    sess = InferenceSession.create("bandit_v2", cfg_path, ckpt, compute_dtype=torch.bfloat16,
                                   device="cpu")
    jsess = JaxSession.create("bandit_v2", cfg_path, ckpt, compute_dtype=None)
    assert sess.instruments == jsess.instruments == list(stems)
    song = (np.random.default_rng(7).standard_normal((2, 12000)) * 0.2).astype(np.float32)
    got, ref = sess.separate(song), jsess.separate(song)
    assert not sess._prepared and sess.rescues == 0
    assert list(got) == list(ref)
    for name in got:
        assert got[name].shape == song.shape
        np.testing.assert_allclose(got[name], ref[name], atol=ATOL)


@pytest.mark.parametrize("version", ["bandit", "bandit_v2"])
def test_cli_separates(tmp_path, version):
    cfg_path, stems = _session_files(tmp_path, version)
    song = (np.random.default_rng(8).standard_normal((2, 9000)) * 0.2).astype(np.float32)
    (tmp_path / "in").mkdir()
    write_audio(str(tmp_path / "in" / "song.wav"), song, 8000)
    sessions = []
    rc = cli_main(["--model_type", version, "--config_path", cfg_path,
                   "--input_folder", str(tmp_path / "in"), "--store_dir", str(tmp_path / "out"),
                   "--force_cpu"], session_out=sessions)
    assert rc == 0 and not sessions[0]._prepared
    for name in stems:
        out, sr = read_audio(str(tmp_path / "out" / f"song_{name}.wav"))
        assert sr == 8000 and out.shape == song.shape and np.isfinite(out).all()
