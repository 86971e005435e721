"""The port's post-processing (ensemble, phase fixer, Apollo enhancement),
its streaming audio I/O and the device transport of demix held against
sesa_tpu on the CPU, and the slice as a whole: two small separation models ->
avg_wave ensemble -> phase fix -> a small Apollo, port against JAX package."""

import importlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_collections import ConfigDict

from sesa_tpu.models import apollo as jax_apollo
from sesa_tpu.models import bs_roformer as jax_bs
from sesa_tpu.models import mel_band_conformer as jax_mbc
from sesa_tpu.postprocess import ensemble as jax_ens
from sesa_tpu.postprocess import phase_fixer as jax_pf
from sesa_tpu_torch import apollo_processing
from sesa_tpu_torch.audio_io import AudioReader, AudioWriter, read_audio, write_audio
from sesa_tpu_torch.configs import AttrDict
from sesa_tpu_torch.convert.from_jax import params_from_jax
from sesa_tpu_torch.models import apollo, bs_roformer, mel_band_conformer
from sesa_tpu_torch.postprocess import ensemble as ens
from sesa_tpu_torch.postprocess import phase_fixer as pf
from sesa_tpu_torch.runtime.session import InferenceSession
from tests.test_roformer import bs_model_cfg


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch: with the tier-1 run's six workers on
    eight cores, torch's thread pools spin against each other (a session
    test of 0.5 s alone took 40 s beside five busy processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


jax_demix = importlib.import_module("sesa_tpu.runtime.demix")
port_demix = importlib.import_module("sesa_tpu_torch.runtime.demix")

SR = 16000


def _waves(n, length=6000, seed=0, ragged=True):
    """n stereo waveforms whose lengths differ by a few samples."""
    rng = np.random.default_rng(seed)
    return [(0.2 * rng.standard_normal((2, length - (3 * i if ragged else 0))))
            .astype(np.float32) for i in range(n)]


def _snr_db(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return 10 * np.log10((ref ** 2).sum() / max(((got - ref) ** 2).sum(), 1e-300))


def _inner_snr_db(got, ref):
    """SNR over the 2048/512 STFT bins away from DC and Nyquist, of the
    frames away from the two ends. The phase fixer blends wrapped angles, so
    a bin whose target angle is +-pi moves by 2 pi (1 - blend) with the sign
    of a rounding error. Two families of bins sit exactly there, whatever the
    audio: the DC and Nyquist bins of every frame (their imaginary part is
    +-0), and every bin of the first and last frame (the reflect padding
    makes the frame symmetric about its centre, so its spectrum is real up
    to rounding). Two transforms (a DFT matrix, an FFT) do not share those
    signs, so these bins differ wholesale: a property of the algorithm. Left
    out: 1024 samples at each end (the edge frames' reach) and 8 bins at each
    end of the spectrum (the Hann window leaks a few)."""
    def inner(a):
        a = torch.from_numpy(np.array(a, dtype=np.float32))[:, 1024:-1024]
        return torch.stft(a, 2048, 512, window=torch.hann_window(2048), center=False,
                          return_complex=True)[:, 8:-8]

    g, r = inner(got), inner(ref)
    return 10 * np.log10(float(r.abs().pow(2).sum()) / float((g - r).abs().pow(2).sum()))


# --------------------------------------------------------------------------
# ensemble
# --------------------------------------------------------------------------

def test_methods_are_the_jax_packages():
    assert ens.ENSEMBLE_METHODS == jax_ens.ENSEMBLE_METHODS and len(ens.ENSEMBLE_METHODS) == 7


@pytest.mark.parametrize("method", ens.ENSEMBLE_METHODS)
@pytest.mark.parametrize("n", [2, 3])
def test_ensemble_waveforms_matches_jax(method, n):
    """Host numpy and scipy on both sides: equal to 1e-6 (the *_fft methods
    run scipy's STFT in double)."""
    waves = _waves(n, seed=n)
    ref = jax_ens.ensemble_waveforms(waves, method)
    got = ens.ensemble_waveforms(waves, method)
    assert got.shape == ref.shape == (2, 6000 - 3 * (n - 1)) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-6)


@pytest.mark.parametrize("weights", [[1.0, 3.0], [0.2, 0.5, 0.3]])
def test_weighted_average_matches_jax(weights):
    waves = _waves(len(weights), seed=7)
    ref = jax_ens.ensemble_waveforms(waves, "avg_wave", weights)
    np.testing.assert_allclose(ens.ensemble_waveforms(waves, "avg_wave", weights), ref, atol=1e-6)
    dev = ens.ensemble_waveforms_device([torch.from_numpy(w) for w in waves], "avg_wave",
                                        weights)
    np.testing.assert_allclose(dev.numpy(), ref, atol=1e-6)


@pytest.mark.parametrize("method", ["avg_wave", "median_wave", "max_wave", "min_wave"])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_device_combine_matches_host_and_jax(method, n):
    """Tensors in, tensor out, equal to the host numpy result; the median of
    an even count averages the two middle values (numpy and jnp do; a bare
    torch.median would return the lower one)."""
    waves = _waves(n, seed=10 + n)
    host = ens.ensemble_waveforms(waves, method)
    got = ens.ensemble_waveforms_device([torch.from_numpy(w) for w in waves], method)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), host, atol=1e-6)
    ref = jax_ens.ensemble_waveforms_device([jnp.asarray(w) for w in waves], method)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_short_spectral_input_falls_back_to_the_average():
    waves = _waves(2, length=200, ragged=False)
    np.testing.assert_allclose(ens.ensemble_waveforms(waves, "max_fft"),
                               ens.ensemble_waveforms(waves, "avg_wave"), atol=0)


def test_ensemble_errors_are_kept():
    waves = _waves(2)
    with pytest.raises(ValueError, match="Invalid method"):
        ens.ensemble_waveforms(waves, "mean")
    with pytest.raises(ValueError, match="no input"):
        ens.ensemble_waveforms([], "avg_wave")
    with pytest.raises(ValueError, match="counts must match"):
        ens.ensemble_waveforms(waves, "avg_wave", [1.0])
    tensors = [torch.from_numpy(w) for w in waves]
    with pytest.raises(ValueError, match="waveform methods only"):
        ens.ensemble_waveforms_device(tensors, "max_fft")
    with pytest.raises(ValueError, match="Invalid method"):
        ens.ensemble_waveforms_device(tensors, "mean")
    with pytest.raises(ValueError, match="no input"):
        ens.ensemble_waveforms_device([], "avg_wave")
    with pytest.raises(ValueError, match="counts must match"):
        ens.ensemble_waveforms_device(tensors, "avg_wave", [1.0, 2.0, 3.0])


# --------------------------------------------------------------------------
# streaming audio I/O and the file-level ensemble
# --------------------------------------------------------------------------

@pytest.mark.parametrize("subtype", ["PCM_16", "PCM_24", "FLOAT"])
def test_audio_reader_streams_what_read_audio_reads(tmp_path, subtype):
    audio = _waves(1, length=5000)[0]
    path = write_audio(str(tmp_path / "a.wav"), audio, SR, subtype=subtype)
    whole, sr = read_audio(path)
    with AudioReader(path) as r:
        assert (r.samplerate, r.channels, r.frames) == (SR, 2, 5000)
        parts = [r.read(2048), r.read(2048), r.read(2048)]
        assert r.read(10).shape == (2, 0)
    assert [p.shape[1] for p in parts] == [2048, 2048, 904]
    np.testing.assert_array_equal(np.concatenate(parts, axis=1), whole)
    # PCM: written at 32767 (8388607) per unit, read at 32768 (8388608), truncated
    np.testing.assert_allclose(whole, audio, atol=1e-7 if subtype == "FLOAT" else 7e-5)


def test_audio_writer_appends_and_renames_flac(tmp_path):
    audio = _waves(1, length=3000)[0]
    with AudioWriter(str(tmp_path / "b.flac"), SR, 2, subtype="PCM_24") as w:
        assert w.path.endswith("b.wav")
        w.write(audio[:, :1000])
        w.write(audio[:, 1000:])
        with pytest.raises(ValueError, match="expected"):
            w.write(audio[0])
    got, _ = read_audio(w.path)
    np.testing.assert_allclose(got, audio, atol=2e-7 + 2.0 ** -23)
    with pytest.raises(ValueError, match="subtype"):
        AudioWriter(str(tmp_path / "c.wav"), SR, 2, subtype="PCM_8")


@pytest.fixture()
def stem_files(tmp_path):
    paths = []
    for i, w in enumerate(_waves(3, length=70000, seed=3)):
        paths.append(write_audio(str(tmp_path / f"m{i}.wav"), 0.5 * w, SR, subtype="PCM_24"))
    return paths


@pytest.mark.parametrize("method,weights", [("avg_wave", None), ("avg_wave", [1.0, 2.0, 3.0]),
                                            ("median_wave", None), ("min_fft", None)])
def test_ensemble_files_matches_in_memory_and_jax(stem_files, tmp_path, method, weights):
    """Streaming 32768-frame buffers against the one-shot combine (waveform
    methods are pointwise, so only the PCM_24 quantisation differs) and
    against the JAX package's file ensemble (same buffers, same scipy)."""
    seen = []
    out = ens.ensemble_files(stem_files, method, str(tmp_path / "out" / "e.wav"),
                             weights=weights, progress_cb=seen.append)
    got, sr = read_audio(out)
    assert sr == SR and got.shape == (2, 70000 - 6) and seen[-1] == 1.0 and len(seen) == 3
    ref_path = jax_ens.ensemble_files(stem_files, method, str(tmp_path / "ref.wav"),
                                      weights=weights)
    np.testing.assert_allclose(got, read_audio(ref_path)[0], atol=3e-7)
    if not method.endswith("_fft"):
        waves = [read_audio(p)[0] for p in stem_files]
        np.testing.assert_allclose(got, ens.ensemble_waveforms(waves, method, weights),
                                   atol=2e-7 + 2.0 ** -23)


def test_ensemble_files_errors_are_kept(stem_files, tmp_path):
    out = str(tmp_path / "e.wav")
    with pytest.raises(ValueError, match="Invalid method"):
        ens.ensemble_files(stem_files, "mean", out)
    with pytest.raises(ValueError, match="no input"):
        ens.ensemble_files([], "avg_wave", out)
    with pytest.raises(ValueError, match="counts must match"):
        ens.ensemble_files(stem_files, "avg_wave", out, weights=[1.0])
    other_sr = write_audio(str(tmp_path / "sr.wav"), _waves(1)[0], 8000, subtype="PCM_16")
    with pytest.raises(ValueError, match="sample-rate mismatch"):
        ens.ensemble_files([stem_files[0], other_sr], "avg_wave", out)
    mono = write_audio(str(tmp_path / "mono.wav"), _waves(1)[0][:1], SR, subtype="PCM_16")
    with pytest.raises(ValueError, match="channel-count mismatch"):
        ens.ensemble_files([stem_files[0], mono], "avg_wave", out)


def test_ensemble_main(stem_files, tmp_path, capsys):
    out = str(tmp_path / "cli.wav")
    rc = ens.main(["--files", *stem_files[:2], "--type", "max_wave", "--weights", "1", "2",
                   "--output", out])
    printed = capsys.readouterr().out
    assert rc == 0 and "[SESA_PROGRESS]100" in printed and f"Ensemble written: {out}" in printed
    waves = [read_audio(p)[0] for p in stem_files[:2]]
    np.testing.assert_allclose(read_audio(out)[0], ens.ensemble_waveforms(waves, "max_wave"),
                               atol=2e-7 + 2.0 ** -23)


# --------------------------------------------------------------------------
# phase fixer
# --------------------------------------------------------------------------

def _pair(length=12000, seed=0, drift=0):
    """A mix and a stem of it with harmonic and noise content and no DC
    offset in any frame worth naming."""
    rng = np.random.default_rng(seed)
    t = np.arange(length) / SR
    tone = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 1870 * t + 1.0)
    mix = np.stack([tone, 0.7 * tone]) + 0.05 * rng.standard_normal((2, length))
    stem = 0.6 * mix + 0.05 * rng.standard_normal((2, length))
    return mix.astype(np.float32), stem[:, :length - drift].astype(np.float32)


def test_blend_factors_match_jax_and_refuse_crossed_cutoffs():
    freqs = np.linspace(0.0, 8000.0, 1025).astype(np.float32)
    ref = jax_pf.blend_factors(jnp.asarray(freqs), 500.0, 3000.0, 0.25, 1.4)
    got = pf.blend_factors(torch.from_numpy(freqs), 500.0, 3000.0, 0.25, 1.4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    with pytest.raises(ValueError, match="must be less than"):
        pf.blend_factors(torch.from_numpy(freqs), 9000.0, 9000.0, 0.25, 1.4)
    assert pf.SOURCE_MODELS == jax_pf.SOURCE_MODELS and pf.TARGET_MODELS == jax_pf.TARGET_MODELS


def test_blend_spectra_matches_jax_on_the_same_spectra():
    """Same RI spectra into both: away from the wrap at +-pi the two agree to
    f32 rounding; compared by SNR (>= 60 dB), because a bin within one ulp of
    +-pi moves by 2 pi (1 - blend) and max error alone would flag it."""
    rng = np.random.default_rng(2)
    s = rng.standard_normal((2, 1025, 9, 2)).astype(np.float32)
    t = rng.standard_normal((2, 1025, 9, 2)).astype(np.float32)
    ref = jax_pf.blend_spectra(jnp.asarray(s), jnp.asarray(t), SR, 500.0, 5000.0, 0.25, 1.4)
    got = pf.blend_spectra(torch.from_numpy(s), torch.from_numpy(t), SR, 500.0, 5000.0, 0.25, 1.4)
    assert _snr_db(got.numpy(), np.asarray(ref)) >= 60.0


@pytest.mark.parametrize("drift", [0, 300])
def test_phase_fix_arrays_matches_jax(drift):
    """Against the JAX package (DFT-matrix STFT there, FFT here), by SNR
    >= 50 dB over the bins away from DC and Nyquist (see _inner_snr_db);
    numpy or tensors in, and a tensor out with ``return_device``."""
    mix, stem = _pair(drift=drift)
    ref = jax_pf.phase_fix_arrays(mix, stem, SR, high_cutoff=5000.0)
    got = pf.phase_fix_arrays(mix, stem, SR, high_cutoff=5000.0, device="cpu")
    assert got.shape == ref.shape == mix.shape and isinstance(got, np.ndarray)
    assert _inner_snr_db(got, ref) >= 50.0
    dev = pf.phase_fix_arrays(torch.from_numpy(mix), torch.from_numpy(stem), SR,
                              high_cutoff=5000.0, return_device=True)
    assert isinstance(dev, torch.Tensor)
    np.testing.assert_array_equal(dev.numpy(), got)


def test_ensemble_phase_fix_device_matches_jax_and_the_two_steps():
    mix, stem = _pair(seed=1)
    stems = [stem, 0.8 * stem + 0.01]
    ref = np.asarray(jax_pf.ensemble_phase_fix_device(
        jnp.asarray(mix), [jnp.asarray(s) for s in stems], SR, "avg_wave", high_cutoff=5000.0))
    got = pf.ensemble_phase_fix_device(torch.from_numpy(mix), [torch.from_numpy(s) for s in stems],
                                       SR, "avg_wave", high_cutoff=5000.0)
    assert isinstance(got, torch.Tensor) and got.shape == mix.shape
    assert _inner_snr_db(got.numpy(), ref) >= 50.0
    two_steps = pf.phase_fix_arrays(mix, ens.ensemble_waveforms(stems, "avg_wave"), SR,
                                    high_cutoff=5000.0, device="cpu")
    np.testing.assert_allclose(got.numpy(), two_steps, atol=1e-6)
    weighted = pf.ensemble_phase_fix_device(torch.from_numpy(mix),
                                            [torch.from_numpy(s) for s in stems], SR, "avg_wave",
                                            weights=[3.0, 1.0], high_cutoff=5000.0)
    assert not np.allclose(weighted.numpy(), got.numpy(), atol=1e-4)


def test_phase_fix_errors_are_kept():
    mix, stem = _pair(length=6000)
    with pytest.raises(ValueError, match="same audio span"):
        pf.phase_fix_arrays(mix, stem[:, :5000], SR, device="cpu")
    with pytest.raises(ValueError, match="must be less than"):
        pf.phase_fix_arrays(mix, stem, SR, low_cutoff=9000.0, high_cutoff=500.0, device="cpu")
    tm, ts = torch.from_numpy(mix), torch.from_numpy(stem)
    with pytest.raises(ValueError, match="waveform methods only"):
        pf.ensemble_phase_fix_device(tm, [ts, ts], SR, "median_fft")
    with pytest.raises(ValueError, match="no input"):
        pf.ensemble_phase_fix_device(tm, [], SR)
    with pytest.raises(ValueError, match="same audio span"):
        pf.ensemble_phase_fix_device(tm, [ts, ts[:, :5000]], SR)
    with pytest.raises(ValueError, match="counts must match"):
        pf.ensemble_phase_fix_device(tm, [ts, ts], SR, weights=[1.0])


def test_process_phase_fix_writes_the_fixed_instrumental(tmp_path):
    mix, stem = _pair()
    src = write_audio(str(tmp_path / "song_vocals.wav"), mix, SR)
    tgt = write_audio(str(tmp_path / "song_instrumental.wav"), stem, SR)
    out, msg = pf.process_phase_fix(src, tgt, str(tmp_path / "fixed"), high_cutoff=5000.0,
                                    output_format="wav", device="cpu")
    assert msg == "Phase fix completed successfully!"
    assert os.path.basename(out) == "song (Fixed Instrumental).wav"
    want = pf.phase_fix_arrays(mix, stem, SR, high_cutoff=5000.0, device="cpu")
    np.testing.assert_allclose(read_audio(out)[0], want, atol=1e-6)
    other = write_audio(str(tmp_path / "other.wav"), stem, 8000)
    out, msg = pf.process_phase_fix(src, other, str(tmp_path / "fixed"), device="cpu")
    assert out is None and "Sample rates" in msg


# --------------------------------------------------------------------------
# demix: tensors in, tensors out
# --------------------------------------------------------------------------

APOLLO_TINY = {"sr": SR, "win": 20, "feature_dim": 16, "layer": 1}


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), tree)


@pytest.fixture(scope="module")
def models():
    """Three small models with the same weights on both sides: bs_roformer,
    mel_band_conformer (each one 'vocals' stem) and Apollo."""
    out = {}
    for name, jmod, pmod, mcfg in (
            ("bs", jax_bs, bs_roformer, bs_model_cfg(num_stems=1, depth=1)),
            ("mel", jax_mbc, mel_band_conformer,
             dict(dim=32, depth=1, stereo=True, num_stems=1, time_conformer_depth=1,
                  freq_conformer_depth=1, num_bands=8, dim_head=8, heads=4, ff_mult=2,
                  conv_expansion_factor=2, conv_kernel_size=7, sample_rate=44100,
                  stft_n_fft=128, stft_hop_length=32, stft_win_length=128,
                  mask_estimator_depth=1)),
            ("apollo", jax_apollo, apollo, APOLLO_TINY)):
        jcfg, cfg = ConfigDict({"model": mcfg}), AttrDict({"model": mcfg})
        tree = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(len(out)), jcfg))
        if name == "apollo":
            tree = _perturbed(tree, 5)
            params = params_from_jax(tree, "apollo", cfg)
        elif name == "mel":
            params = params_from_jax(tree, "mel_band_conformer", cfg)
        else:
            params = params_from_jax(tree, bs_roformer.spec_from_config(mcfg))
        out[name] = dict(
            jparams=jax.tree.map(jnp.asarray, tree), params=params,
            japply=lambda p, c, _m=jmod, _c=jcfg: _stems(_m.apply(p, _c, c)),
            apply=lambda p, c, _m=pmod, _c=cfg: _stems(_m.apply(p, _c, c)))
    return out


def _stems(y):
    return y if y.ndim == 4 else y[:, None]


def _song(length, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(length) / SR
    tone = 0.3 * np.sin(2 * np.pi * 330 * t) + 0.1 * np.sin(2 * np.pi * 2100 * t)
    noisy = np.stack([tone, -0.5 * tone]) + 0.05 * rng.standard_normal((2, length))
    return noisy.astype(np.float32)


def test_demix_takes_a_tensor_and_returns_one(models):
    """A tensor mix and transport="device" give the f32 result exactly,
    without the host copy; ``stems`` selects a subset."""
    m = models["bs"]
    spec = port_demix.DemixSpec(chunk_size=4096, num_overlap=2, batch_size=2)
    mix = _song(9000)
    host = port_demix.demix(m["apply"], m["params"], mix, spec, device="cpu")
    dev = port_demix.demix(m["apply"], m["params"], torch.from_numpy(mix), spec, device="cpu",
                           transport="device")
    assert isinstance(host, np.ndarray) and isinstance(dev, torch.Tensor)
    assert dev.dtype == torch.float32 and dev.shape == (1, 2, 9000)
    np.testing.assert_array_equal(dev.numpy(), host)
    sub = port_demix.demix(m["apply"], m["params"], mix, spec, device="cpu", transport="device",
                           stems=[0, 0])
    assert sub.shape == (2, 2, 9000)
    np.testing.assert_array_equal(sub[1].numpy(), host[0])


def test_session_separate_on_device_equals_host(models):
    cfg = {"audio": {"chunk_size": 4800, "num_channels": 2, "sample_rate": SR},
           "model": APOLLO_TINY, "inference": {"num_overlap": 2, "batch_size": 2,
                                               "normalize": True}}
    s = InferenceSession.create("apollo", cfg, device="cpu", compute_dtype=None)
    s.params = models["apollo"]["params"]
    mix = _song(11000, seed=4) + 0.1
    host = s.separate(mix, use_tta=True)["restored"]
    dev = s.separate(torch.from_numpy(mix), use_tta=True, transport="device")["restored"]
    assert isinstance(dev, torch.Tensor) and isinstance(host, np.ndarray)
    np.testing.assert_allclose(dev.numpy(), host, atol=1e-6)  # the stats: torch or numpy
    extras = s.separate_with_extras(torch.from_numpy(mix), extract_instrumental=True,
                                    transport="device")
    assert all(isinstance(v, torch.Tensor) for v in extras.values())
    # the int16 slab transport (ported since): numpy stems within two
    # quantisation steps of the slab's peak (the TTA sums three separations)
    q = s.separate(mix, use_tta=True, transport="int16")["restored"]
    assert isinstance(q, np.ndarray)
    assert np.abs(q - host).max() <= 2 * np.abs(host).max() / 32767


def test_mono_session_keeps_one_channel(models):
    """The mid/side session: num_channels 1, so a mono input is not repeated."""
    cfg = {"audio": {"chunk_size": 4800, "sample_rate": SR}, "model": APOLLO_TINY}
    s = InferenceSession.create("apollo", cfg, device="cpu", compute_dtype=None, num_channels=1)
    seen = []
    real = s._model_apply

    def spy(dtype):
        fn = real(dtype)
        return lambda p, c: (seen.append(tuple(c.shape)), fn(p, c))[1]

    s._model_apply = spy
    out = s.separate(_song(6000)[0])["restored"]
    assert out.shape == (1, 6000) and all(shape[1] == 1 for shape in seen)


# --------------------------------------------------------------------------
# the slice as a whole
# --------------------------------------------------------------------------

def test_chain_matches_jax(models):
    """Two separations -> avg_wave -> phase fix against the mix -> Apollo,
    every stage through demix: the port with tensors kept between stages
    against the JAX package's host functions, in f32 on the CPU. Each model
    agrees to 5e-4; the phase fix is held to >= 50 dB over the bins away from
    DC and Nyquist (see _inner_snr_db), and so is the whole, since Apollo
    carries the difference of those two bins through."""
    mix = _song(12000, seed=6)
    specs = {"bs": dict(chunk_size=4096), "mel": dict(chunk_size=2048),
             "apollo": dict(chunk_size=4800)}

    def jrun(name, audio):
        m = models[name]
        return jax_demix.demix(m["japply"], m["jparams"], audio,
                               jax_demix.DemixSpec(num_overlap=2, batch_size=2, **specs[name]))[0]

    ens_ref = jax_ens.ensemble_waveforms([jrun("bs", mix), jrun("mel", mix)], "avg_wave")
    fixed_ref = jax_pf.phase_fix_arrays(mix, ens_ref, SR, high_cutoff=5000.0)
    ref = jrun("apollo", fixed_ref)

    def run(name, audio):
        m = models[name]
        return port_demix.demix(m["apply"], m["params"], audio,
                                port_demix.DemixSpec(num_overlap=2, batch_size=2, **specs[name]),
                                device="cpu", transport="device")[0]

    with torch.inference_mode():
        tmix = torch.from_numpy(mix)
        v1, v2 = run("bs", tmix), run("mel", tmix)
        fixed = pf.ensemble_phase_fix_device(tmix, [v1, v2], SR, "avg_wave", high_cutoff=5000.0)
        got = run("apollo", fixed)
    assert isinstance(fixed, torch.Tensor) and isinstance(got, torch.Tensor)
    assert got.shape == ref.shape == (2, 12000) and bool(torch.isfinite(got).all())
    assert _inner_snr_db(fixed.numpy(), fixed_ref) >= 50.0
    assert _inner_snr_db(got.numpy(), ref) >= 40.0


# --------------------------------------------------------------------------
# Apollo enhancement of files
# --------------------------------------------------------------------------

@pytest.fixture()
def apollo_patch(models, monkeypatch):
    """process_with_apollo with a small seeded session in place of a preset."""
    made = []

    def fake_session(model_name, chunk_size, overlap, num_channels=2, **kw):
        cfg = {"audio": {"chunk_size": 4800, "sample_rate": SR}, "model": APOLLO_TINY}
        s = InferenceSession.create("apollo", cfg, device="cpu", compute_dtype=None,
                                    num_overlap=overlap, num_channels=num_channels)
        s.params = models["apollo"]["params"]
        made.append((model_name, chunk_size, num_channels, s))
        return s

    monkeypatch.setattr(apollo_processing, "_apollo_session", fake_session)
    return made


def test_process_with_apollo_normal_and_fallback(apollo_patch, tmp_path):
    song = _song(9000, seed=2)
    good = write_audio(str(tmp_path / "my song (vocals).wav"), song, SR)
    bad = str(tmp_path / "broken.wav")
    with open(bad, "wb") as f:
        f.write(b"not a wav file")
    seen = []
    out = apollo_processing.process_with_apollo(
        [good, None, bad, str(tmp_path / "missing.wav")], str(tmp_path / "enh"), 19, 2,
        "normal_method", "MP3 Enhancer", "Apollo Universal Model",
        progress=lambda v, desc="": seen.append((v, desc)), device="cpu")
    assert out[1] is None and out[2] == bad and out[3].endswith("missing.wav")
    assert os.path.basename(out[0]) == "my_song__vocals_Enhanced.wav"
    name, chunk, channels, session = apollo_patch[0]
    assert (name, chunk, channels) == ("MP3 Enhancer", 19, 2)
    got, _ = read_audio(out[0])
    np.testing.assert_allclose(got, session.separate(song)["restored"], atol=1e-6)
    assert [v for v, _ in seen] == [80.0, 90.0] and "(2/2)" in seen[1][1]


def test_process_with_apollo_mid_side(apollo_patch, tmp_path):
    song = _song(9000, seed=3)
    path = write_audio(str(tmp_path / "song.wav"), song, SR)
    out = apollo_processing.process_with_apollo(
        [path], str(tmp_path / "enh"), 19, 2, "mid_side_method", "MP3 Enhancer",
        "Apollo Universal Model", device="cpu")
    assert os.path.basename(out[0]) == "song_Mid_Side_Enhanced.wav"
    name, _, channels, session = apollo_patch[0]
    assert (name, channels) == ("Apollo Universal Model", 1)
    mid, side = (song[0] + song[1]) * 0.5, (song[0] - song[1]) * 0.5
    mid_e = session.separate(mid[None])["restored"][0]
    side_e = session.separate(side[None])["restored"][0]
    got, _ = read_audio(out[0])
    np.testing.assert_allclose(got, np.stack([mid_e + side_e, mid_e - side_e]), atol=1e-6)


def _fake_requests(calls, status=404):
    """A ``requests`` stand-in that records each URL and answers ``status``."""
    import types

    mod = types.ModuleType("requests")

    def get(url, stream=False, timeout=None):
        calls.append(url)
        return types.SimpleNamespace(status_code=status, headers={}, content=b"")

    mod.get = get
    return mod


def test_apollo_session_needs_the_presets_files(tmp_path, monkeypatch):
    """The presets' files come through registry.download_file (network
    mocked): a failed download raises, files already in place are kept."""
    import sys

    from sesa_tpu_torch.registry import models as registry

    assert set(apollo_processing.APOLLO_MODELS) == {
        "MP3 Enhancer", "Lew Vocal Enhancer", "Lew Vocal Enhancer v2 (beta)",
        "Apollo Universal Model"}
    calls = []
    monkeypatch.setitem(sys.modules, "requests", _fake_requests(calls))
    monkeypatch.setattr(registry, "CHECKPOINT_DIR", str(tmp_path / "ckpts"))
    ckpt_url, config_url = apollo_processing.APOLLO_MODELS["Apollo Universal Model"]
    with pytest.raises(RuntimeError, match="apollo_universal_model.ckpt"):
        apollo_processing._apollo_session("Apollo Universal Model", 19, 2, device="cpu")
    assert calls == [ckpt_url] and os.listdir(tmp_path / "ckpts") == []  # no partial file
    # files in place are kept and the session is built from them
    made = []
    monkeypatch.setattr(InferenceSession, "create",
                        classmethod(lambda cls, *a, **k: made.append((a, k)) or "session"))
    for url in apollo_processing.APOLLO_MODELS["MP3 Enhancer"]:
        (tmp_path / "ckpts" / os.path.basename(url)).write_bytes(b"in place")
    assert apollo_processing._apollo_session("MP3 Enhancer", 19, 2, num_channels=1,
                                             device="cpu") == "session"
    assert apollo_processing._apollo_session("MP3 Enhancer", 300000, 4,
                                             device="cpu") == "session"
    assert calls == [ckpt_url]
    files = ("apollo", str(tmp_path / "ckpts" / "apollo.yaml"),
             str(tmp_path / "ckpts" / "pytorch_model.bin"))
    assert made == [(files, dict(chunk_size=19 * 44100, num_overlap=2, num_channels=1,
                                 device="cpu")),
                    (files, dict(chunk_size=300000, num_overlap=4, num_channels=2,
                                 device="cpu"))]
    # a preset whose download fails leaves the files as they are
    paths = [str(tmp_path / "a.wav")]
    assert apollo_processing.process_with_apollo(
        paths, str(tmp_path / "enh"), 19, 2, "normal_method", "Lew Vocal Enhancer",
        "MP3 Enhancer", device="cpu") == paths
    assert calls[-1] == apollo_processing.APOLLO_MODELS["Lew Vocal Enhancer"][0]
    if not torch.cuda.is_available():  # no fallback for a missing device
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            apollo_processing.process_with_apollo(paths, str(tmp_path / "enh"), 19, 2,
                                                  "normal_method", "MP3 Enhancer", "MP3 Enhancer")
    from sesa_tpu.helpers import sanitize_filename
    for name in ("a b/c?.mp3#x", "  weird  (name) [1].flac", "plain.wav"):
        assert apollo_processing.sanitize_filename(name) == sanitize_filename(name)
