"""The port's app layer held against sesa_tpu's on the CPU: helpers,
clean_model, config_manager, cache, download, the processing flows (a fake
session shared by both packages, then a small real bs_roformer loaded from a
checkpoint file through the registry), benchmark.py, warmup.py and
runtime/profiling.py; chip_smoke's ``roformer_state_dict``; and the two
repairs: TF32 flags scoped to a model call, soundfile for non-WAV audio."""

import functools
import json
import os
import re
import sys
import types

import numpy as np
import pytest
import torch
import yaml

import jax
from ml_collections import ConfigDict

import chip_smoke
import sesa_tpu.config_manager as jcm
import sesa_tpu.download as jdl
import sesa_tpu.helpers as jhelpers
import sesa_tpu.processing as jproc
import sesa_tpu.registry.models as jreg
import sesa_tpu_torch.config_manager as pcm
import sesa_tpu_torch.download as pdl
import sesa_tpu_torch.helpers as phelpers
import sesa_tpu_torch.processing as pproc
import sesa_tpu_torch.registry.models as preg
from sesa_tpu.audio_io import read_audio as jread
from sesa_tpu.audio_io import write_audio as jwrite
from sesa_tpu.models import bs_roformer as jax_bs
from sesa_tpu.models import mel_band_roformer as jax_mel
from sesa_tpu_torch import audio_io
from sesa_tpu_torch.configs import AttrDict
from sesa_tpu_torch.convert.from_jax import params_from_jax
from sesa_tpu_torch.models import bs_roformer, mel_band_roformer, scnet
from tests.test_roformer import bs_model_cfg, export_state_dict, mel_model_cfg
from tests.test_scnet import tiny_kwargs as scnet_tiny_kwargs
from tests.test_warmup import TINY_MDX23C_YAML

SR = 44100
# end-to-end f32 tolerance of the JAX package against its torch oracles
# (BASELINE.md:88)
ATOL = 5e-4
TS = re.compile(r"^\d{14}_|_\d{14}(?=\.)")  # the timestamp in an output name


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the tier-1 run's six workers share eight cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _song(seconds, seed=0, channels=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((channels, int(seconds * SR))) * 0.2).astype(np.float32)


def _homes(root, monkeypatch):
    """Each package's workspace (helpers, registry, config) in its own
    directory under ``root``."""
    out = {}
    for key, helpers, reg, cm in (("jax", jhelpers, jreg, jcm), ("port", phelpers, preg, pcm)):
        home = os.path.join(str(root), key)
        for attr, sub in (("INPUT_DIR", "input"), ("OUTPUT_DIR", "output"),
                          ("OLD_OUTPUT_DIR", "old_output"), ("ENSEMBLE_DIR", "ensemble"),
                          ("AUTO_ENSEMBLE_TEMP", "auto_ensemble_temp"),
                          ("AUTO_ENSEMBLE_OUTPUT", "ensemble_output")):
            monkeypatch.setattr(helpers, attr, os.path.join(home, sub))
        monkeypatch.setattr(helpers, "BASE_DIR", home)
        monkeypatch.setattr(reg, "BASE_DIR", home)
        monkeypatch.setattr(reg, "CHECKPOINT_DIR", os.path.join(home, "ckpts"))
        monkeypatch.setattr(reg, "CUSTOM_MODELS_FILE", os.path.join(home, "custom_models.json"))
        monkeypatch.setattr(cm, "CONFIG_DIR", os.path.join(home, "config"))
        monkeypatch.setattr(cm, "CONFIG_FILE", os.path.join(home, "config", "config.json"))
        os.makedirs(os.path.join(home, "ckpts"))
        out[key] = home
    return out


@pytest.fixture()
def homes(tmp_path, monkeypatch):
    return _homes(tmp_path, monkeypatch)


# --------------------------------------------------------------------------
# helpers, clean_model, config_manager, cache, download
# --------------------------------------------------------------------------

NAMES = ["a b/c*d.wav", "a b/c?.mp3#x", "  weird  (name) [1].flac", "plain.wav",
         "song.mp3?dl=1", "ünïcode – title.wav", "..hidden", ""]
MODEL_NAMES = ["VOCALS-InstVocHQ", "Some New Model (by someone)",
               "VOCALS-BS-Roformer_1297 (by viperx)", "INST-Mel-Roformer v1e (by unwa)",
               "weird-name_v2 (x) (y)", ""]


@pytest.mark.parametrize("name", NAMES)
def test_sanitize_filename_matches_jax(name):
    assert phelpers.sanitize_filename(name) == jhelpers.sanitize_filename(name)


@pytest.mark.parametrize("name", MODEL_NAMES + ["A ⭐", 3])
def test_clean_model_name_matches_jax(name):
    from sesa_tpu.clean_model import clean_model_name as jclean
    from sesa_tpu.clean_model import shorten_filename as jshort
    from sesa_tpu_torch.clean_model import CLEAN_NAMES, clean_model_name, shorten_filename

    if isinstance(name, str):
        assert clean_model_name(name) == jclean(name)
        long = name * 5 + ".wav"
        assert shorten_filename(long) == jshort(long)
    assert pcm.clean_model(name) == jcm.clean_model(name)
    assert len(CLEAN_NAMES) == 65


def test_config_manager_round_trip_and_self_heal_match_jax(homes):
    def run(cm):
        cfg = cm.load_config()
        log = [cfg]
        favs = cm.update_favorites(cfg["favorites"], "M1")
        favs = cm.update_favorites(favs, "M2")
        favs = cm.update_favorites(favs, "M1", add=False)
        cm.save_config(favs, dict(cfg["settings"], chunk_size=1000), cfg["presets"])
        log.append(cm.load_config())
        presets = cm.save_preset({}, "p", ["A ⭐", "B"], "avg_wave", overlap=8)
        log += [presets, cm.delete_preset(presets, "p")]
        for bad in ("{not json", "[1, 2]", json.dumps({"settings": None, "favorites": ["X"]})):
            with open(cm.CONFIG_FILE, "w") as f:
                f.write(bad)
            log.append(cm.load_config())
        with open(cm.CONFIG_FILE) as f:
            log.append(json.load(f))
        return log

    port, ref = run(pcm), run(jcm)
    assert port == ref
    assert port[1]["favorites"] == ["M2"] and port[1]["settings"]["chunk_size"] == 1000
    assert port[-2] == {**pcm.DEFAULT_CONFIG, "favorites": ["X"]}


def test_helpers_directories_match_jax(homes):
    for helpers in (jhelpers, phelpers):
        helpers.setup_directories()
        open(os.path.join(helpers.INPUT_DIR, "x.txt"), "w").close()
        os.makedirs(os.path.join(helpers.INPUT_DIR, "sub"))
        open(os.path.join(helpers.OUTPUT_DIR, "take.wav"), "w").close()
        helpers.move_old_files(helpers.OUTPUT_DIR)
        helpers.clear_directory(helpers.INPUT_DIR)
    tree = {k: sorted(os.path.relpath(os.path.join(r, f), h) for r, ds, fs in os.walk(h)
                      for f in fs + ds) for k, h in homes.items()}
    assert tree["port"] == tree["jax"]
    assert "old_output/take_old.wav" in tree["port"]


def test_find_clear_segment_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    t = np.arange(SR * 40) / SR
    env = np.where((t > 12) & (t < 27), 0.5, 0.01)
    track = (env * np.sin(2 * np.pi * 440 * t) + 0.01 * rng.standard_normal(t.size))
    track = np.stack([track, 0.9 * track]).astype(np.float32)
    path = audio_io.write_audio(str(tmp_path / "track.wav"), track, SR)
    s0, e0, seg0 = jhelpers.find_clear_segment(path)
    s1, e1, seg1 = phelpers.find_clear_segment(path)
    assert (s1, e1) == (s0, e0) and 10 <= s1 <= 15
    np.testing.assert_array_equal(seg1, seg0)
    out = phelpers.save_segment(seg1, SR, str(tmp_path / "seg.wav"))
    np.testing.assert_array_equal(audio_io.read_audio(out)[0], seg1[None])


def test_run_matchering_needs_matchering(tmp_path):
    msgs = []
    for helpers in (jhelpers, phelpers):
        with pytest.raises(RuntimeError) as e:
            helpers.run_matchering("a.wav", "b.wav", str(tmp_path / "o.wav"))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "matchering" in msgs[1]


def test_cache_dir_matches_jax_under_sesa_cache_dir(tmp_path, monkeypatch):
    from sesa_tpu.cache import cache_dir as jcache_dir
    from sesa_tpu_torch import cache
    from sesa_tpu_torch.ops import _build

    monkeypatch.setenv("SESA_CACHE_DIR", str(tmp_path / "cache"))
    assert cache.cache_dir() == jcache_dir() == str(tmp_path / "cache")
    assert cache.enable_persistent_cache() is True and os.path.isdir(tmp_path / "cache")
    monkeypatch.delenv("SESA_CACHE_DIR")
    assert cache.cache_dir() == os.path.join(os.path.dirname(cache.__file__), "build")
    assert _build.BUILD_ROOT == cache.cache_dir()  # not set when the tests import it


class _Resp:
    def __init__(self, body):
        self.body = body

    def raise_for_status(self):
        pass

    def iter_content(self, chunk_size=1):
        yield self.body


@pytest.mark.parametrize("url", ["https://example.com/files/my song.wav?x=1",
                                 "https://drive.google.com/file/d/abc",
                                 "https://youtu.be/abc"])
def test_download_callback_matches_jax(homes, tmp_path, monkeypatch, url):
    src = audio_io.write_audio(str(tmp_path / "src.wav"), _song(0.1), SR)
    with open(src, "rb") as f:
        body = f.read()
    fake = types.ModuleType("requests")
    fake.get = lambda u, stream=False, timeout=None: _Resp(body)
    monkeypatch.setitem(sys.modules, "requests", fake)
    for mod in ("gdown", "yt_dlp"):
        monkeypatch.setitem(sys.modules, mod, None)
    res = {}
    for key, dl in (("jax", jdl), ("port", pdl)):
        path, status = dl.download_callback(url)
        res[key] = (path and os.path.relpath(path, homes[key]), status)
        if path:
            res[key + "_data"] = audio_io.read_audio(path)[0]
    assert res["port"] == res["jax"]
    if "example.com" in url:
        assert res["port"] == ("input/my_song.wav", "Downloaded: my_song.wav")
        np.testing.assert_array_equal(res["port_data"], res["jax_data"])
    else:
        assert res["port"][1].startswith("Download error:")


# --------------------------------------------------------------------------
# processing flows with one fake session for both packages
# --------------------------------------------------------------------------

class FakeSession:
    sample_rate = SR
    device = torch.device("cpu")  # where the port's auto ensemble uploads the song

    def separate_with_extras(self, mix, use_tta=False, extract_instrumental=False,
                             demud_phaseremix_inst=False, progress_cb=None, mix_device=None):
        if progress_cb:
            for frac in (0.25, 0.5, 0.75, 1.0):
                progress_cb(frac)
        mix = np.asarray(mix)
        out = {"vocals": mix * 0.5, "male": mix * 0.25}
        if extract_instrumental:
            out["instrumental"] = mix * 0.5 + 0.01
        return out


def _flow(homes, monkeypatch, run):
    """Run ``run(module, key)`` on both packages with the fake session;
    return {key: (updates without timestamps, {name: data})}."""
    res = {}
    for key, proc in (("jax", jproc), ("port", pproc)):
        monkeypatch.setattr(proc, "_make_session", lambda *a, **k: FakeSession())
        updates = list(run(proc, key))
        files = {TS.sub("", os.path.basename(f)): jread(f)[0]
                 for u in updates for f in u["outputs"]}
        steps = [(u["progress"], u["status"], [TS.sub("", os.path.basename(f))
                                               for f in u["outputs"]],
                  {k: v and TS.sub("", os.path.basename(v))
                   for k, v in u.get("slots", {}).items()}) for u in updates]
        res[key] = steps, files
    return res


def _assert_same_flow(res):
    (psteps, pfiles), (jsteps, jfiles) = res["port"], res["jax"]
    assert psteps == jsteps
    assert sorted(pfiles) == sorted(jfiles)
    for name in pfiles:
        np.testing.assert_array_equal(pfiles[name], jfiles[name])


@pytest.mark.parametrize("kw", [
    dict(extract_instrumental=True),
    dict(export_format="flac PCM_16"),
    dict(export_format="wav PCM_24", use_matchering=True),
])
def test_process_audio_flow_matches_jax(homes, tmp_path, monkeypatch, kw):
    song = audio_io.write_audio(str(tmp_path / "My Song.wav"), _song(1.0), SR)
    res = _flow(homes, monkeypatch, lambda proc, key: proc.process_audio(
        song, "Some Model (by x)", output_dir=os.path.join(homes[key], "out"), **kw))
    _assert_same_flow(res)
    steps = res["port"][0]
    assert [s[0] for s in steps][:7] == [0, 5, 22, 40, 57, 75, 80]
    assert steps[-1][0] == 100 and steps[-1][3]["vocals"] and steps[-1][3]["male"]
    assert steps[-1][3]["female"] is None


def test_process_audio_no_input_and_worker_errors(homes, tmp_path, monkeypatch):
    assert list(pproc.process_audio("/nonexistent.wav", "m"))[-1]["status"] == \
        "No input file selected"

    class Boom(FakeSession):
        def separate_with_extras(self, *a, **k):
            raise RuntimeError("boom")

    monkeypatch.setattr(pproc, "_make_session", lambda *a, **k: Boom())
    song = audio_io.write_audio(str(tmp_path / "s.wav"), _song(0.2), SR)
    with pytest.raises(RuntimeError, match="boom"):
        list(pproc.process_audio(song, "m", output_dir=str(tmp_path / "o")))


@pytest.mark.parametrize("kw", [
    dict(ensemble_type="avg_wave"),
    dict(ensemble_type="median_wave", extract_instrumental=True, export_format="flac PCM_24"),
])
def test_auto_ensemble_flow_matches_jax(homes, tmp_path, monkeypatch, kw):
    song = audio_io.write_audio(str(tmp_path / "song.wav"), _song(1.0, seed=1), SR)
    res = _flow(homes, monkeypatch, lambda proc, key: proc.auto_ensemble_process(
        song, ["Model A", "Model B", "Model C"], output_dir=os.path.join(homes[key], "aeo"),
        **kw))
    _assert_same_flow(res)
    final = res["port"][0][-1]
    assert final[0] == 100 and len(final[2]) == (3 if kw.get("extract_instrumental") else 2)
    assert list(pproc.auto_ensemble_process(song, []))[-1]["status"] == "No models selected"


@pytest.mark.parametrize("method", ["avg_wave", "max_wave", "median_fft"])
def test_ensemble_audio_fn_matches_jax(homes, tmp_path, monkeypatch, method):
    files = [audio_io.write_audio(str(tmp_path / f"s{i}.wav"), _song(0.5, seed=i), SR)
             for i in range(3)]
    res = _flow(homes, monkeypatch, lambda proc, key: proc.ensemble_audio_fn(
        files, method, weights="1, 2 1", output_dir=os.path.join(homes[key], "ens")))
    _assert_same_flow(res)
    assert res["port"][0][-1][:3] == (100, "Done", [f"ensemble_{method}.wav"])
    assert "at least two" in list(pproc.ensemble_audio_fn(files[:1], method))[-1]["status"]


@pytest.mark.parametrize("files", [
    [f"/x/20260101000000_song_{slot}_model.wav" for slot in pproc.STEM_SLOTS],
    ["/x/20260101000000_song_female_model.wav", "/x/20260101000000_song_male_model.wav"],
    ["/x/Drums (drum).wav", "/x/female.wav", "/x/the_male.wav", "/x/other.flac"],
    [],
])
def test_find_file_for_stem_matches_jax(files):
    assert pproc.STEM_SLOTS == jproc.STEM_SLOTS and len(pproc.STEM_SLOTS) == 16
    for slot in pproc.STEM_SLOTS:
        assert pproc.find_file_for_stem(files, slot) == jproc.find_file_for_stem(files, slot)
    if len(files) == 16:
        assert [pproc.find_file_for_stem(files, s) for s in pproc.STEM_SLOTS] == files
    if files[:1] == ["/x/20260101000000_song_female_model.wav"]:  # 'male' is in 'female'
        assert pproc.find_file_for_stem(files, "male") == files[1]
        assert pproc.find_file_for_stem(files, "female") == files[0]
        assert pproc.find_file_for_stem(files[:1], "male") is None


def test_timestamped_name_matches_jax():
    a = pproc._timestamped_name("my song", "vocals", "Model (x)", ".wav")
    b = jproc._timestamped_name("my song", "vocals", "Model (x)", ".wav")
    assert TS.sub("", a) == TS.sub("", b) == "my_song_vocals_Model__x.wav"


# --------------------------------------------------------------------------
# a real small bs_roformer from a checkpoint file: processing, benchmark
# --------------------------------------------------------------------------

MODEL_NAME = "Small BS Roformer"
SMALL_CHUNK = 8192


@pytest.fixture(scope="module")
def small_model(tmp_path_factory):
    """A small bs_roformer's YAML config and reference-layout checkpoint."""
    root = tmp_path_factory.mktemp("small_model")
    mcfg = bs_model_cfg()
    cfg = {"audio": {"chunk_size": SMALL_CHUNK, "num_channels": 2, "sample_rate": SR},
           "model": mcfg,
           "training": {"instruments": ["vocals", "other"], "target_instrument": None},
           "inference": {"num_overlap": 2, "batch_size": 1}}
    params = jax_bs.init(jax.random.PRNGKey(0), ConfigDict({"model": mcfg}))
    sd = export_state_dict(params, jax_bs.spec_from_config(mcfg), transformer_norm_output=False,
                           final_norm=True)
    config, ckpt = str(root / "config.yaml"), str(root / "small_bs_roformer.ckpt")
    with open(config, "w") as f:
        yaml.safe_dump(cfg, f)
    torch.save(sd, ckpt)
    return config, ckpt


@pytest.fixture(scope="module")
def processed(small_model, tmp_path_factory):
    """process_audio of a 3 s song with the small model, registered as a
    custom model in each package's home (f32 sessions), run once."""
    root = tmp_path_factory.mktemp("processed")
    song = audio_io.write_audio(str(root / "song.wav"), _song(3.0, seed=4), SR)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        homes = _homes(root, mp)
        for key, proc, reg in (("jax", jproc, jreg), ("port", pproc, preg)):
            ok, msg = reg.add_custom_model(MODEL_NAME, "bs_roformer",
                                           "https://x/small_bs_roformer.ckpt",
                                           "https://x/config.yaml")
            assert ok, msg
            entry = reg.load_custom_models()[MODEL_NAME]
            for src, name in zip(small_model, (entry["config_filename"],
                                               entry["checkpoint_filename"])):
                with open(src, "rb") as f, open(os.path.join(reg.CHECKPOINT_DIR, name),
                                                "wb") as g:
                    g.write(f.read())
            mp.setattr(proc, "_make_session",
                       functools.partial(proc._make_session, compute_dtype="f32"))
            kw = {"device": "cpu"} if key == "port" else {}
            updates = list(proc.process_audio(song, MODEL_NAME, extract_instrumental=True,
                                              output_dir=os.path.join(homes[key], "out"),
                                              **kw))
            with open(os.path.join(reg.CHECKPOINT_DIR, entry["config_filename"]), "rb") as f:
                edited = f.read()
            out[key] = dict(updates=updates, config=edited,
                            stems={TS.sub("", os.path.basename(f)): read_wav(f)
                                   for f in updates[-1]["outputs"]})
    return out


def read_wav(path):
    return jread(path)[0]


def test_process_audio_from_a_checkpoint_matches_jax(processed):
    jax_run, port = processed["jax"], processed["port"]
    # the live "Separating... N%" steps follow each demix engine's batching
    steps = {k: [(u["progress"], u["status"]) for u in r["updates"]
                 if not re.fullmatch(r"Separating\.\.\. \d+%", u["status"])]
             for k, r in processed.items()}
    assert steps["port"] == steps["jax"]
    live = [u["progress"] for u in port["updates"] if u["status"].startswith("Separating... ")]
    assert live == sorted(live) and len(live) >= 3 and 5 < live[0] and live[-1] == 75
    assert port["config"] == jax_run["config"]  # conf_edit ran alike
    assert sorted(port["stems"]) == sorted(jax_run["stems"]) == [
        "song_instrumental_Small_BS_Roformer.wav", "song_other_Small_BS_Roformer.wav",
        "song_vocals_Small_BS_Roformer.wav"]
    for name, got in port["stems"].items():
        assert got.shape == (2, 3 * SR)
        np.testing.assert_allclose(got, jax_run["stems"][name], atol=ATOL, rtol=0)
    assert max(float(np.abs(v).max()) for v in port["stems"].values()) > 1e-3


def test_benchmark_run_mode_matches_jax(small_model):
    from sesa_tpu import benchmark as jbench
    from sesa_tpu_torch import benchmark

    config, ckpt = small_model
    got = benchmark.run_mode("bs_roformer", config, ckpt, "f32", iters=1, device="cpu")
    ref = jbench.run_mode("bs_roformer", config, ckpt, "f32", iters=1)
    assert got["output"].shape == ref["output"].shape == (2, 2, 2, SMALL_CHUNK)
    np.testing.assert_allclose(got["output"], ref["output"], atol=ATOL, rtol=0)
    assert got["ms_per_iter"] > 0 and got["rtf"] > 0


def test_benchmark_cli_test_and_benchmark(small_model, capsys):
    from sesa_tpu_torch import benchmark

    config, ckpt = small_model
    args = ["--config_path", config, "--start_check_point", ckpt, "--iterations", "1",
            "--batch_size", "1", "--force_cpu"]
    assert benchmark.main(["test", *args]) == 0
    out = capsys.readouterr().out
    assert "f32 vs bf16: max abs diff" in out and "All modes within tolerance" in out
    assert benchmark.main(["test", *args, "--tolerance", "0"]) == 1
    capsys.readouterr()
    assert benchmark.main(["benchmark", *args, "--modes", "bf16"]) == 0
    assert re.search(r"bf16: +[0-9.]+ ms/iter", capsys.readouterr().out)
    if not torch.cuda.is_available():  # the GPU is the default and is not optional
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            benchmark.main(["test", *args[:-1]])


def test_warmup_on_the_cpu(tmp_path, monkeypatch, capsys):
    from sesa_tpu_torch import warmup

    cfg = tmp_path / "mdx23c.yaml"
    cfg.write_text(TINY_MDX23C_YAML)
    monkeypatch.setenv("SESA_CACHE_DIR", str(tmp_path / "cache"))
    args = ["--model_type", "mdx23c", "--config_path", str(cfg), "--song_seconds", "1",
            "--compute_dtype", "f32", "--phase_fix_models", "2"]
    assert warmup.main([*args, "--force_cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 and lines[0].endswith(f"-> {tmp_path / 'cache'}")
    assert lines[1].startswith("[warmup] ensemble+phase-fix x2 1s:")
    assert os.path.isdir(tmp_path / "cache")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            warmup.main(args)


# --------------------------------------------------------------------------
# runtime/profiling.py and chip_smoke.roformer_state_dict
# --------------------------------------------------------------------------

def test_get_model_info_matches_jax():
    from sesa_tpu.runtime.profiling import get_model_info as jinfo
    from sesa_tpu_torch.runtime.profiling import get_model_info

    mcfg = bs_model_cfg()
    params = jax_bs.init(jax.random.PRNGKey(0), ConfigDict({"model": mcfg}))
    ported = params_from_jax(jax.tree.map(np.asarray, params), bs_roformer.spec_from_config(mcfg))
    assert get_model_info(ported, "bs_roformer") == jinfo(params, "bs_roformer")
    assert get_model_info({"a": torch.zeros(10, 10), "b": [torch.zeros(5)]})["parameters"] == 105


def test_throughput_tracker():
    from sesa_tpu_torch.runtime.profiling import ThroughputTracker

    t = ThroughputTracker(sample_rate=SR)
    t.update(samples=SR * 10, chunks=5)
    assert t.rtf > 0 and t.chunks_per_sec > 0
    assert "RTF" in t.report()


def test_device_trace_writes_a_chrome_trace(tmp_path):
    from sesa_tpu_torch.runtime.profiling import device_trace

    with device_trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (name,) = os.listdir(tmp_path / "trace")
    with open(tmp_path / "trace" / name) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)


@pytest.mark.parametrize("kind, over", [("bs", {}), ("bs", {"linear_transformer_depth": 1}),
                                        ("mel", {})])
def test_chip_smoke_roformer_state_dict_equals_the_test_exporter(kind, over):
    """The mel-band tree comes from the port's init as numpy leaves: the JAX
    init of mel_band_roformer takes 8 s eagerly, and the exporter only reads
    the leaves."""
    jmod, cfg_fn = (jax_bs, bs_model_cfg) if kind == "bs" else (jax_mel, mel_model_cfg)
    pmod = bs_roformer if kind == "bs" else mel_band_roformer
    mcfg = cfg_fn(**over)
    spec, pspec = jmod.spec_from_config(mcfg), pmod.spec_from_config(mcfg)
    if kind == "bs":
        params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(3),
                                                    ConfigDict({"model": mcfg})))
    else:
        params = jax.tree.map(lambda t: t.numpy(), pmod.init(
            torch.Generator().manual_seed(3), AttrDict({"model": mcfg})))
    ref = export_state_dict(params, spec, transformer_norm_output=kind == "mel",
                            final_norm=kind == "bs")
    got = chip_smoke.roformer_state_dict(params_from_jax(params, pspec), pspec)
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and torch.equal(got[k], ref[k]), k
    back = pmod.convert_torch(got, AttrDict({"model": mcfg}))  # consumes every key
    assert back["layers"][0]["time"]["layers"][0]["ff"]["lin1_w"].shape[1] == mcfg["dim"]


# --------------------------------------------------------------------------
# the repairs: TF32 scoped to a model call; soundfile for non-WAV audio
# --------------------------------------------------------------------------

class _FlagProbe(torch.overrides.TorchFunctionMode):
    """Records (matmul, cuDNN) allow_tf32 at every torch call inside a block."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_function__(self, func, types_, args=(), kwargs=None):
        self.seen.add((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return func(*args, **(kwargs or {}))


def _tiny(kind):
    if kind == "bs_roformer":
        cfg = AttrDict({"model": bs_model_cfg()})
        return bs_roformer, cfg, {}
    cfg = AttrDict({"model": {k: v for k, v in scnet_tiny_kwargs().items() if k != "sources"},
                    "training": {"instruments": scnet_tiny_kwargs()["sources"]}})
    return scnet, cfg, {}


@pytest.mark.parametrize("kind", ["bs_roformer", "scnet"])
def test_tf32_flags_follow_each_model_call(kind, monkeypatch):
    model, config, _ = _tiny(kind)
    params = model.init(torch.Generator().manual_seed(0), config)
    x = torch.from_numpy(_song(4096 / SR, seed=2)[None].copy())
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)  # PyTorch's defaults
    outs = []
    for dtype, want in ((torch.bfloat16, (True, True)), (None, (False, False)),
                        (torch.bfloat16, (True, True))):
        probe = _FlagProbe()
        with torch.inference_mode(), probe:
            outs.append(model.apply(params, config, x, compute_dtype=dtype))
        assert probe.seen == {want}, (dtype, probe.seen)
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == \
            (False, True)
    torch.testing.assert_close(outs[2], outs[0], rtol=0, atol=0)


def test_net_precision_restores_on_error():
    from sesa_tpu_torch.ops.prec import net_precision

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    with pytest.raises(ValueError):
        with net_precision(torch.bfloat16) as dtype:
            assert dtype == torch.bfloat16 and torch.backends.cuda.matmul.allow_tf32
            raise ValueError
    with net_precision(None) as dtype:
        assert dtype == torch.float32 and not torch.backends.cudnn.allow_tf32
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == saved


def _fake_soundfile(store):
    """A stand-in for soundfile (not installed here) that keeps what it
    writes in ``store`` and serves it back."""
    mod = types.ModuleType("soundfile")

    def write(path, data, sr, subtype=None):
        store[path] = (np.array(data, dtype=np.float64), sr, subtype)
        with open(path, "wb") as f:
            f.write(b"fLaC\x00\x00\x00\x22")

    def read(path, always_2d=False):
        store.setdefault("reads", []).append(path)
        data, sr, _ = store[path]
        return data, sr

    mod.write, mod.read = write, read
    return mod


def test_flac_goes_through_soundfile_when_it_imports(tmp_path, monkeypatch):
    store = {}
    monkeypatch.setitem(sys.modules, "soundfile", _fake_soundfile(store))
    x = _song(0.05, seed=5)
    path = str(tmp_path / "a.flac")
    assert audio_io.write_audio(path, x, SR) == path  # real FLAC, not .wav
    assert store[path][2] == "PCM_24" and store[path][1] == SR  # FLOAT coerced
    np.testing.assert_array_equal(store[path][0], x.T)
    got, sr = audio_io.read_audio(path, target_sr=SR)
    assert store["reads"] == [path] and sr == SR and got.dtype == np.float32
    np.testing.assert_array_equal(got, x)
    with audio_io.AudioReader(path) as r:  # streaming reads take the same route
        np.testing.assert_array_equal(np.concatenate([r.read(1000), r.read(5000)], axis=1), x)
    # helpers.convert_to_wav hands a non-WAV file to read_audio
    wav = phelpers.convert_to_wav(path)
    assert wav == str(tmp_path / "a.wav") and wav in store


def test_without_soundfile_nothing_changes(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "soundfile", None)
    x = np.clip(_song(0.05, seed=6), -0.99, 0.99)
    written = audio_io.write_audio(str(tmp_path / "a.flac"), x, SR, subtype="PCM_16")
    assert written == str(tmp_path / "a.wav")
    ref = jwrite(str(tmp_path / "j.flac"), x, SR, subtype="PCM_16")
    assert ref == str(tmp_path / "j.wav")
    np.testing.assert_array_equal(audio_io.read_audio(written)[0], jread(ref)[0])
    with open(tmp_path / "b.flac", "wb") as f:
        f.write(b"fLaC\x00\x00\x00\x22")
    with pytest.raises(ValueError):
        audio_io.read_audio(str(tmp_path / "b.flac"))
