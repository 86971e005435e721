"""The port's CLI end to end on the CPU: WAV + JSON config + torch checkpoint
-> stems on disk, held against the JAX session's stems for the same weights;
and the CLI's refusal to fall back to the CPU without --force_cpu."""

import json
import os

import numpy as np
import pytest
import torch

import jax

from ml_collections import ConfigDict

from sesa_tpu.models import bs_roformer as jax_bs
from sesa_tpu.runtime.session import InferenceSession as JaxSession
from sesa_tpu_torch.audio_io import read_audio, write_audio
from sesa_tpu_torch.cli import main
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


# f32 end to end (BASELINE.md:88), plus the FLOAT WAV round trip (exact)
ATOL = 5e-4


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    sr = 44100
    t = np.arange(sr // 2 + 777) / sr
    song = np.stack([0.4 * np.sin(2 * np.pi * 220 * t),
                     0.3 * np.sin(2 * np.pi * 330 * t)]).astype(np.float32)
    (d / "in").mkdir()
    write_audio(str(d / "in" / "song.wav"), song, sr)
    mcfg = bs_model_cfg(num_stems=1, depth=1)
    cfg = {
        "audio": {"chunk_size": 8192, "num_channels": 2, "sample_rate": sr},
        "model": {k: (list(v) if isinstance(v, tuple) else v) for k, v in mcfg.items()},
        "training": {"instruments": ["vocals", "other"], "target_instrument": "vocals"},
        "inference": {"num_overlap": 2, "batch_size": 2, "normalize": False},
    }
    with open(d / "config.json", "w") as f:
        json.dump(cfg, f)
    params = jax_bs.init(jax.random.PRNGKey(0), ConfigDict({"model": mcfg}))
    sd = export_state_dict(params, jax_bs.spec_from_config(mcfg), False, True)
    torch.save(sd, str(d / "model.ckpt"))
    return d, song


def _args(d, *extra):
    return ["--model_type", "bs_roformer", "--config_path", str(d / "config.json"),
            "--start_check_point", str(d / "model.ckpt"), "--input_folder", str(d / "in"),
            "--compute_dtype", "f32", *extra]


def test_cli_stems_match_jax_session(fixture_dir, capsys):
    d, song = fixture_dir
    out = d / "out"
    rc = main(_args(d, "--store_dir", str(out), "--extract_instrumental", "--force_cpu"))
    assert rc == 0
    assert "[SESA_PROGRESS]100" in capsys.readouterr().out
    assert sorted(os.listdir(out)) == ["song_instrumental.wav", "song_vocals.wav"]

    ref = JaxSession.create("bs_roformer", str(d / "config.json"), str(d / "model.ckpt"),
                            compute_dtype=None).separate_with_extras(
                                song, extract_instrumental=True)
    for name in ("vocals", "instrumental"):
        got, sr = read_audio(str(out / f"song_{name}.wav"))
        assert sr == 44100 and got.shape == song.shape
        np.testing.assert_allclose(got, ref[name], atol=ATOL)


def test_cli_flac_request_writes_wav(fixture_dir):
    d, song = fixture_dir
    out = d / "out_flac"
    assert main(_args(d, "--store_dir", str(out), "--flac_file", "--force_cpu")) == 0
    assert os.listdir(out) == ["song_vocals.wav"]
    got, _ = read_audio(str(out / "song_vocals.wav"))
    assert got.shape == song.shape and np.isfinite(got).all()


def test_cli_without_gpu_raises_unless_forced(fixture_dir, monkeypatch):
    d, _ = fixture_dir
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="force_cpu"):
        main(_args(d, "--store_dir", str(d / "out_gpu")))


def test_cli_missing_input():
    assert main(["--config_path", "/nonexistent.json"]) == 2
