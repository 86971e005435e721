"""The plain reference against the program's CPU path at tiny widths, both
from one state dict in the published layout; the reference demix against
the program's demix."""

import numpy as np
import pytest
import torch

from h100_bench import weights
from h100_bench.models import bs_roformer as bs_yard
from h100_bench.models import mel_band_roformer as mel_yard
from h100_bench.reference import demix as ref_demix
from h100_bench.reference import roformer as ref

FPB = [2] * 24 + [4] * 12 + [12] * 8 + [24] * 8 + [48] * 8 + [128, 129]
TINY = dict(dim=32, depth=2, stereo=True, num_stems=1, time_transformer_depth=1,
            freq_transformer_depth=1, dim_head=16, heads=2, stft_n_fft=2048,
            stft_hop_length=441, stft_win_length=2048, mask_estimator_depth=2)
MODELS = {
    "bs_roformer": (bs_yard, dict(TINY, freqs_per_bands=FPB)),
    "mel_band_roformer": (mel_yard, dict(TINY, num_bands=60, sample_rate=44100)),
}


def _config(model):
    return {"audio": {"chunk_size": 44100, "num_channels": 2, "sample_rate": 44100},
            "model": model, "training": {"instruments": ["vocals", "other"],
                                         "target_instrument": "vocals"}}


@pytest.mark.parametrize("model_type", sorted(MODELS))
def test_reference_matches_the_program_in_f32(model_type):
    from sesa_tpu_torch.configs import config_from_dict
    from sesa_tpu_torch.convert import convert_checkpoint
    from sesa_tpu_torch.models import get_model

    yard, model = MODELS[model_type]
    sd = weights.make_state_dict(yard.state_dict_layout(model), 2 ** 31 + 17, "cpu")
    config = config_from_dict(_config(model))
    params = convert_checkpoint(model_type, sd, config)
    x = torch.randn(2, 2, 22050, generator=torch.Generator().manual_seed(3)) * 0.3
    with torch.inference_mode():
        prog = get_model(model_type).apply(params, config, x, compute_dtype=None)
    with ref.F32().context():
        want = yard.reference_forward(sd, model, x)
    prog = prog.reshape(want.shape)
    err = float((prog - want).norm() / want.norm())
    assert err < 1e-4, err


@pytest.mark.parametrize("model_type", sorted(MODELS))
def test_fp8_products_depart_from_f32(model_type):
    yard, model = MODELS[model_type]
    sd = weights.make_state_dict(yard.state_dict_layout(model), 5, "cpu")
    x = torch.randn(1, 2, 22050, generator=torch.Generator().manual_seed(4)) * 0.3
    with ref.F32().context():
        want = yard.reference_forward(sd, model, x)
    fp8 = ref.FP8()
    with fp8.context():
        got = yard.reference_forward(sd, model, x, fp8)
    err = float((got - want).norm() / want.norm())
    assert 0.02 < err < 1.0, err


def test_mel_bands_match_the_programs_layout():
    from sesa_tpu_torch.models.mel_band_roformer import mel_band_feats

    rows, widths, _ = ref.band_layout("mel_band_roformer", MODELS["mel_band_roformer"][1])
    feats = mel_band_feats(60, 44100, 2048, True)
    assert widths == [len(f) for f in feats]
    # the program's features are (row * 2 + complex part); the reference's rows
    got = np.concatenate([np.asarray(f)[::2] // 2 for f in feats])
    assert np.array_equal(got, rows)


class _ByChunk:
    """A model whose output depends on the chunk's content and position in
    it, so a wrong window, offset or padding shows."""

    def __call__(self, x):
        x = np.asarray(x, dtype=np.float64)
        ramp = np.linspace(0.5, 1.5, x.shape[-1])
        return (np.cumsum(x, axis=-1) * 1e-3 + x * ramp)[:, None]


@pytest.mark.parametrize("seconds", [0.3, 0.9, 1.6, 2.05, 3.4, 7.77])
def test_reference_demix_matches_the_programs(seconds):
    from sesa_tpu_torch.runtime.demix import DemixSpec, demix

    chunk, sr = 8820, 44100
    n = int(seconds * sr)
    mix = np.random.default_rng(n).uniform(-0.5, 0.5, (2, n)).astype(np.float32)
    model = _ByChunk()

    def apply(params, chunks):
        return torch.as_tensor(model(chunks.numpy()), dtype=torch.float32)

    spec = DemixSpec(chunk_size=chunk, num_overlap=2, batch_size=3, num_stems=1)
    prog = demix(apply, None, mix, spec, device="cpu")
    step = chunk // 2
    spans = [(0, min(n, step)), (max(0, n - step), n), (n // 3, n // 3 + min(step, n // 3))]
    got = ref_demix.regions(model, mix, chunk, 2, spans)
    for lo, hi in spans:
        np.testing.assert_allclose(prog[..., lo:hi], got[(lo, hi)], rtol=1e-5, atol=1e-6)
