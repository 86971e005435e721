"""The FLOP and byte counts against hand counts at the flagship's shape,
and the checkpoint layouts against the published checkpoints' sizes."""

import json
import math
import os

import pytest

from h100_bench import roofline
from h100_bench.models import bs_roformer, mel_band_roformer

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _model(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return json.load(f)["model"]


def test_flagship_flops_per_chunk_by_hand():
    model = _model("bs_roformer_viperx1297")
    # 801 frames x 62 bands, d 512, 8 heads x 64, ff 2048
    t = 801 * 62
    attn_proj = 2 * t * 512 * (3 * 512 + 8 + 512)
    ff = 2 * 2 * t * 512 * 2048
    time_core = 4 * 62 * 8 * 801 ** 2 * 64
    freq_core = 4 * 801 * 8 * 62 ** 2 * 64
    layer = 2 * (attn_proj + ff) + time_core + freq_core
    band_split = 2 * 801 * 4100 * 512
    mask = 62 * 2 * 801 * 512 * 2048 + 2 * 801 * 2048 * 2 * 4100
    want = 12 * layer + band_split + mask
    assert bs_roformer.model_flops_per_chunk(model, 352800) == pytest.approx(want, rel=1e-12)
    assert 8.6e12 < want < 8.8e12


def test_flagship_kernel_bounds_by_hand():
    model = _model("bs_roformer_viperx1297")
    b = 6
    k1 = k2 = 0.0
    for seqs, n in ((b * 62, 801), (b * 801, 62)):
        t = seqs * n
        fl = 2 * t * 512 * (3 * 512 + 8 + 512) + 4 * seqs * 8 * n * n * 64
        by = 2 * (2 * t * 512 + (3 * 512 + 8 + 512) * 512 + 8 + 512 + 2 * n * 64)
        k1 += 12 * max(fl / 989e12, by / 3.35e12)
        k2 += 12 * max(4 * t * 512 * 2048 / 989e12,
                       2 * (2 * t * 512 + 2 * 2048 * 512 + 2048 + 3 * 512) / 3.35e12)
    got = bs_roformer.kernel_bound_s(model, 352800, b)
    assert got["K1"] == pytest.approx(k1, rel=1e-12)
    assert got["K2"] == pytest.approx(k2, rel=1e-12)
    assert bs_roformer.kernel_launches(model, b) == {"K1": 24, "K2": 24}


def test_bound_takes_the_larger_leg():
    assert roofline.bound_s(989e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert roofline.bound_s(989e12, 2 * 3.35e12) == pytest.approx(2.0)


@pytest.mark.parametrize("name,module,mib", [
    ("bs_roformer_viperx1297", bs_roformer, 609.6),  # the published .ckpt, 639 MB
    ("mel_band_roformer_kj", mel_band_roformer, 870.5),  # MelBandRoformer.ckpt, 913 MB
])
def test_layout_holds_the_published_checkpoints_parameters(name, module, mib):
    layout = module.state_dict_layout(_model(name))
    n = sum(math.prod(shape) for _, shape, _, _ in layout)
    assert 4 * n / 2 ** 20 == pytest.approx(mib, rel=0.002)
    assert len({k for k, _, _, _ in layout}) == len(layout)


def test_mel_flops_count_the_overlapping_bands():
    model = _model("mel_band_roformer_kj")
    flops = mel_band_roformer.model_flops_per_chunk(model, 352800)
    assert 3.0e12 < flops < 3.2e12
