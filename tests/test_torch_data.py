"""The port's data pipeline held against sesa_tpu.data on the CPU: the same
WAV trees (tests/test_data.py's fixtures) and the same seeds give the same
items, batches and augmentations, bit for bit."""

import os

import numpy as np
import pytest

import sesa_tpu.data as jd
import sesa_tpu_torch.data as td
from sesa_tpu_torch.data import datasets as td_datasets
from tests.test_data import SR, _write_track, dnr_root, musdb_root  # noqa: F401


def _equal(a, b):
    """Items or batches of both packages: the same keys, tracks and arrays
    (dtype, shape and every bit)."""
    assert a.keys() == b.keys()
    assert a.get("track") == b.get("track")
    assert a["audio"].keys() == b["audio"].keys()
    for s in a["audio"]:
        x, y = np.asarray(a["audio"][s]), np.asarray(b["audio"][s])
        assert x.dtype == y.dtype and x.shape == y.shape, s
        np.testing.assert_array_equal(x, y, err_msg=s)


def _same_items(make, n=None):
    """Build each package's dataset with ``make(module)`` and compare every
    item (``n`` of them, in order, for the seeded ones)."""
    ds_j, ds_t = make(jd), make(td)
    assert len(ds_j) == len(ds_t)
    for i in range(len(ds_j) if n is None else n):
        _equal(ds_j[i], ds_t[i])
    return ds_t


def test_all_names_match():
    assert td.__all__ == jd.__all__
    assert sorted(td.AUGMENTATIONS) == sorted(jd.AUGMENTATIONS)


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_musdb_full_track(musdb_root, split):  # noqa: F811
    ds = _same_items(lambda m: m.MUSDB18FullTrackDataset(musdb_root, split, strict=False))
    assert len(ds) == {"train": 2, "val": 2, "test": 1}[split]
    with pytest.raises(ValueError):
        td.MUSDB18FullTrackDataset(musdb_root, "train")


def _sad_root(tmp_path):
    root = str(tmp_path / "sad")
    for i in range(3):
        _write_track(os.path.join(root, "vocals", "train"), f"seg{i}",
                     ["mixture", "vocals", "bass", "drums", "other"], t=SR, seed=i)
    return root


def test_musdb_sad_and_on_the_fly(tmp_path):
    root = _sad_root(tmp_path)
    _same_items(lambda m: m.MUSDB18SadDataset(root, "train", "vocals", target_length=7))
    _same_items(lambda m: m.MUSDB18SadOnTheFlyAugmentedDataset(
        root, "train", "vocals", target_length=40, chunk_size_second=0.25, seed=3), n=12)


def test_dnr_datasets(dnr_root):  # noqa: F811
    kw = dict(strict=False, npy_memmap=False)
    _same_items(lambda m: m.DnRDataset(dnr_root, "train", **kw))
    _same_items(lambda m: m.DnRRandomChunkDataset(dnr_root, "val", target_length=6,
                                                  chunk_size_second=0.5, seed=1, **kw))
    _same_items(lambda m: m.DnRDeterministicChunkDataset(dnr_root, "test",
                                                         chunk_size_second=0.5,
                                                         hop_size_second=0.25, **kw), n=6)
    ds = _same_items(lambda m: m.DnRRandomChunkDatasetWithSpeechReverb(
        dnr_root, "train", target_length=4, chunk_size_second=0.5, seed=2, **kw))
    assert ds.stems[0] == "mixture"


def test_noise_reverb_matches():
    from sesa_tpu.data.datasets import _noise_reverb as jax_reverb

    x = np.random.default_rng(0).standard_normal((2, 3000)).astype(np.float32)
    for width in (0.0, 0.7):
        a = jax_reverb(x, SR, np.random.default_rng(5), 0.3, 0.6, 0.4, 0.6, width)
        b = td_datasets._noise_reverb(x, SR, np.random.default_rng(5), 0.3, 0.6, 0.4, 0.6, width)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    mono = td_datasets._noise_reverb(x[0], SR, np.random.default_rng(5), 0.3, 0.6, 0.4, 0.6, 1.0)
    assert mono.shape == (3000,)


def test_npy_memmap(tmp_path):
    root = str(tmp_path / "dnr")
    rng = np.random.default_rng(0)
    for tr in ("001", "002"):
        path = os.path.join(root, "tr", tr)
        os.makedirs(path)
        for stem in ("mix", "speech", "music"):
            np.save(os.path.join(path, f"{stem}.npy"),
                    rng.standard_normal((2, 2 * SR)).astype(np.float32))
        np.save(os.path.join(path, "sfx.wav.npy"),
                rng.standard_normal((2, 2 * SR)).astype(np.float32))
    _same_items(lambda m: m.DnRDataset(root, "train", strict=False))
    ds = td.DnRDataset(root, "train", stems=["mixture", "nope"], strict=False)
    with pytest.raises(FileNotFoundError):
        ds[0]


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_batch_iterator(musdb_root, shuffle, drop_last):  # noqa: F811
    def batches(m):
        ds = m.MUSDB18FullTrackDataset(musdb_root, "train", strict=False)
        ds.files = ds.files + ds.files[:1]  # three tracks: a ragged last batch
        return list(m.batch_iterator(ds, 2, shuffle=shuffle, seed=4, drop_last=drop_last,
                                     epochs=2))

    a, b = batches(jd), batches(td)
    assert len(a) == len(b) == (2 if drop_last else 4)
    for x, y in zip(a, b):
        _equal(x, y)


AUG_CONFIG = {
    "[common]": {"name": "Gain", "kwargs": {"min_gain_in_db": -6, "max_gain_in_db": 12,
                                            "p": 0.7}},
    "[default]": {"name": "Compose", "kwargs": {"transforms": [
        {"name": "PolarityInversion", "kwargs": {"p": 0.5}},
        {"name": "Shift", "kwargs": {"min_shift": -0.3, "max_shift": 0.3, "p": 0.8,
                                     "rollover": False}},
        {"name": "ShuffleChannels", "kwargs": {"p": 0.5}},
    ], "kwargs": {}}},
    "vocals": {"name": "Compose", "kwargs": {"transforms": [
        {"name": "PeakNormalization", "kwargs": {"p": 0.5}},
        {"name": "Shift", "kwargs": {"min_shift": -100, "max_shift": 100,
                                     "shift_unit": "samples", "p": 1.0}},
        {"name": "Identity", "kwargs": {}},
    ]}},
}


@pytest.mark.parametrize("both", [False, True])
@pytest.mark.parametrize("batched", [True, False])
def test_stem_augmentor(both, batched):
    rng = np.random.default_rng(1)
    shape = (3, 2, 700) if batched else (2, 700)
    audio = {s: (rng.standard_normal(shape) * 0.6).astype(np.float32)
             for s in ("vocals", "bass", "other")}
    audio["mixture"] = sum(audio.values())
    item = {"audio": audio, "track": "t"}
    aug_j = jd.StemAugmentor(AUG_CONFIG, apply_both_default_and_common=both, seed=11)
    aug_t = td.StemAugmentor(AUG_CONFIG, apply_both_default_and_common=both, seed=11)
    for _ in range(4):  # the generators advance in step
        out_t = aug_t(item)
        _equal(aug_j(item), out_t)
    assert out_t["audio"]["vocals"].shape == shape


def test_unknown_augmentation_and_seconds_shift():
    for m in (jd, td):
        with pytest.raises(NameError):
            m.build_augmentation({"name": "TimeStretch", "kwargs": {}})
    shift = td.build_augmentation({"name": "Shift", "kwargs": {"shift_unit": "seconds",
                                                              "p": 1.0}})
    with pytest.raises(ValueError, match="sample_rate"):
        shift(np.zeros((1, 2, 10), np.float32), np.random.default_rng(0))
