"""Source-separation training datasets, MUSDB18-HQ and DnR layouts
(counterpart of sesa_tpu/data/datasets.py).

The reference's data pipeline (reference models/bandit/core/data/
base.py:14-80, musdb/dataset.py:14-280, dnr/dataset.py:15-392) in numpy on
the host. Items are ``{"audio": {stem: float32 (C, T)}, "track":
"split/name"}`` dicts, loaded from per-track directories of ``{stem}.wav``
files (through :mod:`sesa_tpu_torch.audio_io`) or ``{stem}.npy`` /
``{stem}.wav.npy`` memmaps. ``batch_iterator`` stacks items into batches;
the trainer uploads one batch per step. The random draws are the JAX
package's, in its order, so one seed gives the same items in both packages.

There is no torch DataLoader here: chunked audio training reads a few MB
per batch, and one host thread keeps the card fed.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from sesa_tpu_torch.audio_io import read_audio

__all__ = [
    "SourceSeparationDataset",
    "MUSDB18FullTrackDataset",
    "MUSDB18SadDataset",
    "MUSDB18SadOnTheFlyAugmentedDataset",
    "DnRDataset",
    "DnRRandomChunkDataset",
    "DnRDeterministicChunkDataset",
    "DnRRandomChunkDatasetWithSpeechReverb",
    "batch_iterator",
]


class SourceSeparationDataset:
    """Track-directory dataset base (reference base.py:14-80).

    ``data_path/<track>/<stem file>`` per stem; ``stem_file_name`` maps a
    logical stem to its on-disk base name (DnR renames mixture->mix etc.).
    """

    ALLOWED_STEMS: List[str] = []
    STEM_NAME_MAP: Dict[str, str] = {}

    def __init__(self, split: str, stems: Sequence[str], files: Sequence[str],
                 data_path: str, fs: int = 44100, npy_memmap: bool = False,
                 recompute_mixture: bool = False):
        self.split = split
        self.stems = list(stems)
        self.stems_no_mixture = [s for s in self.stems if s != "mixture"]
        self.files = list(files)
        self.data_path = data_path
        self.fs = fs
        self.npy_memmap = npy_memmap
        self.recompute_mixture = recompute_mixture

    # -- per-stem IO -------------------------------------------------------

    def stem_file_name(self, stem: str) -> str:
        return self.STEM_NAME_MAP.get(stem, stem)

    def get_stem(self, *, stem: str, identifier: Dict[str, Any]) -> np.ndarray:
        path = os.path.join(self.data_path, identifier["track"])
        base = self.stem_file_name(stem)
        if self.npy_memmap:
            for name in (f"{base}.npy", f"{base}.wav.npy"):
                cand = os.path.join(path, name)
                if os.path.exists(cand):
                    return np.load(cand, mmap_mode="r")
            raise FileNotFoundError(
                f"no npy memmap for stem {stem!r} under {path}")
        audio, sr = read_audio(os.path.join(path, f"{base}.wav"),
                               target_sr=self.fs)
        del sr
        return audio.astype(np.float32, copy=False)

    def compute_mixture(self, audio: Dict[str, np.ndarray]) -> np.ndarray:
        return sum(np.asarray(audio[s], np.float32)
                   for s in audio if s != "mixture")

    def get_audio(self, identifier: Dict[str, Any]) -> Dict[str, np.ndarray]:
        if self.recompute_mixture:
            audio = {s: self.get_stem(stem=s, identifier=identifier)
                     for s in self.stems_no_mixture}
            audio["mixture"] = self.compute_mixture(audio)
            return audio
        return {s: self.get_stem(stem=s, identifier=identifier)
                for s in self.stems}

    def get_identifier(self, index: int) -> Dict[str, Any]:
        return {"track": self.files[index]}

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        identifier = self.get_identifier(index)
        audio = self.get_audio(identifier)
        return {"audio": audio,
                "track": f"{self.split}/{identifier['track']}"}


# ---------------------------------------------------------------------------
# MUSDB18-HQ (reference musdb/dataset.py:14-280)
# ---------------------------------------------------------------------------

class MUSDB18FullTrackDataset(SourceSeparationDataset):
    """MUSDB18-HQ full tracks: ``data_root/{train,test}/<track>/{stem}.wav``.

    The canonical 14-track validation split is the reference's
    (musdb/dataset.py:63-78). When ``strict=False`` the 100/50 track-count
    asserts are skipped so subsets (or test fixtures) load.
    """

    ALLOWED_STEMS = ["mixture", "vocals", "bass", "drums", "other"]

    VALIDATION_FILES = [
        "Actions - One Minute Smile",
        "Clara Berry And Wooldog - Waltz For My Victims",
        "Johnny Lokke - Promises & Lies",
        "Patrick Talbot - A Reason To Leave",
        "Triviul - Angelsaint",
        "Alexander Ross - Goodbye Bolero",
        "Fergessen - Nos Palpitants",
        "Leaf - Summerghost",
        "Skelpolu - Human Mistakes",
        "Young Griffo - Pennies",
        "ANiMAL - Rockshow",
        "James May - On The Line",
        "Meaxic - Take A Step",
        "Traffic Experiment - Sirens",
    ]

    def __init__(self, data_root: str, split: str,
                 stems: Optional[Sequence[str]] = None, fs: int = 44100,
                 npy_memmap: bool = False, strict: bool = True):
        if stems is None:
            stems = self.ALLOWED_STEMS
        if split == "test":
            subset = "test"
        elif split in ("train", "val"):
            subset = "train"
        else:
            raise NameError(f"unknown split {split!r}")
        data_path = os.path.join(data_root, subset)
        files = sorted(f for f in os.listdir(data_path)
                       if not f.startswith(".")
                       and os.path.isdir(os.path.join(data_path, f)))
        if strict and subset == "train" and len(files) != 100:
            raise ValueError(f"expected 100 train tracks, found {len(files)}")
        if strict and subset == "test" and len(files) != 50:
            raise ValueError(f"expected 50 test tracks, found {len(files)}")
        if subset == "train":
            in_val = set(self.VALIDATION_FILES)
            if split == "train":
                files = [f for f in files if f not in in_val]
            else:
                files = [f for f in files if f in in_val]
        super().__init__(split=split, stems=stems, files=files,
                         data_path=data_path, fs=fs, npy_memmap=npy_memmap)


class MUSDB18SadDataset(SourceSeparationDataset):
    """Source-activity-detected segments: ``data_root/<target_stem>/<split>/``
    (reference musdb/dataset.py:125-168). ``target_length`` repeats the
    segment list to a virtual epoch length."""

    ALLOWED_STEMS = MUSDB18FullTrackDataset.ALLOWED_STEMS

    def __init__(self, data_root: str, split: str, target_stem: str,
                 stems: Optional[Sequence[str]] = None,
                 target_length: Optional[int] = None, fs: int = 44100,
                 npy_memmap: bool = False):
        if stems is None:
            stems = self.ALLOWED_STEMS
        data_path = os.path.join(data_root, target_stem, split)
        files = sorted(f for f in os.listdir(data_path)
                       if not f.startswith("."))
        super().__init__(split=split, stems=stems, files=files,
                         data_path=data_path, fs=fs, npy_memmap=npy_memmap)
        self.n_segments = len(files)
        self.target_stem = target_stem
        self.target_length = (target_length if target_length is not None
                              else self.n_segments)

    def __len__(self) -> int:
        return self.target_length

    def get_identifier(self, index: int) -> Dict[str, Any]:
        return super().get_identifier(index % self.n_segments)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        return super().__getitem__(index % self.n_segments)


class MUSDB18SadOnTheFlyAugmentedDataset(MUSDB18SadDataset):
    """SAD segments with on-the-fly stem shuffling + per-chunk random gain
    (reference musdb/dataset.py:170-259): non-target stems are swapped to a
    random other segment with ``apply_probability``, a random chunk of each
    stem is scaled by U[range] dB (or dropped with ``drop_probability``),
    the mixture is recomputed, and the item is rescaled if it clips."""

    def __init__(self, data_root: str, split: str, target_stem: str,
                 stems: Optional[Sequence[str]] = None,
                 target_length: int = 20000,
                 apply_probability: Optional[float] = None,
                 chunk_size_second: float = 3.0,
                 random_scale_range_db: Tuple[float, float] = (-10, 10),
                 drop_probability: float = 0.1, rescale: bool = True,
                 fs: int = 44100, npy_memmap: bool = False,
                 seed: Optional[int] = None):
        super().__init__(data_root, split, target_stem, stems=stems,
                         fs=fs, npy_memmap=npy_memmap)
        if apply_probability is None:
            apply_probability = (target_length - self.n_segments) / target_length
        self.apply_probability = apply_probability
        self.drop_probability = drop_probability
        self.chunk_size_sample = int(chunk_size_second * self.fs)
        self.random_scale_range_db = random_scale_range_db
        self.rescale = rescale
        self.target_length = target_length
        self.rng = np.random.default_rng(seed)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        identifier = self.get_identifier(index)
        audio: Dict[str, np.ndarray] = {}
        for stem in self.stems_no_mixture:
            if stem == self.target_stem or self.rng.random() >= self.apply_probability:
                ident = identifier
            else:
                ident = self.get_identifier(int(self.rng.integers(self.n_segments)))
            x = np.array(self.get_stem(stem=stem, identifier=ident),
                         dtype=np.float32)
            t = x.shape[-1]
            start = (int(self.rng.integers(t - self.chunk_size_sample))
                     if self.chunk_size_sample < t else 0)
            if self.rng.random() < self.drop_probability:
                scale = np.float32(0.0)
            else:
                db = self.rng.uniform(*self.random_scale_range_db)
                scale = np.float32(10.0 ** (db / 20.0))
            x[..., start:start + self.chunk_size_sample] *= scale
            audio[stem] = x
        audio["mixture"] = self.compute_mixture(audio)
        if self.rescale:
            max_abs = max(float(np.abs(v).max()) for v in audio.values())
            if max_abs > 1.0:
                audio = {k: v / max_abs for k, v in audio.items()}
        return {"audio": audio,
                "track": f"{self.split}/{identifier['track']}"}


# ---------------------------------------------------------------------------
# DnR — Divide and Remaster (reference dnr/dataset.py:15-392)
# ---------------------------------------------------------------------------

class DnRDataset(SourceSeparationDataset):
    """DnR v2: ``data_root/{tr,cv,tt}/<track>/{mix,speech,music,sfx}.*``.
    The pseudo-stem ``mne`` (music-and-effects) is music + sfx summed at
    load (reference dnr/dataset.py:54-60)."""

    ALLOWED_STEMS = ["mixture", "speech", "music", "effects", "mne"]
    STEM_NAME_MAP = {"mixture": "mix", "speech": "speech",
                     "music": "music", "effects": "sfx"}
    SPLIT_NAME_MAP = {"train": "tr", "val": "cv", "test": "tt"}
    EXPECTED_TRACKS = {"train": 3406, "val": 487, "test": 973}

    FULL_TRACK_LENGTH_SECOND = 60

    def __init__(self, data_root: str, split: str,
                 stems: Optional[Sequence[str]] = None, fs: int = 44100,
                 npy_memmap: bool = True, strict: bool = True):
        if stems is None:
            stems = self.ALLOWED_STEMS
        data_path = os.path.join(data_root, self.SPLIT_NAME_MAP[split])
        files = sorted(f for f in os.listdir(data_path)
                       if not f.startswith(".")
                       and os.path.isdir(os.path.join(data_path, f)))
        if strict and len(files) != self.EXPECTED_TRACKS[split]:
            raise ValueError(
                f"expected {self.EXPECTED_TRACKS[split]} {split} tracks, "
                f"found {len(files)}")
        super().__init__(split=split, stems=stems, files=files,
                         data_path=data_path, fs=fs, npy_memmap=npy_memmap)

    @property
    def full_track_length_samples(self) -> int:
        return self.FULL_TRACK_LENGTH_SECOND * self.fs

    def get_stem(self, *, stem: str, identifier: Dict[str, Any]) -> np.ndarray:
        if stem == "mne":
            return (np.asarray(self.get_stem(stem="music", identifier=identifier),
                               np.float32)
                    + np.asarray(self.get_stem(stem="effects", identifier=identifier),
                                 np.float32))
        return super().get_stem(stem=stem, identifier=identifier)


class DnRRandomChunkDataset(DnRDataset):
    """Random fixed-length chunks of DnR tracks; ``target_length`` defines
    the virtual epoch (reference dnr/dataset.py:135-229)."""

    def __init__(self, data_root: str, split: str, target_length: int,
                 chunk_size_second: float,
                 stems: Optional[Sequence[str]] = None, fs: int = 44100,
                 npy_memmap: bool = True, strict: bool = True,
                 seed: Optional[int] = None):
        super().__init__(data_root, split, stems=stems, fs=fs,
                         npy_memmap=npy_memmap, strict=strict)
        self.target_length = target_length
        self.chunk_size = int(chunk_size_second * fs)
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self.target_length

    def get_identifier(self, index: int) -> Dict[str, Any]:
        return super().get_identifier(index % len(self.files))

    def __getitem__(self, index: int) -> Dict[str, Any]:
        identifier = self.get_identifier(index)
        total = self.full_track_length_samples
        hi = max(1, total - self.chunk_size)
        start = int(self.rng.integers(hi))
        end = start + self.chunk_size
        audio = {s: np.asarray(
            self.get_stem(stem=s, identifier=identifier)[..., start:end],
            np.float32) for s in self.stems}
        return {"audio": audio,
                "track": f"{self.split}/{identifier['track']}"}


class DnRDeterministicChunkDataset(DnRDataset):
    """Strided deterministic chunks (reference dnr/dataset.py:232-307):
    item = chunk-major over (n_chunks_per_track, n_tracks)."""

    def __init__(self, data_root: str, split: str, chunk_size_second: float,
                 hop_size_second: float,
                 stems: Optional[Sequence[str]] = None, fs: int = 44100,
                 npy_memmap: bool = True, strict: bool = True):
        super().__init__(data_root, split, stems=stems, fs=fs,
                         npy_memmap=npy_memmap, strict=strict)
        self.chunk_size = int(chunk_size_second * fs)
        self.hop_size = int(hop_size_second * fs)
        self.n_chunks_per_track = int(
            (self.FULL_TRACK_LENGTH_SECOND - chunk_size_second)
            / hop_size_second)

    def __len__(self) -> int:
        return len(self.files) * self.n_chunks_per_track

    def __getitem__(self, index: int) -> Dict[str, Any]:
        n_tracks = len(self.files)
        chunk = index // n_tracks
        identifier = super().get_identifier(index % n_tracks)
        start = chunk * self.hop_size
        end = start + self.chunk_size
        audio = {s: np.asarray(
            self.get_stem(stem=s, identifier=identifier)[..., start:end],
            np.float32) for s in self.stems}
        return {"audio": audio,
                "track": f"{self.split}/{identifier['track']}"}


def _noise_reverb(speech: np.ndarray, fs: int, rng: np.random.Generator,
                  room_size: float, damping: float, wet_level: float,
                  dry_level: float, width: float) -> np.ndarray:
    """Exponentially-decaying-noise reverb (wet/dry mix).

    Clean-room stand-in for the reference's pedalboard.Reverb
    (dnr/dataset.py:352-358; pedalboard is unavailable offline): an IR of
    decorrelated noise with RT60 scaled by room_size and a damping
    low-pass, applied per channel via FFT convolution. Width blends the
    two channels' wet signals toward mono.
    """
    from scipy.signal import fftconvolve

    x = np.atleast_2d(np.asarray(speech, np.float32))
    rt60 = 0.1 + 0.9 * float(room_size)  # 0.1..1.0 s
    n_ir = max(int(rt60 * fs), 64)
    t = np.arange(n_ir, dtype=np.float32) / fs
    decay = np.exp(-6.908 * t / rt60)  # -60 dB at rt60
    irs = []
    for _ in range(x.shape[0]):
        ir = rng.standard_normal(n_ir).astype(np.float32) * decay
        alpha = 0.05 + 0.9 * float(damping)  # one-pole low-pass strength
        if alpha > 0:
            ir = np.asarray(np.append(ir[0], ir[1:] * (1 - alpha)), np.float32)
            for _pass in range(1):
                ir = np.convolve(ir, np.asarray([1 - alpha, alpha],
                                                np.float32))[:n_ir]
        ir /= max(np.sqrt((ir ** 2).sum()), 1e-6)
        irs.append(ir)
    wet = np.stack([fftconvolve(x[c], irs[c])[: x.shape[-1]]
                    for c in range(x.shape[0])])
    if x.shape[0] == 2:
        mono = wet.mean(axis=0, keepdims=True)
        wet = float(width) * wet + (1.0 - float(width)) * mono
    out = (np.float32(dry_level) * x + np.float32(wet_level) * wet)
    return out if np.ndim(speech) == 2 else out[0]


class DnRRandomChunkDatasetWithSpeechReverb(DnRRandomChunkDataset):
    """Random chunks with randomized reverb on the speech stem and the
    mixture recomputed (reference dnr/dataset.py:310-368)."""

    def __init__(self, data_root: str, split: str, target_length: int,
                 chunk_size_second: float,
                 stems: Optional[Sequence[str]] = None, fs: int = 44100,
                 npy_memmap: bool = True, strict: bool = True,
                 seed: Optional[int] = None):
        if stems is None:
            stems = self.ALLOWED_STEMS
        stems_no_mixture = [s for s in stems if s != "mixture"]
        super().__init__(data_root, split, target_length, chunk_size_second,
                         stems=stems_no_mixture, fs=fs, npy_memmap=npy_memmap,
                         strict=strict, seed=seed)
        self.stems = list(stems)
        self.stems_no_mixture = stems_no_mixture

    def __getitem__(self, index: int) -> Dict[str, Any]:
        item = super().__getitem__(index)
        wet_level = float(self.rng.random())
        item["audio"]["speech"] = _noise_reverb(
            item["audio"]["speech"], self.fs, self.rng,
            room_size=float(self.rng.random()),
            damping=float(self.rng.random()),
            wet_level=wet_level, dry_level=1.0 - wet_level,
            width=float(self.rng.random()))
        item["audio"]["mixture"] = sum(
            item["audio"][s] for s in self.stems_no_mixture)
        return item


# ---------------------------------------------------------------------------
# Batching
# ---------------------------------------------------------------------------

def batch_iterator(dataset, batch_size: int, *, shuffle: bool = True,
                   seed: Optional[int] = None, drop_last: bool = True,
                   epochs: Optional[int] = None,
                   ) -> Iterator[Dict[str, Any]]:
    """Yield ``{"audio": {stem: (B, C, T)}, "track": [names]}`` batches.

    Stems are stacked with zero-padding to the longest item in the batch
    (full-track datasets have ragged lengths; chunked ones don't pad).
    """
    n = len(dataset)
    rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(n) if shuffle else np.arange(n)
        for b0 in range(0, n, batch_size):
            idx = order[b0:b0 + batch_size]
            if len(idx) < batch_size and drop_last:
                break
            items = [dataset[int(i)] for i in idx]
            stems = items[0]["audio"].keys()
            t_max = max(int(np.asarray(it["audio"][s]).shape[-1])
                        for it in items for s in stems)
            audio = {}
            for s in stems:
                rows = []
                for it in items:
                    x = np.atleast_2d(np.asarray(it["audio"][s], np.float32))
                    if x.shape[-1] < t_max:
                        x = np.pad(x, ((0, 0), (0, t_max - x.shape[-1])))
                    rows.append(x)
                audio[s] = np.stack(rows)
            yield {"audio": audio, "track": [it["track"] for it in items]}
        epoch += 1
