"""Config-driven stem augmentation for training batches (counterpart of
sesa_tpu/data/augmentation.py).

The reference's ``StemAugmentor`` (reference
models/bandit/core/data/augmentation.py:17-109) wraps
``torch_audiomentations`` modules behind a per-stem config dict. Here, as
in the JAX package, the augmentations are plain numpy on the host: they are
branchy per-example random control flow, and the trainer uploads the
augmented batch once per step. The draws from the ``np.random.Generator``
are the JAX package's, in its order, so one seed gives the same batch bit
for bit in both packages.

Config shape (same as the reference's ``audiomentations`` dict):

    {
      "[common]":  {"name": "Gain", "kwargs": {"min_gain_in_db": -6, ...}},
      "[default]": {"name": "Compose", "kwargs": {"transforms": [...],
                                                   "kwargs": {...}}},
      "vocals":    {"name": "PolarityInversion", "kwargs": {"p": 0.5}},
    }

Reference semantics (augmentation.py:80-109): ``[common]`` applies to every
stem first; a stem-specific entry applies next; stems with no entry get
``[default]`` unless ``[common]`` already ran (override with
``apply_both_default_and_common``). The mixture is recomputed as the sum of
the augmented stems, and clipping is fixed by a shared random rescale
1/(max_abs + U[0, scaler_margin)).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np

__all__ = ["StemAugmentor", "build_augmentation", "AUGMENTATIONS"]


def _per_example(audio: np.ndarray, rng: np.random.Generator, p: float,
                 fn: Callable[[np.ndarray, np.random.Generator], np.ndarray],
                 ) -> np.ndarray:
    """Apply ``fn`` to each (C, T) example independently with prob ``p``
    (torch_audiomentations applies per example within the batch)."""
    out = np.array(audio, copy=True)
    for b in range(out.shape[0]):
        if rng.random() < p:
            out[b] = fn(out[b], rng)
    return out


class Gain:
    """Random gain in dB (torch_audiomentations.Gain semantics)."""

    def __init__(self, min_gain_in_db: float = -18.0,
                 max_gain_in_db: float = 6.0, p: float = 0.5, **_: Any):
        self.lo, self.hi, self.p = float(min_gain_in_db), float(max_gain_in_db), p

    def __call__(self, audio, rng):
        def fn(x, r):
            return x * np.float32(10.0 ** (r.uniform(self.lo, self.hi) / 20.0))
        return _per_example(audio, rng, self.p, fn)


class PolarityInversion:
    def __init__(self, p: float = 0.5, **_: Any):
        self.p = p

    def __call__(self, audio, rng):
        return _per_example(audio, rng, self.p, lambda x, r: -x)


class Shift:
    """Circular (or zero-fill) time shift by a random fraction/samples."""

    def __init__(self, min_shift: float = -0.5, max_shift: float = 0.5,
                 shift_unit: str = "fraction", rollover: bool = True,
                 p: float = 0.5, sample_rate: Optional[int] = None, **_: Any):
        self.lo, self.hi = float(min_shift), float(max_shift)
        self.unit = shift_unit
        self.rollover = rollover
        self.p = p
        self.sr = sample_rate

    def _n_samples(self, r: np.random.Generator, t: int) -> int:
        v = r.uniform(self.lo, self.hi)
        if self.unit == "fraction":
            return int(round(v * t))
        if self.unit == "seconds":
            if not self.sr:
                raise ValueError("Shift(shift_unit='seconds') needs sample_rate")
            return int(round(v * self.sr))
        return int(round(v))  # "samples"

    def __call__(self, audio, rng):
        def fn(x, r):
            n = self._n_samples(r, x.shape[-1])
            if n == 0:
                return x
            y = np.roll(x, n, axis=-1)
            if not self.rollover:
                if n > 0:
                    y[..., :n] = 0.0
                else:
                    y[..., n:] = 0.0
            return y
        return _per_example(audio, rng, self.p, fn)


class PeakNormalization:
    def __init__(self, p: float = 0.5, **_: Any):
        self.p = p

    def __call__(self, audio, rng):
        def fn(x, r):
            peak = np.abs(x).max()
            return x / peak if peak > 0 else x
        return _per_example(audio, rng, self.p, fn)


class ShuffleChannels:
    def __init__(self, p: float = 0.5, **_: Any):
        self.p = p

    def __call__(self, audio, rng):
        def fn(x, r):
            return x[r.permutation(x.shape[0])]
        return _per_example(audio, rng, self.p, fn)


class Identity:
    def __init__(self, **_: Any):
        pass

    def __call__(self, audio, rng):
        return audio


class Compose:
    def __init__(self, transforms, **_: Any):
        self.transforms = list(transforms)

    def __call__(self, audio, rng):
        for t in self.transforms:
            audio = t(audio, rng)
        return audio


AUGMENTATIONS: Dict[str, type] = {
    "Gain": Gain,
    "PolarityInversion": PolarityInversion,
    "Shift": Shift,
    "PeakNormalization": PeakNormalization,
    "ShuffleChannels": ShuffleChannels,
    "Identity": Identity,
}


def build_augmentation(spec: Dict[str, Any]):
    """{"name": ..., "kwargs": {...}} -> transform callable.

    ``Compose`` follows the reference's nested shape
    (augmentation.py:34-46): kwargs = {"transforms": [spec...],
    "kwargs": {...}} where the inner kwargs go to Compose itself.
    """
    name = spec["name"]
    kwargs = dict(spec.get("kwargs", {}))
    if name == "Compose":
        inner = [build_augmentation(s) for s in kwargs.pop("transforms", [])]
        return Compose(inner, **kwargs.pop("kwargs", {}), **kwargs)
    if name not in AUGMENTATIONS:
        raise NameError(f"unknown augmentation {name!r}; "
                        f"available: {sorted(AUGMENTATIONS)}")
    return AUGMENTATIONS[name](**kwargs)


class StemAugmentor:
    """Per-stem augmentation + mixture recompute + clipping fix.

    Operates on a batch dict ``{"audio": {stem: (B, C, T) or (C, T)}}``
    (the reference's BatchedDataDict / DataDict shapes) and returns the
    same structure with ``mixture`` recomputed from the augmented stems.
    """

    def __init__(self, audiomentations: Dict[str, Dict[str, Any]],
                 fix_clipping: bool = True, scaler_margin: float = 0.5,
                 apply_both_default_and_common: bool = False,
                 seed: Optional[int] = None):
        self.augmentations = {stem: build_augmentation(spec)
                              for stem, spec in audiomentations.items()}
        self.has_default = "[default]" in self.augmentations
        self.has_common = "[common]" in self.augmentations
        self.apply_both_default_and_common = apply_both_default_and_common
        self.fix_clipping = fix_clipping
        self.scaler_margin = float(scaler_margin)
        self.rng = np.random.default_rng(seed)

    def __call__(self, item: Dict[str, Any]) -> Dict[str, Any]:
        audio = dict(item["audio"])
        batched = {s: np.ndim(a) == 3 for s, a in audio.items()}
        work = {s: np.asarray(a, np.float32) if batched[s]
                else np.asarray(a, np.float32)[None] for s, a in audio.items()}

        for stem in work:
            if stem == "mixture":
                continue
            if self.has_common:
                work[stem] = self.augmentations["[common]"](work[stem], self.rng)
            if stem in self.augmentations:
                work[stem] = self.augmentations[stem](work[stem], self.rng)
            elif self.has_default and (not self.has_common
                                       or self.apply_both_default_and_common):
                work[stem] = self.augmentations["[default]"](work[stem], self.rng)

        work["mixture"] = sum(v for s, v in work.items() if s != "mixture")

        if self.fix_clipping:
            max_abs = max(float(np.abs(v).max()) for v in work.values())
            if max_abs > 1.0:
                scaler = np.float32(
                    1.0 / (max_abs + self.rng.random() * self.scaler_margin))
                work = {s: v * scaler for s, v in work.items()}

        out = dict(item)
        out["audio"] = {s: v if batched.get(s, True) else v[0]
                        for s, v in work.items()}
        return out
