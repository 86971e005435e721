"""The one traffic generator: a mix file of ``traffic/`` read into items.

A mix is a closed loop of one client: each item is a stereo recording sent
after the previous one has come back. The mix file gives the length range,
the number of strata, the session's settings, and how many items and spans
the check compares. Every seed draws lengths from the same strata in
blocks (block j holds one length from each stratum, in an order and at an
offset inside the stratum drawn from the seed), so any run of consecutive
items covers the range evenly and seeds differ in order, not in work.

The audio is music-like and made on the host from the seed: a bank of short
motifs (decaying harmonic notes, a noise-burst beat, a stereo pan), each
quantised to 16-bit PCM at a few gain levels (every sample is n / 32768, as
decoded CD audio is), strung together in an order drawn from the seed. Item i is the same for a seed whenever
it is asked for, so the check can make it again after the window.
"""

from __future__ import annotations

import numpy as np

_MASK = (1 << 63) - 1


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([seed & _MASK, *stream])


class Mix:
    """Items of one traffic mix for one seed."""

    def __init__(self, spec: dict, seed: int):
        self.spec, self.seed = spec, seed
        self.sr = int(spec.get("sample_rate", 44100))
        self.channels = int(spec.get("channels", 2))
        self._bank = None

    def length(self, i: int) -> int:
        """Samples of item i."""
        lo, hi = self.spec["length_s"]
        k = int(self.spec.get("strata", 4))
        block, slot = divmod(i, k)
        r = _rng(self.seed, 1, block)
        stratum = r.permutation(k)[slot]
        offset = r.random(k)[slot]
        return int(round((lo + (hi - lo) * (stratum + offset) / k) * self.sr))

    def _motifs(self):
        """The bank: each motif at each gain level, already 16-bit exact, so
        a recording is a concatenation and costs a copy."""
        if self._bank is None:
            r = _rng(self.seed, 2)
            gains = np.linspace(0.2, 0.5, int(self.spec.get("gains", 4)))
            bank = []
            for _ in range(int(self.spec.get("motifs", 12))):
                n = int(self.sr * r.uniform(1.0, 3.0))
                t = np.arange(n) / self.sr
                sig = np.zeros(n)
                for _ in range(r.integers(2, 5)):  # notes
                    f0 = 55.0 * 2 ** (r.integers(0, 48) / 12)
                    onset = r.uniform(0, 0.5 * n / self.sr)
                    env = np.where(t >= onset, np.exp(-(t - onset) * r.uniform(1.0, 6.0)), 0.0)
                    for h in range(1, 6):
                        if f0 * h < 0.45 * self.sr:
                            sig += env * np.sin(2 * np.pi * f0 * h * t + r.uniform(0, 6.3)) / h
                beat = int(self.sr * r.uniform(0.25, 0.6))
                hit = r.standard_normal(n) * np.exp(-(t % (beat / self.sr)) * 40.0)
                pan = r.uniform(0.2, 0.8)
                mono = sig / max(np.abs(sig).max(), 1e-9) + 0.3 * hit
                st = np.stack([mono * pan, mono * (1 - pan)] if self.channels == 2 else [mono])
                st = st / max(np.abs(st).max(), 1e-9)
                bank.append([(np.round(st * g * 32768.0) / 32768.0).astype(np.float32)
                             for g in gains])
            self._bank = bank
        return self._bank

    def audio(self, i: int) -> np.ndarray:
        """Item i: (channels, length) float32, every sample n / 32768."""
        return self._synth(_rng(self.seed, 3, i), self.length(i))

    def warm_audio(self, n: int) -> np.ndarray:
        """A warm-up recording of n samples, from a stream of its own."""
        return self._synth(_rng(self.seed, 6, n), n)

    def _synth(self, r: np.random.Generator, n: int) -> np.ndarray:
        bank = self._motifs()
        out = np.empty((self.channels, n), dtype=np.float32)
        have = 0
        while have < n:
            motif = bank[r.integers(len(bank))]
            m = motif[r.integers(len(motif))]
            take = min(m.shape[-1], n - have)
            out[:, have:have + take] = m[:, :take]
            have += take
        return out

    def spans(self, i: int, step: int):
        """The output spans of item i the check may compare: the whole item
        when it is short, else its first and last ``step`` samples and one
        more at an offset drawn from the seed."""
        n = self.length(i)
        if n <= 3 * step:
            return [(0, n)]
        mid = int(_rng(self.seed, 4, i).integers(step, n - 2 * step))
        return [(0, step), (mid, mid + step), (n - step, n)]

    def checked(self, done: int) -> list:
        """Items of the first ``done`` to compare: the longest of them and
        others drawn from the seed, ``check_items`` in all."""
        want = min(int(self.spec.get("check_items", 3)), done)
        if want == 0:
            return []
        longest = max(range(done), key=self.length)
        rest = [i for i in _rng(self.seed, 5).permutation(done).tolist() if i != longest]
        return sorted([longest] + rest[:want - 1])
