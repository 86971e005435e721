"""Overlap-add separation of a song, as Music-Source-Separation-Training's
``demix`` (utils) does it at batch size 1, evaluated only where asked.

A song longer than two borders (border = chunk − step, step = chunk /
overlap) is reflect-padded by a border on each side. Chunks start every
``step`` samples; a chunk that runs past the end is reflect-padded when more
than half a chunk of it is real, else zero-padded. Each chunk's output is
weighted by a linear fade window (``fade = chunk // 10`` samples, both ends
0) with no fade-in on the first chunk and no fade-out on the last, summed,
and divided by the summed weights; the border is cropped off.

:func:`regions` evaluates that result on a few spans of the output without
running the chunks that do not touch them.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np


class Layout:
    """Chunk positions of one song of ``length`` samples."""

    def __init__(self, length: int, chunk: int, overlap: int):
        self.chunk, self.step = chunk, chunk // overlap
        self.border = chunk - self.step
        self.padded = self.border > 0 and length > 2 * self.border
        self.pad = self.border if self.padded else 0
        self.total = length + 2 * self.pad
        self.n_chunks = max(1, -(-self.total // self.step))
        self.length = length

    def window(self, i: int) -> np.ndarray:
        c, fade = self.chunk, self.chunk // 10
        w = np.ones(c, dtype=np.float64)
        if fade > 0:
            w[:fade] = np.linspace(0.0, 1.0, fade)
            w[-fade:] = np.linspace(1.0, 0.0, fade)
            if i == 0:
                w[:fade] = 1.0
            elif i == self.n_chunks - 1:
                w[-fade:] = 1.0
        return w

    def chunk_input(self, mix: np.ndarray, i: int) -> np.ndarray:
        """Chunk ``i`` of the (ch, L) song, padded as the published demix pads it."""
        song = np.pad(mix, ((0, 0), (self.pad, self.pad)), mode="reflect") if self.pad else mix
        start = i * self.step
        part = song[:, start:start + self.chunk]
        real = part.shape[-1]
        if real < self.chunk:
            mode = "reflect" if real > self.chunk // 2 else "constant"
            part = np.pad(part, ((0, 0), (0, self.chunk - real)), mode=mode)
        return part

    def chunks_for(self, lo: int, hi: int) -> List[int]:
        """Chunks whose span touches output samples [lo, hi)."""
        a, b = lo + self.pad, hi + self.pad
        return [i for i in range(self.n_chunks)
                if i * self.step < b and i * self.step + self.chunk > a]


def regions(model: Callable[[np.ndarray], np.ndarray], mix: np.ndarray, chunk: int,
            overlap: int, spans: List[Tuple[int, int]]) -> Dict[Tuple[int, int], np.ndarray]:
    """{(lo, hi): stems (S, ch, hi - lo)} of the output at each span.
    ``model`` maps a (B, ch, chunk) batch to (B, S, ch, chunk)."""
    lay = Layout(mix.shape[-1], chunk, overlap)
    needed = sorted({i for lo, hi in spans for i in lay.chunks_for(lo, hi)})
    outs = {}
    for i in needed:
        outs[i] = model(lay.chunk_input(mix, i)[None])[0].astype(np.float64)
    result = {}
    for lo, hi in spans:
        a, b = lo + lay.pad, hi + lay.pad
        acc = np.zeros(outs[needed[0]].shape[:-1] + (hi - lo,))
        cnt = np.zeros(hi - lo)
        for i in lay.chunks_for(lo, hi):
            s = i * lay.step
            # the part of chunk i inside [a, b), in chunk and in span coordinates
            c0, c1 = max(a, s), min(b, s + chunk)
            w = lay.window(i)[c0 - s:c1 - s]
            acc[..., c0 - a:c1 - a] += outs[i][..., c0 - s:c1 - s] * w
            cnt[c0 - a:c1 - a] += w
        result[(lo, hi)] = np.where(cnt > 0, acc / np.where(cnt > 0, cnt, 1.0), 0.0)
    return result
