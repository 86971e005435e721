"""From a ``torch.profiler`` trace of the window to the numbers the per-layer
metrics read.

Device activity is every CUDA event of the trace (kernels, copies, sets)
except the device-side marks of the harness's own ``bench::`` spans, one
span a call. The device is busy where the union of those intervals lies
(chip_smoke.py's ``_union_us`` method, copied): two streams that overlap
count once. The window is the calls' spans: what the harness does between
calls (making the next input) is not the program's and is left out. Kernel
time by family comes from the name table in ``kernels/`` (one file per
family); a ``sesa::`` kernel that no file names fails the run, so a renamed
kernel cannot read as 0. A name that several families share (the GEMM
template serves K1, K2 and others) goes to the one family among them whose
launch counter moved in the window; if several moved, the run fails.
"""

from __future__ import annotations

import bisect
import glob
import json
import os
import re
from typing import Dict, List, Tuple

import numpy as np

SPAN_PREFIX = "bench::"


def union_runs(intervals) -> List[Tuple[float, float]]:
    """Disjoint sorted runs covering the (start, end) intervals."""
    runs: List[List[float]] = []
    for start, end in sorted(intervals):
        if runs and start <= runs[-1][1]:
            runs[-1][1] = max(runs[-1][1], end)
        else:
            runs.append([start, end])
    return [(a, b) for a, b in runs]


def covered(runs, lo: float, hi: float, starts=None) -> float:
    """Length of [lo, hi) that the runs cover (``starts``: the runs' starts)."""
    starts = [a for a, _ in runs] if starts is None else starts
    k = max(bisect.bisect_right(starts, lo) - 1, 0)
    total = 0.0
    while k < len(runs) and runs[k][0] < hi:
        a, b = runs[k]
        total += max(0.0, min(b, hi) - max(a, lo))
        k += 1
    return total


def load_kernel_table(folder: str) -> Dict[str, dict]:
    """{family: {"patterns": [compiled], "counter": dotted name}} from kernels/*.json."""
    table = {}
    for path in sorted(glob.glob(os.path.join(folder, "*.json"))):
        with open(path) as f:
            entry = json.load(f)
        table[entry["family"]] = {"patterns": [re.compile(p) for p in entry["patterns"]],
                                  "counter": entry["counter"]}
    return table


def kind_of(name: str) -> str:
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


class Trace:
    """The window's trace, reduced. Times in microseconds on the trace's clock."""

    def __init__(self, events, table: Dict[str, dict], moved: Dict[str, int]):
        from torch.autograd import DeviceType

        self.device: List[Tuple[str, float, float]] = []
        cpu = []
        self.spans: List[Tuple[str, float, float]] = []
        main = set()
        for e in events:
            tr = e.time_range
            if e.name.startswith(SPAN_PREFIX):
                if e.device_type == DeviceType.CPU:
                    self.spans.append((e.name, tr.start, tr.end))
                    main.add(e.thread)
                continue
            if e.device_type == DeviceType.CUDA:
                if tr.end > tr.start:
                    self.device.append((e.name, tr.start, tr.end))
            else:
                cpu.append((e.name, tr.start, tr.end, e.thread))
        if not self.spans:
            raise RuntimeError("the trace holds none of the harness's spans")
        if not any(kind_of(n) == "kernel" for n, _, _ in self.device):
            raise RuntimeError("the trace holds no device kernel")
        self.spans.sort(key=lambda s: s[1])
        # the host ops of the thread that runs the calls
        self._cpu = [c for c in cpu if c[3] in main]
        self.runs = union_runs((s, e) for _, s, e in self.device)
        self._starts = [a for a, _ in self.runs]
        self.families = self._classify(table, moved)

    def _classify(self, table, moved) -> Dict[str, float]:
        by_name: Dict[str, float] = {}
        for name, s, e in self.device:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
        fam: Dict[str, float] = {f: 0.0 for f in table}
        unmapped, ambiguous = [], []
        for name, us in by_name.items():
            hits = [f for f, t in table.items() if any(p.search(name) for p in t["patterns"])]
            if len(hits) > 1:
                hits = [f for f in hits if moved.get(f, 0) > 0]
            if not hits:
                if "sesa::" in name:
                    unmapped.append(name)
                continue
            if len(hits) > 1:
                ambiguous.append((name, hits))
                continue
            fam[hits[0]] += us
        if unmapped:
            raise RuntimeError(f"sesa:: kernels in no family of kernels/: {unmapped}")
        if ambiguous:
            raise RuntimeError(f"kernels shared by families that both launched: {ambiguous}")
        self.by_name = by_name
        return fam

    # -- what the readers ask for --------------------------------------------------

    def window_us(self) -> float:
        """The traced window: the calls' spans, the harness's work between
        calls (making the next input) left out."""
        return sum(e - s for _, s, e in self.spans)

    def busy_us(self, lo=None, hi=None) -> float:
        """Device busy time within [lo, hi), or within the calls' spans."""
        if lo is None:
            return sum(covered(self.runs, s, e, self._starts) for _, s, e in self.spans)
        return covered(self.runs, lo, hi, self._starts)

    def kind_us(self, kind: str, prefixes=()) -> float:
        return sum(e - s for n, s, e in self.device
                   if kind_of(n) == kind and (not prefixes or n.startswith(prefixes)))

    def kernel_count(self) -> int:
        return sum(1 for n, _, _ in self.device if kind_of(n) == "kernel")

    def sesa_kernel_us(self) -> float:
        return sum(e - s for n, s, e in self.device if kind_of(n) == "kernel" and "sesa::" in n)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps inside the calls, each named by the harness's span and the
        innermost host op the gap's midpoint falls in."""
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        for _, w0, w1 in self.spans:
            k = max(bisect.bisect_right(self._starts, w0) - 1, 0)
            inside = [(w0, w0)]
            while k < len(self.runs) and self.runs[k][0] < w1:
                inside.append(self.runs[k])
                k += 1
            inside.append((w1, w1))
            gaps += [(max(a[1], w0), min(b[0], w1)) for a, b in zip(inside, inside[1:])
                     if min(b[0], w1) > max(a[1], w0)]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        starts = np.array([c[1] for c in self._cpu]) if self._cpu else np.zeros(0)
        ends = np.array([c[2] for c in self._cpu]) if self._cpu else np.zeros(0)
        labelled = []
        for g0, g1 in gaps:
            t = 0.5 * (g0 + g1)
            span = next(n for n, s, e in self.spans if s <= t <= e)
            inside = np.nonzero((starts <= t) & (ends >= t))[0]
            op = self._cpu[inside[np.argmax(starts[inside])]][0] if len(inside) else "python"
            labelled.append([f"{span} / {op}"[:160], (g1 - g0) * 1e-6])
        return {"device_ops": [[n[:160], us * 1e-6] for n, us in ops], "idle_gaps": labelled}
