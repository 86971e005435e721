"""Throughput counters and device tracing (counterpart of
sesa_tpu/runtime/profiling.py; reference benchmark_pytorch.py:44-153 and
pytorch_backend.py:593-621 ``get_model_info``): a realtime-factor and
chunks-per-second tracker that the demix progress callback can feed, a
parameter count and size report over the port's parameter trees, and a
context manager around ``torch.profiler`` that writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch

from sesa_tpu_torch.tree import tree_map


@dataclass
class ThroughputTracker:
    """Track realtime factor and chunk throughput during separation."""

    sample_rate: int = 44100
    started: float = field(default_factory=time.time)
    samples_done: int = 0
    chunks_done: int = 0

    def update(self, samples: int = 0, chunks: int = 0) -> None:
        self.samples_done += samples
        self.chunks_done += chunks

    @property
    def elapsed(self) -> float:
        return max(1e-9, time.time() - self.started)

    @property
    def rtf(self) -> float:
        """Audio seconds processed per wall second."""
        return (self.samples_done / self.sample_rate) / self.elapsed

    @property
    def chunks_per_sec(self) -> float:
        return self.chunks_done / self.elapsed

    def report(self) -> str:
        return (f"{self.samples_done / self.sample_rate:.1f}s audio in "
                f"{self.elapsed:.1f}s — RTF {self.rtf:.1f}x, "
                f"{self.chunks_per_sec:.2f} chunks/s")


def get_model_info(params, model_type: str = "") -> dict:
    """Parameter count / memory report of a tree of tensors (reference
    pytorch_backend.py:593-621)."""
    leaves = []
    tree_map(leaves.append, params)
    return {
        "model_type": model_type,
        "parameters": int(sum(leaf.numel() for leaf in leaves)),
        "size_mb": sum(leaf.numel() * leaf.element_size() for leaf in leaves) / 1024 / 1024,
        "arrays": len(leaves),
    }


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile a block with ``torch.profiler`` (CPU activity, and CUDA when a
    GPU is visible) and write it to ``log_dir`` as a Chrome trace
    (``trace_<pid>_<ns>.json``; open it in Perfetto or chrome://tracing)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    # start OUTSIDE the try: if starting raises (another profiler is
    # active), stopping here would end the OUTER profile
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
