"""Multi-model ensembling: waveform and spectral combination methods
(counterpart of sesa_tpu/postprocess/ensemble.py).

Functional parity with the reference's AudioEnsembleEngine (reference
ensemble.py:172-256, 258-407): waveform methods avg (weighted) / median /
max / min, and spectral methods max_fft / min_fft / median_fft (magnitude
reduction with the first file's phase, scipy STFT nperseg min(1024,
samples), 50% overlap, falling back to avg_wave on failure).

Three surfaces: ``ensemble_waveforms`` combines in-memory stems on the host
with numpy; ``ensemble_waveforms_device`` combines tensors where they lie
(stems that a separation left on the card stay there for the phase fixer
and Apollo); ``ensemble_files`` streams 32768-frame buffers through aligned
readers with bounded memory for arbitrarily long files, as the reference's
streaming engine (ensemble.py:319).
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional, Sequence

import numpy as np
import torch

ENSEMBLE_METHODS = (
    "avg_wave", "median_wave", "max_wave", "min_wave",
    "max_fft", "min_fft", "median_fft",
)


def _check_method(method: str) -> None:
    if method not in ENSEMBLE_METHODS:
        raise ValueError(f"Invalid method '{method}'. Available: {list(ENSEMBLE_METHODS)}")


def _spectral_combine(stack: np.ndarray, method: str) -> Optional[np.ndarray]:
    """scipy-STFT magnitude reduction, phase of the first file (reference
    ensemble.py:185-256); None when the input is too short."""
    from scipy.signal import istft, stft

    n, ch, t = stack.shape
    if t < 256:
        return None
    nperseg = min(1024, t)
    noverlap = nperseg // 2
    specs = np.stack([np.stack([stft(stack[i, c], nperseg=nperseg, noverlap=noverlap,
                                     window="hann")[2] for c in range(ch)])
                      for i in range(n)])  # (N, ch, F, Tf)
    mag = np.abs(specs)
    if method == "max_fft":
        combined = np.max(mag, axis=0)
    elif method == "min_fft":
        combined = np.min(mag, axis=0)
    elif method == "median_fft":
        combined = np.median(mag, axis=0)
    else:
        raise ValueError(method)
    combined_spec = combined * np.exp(1j * np.angle(specs[0]))
    out = np.zeros((ch, t), dtype=np.float32)
    for c in range(ch):
        _, xrec = istft(combined_spec[c], nperseg=nperseg, noverlap=noverlap, window="hann")
        if xrec.shape[0] < t:
            xrec = np.pad(xrec, (0, t - xrec.shape[0]))
        out[c] = xrec[:t]
    return out


def _check_weights(weights, n_inputs: int) -> None:
    """reference ensemble.py:288-293: the weight count must match the input
    count (a mismatch would otherwise surface mid-stream, after the output
    file was created)."""
    if weights is not None and len(weights) != n_inputs:
        raise ValueError(f"got {len(weights)} weights for {n_inputs} inputs; counts "
                         "must match")


def _waveform_combine_np(stack: np.ndarray, method: str,
                         weights: Optional[np.ndarray]) -> np.ndarray:
    if method == "avg_wave":
        if weights is not None:
            return np.tensordot(weights / weights.sum(), stack, axes=1).astype(np.float32)
        return stack.mean(axis=0)
    if method == "median_wave":
        return np.median(stack, axis=0).astype(np.float32)
    if method == "max_wave":
        return stack.max(axis=0)
    if method == "min_wave":
        return stack.min(axis=0)
    raise ValueError(method)


def ensemble_waveforms(waves: Sequence[np.ndarray], method: str = "avg_wave",
                       weights: Optional[Sequence[float]] = None) -> np.ndarray:
    """Combine N (ch, T) waveforms on the host into one (ch, T_min), truncating
    to the shortest (reference ensemble.py:319)."""
    _check_method(method)
    if not waves:
        raise ValueError("no input waveforms")
    _check_weights(weights, len(waves))
    tmin = min(w.shape[-1] for w in waves)
    stack = np.stack([np.asarray(w, dtype=np.float32)[..., :tmin] for w in waves])
    w = np.asarray(weights, dtype=np.float32) if weights is not None else None
    if method.endswith("_fft"):
        out = _spectral_combine(stack, method)
        if out is not None:
            return out
        method = "avg_wave"  # the reference falls back when the spectral path fails
    return _waveform_combine_np(stack, method, w)


def ensemble_waveforms_device(waves: Sequence[torch.Tensor], method: str = "avg_wave",
                              weights: Optional[Sequence[float]] = None) -> torch.Tensor:
    """Combiner for stems that are tensors (on the card after a separation
    with ``transport="device"``): the waveform methods of
    :func:`ensemble_waveforms`, computed where the stems lie and returned
    there. The spectral (``*_fft``) methods stay host-only: their reference
    semantics (boundary padding, odd-length istft) are pinned to scipy."""
    if method.endswith("_fft"):
        raise ValueError(f"device ensemble supports waveform methods only, got {method!r}; "
                         "copy the stems to the host and use ensemble_waveforms for spectral "
                         "methods")
    _check_method(method)
    if not waves:
        raise ValueError("no input waveforms")
    _check_weights(weights, len(waves))
    tmin = min(w.shape[-1] for w in waves)
    stack = torch.stack([w[..., :tmin].float() for w in waves])
    return combine_stack_device(stack, method, weights)


def combine_stack_device(stack: torch.Tensor, method: str, weights=None) -> torch.Tensor:
    """Waveform combine over a stacked (N, ...) tensor. The median of an even
    count is the mean of the two middle values (numpy's and the JAX
    package's; ``torch.median`` alone would return the lower one)."""
    if method == "avg_wave":
        if weights is not None:
            w = torch.as_tensor(weights, dtype=torch.float32, device=stack.device)
            return torch.tensordot(w / w.sum(), stack, dims=1)
        return stack.mean(dim=0)
    if method == "median_wave":
        n = stack.shape[0]
        ordered = stack.sort(dim=0).values
        return ordered[n // 2] if n % 2 else (ordered[n // 2 - 1] + ordered[n // 2]) * 0.5
    if method == "max_wave":
        return stack.amax(dim=0)
    if method == "min_wave":
        return stack.amin(dim=0)
    raise ValueError(method)


def ensemble_files(files: List[str], method: str, output_path: str,
                   weights: Optional[Sequence[float]] = None,
                   progress_cb=None, buffer_frames: int = 32768) -> str:
    """File-level ensemble, streaming (the reference's ensemble.py surface).

    Bounded memory for arbitrarily long inputs: N aligned streaming readers
    feed ``buffer_frames``-sized buffers, truncated to the shortest file,
    written incrementally as PCM_24. Waveform methods are pointwise across
    files, so chunking is exact; spectral methods reduce per buffer, as the
    reference's streaming engine. Returns the path written.
    """
    from sesa_tpu_torch.audio_io import AudioReader, AudioWriter

    _check_method(method)
    if not files:
        raise ValueError("no input files")
    _check_weights(weights, len(files))
    w = np.asarray(weights, dtype=np.float32) if weights is not None else None

    readers = []
    try:
        for f in files:
            readers.append(AudioReader(f))
        sr, ch = readers[0].samplerate, readers[0].channels
        for f, r in zip(files[1:], readers[1:]):
            if r.samplerate != sr:
                raise ValueError(f"sample-rate mismatch: {f} has {r.samplerate}, expected {sr}")
            if r.channels != ch:
                raise ValueError(f"channel-count mismatch: {f} has {r.channels}, expected {ch}")
        total = min(r.frames for r in readers)  # shortest-file truncation

        os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
        with AudioWriter(output_path, sr, ch, subtype="PCM_24") as writer:
            done = 0
            while done < total:
                n = min(buffer_frames, total - done)
                stack = np.stack([r.read(n) for r in readers])  # (N, ch, n)
                out = _spectral_combine(stack, method) if method.endswith("_fft") else None
                if out is None:  # a waveform method, or a tail too short for the STFT
                    out = _waveform_combine_np(
                        stack, "avg_wave" if method.endswith("_fft") else method, w)
                writer.write(out)
                done += n
                if progress_cb:
                    progress_cb(done / total)
            output_path = writer.path  # a .flac path is written as .wav
    finally:
        for r in readers:
            r.close()
    return output_path


def main(argv=None) -> int:
    """CLI mirroring reference ensemble.py:409-438."""
    import argparse

    p = argparse.ArgumentParser(description="Audio ensemble")
    p.add_argument("--files", nargs="+", required=True)
    p.add_argument("--type", dest="method", default="avg_wave", choices=list(ENSEMBLE_METHODS))
    p.add_argument("--weights", nargs="+", type=float, default=None)
    p.add_argument("--output", required=True)
    args = p.parse_args(argv)

    def progress(frac):
        print(f"[SESA_PROGRESS]{int(frac * 100)}", flush=True)

    out = ensemble_files(args.files, args.method, args.output, weights=args.weights,
                         progress_cb=progress)
    print(f"Ensemble written: {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
