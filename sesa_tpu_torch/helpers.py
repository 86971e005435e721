"""Workspace helpers: directory layout under ``$SESA_TPU_HOME``, filename
hygiene, format conversion, Matchering mastering, clear-segment detection
(counterpart of sesa_tpu/helpers.py; reference helpers.py run_matchering
:262-312, find_clear_segment :314-361, sanitize_filename :220,
clear_directory :163). Feature extraction runs on numpy and scipy;
Matchering is gated on the optional ``matchering`` package.
"""

from __future__ import annotations

import os
import re
import shutil
import tempfile
from typing import Optional, Tuple

import numpy as np

BASE_DIR = os.environ.get("SESA_TPU_HOME", os.path.expanduser("~/.sesa_tpu"))
INPUT_DIR = os.path.join(BASE_DIR, "input")
OUTPUT_DIR = os.path.join(BASE_DIR, "output")
OLD_OUTPUT_DIR = os.path.join(BASE_DIR, "old_output")
ENSEMBLE_DIR = os.path.join(BASE_DIR, "ensemble")
AUTO_ENSEMBLE_TEMP = os.path.join(BASE_DIR, "auto_ensemble_temp")
AUTO_ENSEMBLE_OUTPUT = os.path.join(BASE_DIR, "ensemble_output")


def setup_directories() -> None:
    for d in (INPUT_DIR, OUTPUT_DIR, OLD_OUTPUT_DIR, ENSEMBLE_DIR,
              AUTO_ENSEMBLE_TEMP, AUTO_ENSEMBLE_OUTPUT):
        os.makedirs(d, exist_ok=True)


def clear_directory(directory: str) -> None:
    """Delete all files in a directory (reference helpers.py:163)."""
    if not os.path.isdir(directory):
        return
    for name in os.listdir(directory):
        path = os.path.join(directory, name)
        try:
            if os.path.isfile(path) or os.path.islink(path):
                os.remove(path)
            else:
                shutil.rmtree(path)
        except OSError:
            pass


def clear_temp_folder(directory: str, exclude_items=()) -> None:
    if not os.path.isdir(directory):
        return
    for name in os.listdir(directory):
        if name in exclude_items:
            continue
        path = os.path.join(directory, name)
        try:
            if os.path.isfile(path) or os.path.islink(path):
                os.remove(path)
            else:
                shutil.rmtree(path)
        except OSError:
            pass


def sanitize_filename(filename: str) -> str:
    """Strip characters that break shells/ffmpeg (reference helpers.py:220).

    The extension is sanitized too — URL-derived names can carry query/
    fragment junk after the dot ('song.mp3#frag')."""
    base, ext = os.path.splitext(filename)
    base = re.sub(r"[^\w\-. ]", "_", base)
    base = re.sub(r"\s+", "_", base).strip("_")
    ext = re.sub(r"[^\w.]", "", ext)
    return f"{base}{ext}"


def move_old_files(output_folder: str) -> None:
    """Move previous outputs aside with an _old suffix (reference behavior)."""
    os.makedirs(OLD_OUTPUT_DIR, exist_ok=True)
    if not os.path.isdir(output_folder):
        return
    for name in os.listdir(output_folder):
        path = os.path.join(output_folder, name)
        if os.path.isfile(path):
            base, ext = os.path.splitext(name)
            shutil.move(path, os.path.join(OLD_OUTPUT_DIR, f"{base}_old{ext}"))


def save_uploaded_file(uploaded, is_input: bool = False, target_dir: Optional[str] = None) -> str:
    """Persist an uploaded file object/path into the workspace."""
    target_dir = target_dir or (INPUT_DIR if is_input else OUTPUT_DIR)
    os.makedirs(target_dir, exist_ok=True)
    src = uploaded if isinstance(uploaded, str) else getattr(uploaded, "name", None)
    if src is None:
        raise ValueError("unsupported upload object")
    dest = os.path.join(target_dir, sanitize_filename(os.path.basename(src)))
    shutil.copy2(src, dest)
    return dest


def convert_to_wav(path: str) -> str:
    """Convert any audio file to wav (ffmpeg when present, else audio_io)."""
    if path.lower().endswith(".wav"):
        return path
    out = os.path.splitext(path)[0] + ".wav"
    if shutil.which("ffmpeg"):
        import subprocess

        subprocess.run(["ffmpeg", "-y", "-i", path, out], capture_output=True,
                       check=True)
        return out
    from sesa_tpu_torch.audio_io import read_audio, write_audio

    data, sr = read_audio(path)
    write_audio(out, data, sr)
    return out


# ---------------------------------------------------------------------------
# clear-segment detection (reference helpers.py:314-361) — scipy-based
# ---------------------------------------------------------------------------

def _frame_rms(x: np.ndarray, frame: int, hop: int) -> np.ndarray:
    n = 1 + max(0, (len(x) - frame)) // hop
    out = np.empty(n, dtype=np.float64)
    for i in range(n):
        seg = x[i * hop : i * hop + frame]
        out[i] = np.sqrt(np.mean(seg * seg) + 1e-12)
    return out


def _frame_spectral_flatness(x: np.ndarray, frame: int, hop: int) -> np.ndarray:
    n = 1 + max(0, (len(x) - frame)) // hop
    out = np.empty(n, dtype=np.float64)
    win = np.hanning(frame)
    for i in range(n):
        seg = x[i * hop : i * hop + frame]
        if len(seg) < frame:
            seg = np.pad(seg, (0, frame - len(seg)))
        mag = np.abs(np.fft.rfft(seg * win)) + 1e-10
        out[i] = np.exp(np.mean(np.log(mag))) / np.mean(mag)
    return out


def find_clear_segment(audio_path: str, segment_duration: float = 15,
                       sr: int = 44100) -> Tuple[float, float, np.ndarray]:
    """Find the clearest (high-energy, low-noise) segment of a track."""
    from scipy.signal import find_peaks

    from sesa_tpu_torch.audio_io import read_audio

    audio, sr = read_audio(audio_path, target_sr=sr)
    mono = audio.mean(axis=0)

    window = int(5 * sr)
    hop = window // 2
    rms = _frame_rms(mono, window, hop)
    flatness = _frame_spectral_flatness(mono, window, hop)
    score = rms / (flatness + 1e-6)

    peaks, _ = find_peaks(score, height=np.mean(score), distance=5)
    peak_idx = int(peaks[np.argmax(score[peaks])]) if len(peaks) else len(score) // 2

    start = peak_idx * hop
    end = start + int(segment_duration * sr)
    if end > len(mono):
        end = len(mono)
        start = max(0, end - int(segment_duration * sr))
    return start / sr, end / sr, mono[start:end]


def save_segment(audio: np.ndarray, sr: int, path: str) -> str:
    from sesa_tpu_torch.audio_io import write_audio

    write_audio(path, audio if audio.ndim == 2 else audio[None], sr)
    return path


def run_matchering(reference_path: str, target_path: str, output_path: str,
                   passes: int = 1, bit_depth: int = 24) -> str:
    """Master target audio against a reference clip with Matchering
    (1-5 passes, pcm16/24). Requires the optional ``matchering`` package."""
    try:
        import matchering as mg
    except ImportError as e:
        raise RuntimeError(
            "Matchering mastering requires the 'matchering' package, which is "
            "not installed in this environment."
        ) from e

    from sesa_tpu_torch.audio_io import read_audio, write_audio

    # per-call private tempdir: fixed names in the shared system tempdir
    # let concurrent runs master against each other's reference files
    tmp = tempfile.mkdtemp(prefix="sesa_matchering_")
    try:
        ref, sr = read_audio(reference_path, target_sr=44100)
        tgt, _ = read_audio(target_path, target_sr=44100)
        temp_ref = os.path.join(tmp, "matchering_ref.wav")
        temp_tgt = os.path.join(tmp, "matchering_tgt.wav")
        write_audio(temp_ref, ref, 44100)
        write_audio(temp_tgt, tgt, 44100)

        result_format = mg.pcm24 if bit_depth == 24 else mg.pcm16
        current = temp_tgt
        for i in range(passes):
            temp_out = os.path.join(tmp, f"matchering_out_pass_{i}.wav")
            mg.process(reference=temp_ref, target=current,
                       results=[result_format(temp_out)], config=mg.Config())
            current = temp_out
        shutil.move(current, output_path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return output_path
