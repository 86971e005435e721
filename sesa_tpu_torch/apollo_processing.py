"""Apollo enhancement post-processing (counterpart of
sesa_tpu/apollo_processing.py; reference apollo_processing.py:9-216).

The Apollo model (``sesa_tpu_torch.models.apollo``) runs in-process through
the demix engine. Supports the reference's four model presets, the per-file
``normal_method`` and the ``mid_side_method`` (M/S encode -> enhance each
mono channel -> L/R decode), and the same per-file fallback to the
unenhanced file on error.

The presets' files are fetched through ``registry.download_file`` into the
registry's checkpoint directory; files already there are kept.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from sesa_tpu_torch.helpers import sanitize_filename

# display name -> (checkpoint url, config url): the reference's four presets
APOLLO_MODELS = {
    "MP3 Enhancer": (
        "https://huggingface.co/JusperLee/Apollo/resolve/main/pytorch_model.bin",
        "https://github.com/JusperLee/Apollo/raw/main/configs/apollo.yaml",
    ),
    "Lew Vocal Enhancer": (
        "https://huggingface.co/lew1s/apollo_vocal/resolve/main/apollo_model.ckpt",
        "https://github.com/JusperLee/Apollo/raw/main/configs/apollo.yaml",
    ),
    "Lew Vocal Enhancer v2 (beta)": (
        "https://huggingface.co/lew1s/apollo_vocal/resolve/main/apollo_model_v2.ckpt",
        "https://huggingface.co/lew1s/apollo_vocal/resolve/main/config_apollo_vocal.yaml",
    ),
    "Apollo Universal Model": (
        "https://huggingface.co/jarredou/apollo_universal/resolve/main/apollo_universal_model.ckpt",
        "https://huggingface.co/jarredou/apollo_universal/resolve/main/config_apollo.yaml",
    ),
}


def _apollo_session(model_name: str, chunk_size: int, overlap: int, num_channels: int = 2,
                    device=None):
    """The session of a preset, from its two files, downloaded into the
    registry's ``CHECKPOINT_DIR`` unless they are there already. A failed
    download raises."""
    from sesa_tpu_torch.registry import download_file
    from sesa_tpu_torch.runtime.session import InferenceSession

    ckpt_url, config_url = APOLLO_MODELS.get(model_name, APOLLO_MODELS["Apollo Universal Model"])
    ckpt = download_file(ckpt_url)
    config = download_file(config_url)
    return InferenceSession.create(
        "apollo", config, ckpt,
        # the GUI expresses the apollo chunk size in seconds (default 19)
        chunk_size=int(chunk_size) * 44100 if chunk_size < 100 else int(chunk_size),
        num_overlap=int(overlap), num_channels=num_channels, device=device)


def process_with_apollo(output_files: List[str], output_dir: str, apollo_chunk_size: int,
                        apollo_overlap: int, apollo_method: str, apollo_normal_model: str,
                        apollo_midside_model: str, output_format: str = "wav", progress=None,
                        total_progress_start: int = 80,
                        total_progress_end: int = 100, device=None) -> List[str]:
    """Enhance separated stems with Apollo; a file that fails keeps its
    original path in the returned list. Runs on CUDA unless ``device="cpu"``
    and raises without a GPU: the fallback to the unenhanced files is for a
    preset or a file that fails, not for a missing device."""
    from sesa_tpu_torch import get_device
    from sesa_tpu_torch.audio_io import read_audio, write_audio

    get_device(device)
    os.makedirs(output_dir, exist_ok=True)
    mid_side = apollo_method == "mid_side_method"
    model_name = apollo_midside_model if mid_side else apollo_normal_model
    try:
        session = _apollo_session(model_name, apollo_chunk_size, apollo_overlap,
                                  num_channels=1 if mid_side else 2, device=device)
    except (OSError, ValueError, RuntimeError) as e:
        print(f"Apollo unavailable ({e}); returning unenhanced files")
        return list(output_files)

    files = [f for f in output_files if f and os.path.exists(f)]
    span = total_progress_end - total_progress_start
    enhanced = []
    done = 0  # progress counts processed files, not list positions
    for path in output_files:
        if not path or not os.path.exists(path):
            enhanced.append(path)
            continue
        base = sanitize_filename(os.path.splitext(os.path.basename(path))[0])
        suffix = "_Mid_Side_Enhanced" if mid_side else "_Enhanced"
        out_path = os.path.join(output_dir, f"{base}{suffix}.{output_format}")
        try:
            if progress is not None:
                progress(total_progress_start + done * span / max(1, len(files)),
                         desc=f"Enhancing with Apollo... ({done + 1}/{len(files)})")
            done += 1
            audio, sr = read_audio(path)
            if mid_side:
                if audio.shape[0] == 1:
                    audio = np.repeat(audio, 2, axis=0)
                mid = (audio[0] + audio[1]) * 0.5
                side = (audio[0] - audio[1]) * 0.5
                mid_e = next(iter(session.separate(mid[None]).values()))[0]  # mono channels
                side_e = next(iter(session.separate(side[None]).values()))[0]
                n = min(len(mid_e), len(side_e))
                out = np.stack([mid_e[:n] + side_e[:n], mid_e[:n] - side_e[:n]])
            else:
                out = next(iter(session.separate(audio).values()))
            enhanced.append(write_audio(out_path, out, sr))
        except (OSError, ValueError, RuntimeError) as e:
            print(f"Apollo failed for {path}: {e}; keeping original")
            enhanced.append(path)
    return enhanced
