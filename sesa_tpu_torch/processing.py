"""Separation orchestrators: single model, auto ensemble, manual ensemble
(counterpart of sesa_tpu/processing.py; reference processing.py
process_audio :502-704, auto_ensemble_process :798-1188, ensemble_audio_fn
:706-795). The sessions run in this process and report progress through
callbacks, so there is no subprocess, no scraped ``[SESA_PROGRESS]`` line
and no rebuilt argv.

All three entry points are generators yielding
``{"progress": int, "status": str, "outputs": [paths]}`` dicts. The two
that run models take ``device``: CUDA unless ``"cpu"`` is asked for, and
without a GPU they raise (``sesa_tpu_torch.get_device``).
"""

from __future__ import annotations

import re
import os
import queue
import threading
import time
from typing import Dict, Generator, List, Optional

from sesa_tpu_torch import helpers
from sesa_tpu_torch.config_manager import clean_model

# the 16 output stem slots the GUI maps files onto (reference
# processing.py:385-429)
STEM_SLOTS = [
    "vocals", "instrumental", "phaseremix", "drum", "bass", "other",
    "effects", "speech", "music", "dry", "male", "female", "bleed",
    "karaoke", "mid", "side",
]


def clamp_percentage(value) -> int:
    return max(0, min(100, int(value)))


def extract_model_name_from_checkpoint(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def _timestamped_name(base: str, stem: str, model: str, ext: str) -> str:
    ts = time.strftime("%Y%m%d%H%M%S")
    return f"{ts}_{helpers.sanitize_filename(base)}_{stem}_{helpers.sanitize_filename(model)}{ext}"


def find_file_for_stem(files: List[str], keyword: str) -> Optional[str]:
    """Map an output file to a GUI stem slot.

    Output names are ``{ts}_{base}_{stem}_{model}{ext}``
    (:func:`_timestamped_name`), so the stem is matched as a delimited
    ``_{stem}_`` token — raw substring matching mis-slotted files whenever
    the model name or song title contained a stem word ('male' is even a
    substring of 'female')."""
    token = f"_{keyword.lower()}_"
    for f in files:
        if token in os.path.basename(f).lower():
            return f
    # fallback for externally-named files that don't follow our pattern:
    # require a non-letter before the keyword so 'male' can't hit 'female'
    pat = re.compile(rf"(?<![a-z]){re.escape(keyword.lower())}")
    for f in files:
        if pat.search(os.path.basename(f).lower()):
            return f
    return None


def _make_session(model_name: str, chunk_size, overlap, use_native_chunk=True,
                  compute_dtype="bf16", device=None):
    import torch

    from sesa_tpu_torch.cache import enable_persistent_cache
    from sesa_tpu_torch.registry import get_model_chunk_size, get_model_config
    from sesa_tpu_torch.runtime.session import InferenceSession

    enable_persistent_cache()

    model_type, config_path, ckpt_path = get_model_config(
        clean_model(model_name), chunk_size, overlap)
    if not model_type:
        raise ValueError(f"Unknown model: {model_name}")
    # prefer the model's native YAML chunk size (reference processing.py:554-610)
    native = get_model_chunk_size(clean_model(model_name)) if use_native_chunk else None
    return InferenceSession.create(
        model_type, config_path, ckpt_path,
        chunk_size=native or chunk_size or None,
        num_overlap=overlap or None,
        compute_dtype=torch.bfloat16 if compute_dtype == "bf16" else None,
        device=device,
    )


def process_audio(
    input_audio_file: str,
    model: str,
    chunk_size: int = 352800,
    overlap: int = 2,
    export_format: str = "wav FLOAT",
    use_tta: bool = False,
    demud_phaseremix_inst: bool = False,
    extract_instrumental: bool = False,
    use_apollo: bool = False,
    apollo_chunk_size: int = 19,
    apollo_overlap: int = 2,
    apollo_method: str = "normal_method",
    apollo_normal_model: str = "Apollo Universal Model",
    apollo_midside_model: str = "Apollo Universal Model",
    use_matchering: bool = False,
    matchering_passes: int = 1,
    output_dir: Optional[str] = None,
    progress=None,
    device=None,
) -> Generator[Dict, None, None]:
    """Single-model separation (reference process_audio, processing.py:502-704)."""
    from sesa_tpu_torch.audio_io import read_audio, write_audio

    helpers.setup_directories()
    output_dir = output_dir or helpers.OUTPUT_DIR
    os.makedirs(output_dir, exist_ok=True)

    if not input_audio_file or not os.path.exists(input_audio_file):
        yield {"progress": 0, "status": "No input file selected", "outputs": []}
        return

    yield {"progress": 0, "status": f"Loading model {model}...", "outputs": []}
    session = _make_session(model, chunk_size, overlap, device=device)

    mix, sr = read_audio(input_audio_file, target_sr=session.sample_rate)
    base = os.path.splitext(os.path.basename(input_audio_file))[0]
    model_name = clean_model(model)

    yield {"progress": 5, "status": "Separating...", "outputs": []}
    # Live progress: separation runs in a worker thread and the demix
    # engine's per-segment callback feeds a queue this generator drains,
    # so the GUI sees percent movement during the hot loop (the streaming
    # analog of the reference's [SESA_PROGRESS] stdout protocol,
    # reference processing.py:324-371).
    events: "queue.Queue[Optional[int]]" = queue.Queue()
    result: Dict[str, object] = {}

    def on_progress(frac):
        events.put(clamp_percentage(5 + frac * 70))

    def worker():
        try:
            result["waveforms"] = session.separate_with_extras(
                mix,
                use_tta=use_tta,
                extract_instrumental=extract_instrumental,
                demud_phaseremix_inst=demud_phaseremix_inst,
                progress_cb=on_progress,
            )
        except BaseException as e:  # re-raised on the generator thread
            result["error"] = e
        finally:
            events.put(None)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    last = 5
    while True:
        item = events.get()
        if item is None:
            break
        if item != last:
            last = item
            yield {"progress": item, "status": f"Separating... {item}%",
                   "outputs": []}
    thread.join()
    if "error" in result:
        raise result["error"]
    waveforms = result["waveforms"]

    is_float = export_format.startswith("wav FLOAT")
    ext = ".flac" if export_format.startswith("flac") else ".wav"
    subtype = "FLOAT" if is_float else ("PCM_16" if "PCM_16" in export_format else "PCM_24")

    outputs = []
    for stem, est in waveforms.items():
        out_name = _timestamped_name(base, stem, model_name, ext)
        out_path = os.path.join(output_dir, out_name)
        # write_audio may fall back to .wav without soundfile: record the
        # path actually written, not the requested one
        outputs.append(write_audio(out_path, est, sr, subtype=subtype))
    yield {"progress": 80, "status": "Stems written", "outputs": outputs}

    if use_apollo:
        from sesa_tpu_torch.apollo_processing import process_with_apollo

        outputs = process_with_apollo(
            outputs, output_dir, apollo_chunk_size, apollo_overlap,
            apollo_method, apollo_normal_model, apollo_midside_model,
            ext.lstrip("."), device=device,
        )
        yield {"progress": 90, "status": "Apollo enhancement done", "outputs": outputs}

    if use_matchering:
        try:
            _, _, segment = helpers.find_clear_segment(input_audio_file)
            ref_path = os.path.join(output_dir, "matchering_reference.wav")
            helpers.save_segment(segment, 44100, ref_path)
            mastered = []
            for f in outputs:
                out = os.path.splitext(f)[0] + "_mastered.wav"
                helpers.run_matchering(ref_path, f, out, passes=matchering_passes)
                mastered.append(out)
            outputs = mastered
            yield {"progress": 95, "status": "Matchering done", "outputs": outputs}
        except Exception as e:
            yield {"progress": 95, "status": f"Matchering skipped: {e}", "outputs": outputs}

    # map outputs onto the GUI's 16 stem slots
    slots = {slot: find_file_for_stem(outputs, slot) for slot in STEM_SLOTS}
    yield {"progress": 100, "status": "Done", "outputs": outputs, "slots": slots}


def auto_ensemble_process(
    input_audio_file: str,
    selected_models: List[str],
    chunk_size: int = 352800,
    overlap: int = 2,
    export_format: str = "wav FLOAT",
    use_tta: bool = False,
    extract_instrumental: bool = False,
    ensemble_type: str = "avg_wave",
    use_apollo: bool = False,
    apollo_chunk_size: int = 19,
    apollo_overlap: int = 2,
    apollo_method: str = "normal_method",
    apollo_normal_model: str = "Apollo Universal Model",
    apollo_midside_model: str = "Apollo Universal Model",
    use_matchering: bool = False,
    matchering_passes: int = 1,
    output_dir: Optional[str] = None,
    progress=None,
    device=None,
) -> Generator[Dict, None, None]:
    """Multi-model ensemble (reference auto_ensemble_process,
    processing.py:798-1188): run each model, collect matching stems,
    ensemble, optional Apollo/Matchering."""
    import numpy as np

    from sesa_tpu_torch import runtime
    from sesa_tpu_torch.audio_io import read_audio, write_audio
    from sesa_tpu_torch.postprocess import ensemble_waveforms

    helpers.setup_directories()
    output_dir = output_dir or helpers.AUTO_ENSEMBLE_OUTPUT
    os.makedirs(output_dir, exist_ok=True)

    if not input_audio_file or not os.path.exists(input_audio_file):
        yield {"progress": 0, "status": "No input file selected", "outputs": []}
        return
    if not selected_models:
        yield {"progress": 0, "status": "No models selected", "outputs": []}
        return

    per_model = 80 // max(1, len(selected_models))
    collected: Dict[str, List] = {}
    sr_out = 44100
    # models at the same sample rate share one device copy of the song
    # (runtime.upload_mix), uploaded once per (sample rate, shape)
    upload_cache: Dict[tuple, object] = {}

    for mi, model in enumerate(selected_models):
        yield {"progress": mi * per_model,
               "status": f"Processing with {model} ({mi + 1}/{len(selected_models)})",
               "outputs": []}
        session = _make_session(model, chunk_size, overlap, device=device)
        mix, sr = read_audio(input_audio_file, target_sr=session.sample_rate)
        if mi == 0:
            sr_first = sr
        sr_out = sr
        key = (sr, mix.shape)
        if key not in upload_cache:
            upload_cache[key] = runtime.upload_mix(
                np.repeat(mix, 2, axis=0) if mix.shape[0] == 1 else mix, session.device)
        mix_dev = upload_cache[key]
        # live per-model progress (same worker-thread pattern as
        # process_audio; reference streams per-percent, processing.py:910-979)
        events: "queue.Queue[Optional[int]]" = queue.Queue()
        result: Dict[str, object] = {}

        def on_progress(frac, _mi=mi):
            events.put(clamp_percentage((_mi + frac) * per_model))

        def worker(_session=session, _mix=mix, _mix_dev=mix_dev):
            try:
                result["waveforms"] = _session.separate_with_extras(
                    _mix, use_tta=use_tta,
                    extract_instrumental=extract_instrumental,
                    progress_cb=on_progress, mix_device=_mix_dev)
            except BaseException as e:
                result["error"] = e
            finally:
                events.put(None)

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        last = -1
        while True:
            item = events.get()
            if item is None:
                break
            if item != last:
                last = item
                yield {"progress": item,
                       "status": f"Separating with {model}... "
                                 f"({mi + 1}/{len(selected_models)})",
                       "outputs": []}
        thread.join()
        if "error" in result:
            raise result["error"]
        if sr != sr_first:
            # the file-based ensemble path rejects sample-rate mismatches
            # (postprocess/ensemble.py validate, reference ensemble.py:86-170);
            # averaging waveforms at different rates sample-by-sample would
            # silently time-stretch one of them
            raise ValueError(
                f"model {model!r} separates at {sr} Hz but the first "
                f"selected model ran at {sr_first} Hz; ensemble inputs "
                "must share one sample rate")
        waveforms = result["waveforms"]
        # keep stems whose names match the ensemble targets
        for stem, est in waveforms.items():
            key = stem.lower()
            collected.setdefault(key, []).append(est)

    yield {"progress": 82, "status": f"Ensembling ({ensemble_type})...", "outputs": []}
    base = os.path.splitext(os.path.basename(input_audio_file))[0]
    ext = ".flac" if export_format.startswith("flac") else ".wav"
    # same bit-depth mapping as process_audio: honor an explicit PCM_16
    subtype = ("FLOAT" if export_format.startswith("wav FLOAT")
               else ("PCM_16" if "PCM_16" in export_format else "PCM_24"))

    outputs = []
    for stem, waves in collected.items():
        if len(waves) == 0:
            continue
        combined = ensemble_waveforms(waves, ensemble_type) if len(waves) > 1 else waves[0]
        out_path = os.path.join(
            output_dir, _timestamped_name(base, stem, f"ensemble_{ensemble_type}", ext))
        outputs.append(write_audio(out_path, combined, sr_out, subtype=subtype))

    if use_apollo:
        from sesa_tpu_torch.apollo_processing import process_with_apollo

        outputs = process_with_apollo(
            outputs, output_dir, apollo_chunk_size, apollo_overlap, apollo_method,
            apollo_normal_model, apollo_midside_model, ext.lstrip("."), device=device)
        yield {"progress": 92, "status": "Apollo enhancement done", "outputs": outputs}

    if use_matchering:
        try:
            _, _, segment = helpers.find_clear_segment(input_audio_file)
            ref_path = os.path.join(output_dir, "matchering_reference.wav")
            helpers.save_segment(segment, 44100, ref_path)
            outputs = [
                helpers.run_matchering(ref_path, f, os.path.splitext(f)[0] + "_mastered.wav",
                                       passes=matchering_passes)
                for f in outputs
            ]
        except Exception as e:
            yield {"progress": 97, "status": f"Matchering skipped: {e}", "outputs": outputs}

    yield {"progress": 100, "status": "Done", "outputs": outputs}


def ensemble_audio_fn(files: List[str], method: str, weights=None,
                      output_dir: Optional[str] = None) -> Generator[Dict, None, None]:
    """Manual ensemble of already-separated files (reference
    ensemble_audio_fn, processing.py:706-795). It runs no model: the files
    are combined on the host, in windows."""
    from sesa_tpu_torch.postprocess import ensemble_files

    helpers.setup_directories()
    output_dir = output_dir or helpers.ENSEMBLE_DIR
    os.makedirs(output_dir, exist_ok=True)

    if not files or len(files) < 2:
        yield {"progress": 0, "status": "Select at least two files", "outputs": []}
        return

    ts = time.strftime("%Y%m%d%H%M%S")
    out_path = os.path.join(output_dir, f"ensemble_{method}_{ts}.wav")

    yield {"progress": 5, "status": f"Ensembling {len(files)} files ({method})...",
           "outputs": []}
    if weights is not None and isinstance(weights, str):
        weights = [float(w) for w in weights.replace(",", " ").split()] or None

    # live streaming progress: the same worker-thread + queue pattern the
    # separation orchestrators use (ensemble_files runs synchronously, so
    # an inline callback could never reach the GUI between yields)
    events: "queue.Queue[Optional[int]]" = queue.Queue()
    result: Dict[str, object] = {}

    def cb(frac):
        events.put(clamp_percentage(5 + frac * 90))

    def worker():
        try:
            result["path"] = ensemble_files(files, method, out_path,
                                            weights=weights, progress_cb=cb)
        except BaseException as e:
            result["error"] = e
        finally:
            events.put(None)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    last = 5
    while True:
        item = events.get()
        if item is None:
            break
        if item != last:
            last = item
            yield {"progress": item, "status": f"Ensembling... {item}%",
                   "outputs": []}
    thread.join()
    if "error" in result:
        raise result["error"]
    yield {"progress": 100, "status": "Done", "outputs": [result["path"]]}
