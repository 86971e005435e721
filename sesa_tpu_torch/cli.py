"""Separation CLI of the port (counterpart of sesa_tpu/cli.py), flag-compatible
with the reference's inference.py.

``python -m sesa_tpu_torch.cli --model_type bs_roformer --config_path cfg.json
--start_check_point model.ckpt --input_folder in/ --store_dir out/``

Runs on the GPU; ``--force_cpu`` asks for the CPU. Without it and with no
GPU, the CLI raises. Progress goes to stdout as ``[SESA_PROGRESS]NN`` lines
(reference inference_pytorch.py:166-171). With an empty
``--start_check_point`` the model is initialised from seed 0.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

import torch

from sesa_tpu_torch.models.registry import MODEL_TYPES


def build_parser() -> argparse.ArgumentParser:
    # flags mirror reference inference.py:159-181
    p = argparse.ArgumentParser(description="Audio source separation on the GPU")
    p.add_argument("--model_type", type=str, default="mdx23c",
                   help="the ported model types: " + ", ".join(sorted(MODEL_TYPES)))
    p.add_argument("--config_path", type=str, required=True)
    p.add_argument("--start_check_point", type=str, default="")
    p.add_argument("--input_folder", type=str, default=None)
    p.add_argument("--audio_path", type=str, default=None)
    p.add_argument("--store_dir", type=str, default="")
    p.add_argument("--extract_instrumental", action="store_true")
    p.add_argument("--demud_phaseremix_inst", action="store_true")
    p.add_argument("--use_tta", action="store_true")
    p.add_argument("--flac_file", action="store_true")
    p.add_argument("--export_format", type=str,
                   choices=["wav FLOAT", "flac PCM_16", "flac PCM_24"],
                   default="flac PCM_24")
    p.add_argument("--pcm_type", type=str, choices=["PCM_16", "PCM_24"], default="PCM_24")
    p.add_argument("--chunk_size", type=int, default=0,
                   help="override config.audio.chunk_size (0 = use config)")
    p.add_argument("--overlap", type=int, default=0,
                   help="override config.inference.num_overlap (0 = use config)")
    p.add_argument("--batch_size", type=int, default=0)
    p.add_argument("--compute_dtype", type=str, choices=["bf16", "f32"], default="bf16")
    p.add_argument("--force_cpu", action="store_true")
    p.add_argument("--disable_detailed_pbar", action="store_true")
    # accepted for drop-in compatibility with the reference CLI; one GPU,
    # and the bf16 policy covers AMP and TF32
    p.add_argument("--device_ids", nargs="+", type=int, default=[0])
    p.add_argument("--optimize_mode", type=str, default="default")
    p.add_argument("--enable_amp", action="store_true", default=True)
    p.add_argument("--enable_tf32", action="store_true", default=True)
    p.add_argument("--enable_cudnn_benchmark", action="store_true", default=True)
    p.add_argument("--lora_checkpoint", type=str, default="")
    return p


def shorten_filename(filename: str, max_length: int = 30) -> str:
    base, ext = os.path.splitext(filename)
    if len(base) <= max_length:
        return filename
    return base[:15] + "..." + base[-10:] + ext


def main(argv=None, session_out: list = None) -> int:
    """Run the CLI. ``session_out``, when given, receives the session (so a
    caller can read its counters after the run)."""
    args = build_parser().parse_args(argv)

    from sesa_tpu_torch.audio_io import read_audio, write_audio
    from sesa_tpu_torch.runtime.session import InferenceSession

    if args.audio_path:
        paths = [args.audio_path]
    elif args.input_folder:
        paths = sorted(glob.glob(os.path.join(args.input_folder, "*.*")))
    else:
        print("error: provide --audio_path or --input_folder", file=sys.stderr)
        return 2
    if args.lora_checkpoint:
        # the JAX CLI parses the flag and never reads it, so its users get the
        # base model's stems without a word; this one refuses instead
        raise NotImplementedError(
            "--lora_checkpoint is not applied by the CLI; merge the adapter with "
            "sesa_tpu_torch.utils.load_start_checkpoint(bundle, checkpoint, "
            "lora_checkpoint=...) and separate with sesa_tpu_torch.utils.demix, the route "
            "the JAX package has")

    t0 = time.time()
    session = InferenceSession.create(
        args.model_type, args.config_path, args.start_check_point,
        chunk_size=args.chunk_size or None, num_overlap=args.overlap or None,
        batch_size=args.batch_size or None,
        compute_dtype=torch.bfloat16 if args.compute_dtype == "bf16" else None,
        device="cpu" if args.force_cpu else None)
    if session_out is not None:
        session_out.append(session)
    print(f"Model loaded in {time.time() - t0:.1f}s on {session.device}; "
          f"instruments: {session.instruments}")

    store_dir = args.store_dir or "."
    os.makedirs(store_dir, exist_ok=True)
    is_float = args.export_format.startswith("wav FLOAT")
    codec = "flac" if args.flac_file else "wav"
    subtype = ("FLOAT" if is_float else args.pcm_type) if codec == "flac" else "FLOAT"

    for pi, path in enumerate(paths):
        try:
            mix, sr = read_audio(path, target_sr=session.sample_rate)
        except (OSError, ValueError) as e:
            print(f"cannot read {path}: {e}", file=sys.stderr)
            continue

        def progress(frac, _pi=pi):
            print(f"[SESA_PROGRESS]{int(100 * (_pi + frac) / len(paths))}", flush=True)

        waveforms = session.separate_with_extras(
            mix, use_tta=args.use_tta, extract_instrumental=args.extract_instrumental,
            demud_phaseremix_inst=args.demud_phaseremix_inst, progress_cb=progress)
        base = os.path.splitext(shorten_filename(os.path.basename(path)))[0]
        for instr, est in waveforms.items():
            written = write_audio(os.path.join(store_dir, f"{base}_{instr}.{codec}"),
                                  est, sr, subtype=subtype)
            print(f"wrote {written}")

    print(f"Elapsed: {time.time() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
