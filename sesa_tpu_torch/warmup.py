"""Make the first song pay no build (counterpart of sesa_tpu/warmup.py).

The JAX tool fills the persistent XLA cache. The port's build products are
its CUDA kernel libraries (``ops/_build.py``, kept on disk under
``cache.cache_dir()`` by source hash): this tool builds every one of them,
then separates one low-amplitude seeded song per ``--song_seconds`` so that
the model's first real song finds everything built and loaded.

    python -m sesa_tpu_torch.warmup --model_type bs_roformer --config_path cfg.yaml \
        [--song_seconds 60 300] [--chunk_size N] [--batch_size N] [--overlap N] \
        [--phase_fix_models N] [--force_cpu]

No checkpoint is needed: the session is built with seeded weights. Runs on
CUDA unless ``--force_cpu`` is given; on the CPU nothing is built.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from sesa_tpu_torch.cache import cache_dir, enable_persistent_cache


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="build the CUDA kernels and warm a model")
    p.add_argument("--model_type", type=str, required=True)
    p.add_argument("--config_path", type=str, required=True)
    p.add_argument("--song_seconds", nargs="+", type=int, default=[60, 300],
                   help="representative song lengths to separate once each")
    p.add_argument("--chunk_size", type=int, default=0)
    p.add_argument("--overlap", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=0)
    p.add_argument("--use_tta", action="store_true",
                   help="also run the TTA (channel-swap/polarity) pass")
    p.add_argument("--compute_dtype", type=str, choices=["bf16", "f32"],
                   default="bf16")
    p.add_argument("--phase_fix_models", type=int, default=0, metavar="N",
                   help="also run the device ensemble + phase fix of an N-model "
                        "stack at each song length (the auto-ensemble chain)")
    p.add_argument("--force_cpu", action="store_true",
                   help="run on the CPU (default: CUDA, which must be present)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    enable_persistent_cache()

    from sesa_tpu_torch.runtime.session import InferenceSession

    session = InferenceSession.create(
        args.model_type, args.config_path,
        chunk_size=args.chunk_size or None,
        num_overlap=args.overlap or None,
        batch_size=args.batch_size or None,
        compute_dtype=torch.bfloat16 if args.compute_dtype == "bf16" else None,
        device="cpu" if args.force_cpu else None,
    )
    on_gpu = session.device.type == "cuda"
    if on_gpu:
        from sesa_tpu_torch.ops import _build

        t0 = time.time()
        built = _build.build_all()
        print(f"[warmup] kernels: {len(built)} built in {time.time() - t0:.1f}s "
              f"-> {_build.build_dir()}", flush=True)

    def sync():
        if on_gpu:
            torch.cuda.synchronize()

    sr = session.sample_rate
    rng = np.random.default_rng(0)
    for seconds in args.song_seconds:
        # low-amplitude noise, NOT zeros: a zero mix has std 0, so
        # normalize-enabled configs would divide by zero, and the NaN output
        # would trigger the bf16 -> f32 rescue and warm the wrong dtype
        mix = (0.01 * rng.standard_normal(
            (session.spec.num_channels, seconds * sr))).astype(np.float32)
        t0 = time.time()
        session.separate(mix, use_tta=args.use_tta)
        sync()
        print(f"[warmup] {args.model_type} {seconds}s: "
              f"{time.time() - t0:.1f}s -> {cache_dir()}", flush=True)
        if args.phase_fix_models > 0:
            from sesa_tpu_torch.postprocess.phase_fixer import ensemble_phase_fix_device

            src = torch.from_numpy(mix).to(session.device)
            t0 = time.time()
            ensemble_phase_fix_device(src, [src] * args.phase_fix_models, sr)
            sync()
            print(f"[warmup] ensemble+phase-fix x{args.phase_fix_models} "
                  f"{seconds}s: {time.time() - t0:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
