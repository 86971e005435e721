"""Drive sesa_tpu_torch on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. build: compiles every CUDA source of ``sesa_tpu_torch/csrc`` with nvcc.
2. kernels: at the flagship shapes, launches K1 (fused attention block,
   time leg and freq leg) and K2 (fused feed-forward) and holds each against
   its plain PyTorch version on the same inputs; times the kernel, the plain
   version and a library composite (cuBLAS + SDPA), and computes each
   kernel's bound from its shapes.
3. main path: separates a generated 60 s stereo song through
   ``sesa_tpu_torch.cli.main`` with the flagship bs_roformer (dim 512,
   depth 12, 8 heads x 64, seeded weights) in bf16, and checks the stems,
   the f32-rescue count and the kernels' launch counts.
4. model parity: one chunk batch through ``bs_roformer.apply`` with the
   kernels against the same call with the kernels' plain versions, both bf16
   on the card.
5. profile: device time by kernel over one warm model call (torch.profiler).

Prints the ``kernels`` JSON line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Exits non-zero without a GPU.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

# H100 SXM dense peaks (NVIDIA data sheet): bf16 tensor cores, HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12

FLAGSHIP_MODEL = dict(dim=512, depth=12, stereo=True, num_stems=1,
                      time_transformer_depth=1, freq_transformer_depth=1,
                      dim_head=64, heads=8, stft_n_fft=2048, stft_hop_length=512,
                      stft_win_length=2048, mask_estimator_depth=2)
CHUNK, OVERLAP, BATCH, SR, SONG_S = 352800, 2, 6, 44100, 60
FRAMES, BANDS = CHUNK // 512 + 1, 62  # 690 frames, 62 bands per chunk
TOKENS = BATCH * FRAMES * BANDS  # 256,680 tokens per model call

# K1 / K2 against their plain versions, both bf16 on the card: the two
# round at the same points, but the kernels sum in another order and the
# flash softmax rounds unnormalised probabilities, so they differ by about
# one bf16 ulp. Bounds: max |kernel - plain| <= 5% of max |plain|, and the
# rms error <= 5% of the rms of the branch (out - x) the kernel adds.
KERNEL_MAX_REL, KERNEL_BRANCH_RMS_REL = 0.05, 0.05
# whole model, kernels vs plain versions, bf16 on the card
MODEL_SNR_FLOOR_DB = 20.0


def log(msg):
    print(msg, flush=True)


def gpu_line():
    r = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60, check=True)
    return r.stdout.strip()


def time_ms(fn, reps=5, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name, out, ref, x):
    """max |out - ref| and the rms error relative to the branch ref - x."""
    o, r, xf = out.float(), ref.float(), x.float()
    if not bool(o.isfinite().all()):
        raise RuntimeError(f"{name}: non-finite kernel output")
    max_err = float((o - r).abs().max())
    scale = float(r.abs().max())
    branch_rel = float((o - r).pow(2).mean().sqrt() / (r - xf).pow(2).mean().sqrt())
    log(f"  {name}: max_abs_err {max_err:.4g} (output max {scale:.4g}), "
        f"rms err / rms branch {branch_rel:.4g}")
    if max_err > KERNEL_MAX_REL * scale or branch_rel > KERNEL_BRANCH_RMS_REL:
        raise RuntimeError(f"{name}: kernel disagrees with its plain version "
                           f"(max {max_err:.4g} > {KERNEL_MAX_REL} x {scale:.4g} or "
                           f"branch rms {branch_rel:.4g} > {KERNEL_BRANCH_RMS_REL})")
    return max_err


# ---------------------------------------------------------------------------
# library composites: the same functions through cuBLAS and SDPA, timed only
# here as a yardstick (the port never calls them)
# ---------------------------------------------------------------------------

def k1_library(x, gamma, wqkv, wg, bg, wo, heads, scale, rope):
    import torch
    import torch.nn.functional as F

    from sesa_tpu_torch.ops.rope import apply_rope

    b, n, d = x.shape
    xn = F.normalize(x, dim=-1) * (d ** 0.5) * gamma
    q, k, v = (xn @ wqkv.T).reshape(b, n, 3, heads, -1).permute(2, 0, 3, 1, 4)
    q, k = apply_rope(q, *rope), apply_rope(k, *rope)
    o = F.scaled_dot_product_attention(q, k, v, scale=scale)
    o = o * torch.sigmoid(xn @ wg.T + bg).permute(0, 2, 1)[..., None]
    return o.permute(0, 2, 1, 3).reshape(b, n, -1) @ wo.T + x


def k2_library(x, gamma, w1, b1, w2, b2):
    import torch.nn.functional as F

    xn = F.normalize(x, dim=-1) * (x.shape[-1] ** 0.5) * gamma
    return F.linear(F.gelu(F.linear(xn, w1, b1), approximate="tanh"), w2, b2) + x


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build():
    from sesa_tpu_torch.ops import _build

    t0 = time.perf_counter()
    per_lib = _build.build_all()
    log(f"[build] {time.perf_counter() - t0:.1f}s wall; per library "
        f"{ {k: round(v, 1) for k, v in per_lib.items()} } into {_build.build_dir()}")
    for name in _build.SIGNATURES:
        path = os.path.join(_build.build_dir(), f"lib{name}.log")
        if os.path.exists(path):
            for line in open(path):
                if "Used" in line or "spill" in line.lower() and "0 bytes" not in line:
                    log(f"  {name}: {line.strip()}")
        _build.load(name)


def _weights(gen, shape, fan_in, device):
    import torch

    w = (torch.rand(shape, generator=gen) * 2 - 1) / math.sqrt(fan_in)
    return w.to(device=device, dtype=torch.bfloat16)


def phase_kernels():
    import torch

    from sesa_tpu_torch.ops.attention import fused_attention_block, fused_attention_block_plain
    from sesa_tpu_torch.ops.ff import fused_ff_residual, fused_ff_residual_plain
    from sesa_tpu_torch.ops.rope import default_freqs, rope_tables

    dev = torch.device("cuda")
    d, heads, dh = FLAGSHIP_MODEL["dim"], FLAGSHIP_MODEL["heads"], FLAGSHIP_MODEL["dim_head"]
    hd = heads * dh
    gen = torch.Generator().manual_seed(1)
    gamma = (1 + 0.1 * torch.randn(d, generator=gen)).to(dev, torch.bfloat16)
    wqkv = _weights(gen, (3 * hd, d), d, dev)
    wg, bg = _weights(gen, (heads, d), d, dev), _weights(gen, (heads,), d, dev)
    wo = _weights(gen, (d, hd), hd, dev)
    rows = []
    for leg, b, n in (("time", BATCH * BANDS, FRAMES), ("freq", BATCH * FRAMES, BANDS)):
        # rms_norm makes the branch independent of the scale of x; a smaller
        # x keeps the rounding of the residual add from hiding the branch
        x = (0.5 * torch.randn((b, n, d), generator=gen)).to(dev, torch.bfloat16)
        rope = tuple(r.to(dev, torch.bfloat16)
                     for r in rope_tables(torch.from_numpy(default_freqs(dh)).to(dev), n))
        args = (x, gamma, wqkv, wg, bg, wo, heads, dh ** -0.5)
        out = fused_attention_block(*args, rope=rope)
        torch.cuda.synchronize()
        ref = fused_attention_block_plain(*args, rope=rope)
        err = compare(f"K1 {leg} leg (b={b}, n={n})", out, ref, x)
        del out, ref
        ms = time_ms(lambda: fused_attention_block(*args, rope=rope))
        plain_ms = time_ms(lambda: fused_attention_block_plain(*args, rope=rope), reps=2, warmup=1)
        lib_ms = time_ms(lambda: k1_library(*args, rope))
        tokens = b * n
        flops = 2 * tokens * d * (3 * hd + heads + hd) + 4 * b * heads * n * n * dh
        nbytes = 2 * (2 * tokens * d + (3 * hd + heads + hd) * d + heads + d + 2 * n * dh)
        rows.append(dict(name=f"fused_attention_block ({leg} leg, b={b}, n={n})",
                         route="cuda", source="sesa_tpu_torch/csrc/attention.cu",
                         replaces="sesa_tpu/ops/attention.py:461", max_abs_err=err,
                         ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         **_bound(flops, nbytes), kernel="K1"))
        del x
        torch.cuda.empty_cache()

    hidden = 4 * d
    x = torch.randn((TOKENS, d), generator=gen).to(dev, torch.bfloat16)
    w1, b1 = _weights(gen, (hidden, d), d, dev), _weights(gen, (hidden,), d, dev)
    w2, b2 = _weights(gen, (d, hidden), hidden, dev), _weights(gen, (d,), hidden, dev)
    args = (x, gamma, w1, b1, w2, b2)
    out = fused_ff_residual(*args)
    torch.cuda.synchronize()
    err = compare(f"K2 (tokens={TOKENS}, d={d}, hidden={hidden})", out,
                  fused_ff_residual_plain(*args), x)
    rows.append(dict(name=f"fused_ff_residual (tokens={TOKENS}, d={d}, hidden={hidden})",
                     route="cuda", source="sesa_tpu_torch/csrc/ff.cu",
                     replaces="sesa_tpu/ops/ff.py:74", max_abs_err=err,
                     ms=time_ms(lambda: fused_ff_residual(*args)),
                     plain_ms=time_ms(lambda: fused_ff_residual_plain(*args), reps=2, warmup=1),
                     library_ms=time_ms(lambda: k2_library(*args)),
                     **_bound(4 * TOKENS * d * hidden,
                              2 * (2 * TOKENS * d + 2 * hidden * d + hidden + 2 * d)),
                     kernel="K2"))
    for r in rows:
        log(f"  {r['name']}: {r['ms']:.3f} ms (bound {r['bound_ms']:.3f} ms by "
            f"{r['bound_by']}, plain {r['plain_ms']:.3f} ms, library {r['library_ms']:.3f} ms)")
    return rows


def _bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_S
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def _song(seconds):
    import numpy as np

    rng = np.random.default_rng(0)
    t = np.arange(seconds * SR) / SR
    voice = 0.3 * np.sin(2 * np.pi * 220 * t * (1 + 0.01 * np.sin(2 * np.pi * 0.5 * t)))
    band = 0.2 * np.sin(2 * np.pi * 110 * t) + 0.1 * np.sign(np.sin(2 * np.pi * 2 * t))
    noise = 0.02 * rng.standard_normal((2, t.size))
    return (np.stack([voice + band, 0.8 * voice + band]) + noise).astype(np.float32)


def phase_main_path(work):
    import numpy as np
    import torch

    from sesa_tpu_torch import cli
    from sesa_tpu_torch.audio_io import read_audio, write_audio
    from sesa_tpu_torch.ops.attention import fused_attention_block
    from sesa_tpu_torch.ops.ff import fused_ff_residual

    song = _song(SONG_S)
    os.makedirs(os.path.join(work, "in"))
    write_audio(os.path.join(work, "in", "song.wav"), song, SR)
    cfg = {"audio": {"chunk_size": CHUNK, "num_channels": 2, "sample_rate": SR},
           "model": FLAGSHIP_MODEL,
           "training": {"instruments": ["vocals", "other"], "target_instrument": "vocals"},
           "inference": {"num_overlap": OVERLAP, "batch_size": BATCH, "normalize": False}}
    cfg_path = os.path.join(work, "config.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    out_dir = os.path.join(work, "out")

    sessions = []
    torch.cuda.reset_peak_memory_stats()
    fused_attention_block.launches = 0
    fused_ff_residual.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(["--model_type", "bs_roformer", "--config_path", cfg_path,
                   "--input_folder", os.path.join(work, "in"), "--store_dir", out_dir,
                   "--compute_dtype", "bf16"], session_out=sessions)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = fused_attention_block.launches, fused_ff_residual.launches
    peak = torch.cuda.max_memory_allocated()
    if rc != 0:
        raise RuntimeError(f"cli.main returned {rc}")
    session = sessions[0]

    stems, _ = read_audio(os.path.join(out_dir, "song_vocals.wav"))
    if stems.shape != song.shape or not np.isfinite(stems).all():
        raise RuntimeError(f"bad stems: shape {stems.shape}, finite {np.isfinite(stems).all()}")
    if session.rescues != 0:
        raise RuntimeError(f"{session.rescues} bf16 -> f32 rescues on the main path")
    length = song.shape[-1] + 2 * (CHUNK - CHUNK // OVERLAP)
    calls = -(-(-(-length // (CHUNK // OVERLAP))) // BATCH)
    layers = FLAGSHIP_MODEL["depth"] * (FLAGSHIP_MODEL["time_transformer_depth"]
                                        + FLAGSHIP_MODEL["freq_transformer_depth"])
    if k1 != layers * calls or k2 != layers * calls:
        raise RuntimeError(f"launches K1 {k1}, K2 {k2}; expected {layers} x {calls} model calls")

    # a second separation on the warm session, timed alone
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    session.separate(song)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t1
    res = dict(song_s=SONG_S, model_calls=calls, k1_launches=k1, k2_launches=k2,
               cli_wall_s=wall, rtf_cli=SONG_S / wall, separate_warm_s=warm,
               rtf_warm=SONG_S / warm, peak_cuda_mem_gib=peak / 2 ** 30,
               rescues=session.rescues)
    log(f"[main path] {json.dumps(res)}")
    return res, session, song


def phase_model_parity(session, song):
    import numpy as np
    import torch

    from sesa_tpu_torch.models import bs_roformer
    from sesa_tpu_torch.models import roformer_core as core
    from sesa_tpu_torch.ops.attention import fused_attention_block_plain
    from sesa_tpu_torch.ops.ff import fused_ff_residual_plain

    step = CHUNK // OVERLAP
    chunks = torch.stack([torch.from_numpy(song[:, i * step:i * step + CHUNK])
                          for i in range(BATCH)]).cuda()
    with torch.inference_mode():
        kern = bs_roformer.apply(session.params, session.config, chunks,
                                 compute_dtype=torch.bfloat16)
        k_attn, k_ff = core.fused_attention_block, core.fused_ff_residual
        core.fused_attention_block, core.fused_ff_residual = \
            fused_attention_block_plain, fused_ff_residual_plain
        try:
            plain = bs_roformer.apply(session.params, session.config, chunks,
                                      compute_dtype=torch.bfloat16)
        finally:
            core.fused_attention_block, core.fused_ff_residual = k_attn, k_ff
        f32 = bs_roformer.apply(session.params, session.config, chunks)

    def snr(a, ref):
        return float(10 * torch.log10(ref.pow(2).sum() / (a - ref).pow(2).sum()))

    res = dict(snr_kernel_vs_plain_db=snr(kern, plain), snr_kernel_vs_f32_db=snr(kern, f32),
               snr_plain_vs_f32_db=snr(plain, f32), finite=bool(torch.isfinite(kern).all()))
    log(f"[model parity] {json.dumps(res)}")
    if not res["finite"]:
        raise RuntimeError("model parity: non-finite output")
    if not res["snr_kernel_vs_plain_db"] >= MODEL_SNR_FLOOR_DB:  # NaN fails too
        raise RuntimeError(f"model parity: SNR {res['snr_kernel_vs_plain_db']:.1f} dB "
                           f"below {MODEL_SNR_FLOOR_DB} dB")
    return res


def phase_profile(session, song):
    """Device time by kernel over one warm flagship model call (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sesa_tpu_torch.models import bs_roformer

    step = CHUNK // OVERLAP
    chunks = torch.stack([torch.from_numpy(song[:, i * step:i * step + CHUNK])
                          for i in range(BATCH)]).cuda()
    with torch.inference_mode():
        bs_roformer.apply(session.params, session.config, chunks, compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            bs_roformer.apply(session.params, session.config, chunks,
                              compute_dtype=torch.bfloat16)
            torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"[profile] one model call ({BATCH} chunks): wall {wall_ms:.1f} ms under the profiler, "
        f"device busy {busy:.1f} ms")
    for ms, count, key in rows[:14]:
        log(f"  {ms:9.2f} ms  {count:5d}x  {key[:90]}")
    return dict(wall_ms=wall_ms, device_busy_ms=busy,
                top=[dict(ms=ms, count=c, kernel=k[:120]) for ms, c, k in rows[:20]])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    try:
        import sesa_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: sesa_tpu_torch is not importable here: {e}", file=sys.stderr)
        return 1
    card = gpu_line()
    log(f"[device] {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}; {card}")
    t0 = time.perf_counter()
    phase_build()
    rows = phase_kernels()
    with tempfile.TemporaryDirectory() as work:
        main_res, session, song = phase_main_path(work)
    parity = phase_model_parity(session, song)
    profile_res = phase_profile(session, song)
    launches = {"K1": main_res["k1_launches"], "K2": main_res["k2_launches"]}
    kernels = [dict(name=r["name"], route=r["route"], source=r["source"],
                    replaces=r["replaces"], launches=launches[r["kernel"]],
                    max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=r["library_ms"]) for r in rows]
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, kernels=kernels, main_path=main_res, model_parity=parity,
                       profile=profile_res, seconds=time.perf_counter() - t0), f, indent=1)
    log(f"[total] {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
