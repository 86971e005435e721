"""Drive sesa_tpu_torch on one NVIDIA GPU and check it.

    python3 chip_smoke.py                 # every phase: the check of the port
    python3 chip_smoke.py --kernels-only  # phases 1-2, a first check of new kernels
    python3 chip_smoke.py --kernels-only --only K2,K3  # phases 1-2 for those kernels only

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. build: compiles every CUDA source of ``sesa_tpu_torch/csrc`` with nvcc,
   one process per source, all in parallel.
2. kernels: at the main paths' shapes, launches K1 (fused attention block,
   time and freq legs, and its value-residual modes 1 and 2), K2 (fused
   feed-forward, roformer RMSNorm/GELU form and conformer LayerNorm/SiLU
   form), K3 (whole-sequence attention), K4 (conformer attention, time and
   freq legs), K5 (conformer conv module, both legs), K6 (Apollo conv
   block), K7 (packed-qkv rope attention) and K8 (Mamba-2 SSD scan, bf16 and
   f32), holds each against its plain PyTorch version on the same inputs,
   times the kernel, the plain version and a library composite (cuBLAS,
   SDPA under its fastest backend of flash, cuDNN and efficient, cuDNN, the
   einsum scan), and computes each kernel's bound from its shapes; K1's, K2's
   and K6's rows also give device time by kernel (K1: norm, projection, vr
   pass, core, out; K6: dw, up, down), K2's the composite's too. K1 is also
   checked at small ragged shapes (dim_head 32 and 64, n 1 to 690 across
   its core's two routes, no and partial rope, all three modes, no
   residual), K2 at token counts that leave its last tile part empty, K3 at
   the edges of its gate (S 256, 257, 1000, 2048) for D 32, 64 and 128, and
   K4 to K8 at small ragged shapes (other head widths, clipping, short and
   even kernels, partial and no rope, sequences beyond one tile, one and
   three chunks, an impulse the state must carry, fast decays). With
   ``--only``, phases 1-2 build and check just the kernels named.
3. flagship: separates a generated 60 s stereo song through
   ``sesa_tpu_torch.cli.main`` with the flagship bs_roformer (dim 512,
   depth 12, 8 heads x 64, seeded weights) in bf16, and checks the stems,
   the f32-rescue count and the kernels' launch counts.
4. mel-band conformer: the same song through ``cli.main --model_type
   mel_band_conformer`` at bench.py's ``_melconf_setup`` shape (dim 384,
   depth 8, 60 mel bands, 8 heads x 64, conv kernel 31) in bf16; checks as
   in 3, with K2, K4 and K5 launched at every conformer block.
5. apollo: the same song restored through ``cli.main --model_type apollo``
   at bench.py's ``_apollo_setup`` shape (20 ms window, feature_dim 256, 6
   layers, chunks of 19 s, batch 2) in bf16, with K7 launched once and K6
   three times per layer.
6. chain: on the three loaded sessions, the device-resident chain of
   bench.py's ``bench_ensemble_pipeline``: the flagship's and the mel-band
   conformer's vocals kept on the card -> ``ensemble_phase_fix_device``
   (avg_wave + phase fix against the mix) -> Apollo, one host copy at the
   end; the device ensemble + phase fix is held against the host functions.
7. model parity: one chunk batch through bs_roformer, mel_band_conformer and
   apollo with the kernels against the same call with the kernels' plain
   versions, both bf16 on the card (and against f32, for the record).
8. mel-band roformer: one model call of 6 chunks at bench.py's
   ``_melband_setup`` shape (dim 384, depth 12, 60 mel bands) with the
   kernels (K1, K2) and with their plain versions.
9. experimental roformers and bs_mamba2: the same song through ``cli.main``
   with ``bs_roformer_experimental`` at the flagship widths with value
   residual learning (K1 in modes 1 and 2, K2 at depth 0), the same with
   four residual streams (hyper-connections; K3 on the time legs), and
   ``bs_mamba2`` at the reference's defaults (57 bands, feature_dim 128, 8
   mask and 4 map repeats, 4 stems; K8 48 times per model call); checks as
   in 3, then model parity as in 7. bs_mamba2 then runs once more with
   ``--compute_dtype f32`` (what a bf16 -> f32 rescue reruns), which launches
   K8's f32 form, with model parity in f32; K8's launches are counted by
   dtype.
10. profile: device time by kernel over one warm model call of the flagship,
   the mel-band conformer, apollo, the value-residual and four-stream
   roformers and bs_mamba2
   (torch.profiler), with the idle share read from the traced call itself.

Prints the ``kernels`` JSON line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

# H100 SXM dense peaks (NVIDIA data sheet): bf16 tensor cores, TF32 tensor
# cores (one pass; K8's products with an f32 operand take two or three),
# HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 494.7e12
PEAK_BYTES_S = 3.35e12

FLAGSHIP_MODEL = dict(dim=512, depth=12, stereo=True, num_stems=1,
                      time_transformer_depth=1, freq_transformer_depth=1,
                      dim_head=64, heads=8, stft_n_fft=2048, stft_hop_length=512,
                      stft_win_length=2048, mask_estimator_depth=2)
# bench.py _melconf_setup (the other keys at mel_band_conformer's defaults:
# 8 heads x 64, ff_mult 4, conv expansion 2, kernel 31, mask depth 1)
MELCONF_MODEL = dict(dim=384, depth=8, stereo=True, num_stems=1, num_bands=60,
                     time_conformer_depth=1, freq_conformer_depth=1,
                     stft_n_fft=2048, stft_hop_length=512, stft_win_length=2048)
# bench.py _melband_setup
MELBAND_MODEL = dict(dim=384, depth=12, stereo=True, num_stems=1, num_bands=60,
                     sample_rate=44100, time_transformer_depth=1, freq_transformer_depth=1,
                     dim_head=64, heads=8, stft_n_fft=2048, stft_hop_length=512,
                     stft_win_length=2048, mask_estimator_depth=1)
# bench.py _apollo_setup: 20 ms window at 44.1 kHz, 80 bands, 8 heads x 32,
# chunks of 19 s, batch 2 (x stereo = 4 rows)
APOLLO_MODEL = dict(sr=44100, win=20, feature_dim=256, layer=6)
APOLLO_CHUNK, APOLLO_BATCH = 19 * 44100, 2
APOLLO_BPRIME, APOLLO_BANDS = 2 * APOLLO_BATCH, 80
APOLLO_FRAMES = APOLLO_CHUNK // 441 + 1  # 1901 frames per chunk
# the experimental roformers at the flagship widths: value residual learning
# on one stream, and on four residual streams (hyper-connections)
VR_MODEL = dict(FLAGSHIP_MODEL, use_value_residual_learning=True)
HC_MODEL = dict(VR_MODEL, num_residual_streams=4)
HC_STREAMS = HC_MODEL["num_residual_streams"]
# bs_mamba2 at the reference's defaults: 57 bands, 8 heads x 64, state 128
MAMBA_MODEL = dict(sr=44100, win=2048, stride=512, feature_dim=128, num_repeat_mask=8,
                   num_repeat_map=4, num_output=4)
MAMBA_BANDS, MAMBA_HEADS, MAMBA_STEMS = 57, 8, ["vocals", "drums", "bass", "other"]
CHUNK, OVERLAP, BATCH, SR, SONG_S = 352800, 2, 6, 44100, 60
FRAMES, BANDS, MEL_BANDS = CHUNK // 512 + 1, 62, 60  # 690 frames; 62 / 60 bands
TOKENS = BATCH * FRAMES * BANDS  # 256,680 tokens per flagship model call
MEL_TOKENS = BATCH * FRAMES * MEL_BANDS  # 248,400 tokens per mel model call

# kernels against their plain versions, both bf16 on the card: the two
# round at the same points, but the kernels sum in another order and the
# flash softmax rounds unnormalised probabilities, so they differ by about
# one bf16 ulp. Bounds: max |kernel - plain| <= 5% of max |plain|, and the
# rms error <= 5% of the rms of the branch (out - x) the kernel adds.
KERNEL_MAX_REL, KERNEL_BRANCH_RMS_REL = 0.05, 0.05
# K8 against its plain version: f32 sums in another order (and 3xTF32
# products) in f32; in bf16 the output rounding on top
SSD_F32_ATOL, SSD_F32_RTOL, SSD_BF16_REL = 2e-4, 1e-3, 0.05
# whole model, kernels vs plain versions, bf16 on the card
MODEL_SNR_FLOOR_DB = 20.0
# the chain's device ensemble + phase fix against the host functions, over
# the STFT bins away from DC and Nyquist and the frames away from the ends
# (f32 both; they differ by the FFT libraries' rounding)
CHAIN_FIX_SNR_FLOOR_DB = 40.0


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


def device_breakdown(fn, calls=3):
    """Device ms per call by kernel over ``calls`` warm calls (torch.profiler,
    kernel rows only), largest first: [(ms, launches per call, name), ...]."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [(getattr(e, "self_device_time_total", 0) / 1e3 / calls, e.count / calls, e.key)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sorted((r for r in rows if r[0] > 0), reverse=True)


def log_breakdown(row, label, fn, what="kernel"):
    """Device time by kernel of ``fn`` (one of a row's sub-kernels, or its
    library composite's) into ``row[what + "_breakdown"]``, and logged."""
    parts = device_breakdown(fn)
    row[f"{what}_breakdown"] = parts
    log(f"  {label} {what} by kernel: " + "; ".join(
        f"{name[:60]} {ms:.3f} ms x{n:g}" for ms, n, name in parts))


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


def snr_db(a, ref):
    return float(10 * math.log10(float(ref.double().pow(2).sum())
                                 / float((a.double() - ref.double()).pow(2).sum())))


def _bound(flops, nbytes, peak_flops=PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES_S
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


# bs_mamba2's two shapes of K8, (leg, B, L) at H 8: band_rnn, sequences of
# 690 frames padded to 704, and band_comm, sequences of 57 bands padded to 64
K8_LEGS = (("band_rnn", BATCH * 2 * MAMBA_BANDS, -(-FRAMES // 64) * 64),
           ("band_comm", BATCH * 2 * FRAMES, 64))


def ssd_inputs(gen, bsz, l, h, dtype, device, a_scale=1.0):
    """x, a, b, c of K8 from ``gen``: x ~ 0.5 N, a = -|N| * a_scale, b, c ~ 0.3 N."""
    import torch

    x = (0.5 * torch.randn((bsz, l, h, 64), generator=gen)).to(device, dtype)
    a = (-a_scale * torch.randn((bsz, l, h), generator=gen).abs()).to(device, dtype)
    b, c = ((0.3 * torch.randn((bsz, l, 1, 128), generator=gen)).to(device, dtype)
            for _ in range(2))
    return x, a, b, c


def compare_ssd(name, out, ref):
    """K8 against its plain version: f32 at SSD_F32_ATOL + SSD_F32_RTOL |ref|,
    bf16 at SSD_BF16_REL of max |ref|; returns max |out - ref|."""
    import torch

    o, r = out.float(), ref.float()
    if not bool(o.isfinite().all()):
        raise RuntimeError(f"{name}: non-finite kernel output")
    diff, scale = (o - r).abs(), float(r.abs().max())
    max_err = float(diff.max())
    if out.dtype == torch.float32:
        bad = bool((diff > SSD_F32_ATOL + SSD_F32_RTOL * r.abs()).any())
        bound = f"atol {SSD_F32_ATOL}, rtol {SSD_F32_RTOL}"
    else:
        bad = max_err > SSD_BF16_REL * scale
        bound = f"{SSD_BF16_REL} x the output's largest value"
    log(f"  {name}: max_abs_err {max_err:.4g} (output max {scale:.4g})")
    if bad:
        raise RuntimeError(f"{name}: kernel disagrees with its plain version ({bound})")
    return max_err


def k8_bound(bsz, l, h, dtype):
    """K8's bound at chunk 64: what the function needs per sequence row. C·Bᵀ
    once for the heads together and, per head, its masked product with x, both
    over the lower triangle of each chunk (Q(Q+1)/2 pairs, the decay mask is 0
    above it); the two state products only where a state is read (every chunk
    but the first) or handed on (every chunk but the last), none at one chunk.
    Each product is priced at the passes its accuracy needs: in f32 three TF32
    passes; in bf16 C·Bᵀ, whose operands are exact, one bf16 pass, and the
    others, one f32 operand times an exact one, the cheaper of two TF32 passes
    and three bf16 passes (both keep 21 bits or more). Against the bytes
    (inputs once, the output once)."""
    import torch

    chunks, tri = l // 64, 64 * 65  # 2 FLOP x Q(Q+1)/2 pairs
    cbt = bsz * chunks * tri * 128
    rest = bsz * chunks * h * tri * 64 + 2 * bsz * (chunks - 1) * 64 * h * 2 * 128 * 64
    bf16 = dtype == torch.bfloat16
    if bf16:
        t_ops = cbt / PEAK_BF16_FLOPS + rest * min(2 / PEAK_TF32_FLOPS, 3 / PEAK_BF16_FLOPS)
    else:
        t_ops = 3 * (cbt + rest) / PEAK_TF32_FLOPS
    t_bytes = (2 if bf16 else 4) * bsz * l * (2 * h * 64 + h + 2 * 128) / PEAK_BYTES_S
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def counters():
    """The launch counter of every kernel wrapper, by kernel."""
    from sesa_tpu_torch.ops.attention import (fused_attention_block, fused_conformer_attention,
                                              fused_rope_attention, vmem_attention)
    from sesa_tpu_torch.ops.convblock import fused_apollo_conv, fused_conformer_conv
    from sesa_tpu_torch.ops.ff import fused_ff_residual
    from sesa_tpu_torch.ops.ssd import ssd_fused

    return {"K1": fused_attention_block, "K2": fused_ff_residual, "K3": vmem_attention,
            "K4": fused_conformer_attention, "K5": fused_conformer_conv,
            "K6": fused_apollo_conv, "K7": fused_rope_attention, "K8": ssd_fused}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0
    counters()["K1"].launches_by_mode = [0, 0, 0]
    counters()["K8"].launches_by_dtype = {"bf16": 0, "f32": 0}


def read_counts():
    return {k: fn.launches for k, fn in counters().items()}


def expect(**counts):
    """Launch counts of every kernel: the given ones, 0 for the others."""
    return {k: counts.get(k, 0) for k in counters()}


# ---------------------------------------------------------------------------
# library composites: the same functions through cuBLAS, SDPA and cuDNN,
# timed only here as a yardstick (the port never calls them)
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


def k1_vr_library(x, gamma, wqkv, wg, bg, wo, heads, scale, rope, vr, add_residual):
    """k1_library with the value-residual lerp in torch ops; returns
    (out, pre-mix V)."""
    import torch
    import torch.nn.functional as F

    from sesa_tpu_torch.ops.rope import apply_rope

    b, n, d = x.shape
    xn = F.normalize(x, dim=-1) * (d ** 0.5) * gamma
    q, k, v = (xn @ wqkv.T).reshape(b, n, 3, heads, -1).permute(2, 0, 3, 1, 4)
    v_pre = v.permute(0, 2, 1, 3).reshape(b, n, -1).contiguous()
    wvr, bvr, v_first = vr
    if v_first is not None:
        mix = torch.sigmoid(xn @ wvr.T + bvr).permute(0, 2, 1)[..., None]
        v = torch.lerp(v, v_first.reshape(b, n, heads, -1).permute(0, 2, 1, 3), mix)
    q, k = apply_rope(q, *rope), apply_rope(k, *rope)
    o = F.scaled_dot_product_attention(q, k, v, scale=scale)
    o = o * torch.sigmoid(xn @ wg.T + bg).permute(0, 2, 1)[..., None]
    o = o.permute(0, 2, 1, 3).reshape(b, n, -1) @ wo.T
    return (o + x if add_residual else o), v_pre


def k2_library(x, gamma, w1, b1, w2, b2):
    import torch.nn.functional as F

    xn = F.normalize(x, dim=-1) * (x.shape[-1] ** 0.5) * gamma
    return F.linear(F.gelu(F.linear(xn, w1, b1), approximate="tanh"), w2, b2) + x


def k2ln_library(x, gamma, w1, b1, w2, b2, beta):
    import torch.nn.functional as F

    xn = F.layer_norm(x, (x.shape[-1],), gamma, beta)
    return F.linear(F.silu(F.linear(xn, w1, b1)), w2, b2) * 0.5 + x


def k3_library(q, k, v, scale):
    """SDPA under each backend that runs these inputs; the fastest is the
    yardstick: {"library_ms": ms, "library": "SDPA <backend>", "sdpa_ms": {...}}."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    times = {}
    for name, backend in (("flash", SDPBackend.FLASH_ATTENTION),
                          ("cudnn", SDPBackend.CUDNN_ATTENTION),
                          ("efficient", SDPBackend.EFFICIENT_ATTENTION)):
        try:
            with sdpa_kernel(backend):
                times[name] = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
        except RuntimeError as e:  # a backend that does not take these inputs on this card
            log(f"  K3 yardstick: SDPA {name} does not run here ({str(e).splitlines()[0]})")
    best = min(times, key=times.get)
    log(f"  K3 yardstick: SDPA by backend {times} ms; fastest {best}")
    return dict(library_ms=times[best], library=f"SDPA {best}", sdpa_ms=times)


def k4_library(x, ln_w, ln_b, wqkv, rel, wo, bo, heads):
    """LayerNorm, cuBLAS qkv, the Shaw bias as torch.matmul against the
    gathered (n, n, dh) table, SDPA with that bias as attn_mask, cuBLAS out;
    in batch slices that keep an f32 (n, n) bias under 2 GiB."""
    import torch
    import torch.nn.functional as F

    from sesa_tpu_torch.ops.attention import shaw_rel_index

    b, n, d = x.shape
    dh = rel.shape[1]
    scale = dh ** -0.5
    xn = F.layer_norm(x, (d,), ln_w, ln_b)
    q, k, v = F.linear(xn, wqkv).reshape(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
    table = rel[torch.as_tensor(shaw_rel_index(n, (rel.shape[0] - 1) // 2), device=x.device)]
    step = max(1, (2 << 30) // (heads * n * n * 4))
    outs = []
    for s0 in range(0, b, step):
        qs = q[s0:s0 + step]
        c = qs.shape[0]
        bias = torch.matmul(qs.permute(2, 0, 1, 3).reshape(n, c * heads, dh),
                            table.transpose(1, 2))  # (n, c*h, n)
        bias = bias.reshape(n, c, heads, n).permute(1, 2, 0, 3) * scale
        outs.append(F.scaled_dot_product_attention(qs, k[s0:s0 + step], v[s0:s0 + step],
                                                   attn_mask=bias, scale=scale))
    o = torch.cat(outs).permute(0, 2, 1, 3).reshape(b, n, -1)
    return F.linear(o, wo, bo) + x


def k5_library(x, p):
    import torch
    import torch.nn.functional as F

    from sesa_tpu_torch.ops.convblock import conv_pad

    d = x.shape[-1]
    xn = F.layer_norm(x, (d,), p["norm"]["weight"], p["norm"]["bias"])
    h = F.glu(F.linear(xn, p["pw1"]["weight"][:, :, 0], p["pw1"]["bias"]), dim=-1)
    w = p["dw"]["weight"]
    h = F.conv1d(F.pad(h.transpose(1, 2), conv_pad(w.shape[-1])), w, p["dw"]["bias"],
                 groups=w.shape[0])
    bn = p["bn"]
    scale = bn["weight"] * torch.rsqrt(bn["running_var"] + 1e-5)
    h = F.silu(h * scale[:, None] + (bn["bias"] - bn["running_mean"] * scale)[:, None])
    return F.linear(h.transpose(1, 2), p["pw2"]["weight"][:, :, 0], p["pw2"]["bias"]) + x


def k6_library(x, p):
    """cuDNN's grouped conv1d, an RMSNorm in torch ops, two cuBLAS F.linear
    and F.silu."""
    import torch
    import torch.nn.functional as F

    k = p["dw_w"].shape[-1]
    y = F.conv1d(x.transpose(1, 2), p["dw_w"], p["dw_b"], padding=(k - 1) // 2,
                 groups=x.shape[-1]).transpose(1, 2)
    yf = y.float()
    yn = (yf * torch.rsqrt(yf.pow(2).mean(-1, keepdim=True) + 1e-5)).to(x.dtype) * p["norm"]
    return F.linear(F.silu(F.linear(yn, p["pw1_w"], p["pw1_b"])), p["pw2_w"], p["pw2_b"]) + x


def k7_library(qkv, heads, scale, rope):
    """The head split, rope in torch ops, SDPA and the re-pack."""
    import torch.nn.functional as F

    from sesa_tpu_torch.ops.rope import apply_rope

    b, n, packed = qkv.shape
    q, k, v = qkv.reshape(b, n, 3, heads, packed // (3 * heads)).permute(2, 0, 3, 1, 4)
    if rope is not None:
        q, k = apply_rope(q, *rope), apply_rope(k, *rope)
    o = F.scaled_dot_product_attention(q, k, v, scale=scale)
    return o.permute(0, 2, 1, 3).reshape(b, n, packed // 3)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

# the library that holds each kernel (--only builds just those)
LIBRARIES = {"K1": "attention", "K2": "ff", "K3": "vmem_attention", "K4": "conformer_attention",
             "K5": "convblock", "K6": "apollo_conv", "K7": "rope_attention", "K8": "ssd"}


def phase_build(names=None):
    from sesa_tpu_torch.ops import _build

    t0 = time.perf_counter()
    per_lib = _build.build_all(names)
    log(f"[build] {time.perf_counter() - t0:.1f}s wall; per library "
        f"{ {k: round(v, 1) for k, v in per_lib.items()} } into {_build.build_dir()}")
    for name in names or _build.SIGNATURES:
        path = os.path.join(_build.build_dir(), f"lib{name}.log")
        if os.path.exists(path):
            for line in open(path):
                # all of the compiler's report for the few libraries of --only
                if names or "Used" in line or "spill" in line.lower() and "0 bytes" not in line:
                    log(f"  {name}: {line.strip()}")
        _build.load(name)


def _weights(gen, shape, fan_in, device):
    import torch

    w = (torch.rand(shape, generator=gen) * 2 - 1) / math.sqrt(fan_in)
    return w.to(device=device, dtype=torch.bfloat16)


def _near_one(gen, shape, device, spread=0.1):
    import torch

    return (1 + spread * torch.randn(shape, generator=gen)).to(device, torch.bfloat16)


def _conv_params(gen, d, e, k, device):
    """Random conformer conv-module parameters in bf16, BatchNorm away from
    its identity init."""
    import torch

    bf = torch.bfloat16
    return {"norm": {"weight": _near_one(gen, d, device), "bias": _weights(gen, d, 100, device)},
            "pw1": {"weight": _weights(gen, (2 * e, d, 1), d, device),
                    "bias": _weights(gen, 2 * e, d, device)},
            "dw": {"weight": _weights(gen, (e, 1, k), k, device),
                   "bias": _weights(gen, e, k, device)},
            "bn": {"weight": _near_one(gen, e, device), "bias": _weights(gen, e, 100, device),
                   "running_mean": _weights(gen, e, 100, device),
                   "running_var": (1 + 0.5 * torch.rand(e, generator=gen)).to(device, bf)},
            "pw2": {"weight": _weights(gen, (d, e, 1), e, device),
                    "bias": _weights(gen, d, e, device)}}


def _apollo_conv_params(gen, d, k, device):
    """Random Apollo ICB-block parameters in bf16 (torch layouts)."""
    return {"dw_w": _weights(gen, (d, 1, k), k, device), "dw_b": _weights(gen, d, k, device),
            "norm": _near_one(gen, d, device),
            "pw1_w": _weights(gen, (4 * d, d), d, device),
            "pw1_b": _weights(gen, 4 * d, d, device),
            "pw2_w": _weights(gen, (d, 4 * d), 4 * d, device),
            "pw2_b": _weights(gen, d, 4 * d, device)}


def _k7_args(gen, b, n, heads, dh, rot, device):
    """(qkv, heads, scale, rope) with rope tables of width ``rot`` (None: no
    rope) from the default frequencies."""
    import torch

    from sesa_tpu_torch.ops.rope import default_freqs, rope_tables

    qkv = torch.randn((b, n, 3 * heads * dh), generator=gen).to(device, torch.bfloat16)
    rope = None
    if rot is not None:
        rope = tuple(r.to(device, torch.bfloat16).contiguous() for r in
                     rope_tables(torch.from_numpy(default_freqs(rot)).to(device), n))
    return qkv, heads, dh ** -0.5, rope


# K1's small ragged shapes: (b, n, d, heads, dim_head, rotary width or None,
# mode, with the residual)
K1_SMALL = ((3, 62, 128, 1, 64, 64, 0, True), (5, 65, 192, 2, 32, None, 0, True),
            (2, 257, 256, 8, 32, 16, 1, True), (1, 690, 128, 2, 64, 32, 2, False),
            (7, 62, 64, 2, 32, 32, 2, False), (4, 65, 128, 4, 64, 48, 1, True),
            (2, 257, 64, 1, 64, None, 0, False), (3, 690, 192, 3, 64, 64, 0, True),
            (5, 1, 128, 2, 32, 32, 2, False))


def _k1_args(gen, b, n, d, heads, dh, rot, device):
    """K1's positional arguments (x, gamma, wqkv, wg, bg, wo, heads, scale)
    and rope tables of width ``rot`` (None: no rope) from the default
    frequencies."""
    import torch

    from sesa_tpu_torch.ops.rope import default_freqs, rope_tables

    hd = heads * dh
    x = (0.5 * torch.randn((b, n, d), generator=gen)).to(device, torch.bfloat16)
    args = (x, _near_one(gen, d, device), _weights(gen, (3 * hd, d), d, device),
            _weights(gen, (heads, d), d, device), _weights(gen, (heads,), d, device),
            _weights(gen, (d, hd), hd, device), heads, dh ** -0.5)
    rope = None
    if rot is not None:
        rope = tuple(r.to(device, torch.bfloat16).contiguous() for r in
                     rope_tables(torch.from_numpy(default_freqs(rot)).to(device), n))
    return args, rope


def _k4_args(gen, b, n, d, heads, dh, max_pos, device):
    import torch

    hd = heads * dh
    x = (0.5 * torch.randn((b, n, d), generator=gen)).to(device, torch.bfloat16)
    rel = (0.5 * torch.randn((2 * max_pos + 1, dh), generator=gen)).to(device, torch.bfloat16)
    return (x, _near_one(gen, d, device), _weights(gen, d, 100, device),
            _weights(gen, (3 * hd, d), d, device), rel, _weights(gen, (d, hd), hd, device),
            _weights(gen, d, hd, device), heads)


def phase_kernels(only=None):
    """Each kernel's rows (all, or the kernels in ``only``, e.g. {"K2", "K3"})."""
    import torch

    import torch.nn.functional as F

    from sesa_tpu_torch.ops.attention import (fused_attention_block, fused_attention_block_plain,
                                              fused_conformer_attention,
                                              fused_conformer_attention_plain,
                                              fused_rope_attention, fused_rope_attention_plain,
                                              vmem_attention, vmem_attention_plain)
    from sesa_tpu_torch.ops.convblock import (fused_apollo_conv, fused_apollo_conv_plain,
                                              fused_conformer_conv, fused_conformer_conv_plain)
    from sesa_tpu_torch.ops.ff import fused_ff_residual, fused_ff_residual_plain
    from sesa_tpu_torch.ops.rope import apply_rope, default_freqs, rope_tables
    from sesa_tpu_torch.ops.ssd import ssd_einsum, ssd_fused, ssd_plain

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    rows = []

    zero = torch.zeros((), device=dev)

    def want(key):
        return only is None or key in only

    if want("K1"):
        # K1 at the flagship shapes
        d, heads, dh = FLAGSHIP_MODEL["dim"], FLAGSHIP_MODEL["heads"], FLAGSHIP_MODEL["dim_head"]
        hd = heads * dh
        gamma = _near_one(gen, d, dev)
        wqkv = _weights(gen, (3 * hd, d), d, dev)
        wg, bg = _weights(gen, (heads, d), d, dev), _weights(gen, (heads,), d, dev)
        wo = _weights(gen, (d, hd), hd, dev)
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
            plain_ms = time_ms(lambda: fused_attention_block_plain(*args, rope=rope), reps=2,
                               warmup=1)
            lib_ms = time_ms(lambda: k1_library(*args, rope))
            tokens = b * n
            flops = 2 * tokens * d * (3 * hd + heads + hd) + 4 * b * heads * n * n * dh
            nbytes = 2 * (2 * tokens * d + (3 * hd + heads + hd) * d + heads + d + 2 * n * dh)
            rows.append(dict(name=f"fused_attention_block ({leg} leg, b={b}, n={n})",
                             route="cuda", source="sesa_tpu_torch/csrc/attention.cu",
                             replaces="sesa_tpu/ops/attention.py:461", max_abs_err=err,
                             ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             **_bound(flops, nbytes), kernel="K1"))
            log_breakdown(rows[-1], f"K1 {leg} leg", lambda: fused_attention_block(*args, rope=rope))

            # the value-residual modes: mode 1 (first layer: with the residual,
            # returns the pre-mix V) and mode 2 (later layers: V lerped toward a
            # given V by the per-head mix, no residual)
            wvr, bvr = _weights(gen, (heads, d), d, dev), _weights(gen, (heads,), d, dev)
            v_first = torch.randn((b, n, hd), generator=gen).to(dev, torch.bfloat16)
            for mode, vr, resid in ((1, (None, None, None), True), (2, (wvr, bvr, v_first), False)):
                kw = dict(rope=rope, vr=vr, add_residual=resid)
                out, v_pre = fused_attention_block(*args, **kw)
                torch.cuda.synchronize()
                ref, ref_v = fused_attention_block_plain(*args, **kw)
                base = x if resid else torch.zeros((), device=dev)
                err = compare(f"K1 mode {mode} {leg} leg (b={b}, n={n})", out, ref, base)
                compare(f"K1 mode {mode} {leg} leg, pre-mix V", v_pre, ref_v,
                        torch.zeros((), device=dev))
                del out, ref, v_pre, ref_v
                extra = 0 if mode == 1 else tokens * hd + heads * d + heads  # v_first, wvr, bvr
                rows.append(dict(
                    name=f"fused_attention_block vr mode {mode}, "
                         f"{'with' if resid else 'no'} residual ({leg} leg, b={b}, n={n})",
                    route="cuda", source="sesa_tpu_torch/csrc/attention.cu",
                    replaces="sesa_tpu/ops/attention.py:461", max_abs_err=err,
                    ms=time_ms(lambda: fused_attention_block(*args, **kw)),
                    plain_ms=time_ms(lambda: fused_attention_block_plain(*args, **kw), reps=2,
                                     warmup=1),
                    library_ms=time_ms(lambda: k1_vr_library(*args, rope, vr, resid)),
                    **_bound(flops + (2 * tokens * d * heads if mode == 2 else 0),
                             nbytes + 2 * (tokens * hd + extra)),
                    kernel=f"K1m{mode}"))
                log_breakdown(rows[-1], f"K1 mode {mode} {leg} leg",
                              lambda: fused_attention_block(*args, **kw))
            del x, v_first
            torch.cuda.empty_cache()

        # K1 at small ragged shapes, across the core's routes (n <= 64: two
        # (sequence, head) units a tile, an odd count of them; n > 64: tiles of
        # 192 queries, the last one part empty), both head widths, widths that
        # leave lanes of the norm pass idle, no rope and partial rope, the three
        # modes, with and without the residual
        for b, n, d, heads, dh, rot, mode, resid in K1_SMALL:
            args, rope = _k1_args(gen, b, n, d, heads, dh, rot, dev)
            x = args[0]
            vr = None
            if mode == 1:
                vr = (None, None, None)
            elif mode == 2:
                vr = (_weights(gen, (heads, d), d, dev), _weights(gen, (heads,), d, dev),
                      torch.randn((b, n, heads * dh), generator=gen).to(dev, torch.bfloat16))
            kw = dict(rope=rope, vr=vr, add_residual=resid)
            out, ref = fused_attention_block(*args, **kw), fused_attention_block_plain(*args, **kw)
            label = (f"K1 small mode {mode} (b={b}, n={n}, d={d}, {heads}x{dh}, rope {rot}, "
                     f"{'with' if resid else 'no'} residual)")
            if vr is not None:
                compare(f"{label}, pre-mix V", out[1], ref[1], zero)
                out, ref = out[0], ref[0]
            compare(label, out, ref, x if resid else zero)
        torch.cuda.synchronize()

    if want("K2"):
        # K2, both forms: roformer at the flagship shape, conformer at the mel one
        for form, tokens, d in (("rms", TOKENS, FLAGSHIP_MODEL["dim"]),
                                ("ln", MEL_TOKENS, MELCONF_MODEL["dim"])):
            hidden = 4 * d
            x = torch.randn((tokens, d), generator=gen).to(dev, torch.bfloat16)
            w1, b1 = _weights(gen, (hidden, d), d, dev), _weights(gen, (hidden,), d, dev)
            w2, b2 = _weights(gen, (d, hidden), hidden, dev), _weights(gen, (d,), hidden, dev)
            args = (x, _near_one(gen, d, dev), w1, b1, w2, b2)
            if form == "rms":
                kw, lib, label, key = {}, lambda: k2_library(*args), "rms/GELU", "K2"
            else:
                beta = _weights(gen, d, 100, dev)
                kw = dict(beta=beta, norm="ln", act="swish", out_scale=0.5)
                lib, label, key = lambda: k2ln_library(*args, beta), "ln/SiLU/0.5", "K2ln"
            out = fused_ff_residual(*args, **kw)
            torch.cuda.synchronize()
            err = compare(f"K2 {label} (tokens={tokens}, d={d}, hidden={hidden})", out,
                          fused_ff_residual_plain(*args, **kw), x)
            del out
            rows.append(dict(name=f"fused_ff_residual {label} (tokens={tokens}, d={d}, "
                                  f"hidden={hidden})",
                             route="cuda", source="sesa_tpu_torch/csrc/ff.cu",
                             replaces="sesa_tpu/ops/ff.py:74", max_abs_err=err,
                             ms=time_ms(lambda: fused_ff_residual(*args, **kw)),
                             plain_ms=time_ms(lambda: fused_ff_residual_plain(*args, **kw), reps=2,
                                              warmup=1),
                             library_ms=time_ms(lib),
                             **_bound(4 * tokens * d * hidden,
                                      2 * (2 * tokens * d + 2 * hidden * d + hidden + 3 * d)),
                             kernel=key))
            log_breakdown(rows[-1], f"K2 {label}", lambda: fused_ff_residual(*args, **kw))
            log_breakdown(rows[-1], f"K2 {label}", lib, what="library")
            # token counts that leave the last 128-row tile part empty
            for ragged in (1, 257, 1000):
                xr = x[:ragged].clone()
                compare(f"K2 {label} ragged (tokens={ragged}, d={d})",
                        fused_ff_residual(xr, *args[1:], **kw),
                        fused_ff_residual_plain(xr, *args[1:], **kw), xr)
            del x, args
            torch.cuda.empty_cache()

    if want("K4") or want("K5"):
        # K4 and K5 at the mel-band conformer shapes
        d, heads, dh, max_pos, k = MELCONF_MODEL["dim"], 8, 64, 512, 31
        hd, e = heads * dh, 2 * d
        conv_p = _conv_params(gen, d, e, k, dev)
        for leg, b, n in (("time", BATCH * MEL_BANDS, FRAMES), ("freq", BATCH * FRAMES, MEL_BANDS)):
            args = _k4_args(gen, b, n, d, heads, dh, max_pos, dev)
            x, tokens = args[0], b * n
            out = fused_conformer_attention(*args)
            torch.cuda.synchronize()
            err = compare(f"K4 {leg} leg (b={b}, n={n})", out,
                          fused_conformer_attention_plain(*args), x)
            del out
            flops = 2 * tokens * d * 4 * hd + 6 * b * heads * n * n * dh
            nbytes = 2 * (2 * tokens * d + 4 * hd * d + 3 * d + (2 * max_pos + 1) * dh)
            rows.append(dict(name=f"fused_conformer_attention ({leg} leg, b={b}, n={n})",
                             route="cuda", source="sesa_tpu_torch/csrc/conformer_attention.cu",
                             replaces="sesa_tpu/ops/attention.py:641", max_abs_err=err,
                             ms=time_ms(lambda: fused_conformer_attention(*args)),
                             plain_ms=time_ms(lambda: fused_conformer_attention_plain(*args),
                                              reps=2, warmup=1),
                             library_ms=time_ms(lambda: k4_library(*args)),
                             **_bound(flops, nbytes), kernel="K4"))
            torch.cuda.empty_cache()

            out = fused_conformer_conv(x, conv_p)
            torch.cuda.synchronize()
            err = compare(f"K5 {leg} leg (b={b}, n={n})", out,
                          fused_conformer_conv_plain(x, conv_p), x)
            del out
            flops = 2 * tokens * (d * 2 * e + e * d) + 2 * tokens * k * e
            nbytes = 2 * (2 * tokens * d + 3 * d * e + k * e + 4 * e + 3 * d)
            rows.append(dict(name=f"fused_conformer_conv ({leg} leg, b={b}, n={n}, k={k})",
                             route="cuda", source="sesa_tpu_torch/csrc/convblock.cu",
                             replaces="sesa_tpu/ops/convblock.py:110", max_abs_err=err,
                             ms=time_ms(lambda: fused_conformer_conv(x, conv_p)),
                             plain_ms=time_ms(lambda: fused_conformer_conv_plain(x, conv_p),
                                              reps=2, warmup=1),
                             library_ms=time_ms(lambda: k5_library(x, conv_p)),
                             **_bound(flops, nbytes), kernel="K5"))
            del args, x
            torch.cuda.empty_cache()

        # K4 and K5 at small ragged shapes: the other head widths, clipping of the
        # Shaw distances, short sequences, a short and an even conv kernel
        for b, n, d, heads, dh, max_pos in ((3, 130, 64, 2, 32, 64), (5, 40, 64, 2, 32, 16),
                                            (2, 70, 128, 1, 128, 512), (2, 200, 128, 2, 64, 80)):
            args = _k4_args(gen, b, n, d, heads, dh, max_pos, dev)
            compare(f"K4 small (b={b}, n={n}, d={d}, {heads}x{dh}, P={max_pos})",
                    fused_conformer_attention(*args), fused_conformer_attention_plain(*args),
                    args[0])
        for b, n, d, k in ((3, 100, 64, 7), (2, 33, 128, 8), (4, 64, 64, 31)):
            p = _conv_params(gen, d, 2 * d, k, dev)
            x = (0.5 * torch.randn((b, n, d), generator=gen)).to(dev, torch.bfloat16)
            compare(f"K5 small (b={b}, n={n}, d={d}, k={k})", fused_conformer_conv(x, p),
                    fused_conformer_conv_plain(x, p), x)
        torch.cuda.synchronize()

    if want("K6"):
        # K6 at Apollo's shape: 4 x 80 band sequences of 1901 frames, d 256, k 7
        b, n, d, k = APOLLO_BPRIME * APOLLO_BANDS, APOLLO_FRAMES, APOLLO_MODEL["feature_dim"], 7
        tokens, hidden = b * n, 4 * d
        p = _apollo_conv_params(gen, d, k, dev)
        x = (0.5 * torch.randn((b, n, d), generator=gen)).to(dev, torch.bfloat16)
        out = fused_apollo_conv(x, p)
        torch.cuda.synchronize()
        err = compare(f"K6 (b={b}, n={n}, d={d}, k={k})", out, fused_apollo_conv_plain(x, p), x)
        del out
        torch.cuda.empty_cache()
        rows.append(dict(name=f"fused_apollo_conv (b={b}, n={n}, d={d}, hidden={hidden}, k={k})",
                         route="cuda", source="sesa_tpu_torch/csrc/apollo_conv.cu",
                         replaces="sesa_tpu/ops/convblock.py:200", max_abs_err=err,
                         ms=time_ms(lambda: fused_apollo_conv(x, p)),
                         plain_ms=time_ms(lambda: fused_apollo_conv_plain(x, p), reps=2, warmup=1),
                         library_ms=time_ms(lambda: k6_library(x, p)),
                         **_bound(2 * tokens * 2 * d * hidden + 2 * tokens * k * d,
                                  2 * (2 * tokens * d + 2 * d * hidden + k * d + 3 * d + hidden)),
                         kernel="K6"))
        log_breakdown(rows[-1], "K6", lambda: fused_apollo_conv(x, p))
        del x
        torch.cuda.empty_cache()

    if want("K7"):
        # K7 at Apollo's shape: 4 x 1901 frame sequences of 80 bands, 8 heads x 32
        b, n, heads, dh = APOLLO_BPRIME * APOLLO_FRAMES, APOLLO_BANDS, 8, d // 8
        args = _k7_args(gen, b, n, heads, dh, dh, dev)
        out = fused_rope_attention(*args)
        torch.cuda.synchronize()
        err = compare(f"K7 (b={b}, n={n}, {heads}x{dh})", out, fused_rope_attention_plain(*args),
                      zero)
        del out
        torch.cuda.empty_cache()
        rows.append(dict(name=f"fused_rope_attention (b={b}, n={n}, {heads} heads x {dh}, "
                              f"rope {dh})",
                         route="cuda", source="sesa_tpu_torch/csrc/rope_attention.cu",
                         replaces="sesa_tpu/ops/attention.py:280", max_abs_err=err,
                         ms=time_ms(lambda: fused_rope_attention(*args)),
                         plain_ms=time_ms(lambda: fused_rope_attention_plain(*args), reps=2,
                                          warmup=1),
                         library_ms=time_ms(lambda: k7_library(*args)),
                         **_bound(4 * b * heads * n * n * dh,
                                  2 * (b * n * 4 * heads * dh + 2 * n * dh)),
                         kernel="K7"))
        del args
        torch.cuda.empty_cache()

    # K6 and K7 at small ragged shapes: short and long sequences against the
    # 64-row tile, a 3-tap kernel; no rope, partial rotary, one and three
    # heads, a sequence beyond one key tile, a batch that no grouping divides
    if want("K6"):
        for n, k in ((62, 7), (100, 3), (257, 7)):
            p = _apollo_conv_params(gen, 128, k, dev)
            x = (0.5 * torch.randn((3, n, 128), generator=gen)).to(dev, torch.bfloat16)
            compare(f"K6 small (b=3, n={n}, d=128, k={k})", fused_apollo_conv(x, p),
                    fused_apollo_conv_plain(x, p), x)
    if want("K7"):
        for n, heads, dh, rot in ((12, 1, 64, None), (33, 3, 32, 8), (130, 1, 64, 64),
                                  (130, 3, 64, None), (33, 3, 64, 64), (12, 3, 32, 32)):
            args = _k7_args(gen, 13, n, heads, dh, rot, dev)
            compare(f"K7 small (b=13, n={n}, {heads}x{dh}, rope {rot})",
                    fused_rope_attention(*args), fused_rope_attention_plain(*args), zero)
    torch.cuda.synchronize()

    if want("K3"):
        # K3 at the hyper-connection time leg, as attention_apply hands it over:
        # permuted views of the qkv projection, q and k through rope
        heads, dh, n = FLAGSHIP_MODEL["heads"], FLAGSHIP_MODEL["dim_head"], FRAMES
        b = BATCH * BANDS
        qkv = torch.randn((b * n, 3 * heads * dh), generator=gen).to(dev, torch.bfloat16)
        rope = tuple(r.to(dev, torch.bfloat16)
                     for r in rope_tables(torch.from_numpy(default_freqs(dh)).to(dev), n))
        q, k, v = qkv.reshape(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
        q, k = apply_rope(q, *rope), apply_rope(k, *rope)
        scale = dh ** -0.5
        out = vmem_attention(q, k, v, scale)
        torch.cuda.synchronize()
        err = compare(f"K3 (BH={b * heads}, S={n}, D={dh})", out,
                      vmem_attention_plain(q, k, v, scale), zero)
        del out
        torch.cuda.empty_cache()
        rows.append(dict(name=f"vmem_attention (BH={b * heads}, S={n}, D={dh}, strided views)",
                         route="cuda", source="sesa_tpu_torch/csrc/vmem_attention.cu",
                         replaces="sesa_tpu/ops/attention.py:137", max_abs_err=err,
                         ms=time_ms(lambda: vmem_attention(q, k, v, scale)),
                         plain_ms=time_ms(lambda: vmem_attention_plain(q, k, v, scale), reps=2,
                                          warmup=1),
                         **k3_library(q, k, v, scale),
                         **_bound(4 * b * heads * n * n * dh, 2 * 4 * b * heads * n * dh),
                         kernel="K3"))
        # the same on contiguous copies, to tell the cost of the strides
        qc, kc, vc = (t.contiguous() for t in (q, k, v))
        rows[-1].update(contiguous_ms=time_ms(lambda: vmem_attention(qc, kc, vc, scale)),
                        copies_ms=time_ms(lambda: [t.contiguous() for t in (q, k, v)]))
        log(f"  K3 on contiguous (b, h, s, d) copies: {rows[-1]['contiguous_ms']:.3f} ms; "
            f"the three copies: {rows[-1]['copies_ms']:.3f} ms")
        del qkv, q, k, v, qc, kc, vc
        torch.cuda.empty_cache()
        # K3 at the edges of its gate and the other head widths, contiguous (BH, S, D)
        for s_len in (256, 257, 1000, 2048):
            for dh in (32, 64, 128):
                q, k, v = (torch.randn((5, s_len, dh), generator=gen).to(dev, torch.bfloat16)
                           for _ in range(3))
                compare(f"K3 small (BH=5, S={s_len}, D={dh})", vmem_attention(q, k, v, dh ** -0.5),
                        vmem_attention_plain(q, k, v, dh ** -0.5), zero)
        torch.cuda.synchronize()

    if want("K8"):
        # K8 at bs_mamba2's two shapes, bf16 (the session's path) and f32 (the
        # rescue's)
        for leg, bsz, l in K8_LEGS:
            for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
                args = ssd_inputs(gen, bsz, l, MAMBA_HEADS, dtype, dev)
                out = ssd_fused(*args)
                torch.cuda.synchronize()
                ref = ssd_plain(*args)
                err = compare_ssd(f"K8 {leg} {tag} (B={bsz}, L={l}, H={MAMBA_HEADS})", out, ref)
                rows.append(dict(name=f"ssd_fused {tag} ({leg}, B={bsz}, L={l}, H={MAMBA_HEADS}, "
                                      "P=64, N=128, chunk 64"
                                      + (")" if tag == "bf16" else "; the main path runs bf16)"),
                                 route="cuda", source="sesa_tpu_torch/csrc/ssd.cu",
                                 replaces="sesa_tpu/ops/ssd.py:128", max_abs_err=err,
                                 ms=time_ms(lambda: ssd_fused(*args)),
                                 plain_ms=time_ms(lambda: ssd_plain(*args), reps=2, warmup=1),
                                 library_ms=time_ms(lambda: ssd_einsum(*args), reps=2, warmup=1),
                                 **k8_bound(bsz, l, MAMBA_HEADS, dtype),
                                 kernel="K8" if dtype == torch.bfloat16 else "K8f32"))
                del args, out, ref
                torch.cuda.empty_cache()
        # K8 at small shapes: one chunk with one head and with heads beyond one
        # group of the rows kernel's decay scans, three chunks with fast decays,
        # other head counts, a band_comm batch whose last wave is part empty,
        # and the impulse in chunk 0 that the state must carry to the last chunk
        for bsz, l, h, a_scale in ((3, 64, 1, 1.0), (2, 64, 3, 1.0), (2, 64, 11, 1.0),
                                   (2, 192, 3, 3.0), (5, 256, 8, 0.7), (1001, 64, 8, 1.0)):
            for dtype in (torch.float32, torch.bfloat16):
                args = ssd_inputs(gen, bsz, l, h, dtype, dev, a_scale)
                compare_ssd(f"K8 small {dtype} (B={bsz}, L={l}, H={h}, |a| x {a_scale})",
                            ssd_fused(*args), ssd_plain(*args))
        x = torch.zeros((1, 192, 1, 64), device=dev)
        x[0, 3, 0, :] = 1.0
        a = torch.full((1, 192, 1), -1e-3, device=dev)
        bc = torch.full((1, 192, 1, 128), 0.1, device=dev)
        out = ssd_fused(x, a, bc, bc.clone())
        compare_ssd("K8 impulse (L=192)", out, ssd_plain(x, a, bc, bc))
        if not float(out[0, -1].abs().max()) > 0.1:
            raise RuntimeError("K8 impulse: the state did not reach the last chunk")
        torch.cuda.synchronize()

    for r in rows:
        log(f"  {r['name']}: {r['ms']:.3f} ms (bound {r['bound_ms']:.3f} ms by "
            f"{r['bound_by']}, plain {r['plain_ms']:.3f} ms, library {r['library_ms']:.3f} ms)")
    return rows


def _song(seconds):
    import numpy as np

    rng = np.random.default_rng(0)
    t = np.arange(seconds * SR) / SR
    voice = 0.3 * np.sin(2 * np.pi * 220 * t * (1 + 0.01 * np.sin(2 * np.pi * 0.5 * t)))
    band = 0.2 * np.sin(2 * np.pi * 110 * t) + 0.1 * np.sign(np.sin(2 * np.pi * 2 * t))
    noise = 0.02 * rng.standard_normal((2, t.size))
    return (np.stack([voice + band, 0.8 * voice + band]) + noise).astype(np.float32)


def _model_calls(chunk=CHUNK, batch=BATCH):
    """Model calls for one SONG_S song: chunks of the padded song / batch."""
    length = SONG_S * SR + 2 * (chunk - chunk // OVERLAP)
    return -(-(-(-length // (chunk // OVERLAP))) // batch)


def drive_cli(work, model_type, model_cfg, song, expected, chunk=CHUNK, batch=BATCH,
              stem="vocals", instruments=None, k1_modes=None, compute_dtype="bf16"):
    """Separate ``song`` through cli.main; check the stem written, the rescues
    and the launch counts (counters set to 0 just before, read just after);
    time a second, warm separation on the session. ``stem="vocals"`` writes a
    vocals/other config; another name leaves the training section out (the
    model then gives one stem, "restored"). ``instruments`` names the stems
    of a model that gives several. ``k1_modes`` is K1's expected count by
    mode; K8's launches must all be of ``compute_dtype``."""
    import numpy as np
    import torch

    from sesa_tpu_torch import cli
    from sesa_tpu_torch.audio_io import read_audio, write_audio

    os.makedirs(os.path.join(work, "in"))
    write_audio(os.path.join(work, "in", "song.wav"), song, SR)
    cfg = {"audio": {"chunk_size": chunk, "num_channels": 2, "sample_rate": SR},
           "model": model_cfg,
           "inference": {"num_overlap": OVERLAP, "batch_size": batch, "normalize": False}}
    if instruments:
        cfg["training"] = {"instruments": list(instruments)}
    elif stem == "vocals":
        cfg["training"] = {"instruments": ["vocals", "other"], "target_instrument": "vocals"}
    cfg_path = os.path.join(work, "config.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    out_dir = os.path.join(work, "out")

    sessions = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    rc = cli.main(["--model_type", model_type, "--config_path", cfg_path,
                   "--input_folder", os.path.join(work, "in"), "--store_dir", out_dir,
                   "--compute_dtype", compute_dtype], session_out=sessions)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    by_mode = list(counters()["K1"].launches_by_mode)
    k8_by_dtype = dict(counters()["K8"].launches_by_dtype)
    peak = torch.cuda.max_memory_allocated()
    if rc != 0:
        raise RuntimeError(f"{model_type}: cli.main returned {rc}")
    session = sessions[0]

    for name in instruments or [stem]:
        stems, _ = read_audio(os.path.join(out_dir, f"song_{name}.wav"))
        if stems.shape != song.shape or not np.isfinite(stems).all():
            raise RuntimeError(f"{model_type}: bad stem {name}: shape {stems.shape}, "
                               f"finite {np.isfinite(stems).all()}")
    if session.rescues != 0:
        raise RuntimeError(f"{model_type}: {session.rescues} bf16 -> f32 rescues")
    if launches != expected:
        raise RuntimeError(f"{model_type}: launches {launches}, expected {expected}")
    if k1_modes is not None and by_mode != list(k1_modes):
        raise RuntimeError(f"{model_type}: K1 launches by mode {by_mode}, expected {k1_modes}")
    if k8_by_dtype != dict({"bf16": 0, "f32": 0}, **{compute_dtype: expected["K8"]}):
        raise RuntimeError(f"{model_type} in {compute_dtype}: K8 launches by dtype {k8_by_dtype}")

    torch.cuda.synchronize()
    t1 = time.perf_counter()
    session.separate(song)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t1
    res = dict(model_type=model_type, song_s=SONG_S, model_calls=_model_calls(chunk, batch),
               launches=launches, k1_launches_by_mode=by_mode,
               k8_launches_by_dtype=k8_by_dtype, compute_dtype=compute_dtype, cli_wall_s=wall,
               rtf_cli=SONG_S / wall,
               separate_warm_s=warm, rtf_warm=SONG_S / warm,
               peak_cuda_mem_gib=peak / 2 ** 30, rescues=session.rescues)
    log(f"[{model_type} {compute_dtype}] {json.dumps(res)}")
    return res, session


def _chunks(song, chunk=CHUNK, batch=BATCH):
    import torch

    step = chunk // OVERLAP
    return torch.stack([torch.from_numpy(song[:, i * step:i * step + chunk])
                        for i in range(batch)]).cuda()


def _chunking(model_type):
    """(chunk, batch) of the model's driven configuration."""
    return (APOLLO_CHUNK, APOLLO_BATCH) if model_type == "apollo" else (CHUNK, BATCH)


def _plain_swaps(model_type):
    """(module, attribute, plain version) for every kernel the model reaches."""
    from sesa_tpu_torch.models import apollo, conformer_core, roformer_core
    from sesa_tpu_torch.ops import attention as attention_ops
    from sesa_tpu_torch.ops import ssd as ssd_ops
    from sesa_tpu_torch.ops.attention import (fused_attention_block_plain,
                                              fused_conformer_attention_plain,
                                              fused_rope_attention_plain)
    from sesa_tpu_torch.ops.convblock import (fused_apollo_conv_plain,
                                              fused_conformer_conv_plain)
    from sesa_tpu_torch.ops.ff import fused_ff_residual_plain

    if model_type.startswith("bs_mamba2"):  # ssd() looks ssd_fused up in its module
        return [(ssd_ops, "ssd_fused", ssd_ops.ssd_plain)]
    if model_type == "bs_roformer_experimental_hc":  # so does sdpa() with K3
        return [(attention_ops, "vmem_attention", attention_ops.vmem_attention_plain)]
    if model_type == "apollo":
        return [(apollo, "fused_rope_attention", fused_rope_attention_plain),
                (apollo, "fused_apollo_conv", fused_apollo_conv_plain)]
    if model_type == "mel_band_conformer":
        return [(conformer_core, "fused_ff_residual", fused_ff_residual_plain),
                (conformer_core, "fused_conformer_attention", fused_conformer_attention_plain),
                (conformer_core, "fused_conformer_conv", fused_conformer_conv_plain)]
    return [(roformer_core, "fused_attention_block", fused_attention_block_plain),
            (roformer_core, "fused_ff_residual", fused_ff_residual_plain)]


def model_parity(model_type, params, config, song, with_f32=True, label=None, dtype=None):
    """One chunk batch with the kernels against the same call with the
    kernels' plain versions (both in ``dtype`` on the card, bf16 unless
    given), and against f32. ``label`` names a configuration of a model type
    that is driven in two."""
    import torch

    from sesa_tpu_torch.models import get_model

    dtype = torch.bfloat16 if dtype is None else dtype
    model = get_model(model_type)
    chunks = _chunks(song, *_chunking(model_type))
    swaps = _plain_swaps(label or model_type)
    model_type = label or model_type
    with torch.inference_mode():
        reset_counts()
        kern = model.apply(params, config, chunks, compute_dtype=dtype)
        torch.cuda.synchronize()
        launches = read_counts()
        saved = [getattr(m, a) for m, a, _ in swaps]
        for m, a, plain in swaps:
            setattr(m, a, plain)
        try:
            plain = model.apply(params, config, chunks, compute_dtype=dtype)
        finally:
            for (m, a, _), fn in zip(swaps, saved):
                setattr(m, a, fn)
        f32 = model.apply(params, config, chunks) if with_f32 else None
    torch.cuda.empty_cache()

    res = dict(model_type=model_type, dtype=str(dtype).split(".")[-1], launches=launches,
               snr_kernel_vs_plain_db=snr_db(kern, plain),
               finite=bool(torch.isfinite(kern).all()))
    if f32 is not None:
        res.update(snr_kernel_vs_f32_db=snr_db(kern, f32), snr_plain_vs_f32_db=snr_db(plain, f32))
    log(f"[parity] {json.dumps(res)}")
    if not res["finite"]:
        raise RuntimeError(f"{model_type} parity: non-finite output")
    if not res["snr_kernel_vs_plain_db"] >= MODEL_SNR_FLOOR_DB:  # NaN fails too
        raise RuntimeError(f"{model_type} parity: SNR {res['snr_kernel_vs_plain_db']:.1f} dB "
                           f"below {MODEL_SNR_FLOOR_DB} dB")
    return res


def phase_melband(song):
    """mel_band_roformer at the _melband_setup shape: one model call of 6
    chunks with the kernels (K1 and K2 once per layer) and with the plain
    versions."""
    import torch

    from sesa_tpu_torch.configs import AttrDict
    from sesa_tpu_torch.models import mel_band_roformer
    from sesa_tpu_torch.tree import tree_map

    config = AttrDict({"model": MELBAND_MODEL})
    params = mel_band_roformer.init(torch.Generator().manual_seed(2), config)
    params = tree_map(lambda p: p.cuda(), params)
    res = model_parity("mel_band_roformer", params, config, song, with_f32=False)
    layers = MELBAND_MODEL["depth"] * 2
    expected = expect(K1=layers, K2=layers)
    if res["launches"] != expected:
        raise RuntimeError(f"mel_band_roformer: launches {res['launches']}, expected {expected}")
    return res


def phase_profile(model_type, session, song, label=None):
    """Device time by kernel over one warm model call (torch.profiler). The
    idle share is read from that one traced call: 1 - (kernel time) / (first
    kernel's start to last kernel's end), all on the device's clock. The
    profiler slows the host, so it is an upper estimate. The host wall of the
    same call without the profiler is printed beside it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sesa_tpu_torch.models import get_model

    model = get_model(model_type)
    chunk, batch = _chunking(model_type)
    model_type = label or model_type
    chunks = _chunks(song, chunk, batch)
    # the weights as the session's separate hands them to the model
    params = session._prepared.get(torch.bfloat16, session.params)
    with torch.inference_mode():
        walls = []
        for _ in range(3):  # the first call warms up; the wall is the best of the next two
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.apply(params, session.config, chunks, compute_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model.apply(params, session.config, chunks, compute_dtype=torch.bfloat16)
            torch.cuda.synchronize()
    # kernel events only: an aten op's device time is its kernels' time again
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if e.device_type == DeviceType.CUDA and dev_us > 0:
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy, wall = sum(r[0] for r in rows), min(walls[1:])
    sesa = sum(r[0] for r in rows if r[2].startswith(("sesa::", "void sesa::")))
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start]
    if not spans:
        raise RuntimeError(f"profile {model_type}: the trace holds no device kernel")
    span = (max(end for _, end in spans) - min(start for start, _ in spans)) / 1e3
    in_span = sum(end - start for start, end in spans) / 1e3
    idle = 1 - in_span / span
    log(f"[profile {model_type}] one model call ({batch} chunks): device busy {busy:.1f} ms "
        f"({sesa:.1f} ms in the port's kernels) of a traced span of {span:.1f} ms, idle share "
        f"{idle:.3f}; host wall without the profiler {wall:.1f} ms")
    for ms, count, key in rows[:20]:
        log(f"  {ms:9.2f} ms  {count:5d}x  {key[:90]}")
    return dict(wall_ms=wall, device_busy_ms=busy, sesa_kernels_ms=sesa,
                traced_span_ms=span, idle_share=idle,
                top=[dict(ms=ms, count=c, kernel=k[:120]) for ms, c, k in rows[:30]])


def phase_chain(sessions, song, expected):
    """The device-resident chain of bench.py's bench_ensemble_pipeline on the
    loaded sessions: two vocals separations whose stems stay on the card ->
    avg_wave ensemble + phase fix against the mix -> Apollo restoration, one
    host copy at the end. The first run is checked (launch counts, rescues,
    shape, finiteness, and the device ensemble + phase fix against the host
    functions on the same stems); a second, warm run is timed."""
    import numpy as np
    import torch

    from sesa_tpu_torch.postprocess import (ensemble_phase_fix_device, ensemble_waveforms,
                                            phase_fix_arrays)

    def run():
        mix = torch.from_numpy(song).cuda()
        v1 = sessions["bs_roformer"].separate(mix, transport="device")["vocals"]
        v2 = sessions["mel_band_conformer"].separate(mix, transport="device")["vocals"]
        fixed = ensemble_phase_fix_device(mix, [v1, v2], SR, "avg_wave")
        restored = sessions["apollo"].separate(fixed, transport="device")["restored"]
        return v1, v2, fixed, restored.cpu().numpy()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    v1, v2, fixed, out = run()
    torch.cuda.synchronize()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    rescues = {mt: s.rescues for mt, s in sessions.items()}
    if out.shape != song.shape or not np.isfinite(out).all():
        raise RuntimeError(f"chain: bad output: shape {out.shape}, "
                           f"finite {np.isfinite(out).all()}")
    if any(rescues.values()):
        raise RuntimeError(f"chain: bf16 -> f32 rescues {rescues}")
    if launches != expected:
        raise RuntimeError(f"chain: launches {launches}, expected {expected}")

    # the device function against the host pair on the same stems. The blend
    # works on wrapped angles, so a bin whose target angle is +-pi moves by
    # 2 pi (1 - blend) with the sign of a rounding error. Two families of
    # bins sit exactly there: the DC and Nyquist bins of every frame (their
    # imaginary part is +-0) and every bin of the first and last frame (the
    # reflect padding makes the frame symmetric, its spectrum real up to
    # rounding). cuFFT (here) and pocketfft (the host) do not share those
    # signs, so these bins differ wholesale. Compared by SNR over the STFT
    # bins 8..1016 (the Hann window leaks a few) of the frames away from the
    # ends; the full-band SNR and the share of samples within 1e-4 are
    # printed beside it
    host = torch.from_numpy(phase_fix_arrays(
        song, ensemble_waveforms([v1.cpu().numpy(), v2.cpu().numpy()], "avg_wave"), SR,
        device="cpu"))
    dev = fixed.cpu()

    def inner_bins(a):
        return torch.stft(a[:, 1024:-1024], 2048, 512, window=torch.hann_window(2048),
                          center=False, return_complex=True)[:, 8:-8]

    snr_full = snr_db(dev, host)
    hb, db = inner_bins(host), inner_bins(dev)
    snr = float(10 * math.log10(float(hb.abs().pow(2).sum())
                                / float((db - hb).abs().pow(2).sum())))
    close = float(((dev - host).abs() <= 1e-4).float().mean())
    log(f"  chain: device ensemble + phase fix vs host: {snr:.1f} dB over bins 8..1016, "
        f"{snr_full:.1f} dB full band, {close:.4f} of samples within 1e-4")
    if not snr >= CHAIN_FIX_SNR_FLOOR_DB:
        raise RuntimeError(f"chain: device ensemble + phase fix is {snr:.1f} dB from the host "
                           f"functions, below {CHAIN_FIX_SNR_FLOOR_DB} dB")
    del v1, v2, fixed

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = dict(launches=launches, rescues=rescues, chain_warm_s=wall, rtf_chain=SONG_S / wall,
               peak_cuda_mem_gib=peak / 2 ** 30, phase_fix_device_vs_host_snr_db=snr,
               phase_fix_full_band_snr_db=snr_full, phase_fix_share_within_1e_4=close)
    log(f"[chain] {json.dumps(res)}")
    return res


def phase_new_paths(song, calls):
    """The experimental roformers (value residual; four residual streams) and
    bs_mamba2 through cli.main, then model parity of each (kernels against
    plain versions), then the profile of the value-residual and four-stream
    models and of bs_mamba2. Each session is dropped before the next model
    loads."""
    import torch

    depth = FLAGSHIP_MODEL["depth"]
    bsnets = MAMBA_MODEL["num_repeat_mask"] + MAMBA_MODEL["num_repeat_map"]
    paths = [
        # value residual, one stream: K1 on both legs of every depth layer,
        # mode 1 with the residual at depth 0, mode 2 without after it; K2
        # only at depth 0 (later layers run ff_apply without the residual)
        ("vr", "bs_roformer_experimental", VR_MODEL, expect(K1=2 * depth * calls, K2=2 * calls),
         dict(k1_modes=[0, 2 * calls, 2 * (depth - 1) * calls]), expect(K1=2 * depth, K2=2)),
        # four residual streams: the branches run the unfused chain, whose
        # sdpa reaches K3 on the time legs (690 frames); the freq legs (62
        # bands) are below K3's gate and take the einsum
        ("hc", "bs_roformer_experimental", HC_MODEL, expect(K3=depth * calls), {},
         expect(K3=depth)),
        # per BSNet two ResMambas (band_rnn, band_comm) of two directions
        ("bs_mamba2", "bs_mamba2", MAMBA_MODEL, expect(K8=4 * bsnets * calls),
         dict(instruments=MAMBA_STEMS), expect(K8=4 * bsnets)),
        # the same in f32, what a bf16 -> f32 rescue reruns: K8's f32 form
        ("bs_mamba2_f32", "bs_mamba2", MAMBA_MODEL, expect(K8=4 * bsnets * calls),
         dict(instruments=MAMBA_STEMS, compute_dtype="f32"), expect(K8=4 * bsnets)),
    ]
    out = {"runs": {}, "parity": [], "profile": {}}
    for key, model_type, model_cfg, expected, kw, per_call in paths:
        label = key if key.startswith(model_type) else f"{model_type}_{key}"
        with tempfile.TemporaryDirectory() as work:
            res, session = drive_cli(work, model_type, model_cfg, song, expected, **kw)
        res["config"] = label
        out["runs"][key] = res
        parity = model_parity(model_type, session.params, session.config, song,
                              with_f32=False, label=label,
                              dtype=torch.float32 if kw.get("compute_dtype") == "f32" else None)
        if parity["launches"] != per_call:
            raise RuntimeError(f"{label} parity: launches {parity['launches']} in one model "
                               f"call, expected {per_call}")
        out["parity"].append(parity)
        if key in ("vr", "hc", "bs_mamba2"):
            out["profile"][label] = phase_profile(model_type, session, song, label=label)
        del session
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernels-only", action="store_true",
                        help="build and check the kernels, then stop without result lines")
    parser.add_argument("--only", type=lambda v: set(v.split(",")), default=None,
                        help="with --kernels-only: build and check only these kernels, "
                             "e.g. K2,K3 (K4 and K5 run together)")
    args = parser.parse_args(argv)
    if args.only is not None and (not args.kernels_only or not args.only <= set(LIBRARIES)):
        parser.error(f"--only takes a subset of {sorted(LIBRARIES)} and needs --kernels-only")

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
    only = args.only
    if only is not None and only & {"K4", "K5"}:
        only = only | {"K4", "K5"}
    phase_build(None if only is None else sorted({LIBRARIES[k] for k in only}))
    out = dict(card=card, kernel_rows=phase_kernels(only))
    if args.kernels_only:
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "chip_smoke_kernels.json"), "w") as f:
            json.dump(out, f, indent=1)
        log(f"[total] {time.perf_counter() - t0:.1f}s; --kernels-only: no result lines")
        return 0
    song = _song(SONG_S)
    sessions = {}
    calls = _model_calls()
    layers = FLAGSHIP_MODEL["depth"] * (FLAGSHIP_MODEL["time_transformer_depth"]
                                        + FLAGSHIP_MODEL["freq_transformer_depth"])
    with tempfile.TemporaryDirectory() as work:
        out["flagship"], sessions["bs_roformer"] = drive_cli(
            work, "bs_roformer", FLAGSHIP_MODEL, song,
            expect(K1=layers * calls, K2=layers * calls), k1_modes=[layers * calls, 0, 0])
    blocks = MELCONF_MODEL["depth"] * (MELCONF_MODEL["time_conformer_depth"]
                                       + MELCONF_MODEL["freq_conformer_depth"])
    with tempfile.TemporaryDirectory() as work:
        out["melconf"], sessions["mel_band_conformer"] = drive_cli(
            work, "mel_band_conformer", MELCONF_MODEL, song,
            expect(K2=2 * blocks * calls, K4=blocks * calls, K5=blocks * calls))
    apollo_calls, apollo_layers = _model_calls(APOLLO_CHUNK, APOLLO_BATCH), APOLLO_MODEL["layer"]
    apollo_counts = {"K6": 3 * apollo_layers * apollo_calls, "K7": apollo_layers * apollo_calls}
    with tempfile.TemporaryDirectory() as work:
        out["apollo"], sessions["apollo"] = drive_cli(
            work, "apollo", APOLLO_MODEL, song, expect(**apollo_counts),
            chunk=APOLLO_CHUNK, batch=APOLLO_BATCH, stem="restored")
    out["chain"] = phase_chain(
        sessions, song,
        expect(K1=layers * calls, K2=(layers + 2 * blocks) * calls, K4=blocks * calls,
               K5=blocks * calls, **apollo_counts))
    out["parity"] = [model_parity(mt, s.params, s.config, song) for mt, s in sessions.items()]
    per_call = {k: v // apollo_calls for k, v in apollo_counts.items()}
    got = {k: out["parity"][-1]["launches"][k] for k in per_call}
    if got != per_call:
        raise RuntimeError(f"apollo parity: launches {got} in one model call, expected {per_call}")
    out["melband"] = phase_melband(song)
    out["profile"] = {mt: phase_profile(mt, s, song) for mt, s in sessions.items()}
    sessions.clear()
    torch.cuda.empty_cache()
    out["new_paths"] = phase_new_paths(song, calls)
    out["seconds"] = time.perf_counter() - t0
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(out, f, indent=1)
    log(f"[total] {out['seconds']:.1f}s")

    # each row's launches on the main path that runs its kernel. One count per
    # wrapper: a two-leg kernel's rows both carry the count of both legs. K1
    # is counted by mode and K8 by dtype: its f32 rows carry the f32 launches
    # of the bs_mamba2 run with --compute_dtype f32
    runs = out["new_paths"]["runs"]
    launches = {"K1": out["flagship"]["launches"]["K1"], "K2": out["flagship"]["launches"]["K2"],
                "K1m1": runs["vr"]["k1_launches_by_mode"][1],
                "K1m2": runs["vr"]["k1_launches_by_mode"][2],
                "K3": runs["hc"]["launches"]["K3"],
                "K2ln": out["melconf"]["launches"]["K2"], "K4": out["melconf"]["launches"]["K4"],
                "K5": out["melconf"]["launches"]["K5"], "K6": out["apollo"]["launches"]["K6"],
                "K7": out["apollo"]["launches"]["K7"],
                "K8": runs["bs_mamba2"]["k8_launches_by_dtype"]["bf16"],
                "K8f32": runs["bs_mamba2_f32"]["k8_launches_by_dtype"]["f32"]}
    kernels = [dict(name=r["name"], route=r["route"], source=r["source"],
                    replaces=r["replaces"], launches=launches[r["kernel"]],
                    max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=r["library_ms"]) for r in out["kernel_rows"]]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
