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
   einsum scan), and computes each kernel's bound from its shapes. K1 and K2
   have rows at scnet_tran's shapes too (d 128 and 256, 8 heads x 64, both
   legs: heads x dim_head above d, both routes of K1's core); K1's, K2's,
   K4's, K5's and K6's rows also give device time by kernel (K1: norm,
   projection, vr pass, core, out; K4: norm, projection, table, core, out;
   K5: norm, up, dw, down; K6: dw, up, down), K2's the composite's too. K1 is also
   checked at small ragged shapes (dim_head 32 and 64, n 1 to 690 across
   its core's two routes, no and partial rope, all three modes, no
   residual), K2 at token counts that leave its last tile part empty, K3 at
   the edges of its gate (S 256, 257, 1000, 2048) for D 32, 64 and 128, and
   K4 to K8 at small ragged shapes (K4 across its core's two routes, other
   head widths, clipping and none, short and
   even kernels, K7 at every dim_head it takes with partial and no rope,
   one token, several boxes along n and a partial head group, sequences
   beyond one tile, one and three chunks, an impulse the state must carry,
   fast decays); K7's row also gives its device time. Then the widths
   (``width_rows``): K1 at 4 heads x 128, 16 x 32 and 8 x 96 (padded to
   128) on the flagship's legs and at 8 x 48 on the mel-band roformer's, K3
   at D 48 and 96 (BH 2976 x S 690), K4 at 8 x 48, 12 x 32 and 3 x 128 on
   the mel-band conformer's legs, K6 at d 512, 768, 896 and 1024 (b 320 x n
   1901, k 7), each a timed row with its bound on the real widths, and
   small shapes of each at head widths from 8 to 128 and at d 576 to 1024.
   Then the shapes that K5, K7 and K8 took last, each a timed row against
   its plain version with its bound: K5 at 33, 64, 65, 129 and 255 taps on
   the mel-band conformer's legs; K7 at 8 heads x 16, 24, 25 (rope 24, heads
   repacked to 32; also timed on heads already padded), 40, 64 and 112 at
   Apollo's shape (b 7604 x n 80); K8 at (H, P, N, chunk) = (16, 32, 128,
   64), (8, 64, 256, 64), (8, 64, 128, 32), (8, 64, 128, 176) and (64, 8,
   128, 8) at band_rnn's B 684 x L 704, and band_comm's B 8280 x L 64 at
   chunk 32, in bf16 and f32; and small shapes of each (K5 to 257 taps, K7 at head widths
   8 to 120 read as they lie or repacked, K8 with L, P and N padded or
   sliced). Then the Mamba mixer's two kernels (MX: ``mamba_conv``, MC, and
   ``mamba_gate_norm``, MG, ``csrc/mamba_mixer.cu``) at bs_mamba2's band_rnn
   (684 x 690) and band_comm (8,280 x 57) in bf16 and f32, both directions,
   against their plain versions, each timed beside its bytes bound at 3.35
   TB/s, its plain version and the PyTorch sequence it replaces; small
   shapes (d_model 32 to 256, rows read value by value, one step); and one
   bs_mamba2 model call (48 launches of MC, MG and K8, parity as in 7).
   With ``--only``, phases 1-2 build and check just the kernels named.
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
   end; the device ensemble + phase fix is held against the host functions,
   and the phase fix and Apollo (through ``demix_start``) are queued again
   under PyTorch's sync debug mode, which raises on a synchronising call,
   their results equal to the first run's.
7. model parity: one chunk batch through bs_roformer, mel_band_conformer and
   apollo with the kernels against the same call with the kernels' plain
   versions, both bf16 on the card (and against f32, for the record).
8. mel-band roformer: one model call of 6 chunks at bench.py's
   ``_melband_setup`` shape (dim 384, depth 12, 60 mel bands) with the
   kernels (K1, K2) and with their plain versions. Then the per-kernel
   choices off the main paths (``GATE_PATHS``, depth 1, one model call each
   with the kernels and with their plain versions): Apollo at feature_dim
   384, 512, 768, 896 and 1024 (K7 at dim_head 48, 64, 96, 112 and 128, K6
   at d 384 to 1024), the mel-band conformer at 12 heads x 32 (K4 on
   flash_shaw's 32-wide tiles on the time leg), 8 x 48 (K4 on heads padded
   to 64) and 3 x 128 (K4's mma route on both legs), each with K2 and K5,
   and at conv kernels 33, 64, 65, 129 and 255 (K2, K4 and K5 in up to 8
   register blocks of taps), Apollo at feature_dim 128, 192 (K6 and K7 at 8
   x 16 and 8 x 24) and 200 (K7 alone, 8 x 25 on heads padded to 32), the
   four-stream roformer at 8 heads x 48 and x 96 (K3 on its time legs), the
   roformer at 16 x 32 (K1 on its 32-wide cores: flash_wgmma on the time
   leg, flash_core on the freq leg) and 8 x 96 (K1 padded to 128), each
   with K2; launches as the choice predicts (K1 in mode 0), the routes the
   host plans take (``GATE_ROUTES``), parity as in 7. Then K8's sizes beside
   (64, 128, 64) through the public ``ssd`` op, one launch each with the
   counts set to 0 before. Then the widths of
   larger checkpoints at full depth (``WIDTH_PATHS``), each through
   ``cli.main`` as in 3 and warm, with exact launch counts from the model's
   choice, parity as in 7 and the profile of one warm call: the flagship at
   4 heads x 128 (K1 and K2 72 times a run), the mel-band roformer at 8 x
   48 (K1 and K2 72), the mel-band conformer at 8 x 48 (K2 96, K4 and K5
   48), Apollo at feature_dim 768 (K6 90, K7 30), the mel-band conformer at
   33 taps (K2 96, K4 and K5 48) and Apollo at feature_dim 320 (8 x 40: K6
   90, K7 30).
9. experimental roformers and bs_mamba2: the same song through ``cli.main``
   with ``bs_roformer_experimental`` at the flagship widths with value
   residual learning (K1 in modes 1 and 2, K2 at depth 0), the same with
   four residual streams (hyper-connections; K3 on the time legs), and
   ``bs_mamba2`` at the reference's defaults (57 bands, feature_dim 128, 8
   mask and 4 map repeats, 4 stems; K8 and the mixer's MC and MG 48 times
   per model call); checks as
   in 3, then model parity as in 7. bs_mamba2 then runs once more with
   ``--compute_dtype f32`` (what a bf16 -> f32 rescue reruns), which launches
   K8's f32 form, with model parity in f32, its depth cut to 2 mask and 1 map
   repeats (``MAMBA_F32_MODEL``: K8 12 times per call); K8's launches are
   counted by dtype.
10. profile: device time by kernel over one warm model call of the flagship,
   the mel-band conformer, apollo, the value-residual and four-stream
   roformers, bs_mamba2, scnet and scnet_tran
   (torch.profiler), with the idle share read from the traced call itself,
   the kernel launches, the device time of cuFFT's transforms by op and of
   cuDNN's LSTM by scope; a launch of the retired cp.async GEMM
   (``gemm_nt_kernel``) fails it.
11. scnet and bench.py's own chain: the song through ``cli.main
   --model_type scnet`` at bench.py's ``_scnet_setup`` shape (dims 4, 32,
   64, 128, nfft 4096, hop 1024, 6 dual-path layers, 4 stems) in bf16, with
   no kernel launch, one model call in bf16 against f32 on the card (max
   |err| < 0.12 x max |f32|), cuDNN's BiLSTM at SCNet's shapes in bf16 and
   in f32 with TF32 off and on; then the chain of 6 with SCNet's vocals in
   the flagship's place, checked as there.
12. the rest of the slice, each through ``cli.main`` in bf16 unless said:
   scnet_tran at the same widths (K1 and K2 on both legs of its 6 layers,
   the dual path's shapes checked, model parity as in 7); scnet_masked, one
   model call in bf16 against f32 (0.15); ConformerMSS at the JAX defaults
   (2049 bins, embed 512, depth 8) and scnet_unofficial at its defaults,
   both f32 only: no kernel launch, no prepared bf16 weights, and one chunk
   on the card against the CPU (max |err| <= 1e-3 x max |CPU|);
   bs_roformer_custom at the flagship widths with the FNO stage (16 modes;
   K1 in mode 1 on every leg, K2 at depth 0), with model parity.
13. mel_band_roformer_experimental: one model call at ``_melband_setup``'s
   widths with value residual learning, with the kernels and with their
   plain versions (K1 in mode 1 at depth 0 and mode 2 after, K2 at depth 0),
   parity as in 7.
14. MDX23C and the Demucs family, none of which launches a kernel, each
   through ``cli.main`` in bf16 with 0 rescues: mdx23c at bench.py's
   InstVocHQ shape (n_fft 8192, dim_f 4096, 4 subbands, 5 scales of 128
   channels growing by 128; chunks of 261,120, batch 8), one model call in
   bf16 against f32 (0.08) and its profile;
   experimental_mdx23c_stht at the same widths (f32 only: one chunk on the
   card against the CPU at 1e-3); htdemucs at the htdemucs_ft shape (48
   channels, depth 4, 5 cross-transformer layers at 512, demucs mode,
   segment 11 s, batch 8) with its attention's token counts, bf16 against
   f32 (0.08) and its profile; hdemucs and legacy demucs at their defaults
   (segment 11 s), one chunk in f32 on the card against the CPU (1e-3).
   The profiles add the device time of the convolutions, the norms and
   htdemucs's attention (record_function scopes around them during the
   traced call) and peak CUDA memory.
15. the band-split RNNs and the segmentation U-Nets, none of which
   launches a kernel and all f32 only (a bf16 session runs them in f32 with
   no prepared bf16 weights), each through ``cli.main`` with 0 rescues and
   one chunk on the card against the CPU (1e-3): ``bandit`` and
   ``bandit_v2`` at the mus64 widths of the registry's CINEMATIC configs (3
   stems, 64 bands, 12 seq-band modules, emb 128, rnn 256; the CPU leg on a
   quarter chunk) and VitLarge23 (``segm_models`` with
   ``tu-maxvit_large_tf_512``, n_fft 8192, hop 512, dim_f 4096, 8 subbands,
   128 channels; chunks of 261,632, batch 4), with the profile of one model
   call of bandit_v2 and VitLarge23 (cuDNN's LSTM, the bandits' per-band
   loops, the convolutions, the norms and MaxViT's partition attention by
   scope, kernel launches per call); then ``torchseg`` with resnet50 and
   ``segm_models`` with efficientnet-b3 at VitLarge23's shell widths, one
   chunk each on the card against the CPU.
16. swin_upernet and SQUIM, neither of which launches a kernel:
   ``swin_upernet`` at upernet-swin-large's widths (embed 192, depths 2 / 2
   / 18 / 2, heads 6 / 12 / 24 / 48, window 12, UperNet hidden 512) inside
   VitLarge23's STFT shell through ``cli.main`` in bf16 with 0 rescues, one
   model call in bf16 against f32 (0.08) and one chunk in f32 on the card
   against the CPU (1e-3), the profile of one model call (window attention,
   MLP, patch merging, LayerNorms, resizes and the UperNet head's conv
   modules by scope); ``utils.demix`` of a seeded ``ModelBundle`` against an f32
   session on the same weights (equal stems); SQUIM at
   ``squim_objective_base`` on 4 x 10 s of 16 kHz mono through
   ``metrics.squim_objective_scores``, card against CPU per score (1e-3),
   and its time per call.
17. the app layer: with ``SESA_TPU_HOME`` at a temporary directory, the
   flagship and mel_band_roformer (seeded; ``roformer_state_dict`` writes
   them as reference-layout checkpoints) registered as custom models
   (``add_custom_model`` and ``conf_edit`` where pyyaml imports, else
   entries with .json configs), then ``processing.process_audio`` of the
   song with each (live progress, stems and slots, K1 and K2 at layers x
   calls, the flagship's stem equal to a direct session on the same file,
   the loaded parameters equal to the seeded ones bit for bit),
   ``auto_ensemble_process`` of both (K1 and K2 at the sum, the file equal to
   the host ensemble of the single-model stems), the TF32 repair (a bf16
   SCNet call equal before and after an f32 one, the flags each call sees,
   the BiLSTMs' device time against the policy before the repair),
   ``benchmark.main`` test and benchmark, ``warmup.main`` and a
   ``device_trace`` of one flagship model call that names K1's norm kernel.
18. training (``phase_train``): one SGD step of a tiny mdx23c and a tiny
   bs_roformer (tests/test_torch_train.py's configs) on the card against
   the CPU, on a batch of one item and of two, loss and every gradient leaf
   (1e-3 of the leaf's largest); the
   flagship at full width in f32 through ``sesa_tpu_torch.train.Trainer``
   (default loss, Adam 1e-4) on one seeded batch of 1 x 2 x 352,800, 2
   warm-up steps with hooks that read both TF32 flags inside the backward
   pass (off, with both set on before), then 5 timed steps (ms per step,
   peak CUDA memory; the loss must fall); ``save`` and ``load`` into a
   fresh trainer (params bit for bit, the next losses equal);
   ``validate_track`` of a 30 s seeded song through demix; a bs_mamba2
   ``Trainer`` at K8's shape must raise the autograd guard (the mixer's
   conv, the first kernel it reaches) with no kernel launched, and
   ``ssd_fused`` under ``no_grad`` launches once; the UI:
   ``sesa_tpu_torch.gui`` imports (``GRADIO_AVAILABLE``) and ``python -m
   sesa_tpu_torch.main --help`` exits 0.
19. the modules of the last slice, each in its place among the phases
   above: I8 (``sdpa_int8``) in the kernels phase at the flagship's legs
   (the freq leg's fused route, the time leg's pre-pass and attention
   kernel, each stage timed alone with CUDA events), with small shapes on
   both routes, f32 through the plain version and a NaN kept to its row; ``phase_jobs`` after the first chain, on its loaded flagship and
   mel-band conformer sessions (one ``upload_mix``, two ``demix_start``
   back to back under PyTorch's sync debug mode with the card still busy
   when they return, ``collect_device(stems=)`` into
   ``ensemble_phase_fix_device`` equal to the demix chain, int16 within
   max / 32767, f32 ``collect`` equal to ``demix``); ``phase_int8`` after it
   (the flagship through ``cli.main`` with ``SESA_INT8_ATTN=1``: I8 72, K1
   0, K2 72, 0 rescues, >= 25 dB against f32 beside the bf16 run's SNR, its
   warm separation's seconds beside the bf16 session's);
   ``phase_export`` after phase 14 (mdx23c at the InstVocHQ widths, one
   block a scale, exported with ``torch.export`` in f32, loaded, a batch of
   8 against the direct apply; bs_mamba2's trace, one block a stage, refused
   by the mixer's conv wrapper naming it), then ``istft_repeats`` (istft_ri twice on
   the card at hops 512 and 441 into n_fft 2048: the same bits);
   ``phase_mesh`` after training (a world-size-1 NCCL group, ``make_mesh(1)``,
   the flagship's ``demix(mesh)`` and a mesh session equal to ``demix``, one
   ``Trainer(mesh)`` SGD step at full width against ``Trainer()``'s).

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
# the head widths and Apollo widths of larger checkpoints that the JAX gates
# fuse and the kernels take padded (K1, K4: heads padded per head to 64 or
# 128) or wider (K6 at d 768): each through cli.main at full depth.
# (label, model type, model config)
WIDTH_PATHS = (("flagship_dh128", "bs_roformer", dict(FLAGSHIP_MODEL, heads=4, dim_head=128)),
               ("melband_dh48", "mel_band_roformer", dict(MELBAND_MODEL, dim_head=48)),
               ("melconf_dh48", "mel_band_conformer", dict(MELCONF_MODEL, dim_head=48)),
               ("apollo_fd768", "apollo", dict(APOLLO_MODEL, feature_dim=768)),
               # K5 past 32 taps (two register blocks) and K7 at 8 heads x 40
               # (a head width that is not a multiple of 16)
               ("melconf_k33", "mel_band_conformer", dict(MELCONF_MODEL, conv_kernel_size=33)),
               ("apollo_fd320", "apollo", dict(APOLLO_MODEL, feature_dim=320)))
# the experimental roformers at the flagship widths: value residual learning
# on one stream, and on four residual streams (hyper-connections)
VR_MODEL = dict(FLAGSHIP_MODEL, use_value_residual_learning=True)
HC_MODEL = dict(VR_MODEL, num_residual_streams=4)
HC_STREAMS = HC_MODEL["num_residual_streams"]
# bs_mamba2 at the reference's defaults: 57 bands, 8 heads x 64, state 128
MAMBA_MODEL = dict(sr=44100, win=2048, stride=512, feature_dim=128, num_repeat_mask=8,
                   num_repeat_map=4, num_output=4)
MAMBA_BANDS, MAMBA_HEADS, MAMBA_STEMS = 57, 8, ["vocals", "drums", "bass", "other"]
# its f32 run (K8's f32 form, a rescue's path) at the same widths, depth cut
# to two mask BSNets and one map BSNet for the script's time
MAMBA_F32_MODEL = dict(MAMBA_MODEL, num_repeat_mask=2, num_repeat_map=1)
CHUNK, OVERLAP, BATCH, SR, SONG_S = 352800, 2, 6, 44100, 60
FRAMES, BANDS, MEL_BANDS = CHUNK // 512 + 1, 62, 60  # 690 frames; 62 / 60 bands
TOKENS = BATCH * FRAMES * BANDS  # 256,680 tokens per flagship model call
MEL_TOKENS = BATCH * FRAMES * MEL_BANDS  # 248,400 tokens per mel model call
# bench.py _scnet_setup (the other keys at SCNet's defaults: bands 0.175 /
# 0.392 / 0.433 at strides 1 / 4 / 16, 4 stems); scnet_tran adds its
# defaults, 8 heads x 64, rope 64, depth 1
SCNET_MODEL = dict(dims=[4, 32, 64, 128], nfft=4096, hop_size=1024, win_size=4096,
                   normalized=True, num_dplayer=6, expand=1)
SCNET_STEMS = ["drums", "bass", "other", "vocals"]
# the dual path's shapes at CHUNK: 2049 bins compressed to 57 by the three
# SD blocks; 346 frames (the chunk padded to an odd 345 hops), 174 after the
# frame rFFT of the even layers, whose output is twice as wide (d 256)
SCNET_BANDS, SCNET_FRAMES, SCNET_RFFT_FRAMES = 57, 346, 174
SCNET_DIM = SCNET_MODEL["dims"][-1]
# ConformerMSS at the JAX package's defaults (sesa_tpu/models/conformer.py:24-27)
MSS_MODEL = dict(in_channels=2, sources=2, freq_bins=2049, embed_dim=512, depth=8,
                 dim_head=64, heads=8, ff_mult=4, conv_expansion_factor=2, conv_kernel_size=31)
MSS_STFT = dict(n_fft=4096, hop_length=1024)
# bs_roformer_custom: the flagship widths with the FNO stage
CUSTOM_MODEL = dict(FLAGSHIP_MODEL, use_fno=True, fno_modes=16)
# bench.py bench_mdx23c, the InstVocHQ shape: n_fft 8192, dim_f 4096, 4
# subbands, 5 scales of 128 channels growing by 128, 2 blocks a scale
MDX_CHUNK, MDX_BATCH = 261120, 8
MDX_AUDIO = dict(n_fft=8192, hop_length=1024, dim_f=4096, num_channels=2,
                 chunk_size=MDX_CHUNK, sample_rate=44100)
MDX_MODEL = dict(num_subbands=4, num_scales=5, scale=[2, 2], num_blocks_per_scale=2,
                 num_channels=128, growth=128, bottleneck_factor=4, norm="InstanceNorm",
                 act="gelu")
MDX_STEMS = ["vocals", "other"]
# phase_export's mdx23c: the InstVocHQ widths at one block a scale
EXPORT_MDX_MODEL = dict(MDX_MODEL, num_blocks_per_scale=1)
# bench.py bench_htdemucs, the htdemucs_ft shape: 48 channels, depth 4, nfft
# 4096, 5 cross-transformer layers at bottom_channels 512, 8 heads; demucs
# mode, chunks of segment x samplerate; hdemucs and legacy demucs at the JAX
# package's defaults (sesa_tpu/models/htdemucs.py:48-62, demucs_legacy.py:41-46)
DEMUCS_SEGMENT, DEMUCS_BATCH = 11, 8
DEMUCS_CHUNK = DEMUCS_SEGMENT * 44100
DEMUCS_STEMS = ["drums", "bass", "other", "vocals"]
HT_SECTION = dict(channels=48, growth=2, nfft=4096, depth=4, kernel_size=8, stride=4,
                  norm_starts=4, norm_groups=4, dconv_depth=2, dconv_comp=8, t_layers=5,
                  t_heads=8, t_hidden_scale=4.0, bottom_channels=512, freq_emb=0.2, emb_scale=10)
# the token counts of htdemucs's transformer at DEMUCS_CHUNK: 8 frequency rows
# (2048 / 4^4) x 474 frames, and the time branch's 485,100 / 4^4 samples
HT_FREQ_TOKENS, HT_TIME_TOKENS = 8 * 474, 1895
# mel_band_roformer_experimental at bench.py's _melband_setup widths
MELBAND_VR_MODEL = dict(MELBAND_MODEL, use_value_residual_learning=True)
# BandIt v1 and v2 at the JAX package's defaults, the mus64 layout of the
# registry's CINEMATIC configs (sesa_tpu/models/bandit.py:25-33,
# bandit_v2.py:74-79): mono channels folded into the batch, 64 musical bands,
# 12 seq-band modules (24 BiLSTMs), emb 128, rnn 256, mlp 512
BANDIT_MODEL = dict(stems=["speech", "music", "effects"], n_bands=64, n_sqm_modules=12,
                    emb_dim=128, rnn_dim=256, mlp_dim=512, n_fft=2048, win_length=2048,
                    hop_length=512, fs=44100)
BANDIT_STEMS = BANDIT_MODEL["stems"]
# the bandits' card-vs-CPU check runs a quarter chunk (173 frames) at the same
# widths: a whole chunk's 24 BiLSTMs take tens of seconds on the CPU
BANDIT_CPU_CHUNK = CHUNK // 4
# VOCALS-VitLarge23: config_vocals_segm_models.yaml of ZFTurbo's
# Music-Source-Separation-Training (the file the registry entry names):
# n_fft 8192, hop 512, dim_f 4096, chunks of 512 frames; 8 subbands, 128
# channels, timm's MaxViT-Large at 512 (dims 128 / 256 / 512 / 1024, depths 2
# / 6 / 14 / 2, partition 16) and smp's Unet decoder; target vocals
SEGM_CHUNK, SEGM_BATCH = 261632, 4
SEGM_AUDIO = dict(n_fft=8192, hop_length=512, dim_f=4096, num_channels=2,
                  chunk_size=SEGM_CHUNK, sample_rate=44100)
SEGM_MODEL = dict(num_subbands=8, num_channels=128, act="gelu",
                  encoder_name="tu-maxvit_large_tf_512", decoder_type="unet")
SEGM_DECODER = dict(decoder_channels=[256, 128, 64, 32, 16])
# the other two native encoder zoos at VitLarge23's shell widths, one chunk
# each on the card against the CPU: (label, model type, encoder)
SEGM_ENCODERS = (("torchseg_resnet50", "torchseg", "resnet50"),
                 ("segm_models_efficientnet_b3", "segm_models", "efficientnet-b3"))
# swin_upernet at the JAX package's Swin defaults, openmmlab/upernet-swin-large
# (embed 192, depths 2/2/18/2, heads 6/12/24/48, window 12, UperNet hidden
# 512, pool scales 1/2/3/6; sesa_tpu/models/swin_upernet.py:44-51), inside
# VitLarge23's STFT shell: ZFTurbo's config_vocals_swin_upernet.yaml, the
# shell users load, is not in the repository. 128 channels x 512 x 512, stage
# maps 128^2 to 16^2 (window-padded to 132, 72, 36, 24); chunks of 261,632,
# batch 4, bf16
SWIN_MODEL = dict(num_subbands=8, num_channels=128, act="gelu")
# SQUIM at torchaudio's squim_objective_base (the JAX defaults): 4 x 10 s of
# 16 kHz mono
SQUIM_SR, SQUIM_BATCH, SQUIM_S = 16000, 4, 10
# phase_train: the tiny configs of tests/test_torch_train.py (tests/
# test_mdx23c.py tiny_config, tests/test_roformer.py bs_model_cfg) for one
# step on the card against the CPU, with a batch of 1 and of 2 items of
# TRAIN_TINY_SAMPLES; the
# flagship trains at full width on a batch of 1 x 2 x TRAIN_CHUNK in f32
TRAIN_TINY = {
    "mdx23c": {"audio": dict(n_fft=512, hop_length=128, dim_f=256, num_channels=2,
                             chunk_size=8064, sample_rate=44100),
               "model": dict(num_subbands=2, num_scales=2, scale=[2, 2], num_blocks_per_scale=1,
                             num_channels=8, growth=4, bottleneck_factor=2,
                             norm="InstanceNorm", act="gelu")},
    "bs_roformer": {"model": dict(dim=32, depth=2, stereo=True, num_stems=2,
                                  time_transformer_depth=1, freq_transformer_depth=1,
                                  linear_transformer_depth=0,
                                  freqs_per_bands=[2] * 8 + [4] * 4 + [16, 17], dim_head=8,
                                  heads=4, stft_n_fft=128, stft_hop_length=32,
                                  stft_win_length=128, mask_estimator_depth=2)},
}
TRAIN_TINY_SAMPLES = {"mdx23c": 8064, "bs_roformer": 2048}
TRAIN_CHUNK, TRAIN_WARMUP, TRAIN_STEPS, TRAIN_VAL_S = CHUNK, 2, 5, 30
# a tiny model's gradient on the card against the CPU, both f32 with TF32
# off: per leaf, max |card - cpu| <= this share of the leaf's largest CPU
# gradient (cuDNN's and MKL's convolutions and cuFFT's and pocketfft's
# transforms sum in other orders)
TRAIN_CARD_VS_CPU_REL = 1e-3
# the guard's bs_mamba2: K8's shape (feature_dim 128: 4 heads x 64, state
# 128, chunk 64), one mask and one map repeat, 2 s
TRAIN_MAMBA_MODEL = dict(MAMBA_MODEL, num_repeat_mask=1, num_repeat_map=1, num_output=2)

# kernels against their plain versions, both bf16 on the card: the two
# round at the same points, but the kernels sum in another order and the
# flash softmax rounds unnormalised probabilities, so they differ by about
# one bf16 ulp. Bounds: max |kernel - plain| <= 5% of max |plain|, and the
# rms error <= 5% of the rms of the branch (out - x) the kernel adds.
KERNEL_MAX_REL, KERNEL_BRANCH_RMS_REL = 0.05, 0.05
# the spin queued ahead of phase_jobs' dispatch, in cycles (about 1 s at the
# H100's 1.98 GHz boost clock; measured each run)
JOBS_SPIN_CYCLES = 2_000_000_000
# the int8 flagship's stems against an f32 run of the same weights: int8
# codes (7 bits a row) on top of the bf16 session's rounding
INT8_SNR_FLOOR_DB = 25.0
# an exported f32 program against the direct f32 apply on the card: the
# same ops, up to cuDNN's choice of algorithm
EXPORT_REL = 1e-4
# Trainer(mesh) at world size 1 against Trainer(): the same products, the
# tensor-parallel branches through DTensor (f32 sums in another order)
MESH_TRAIN_REL = 1e-5
# K8 against its plain version: f32 sums in another order (and 3xTF32
# products) in f32; in bf16 the output rounding on top
SSD_F32_ATOL, SSD_F32_RTOL, SSD_BF16_REL = 2e-4, 1e-3, 0.05
# the Mamba mixer's kernels against their plain versions: in f32 the same
# products in another order (FMAs, the norm's sum across a warp), a few ulps
# of the largest value; in bf16 each output may round one ulp (2^-8 of its
# value) the other way
MIXER_F32_REL, MIXER_BF16_REL = 1e-5, 2.0 ** -7
# whole model, kernels vs plain versions, bf16 on the card
MODEL_SNR_FLOOR_DB = 20.0
# the chain's device ensemble + phase fix against the host functions, over
# the STFT bins away from DC and Nyquist and the frames away from the ends
# (f32 both; they differ by the FFT libraries' rounding)
CHAIN_FIX_SNR_FLOOR_DB = 40.0
# a model in bf16 against the same model in f32, both on the card: max |err|
# below this share of max |f32| (the JAX package's own bounds for the SCNet
# family, tests/test_compute_dtype.py:65-75 and 110-130)
SCNET_BF16_REL, SCNET_MASKED_BF16_REL = 0.12, 0.15
# the f32-only models, one chunk on the card against the same chunk through
# the port on the CPU: max |err| <= this share of max |CPU|
CARD_VS_CPU_REL = 1e-3
# mdx23c, htdemucs and swin_upernet in bf16 against f32 on the card: the JAX
# package's default bound (tests/test_compute_dtype.py:23-62)
MDX_BF16_REL = HT_BF16_REL = SWIN_BF16_REL = 0.08


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


def ssd_inputs(gen, bsz, l, h, dtype, device, a_scale=1.0, p=64, n=128):
    """x, a, b, c of K8 from ``gen``, drawn where ``gen`` lies: x ~ 0.5 N
    (B, L, H, P), a = -|N| * a_scale, b, c ~ 0.3 N (B, L, 1, N)."""
    import torch

    def randn(shape):
        return torch.randn(shape, generator=gen, device=gen.device)

    x = (0.5 * randn((bsz, l, h, p))).to(device, dtype)
    a = (-a_scale * randn((bsz, l, h)).abs()).to(device, dtype)
    b, c = ((0.3 * randn((bsz, l, 1, n))).to(device, dtype) for _ in range(2))
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


def k8_bound(bsz, l, h, dtype, p=64, n=128, chunk=64):
    """K8's bound at (P, N, chunk): what the function needs per sequence row,
    at the asked chunk and the real P and N (not the kernel's padded layout).
    C·Bᵀ once for the heads together and, per head, its masked product with x,
    both over the lower triangle of each chunk (Q(Q+1)/2 pairs, the decay mask
    is 0 above it); the two state products only where a state is read (every
    chunk but the first) or handed on (every chunk but the last), none at one
    chunk.
    Each product is priced at the passes its accuracy needs: in f32 three TF32
    passes; in bf16 C·Bᵀ, whose operands are exact, one bf16 pass, and the
    others, one f32 operand times an exact one, the cheaper of two TF32 passes
    and three bf16 passes (both keep 21 bits or more). Against the bytes
    (inputs once, the output once)."""
    import torch

    chunks, tri = l // chunk, chunk * (chunk + 1)  # 2 FLOP x Q(Q+1)/2 pairs
    cbt = bsz * chunks * tri * n
    rest = bsz * chunks * h * tri * p + 2 * bsz * (chunks - 1) * chunk * h * 2 * n * p
    bf16 = dtype == torch.bfloat16
    if bf16:
        t_ops = cbt / PEAK_BF16_FLOPS + rest * min(2 / PEAK_TF32_FLOPS, 3 / PEAK_BF16_FLOPS)
    else:
        t_ops = 3 * (cbt + rest) / PEAK_TF32_FLOPS
    t_bytes = (2 if bf16 else 4) * bsz * l * (2 * h * p + h + 2 * n) / PEAK_BYTES_S
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def counters():
    """The launch counter of every kernel wrapper, by kernel."""
    from sesa_tpu_torch.ops.attention import (fused_attention_block, fused_conformer_attention,
                                              fused_rope_attention, sdpa_int8, vmem_attention)
    from sesa_tpu_torch.ops.convblock import fused_apollo_conv, fused_conformer_conv
    from sesa_tpu_torch.ops.ff import fused_ff_residual
    from sesa_tpu_torch.ops.mamba import mamba_conv, mamba_gate_norm
    from sesa_tpu_torch.ops.ssd import ssd_fused

    return {"K1": fused_attention_block, "K2": fused_ff_residual, "K3": vmem_attention,
            "K4": fused_conformer_attention, "K5": fused_conformer_conv,
            "K6": fused_apollo_conv, "K7": fused_rope_attention, "K8": ssd_fused,
            "I8": sdpa_int8, "MC": mamba_conv, "MG": mamba_gate_norm}


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


def _mamba_launches(mixers):
    """bs_mamba2's launch counts for ``mixers`` Mamba-2 mixer calls: each
    the mixer's conv, K8 and the mixer's gated norm once."""
    return expect(K8=mixers, MC=mixers, MG=mixers)


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
             "K5": "convblock", "K6": "apollo_conv", "K7": "rope_attention", "K8": "ssd",
             "I8": "int8_attention", "MX": "mamba_mixer"}


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


# K7's small ragged shapes (b, n, heads, dim_head, rotary width or None):
# every dim_head the kernel takes, a group left partial (3 heads), one token,
# several boxes along n (257, 530), no and partial rope, and batches whose
# items wrap the ring of every block
K7_SMALL = ((13, 12, 1, 64, None), (13, 33, 3, 32, 8), (13, 130, 1, 64, 64),
            (13, 130, 3, 64, None), (13, 33, 3, 64, 64), (13, 12, 3, 32, 32),
            (13, 80, 8, 16, 16), (13, 1, 3, 32, 32), (13, 1, 3, 16, None),
            (13, 257, 3, 64, 64), (13, 257, 2, 16, 8), (5, 530, 2, 32, 32),
            (13, 80, 8, 48, 48), (600, 33, 3, 48, 16), (13, 80, 8, 96, 96),
            (13, 80, 3, 96, 32), (13, 80, 4, 80, 80), (13, 80, 8, 112, 112),
            (13, 50, 2, 128, 128), (1000, 80, 8, 32, 32), (400, 257, 3, 64, 64),
            # head widths that are not multiples of 16: 8, 24, 40 and 56 read as
            # they lie (a partial group of 3 x 24, several boxes along n),
            # repacked: 25 (rope 24), 1 (no rope), 120 and 2 x 72 (too wide for
            # whole boxes as they lie)
            (13, 80, 8, 24, 24), (13, 33, 3, 24, 8), (13, 257, 3, 24, 24),
            (13, 80, 8, 40, 40), (600, 33, 8, 56, 56), (13, 12, 8, 8, 8),
            (13, 80, 8, 25, 24), (13, 80, 8, 1, None), (13, 80, 8, 120, 120),
            (13, 80, 2, 72, 72))
# K7 at Apollo's shape at other head widths: feature_dim 128, 192, 200, 320,
# 512 and 896 (8 heads x 16, 24, 25, 40, 64 and 112), each with Apollo's rope
# 2 (dh // 2) wide
K7_WIDTHS = (16, 24, 25, 40, 64, 112)
# K8 beside bs_mamba2's (64, 128, 64): (H, P, N, chunk) at band_rnn's B 684 x
# L 704 (h·P = 512), and band_comm's B 8280 x L 64 at chunk 32
K8_SIZES = ((16, 32, 128, 64), (8, 64, 256, 64), (8, 64, 128, 32), (8, 64, 128, 176),
            (64, 8, 128, 8))
K8_COMM_CHUNK = 32


def _k7_plan_line(b, n, heads, dh, rot):
    """K7's plan as one short string: group, stages, boxes along n, grid."""
    import torch

    from sesa_tpu_torch.ops.attention import k7_plan

    p = k7_plan(b, n, heads, dh, rot or 0,
                torch.cuda.get_device_properties(0).multi_processor_count)
    return (f"G {p['group']}, {p['stages']} stages, {p['nbox']} x {p['box_rows']} rows, "
            f"table {p['table']}, grid {p['grid']}")


# K1's small ragged shapes: (b, n, d, heads, dim_head, rotary width or None,
# mode, with the residual)
K1_SMALL = ((3, 62, 128, 1, 64, 64, 0, True), (5, 65, 192, 2, 32, None, 0, True),
            (2, 257, 256, 8, 32, 16, 1, True), (1, 690, 128, 2, 64, 32, 2, False),
            (7, 62, 64, 2, 32, 32, 2, False), (4, 65, 128, 4, 64, 48, 1, True),
            (2, 257, 64, 1, 64, None, 0, False), (3, 690, 192, 3, 64, 64, 0, True),
            (5, 1, 128, 2, 32, 32, 2, False),
            # head widths the cores run padded (3 x 8 to 64, 24 to 32, 48 to
            # 64, 96 and 120 to 128) and 128 on both routes
            (3, 100, 64, 3, 8, 8, 0, True), (5, 62, 128, 2, 24, 16, 2, False),
            (2, 257, 384, 8, 48, 48, 1, True), (4, 62, 256, 2, 96, 96, 0, False),
            (3, 65, 128, 1, 120, 64, 2, False), (3, 129, 256, 2, 128, 128, 0, True),
            (5, 33, 256, 2, 128, None, 1, True),
            # one head of 24 and of 32: run at 64, the out product's k-step
            (3, 100, 64, 1, 24, 24, 0, True), (4, 62, 64, 1, 32, 32, 2, False))


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


def _k1_row(args, rope, label, key):
    """K1 on ``args`` (from :func:`_k1_args`) against its plain version:
    its kernel row, timed beside the plain version and the library
    composite, with the device time by sub-kernel."""
    import torch

    from sesa_tpu_torch.ops.attention import fused_attention_block, fused_attention_block_plain

    x, heads = args[0], args[6]
    b, n, d = x.shape
    hd = args[2].shape[0] // 3
    dh = hd // heads
    out = fused_attention_block(*args, rope=rope)
    torch.cuda.synchronize()
    err = compare(f"K1 {label} (b={b}, n={n})", out,
                  fused_attention_block_plain(*args, rope=rope), x)
    del out
    tokens = b * n
    flops = 2 * tokens * d * (3 * hd + heads + hd) + 4 * b * heads * n * n * dh
    nbytes = 2 * (2 * tokens * d + (3 * hd + heads + hd) * d + heads + d + 2 * n * dh)
    row = dict(name=f"fused_attention_block ({label}, b={b}, n={n})", route="cuda",
               source="sesa_tpu_torch/csrc/attention.cu",
               replaces="sesa_tpu/ops/attention.py:461", max_abs_err=err,
               ms=time_ms(lambda: fused_attention_block(*args, rope=rope)),
               plain_ms=time_ms(lambda: fused_attention_block_plain(*args, rope=rope), reps=2,
                                warmup=1),
               library_ms=time_ms(lambda: k1_library(*args, rope)),
               **_bound(flops, nbytes), kernel=key)
    log_breakdown(row, f"K1 {label}", lambda: fused_attention_block(*args, rope=rope))
    return row


# K4's small shapes (b, n, d, heads, dim_head, P): the mma route (n <= 64, or
# dim_head 128) and the tiles route (n > 64 at dim_head 32 or 64), P below and
# above n, one key tile and several
K4_SMALL = ((3, 64, 128, 2, 64, 512), (3, 65, 128, 2, 64, 16), (3, 130, 64, 2, 32, 64),
            (5, 40, 64, 2, 32, 16), (2, 300, 64, 2, 32, 512), (2, 129, 128, 2, 64, 512),
            (2, 200, 128, 2, 64, 80), (2, 70, 128, 1, 128, 512), (2, 300, 256, 2, 128, 100),
            # head widths the cores run padded: 3 x 8 and 40 on the tiles route
            # at 64, 48 on both routes, 96 and 120 on the mma route at 128
            (2, 300, 128, 3, 8, 16), (2, 130, 192, 3, 40, 64), (3, 60, 384, 8, 48, 512),
            (2, 200, 384, 8, 48, 100), (2, 200, 128, 1, 96, 64), (3, 65, 128, 2, 120, 512),
            (2, 130, 64, 1, 32, 64))
# K5's small shapes (b, n, d, k): past 32 taps in two, three, five and nine
# register blocks, odd and even, over one row, one tile and several
K5_SMALL = ((3, 100, 64, 7), (2, 33, 128, 8), (4, 64, 64, 31), (2, 300, 64, 31),
            (3, 130, 128, 32), (5, 1, 64, 31), (3, 100, 64, 33), (2, 33, 128, 64),
            (2, 300, 64, 65), (1, 17, 64, 129), (2, 5, 64, 257), (3, 130, 128, 96))
# K5 past 32 taps at the mel-band conformer's legs: one odd and one even
# count in two register blocks, three, five and eight
K5_TAPS = (33, 64, 65, 129, 255)


def _k4_args(gen, b, n, d, heads, dh, max_pos, device):
    import torch

    hd = heads * dh
    x = (0.5 * torch.randn((b, n, d), generator=gen)).to(device, torch.bfloat16)
    rel = (0.5 * torch.randn((2 * max_pos + 1, dh), generator=gen)).to(device, torch.bfloat16)
    return (x, _near_one(gen, d, device), _weights(gen, d, 100, device),
            _weights(gen, (3 * hd, d), d, device), rel, _weights(gen, (d, hd), hd, device),
            _weights(gen, d, hd, device), heads)


# K3's and K6's small shapes at the new widths: K3 (BH, S, D) contiguous,
# read in place (D 8, 48, 96, 120) or padded by a copy (D 20); K6 (b, n, d, k)
# with the conv rows beside the staged input (d 576 at k 9) and in xn (d 768
# at 31 taps, d 1024)
K3_WIDTHS_SMALL = ((5, 256, 8), (5, 1000, 20), (3, 257, 48), (3, 690, 96), (2, 2048, 120))
K6_WIDTHS_SMALL = ((2, 70, 576, 9), (3, 100, 768, 31), (2, 257, 1024, 7), (3, 62, 1024, 31))


def _k3_views(gen, dev, b, n, heads, dh):
    """q, k, v (b, h, n, dh) as the four-stream roformer hands them to K3:
    permuted views of a qkv projection, q and k through rope."""
    import torch

    from sesa_tpu_torch.ops.rope import apply_rope, default_freqs, rope_tables

    qkv = torch.randn((b * n, 3 * heads * dh), generator=gen).to(dev, torch.bfloat16)
    rope = tuple(r.to(dev, torch.bfloat16)
                 for r in rope_tables(torch.from_numpy(default_freqs(dh)).to(dev), n))
    q, k, v = qkv.reshape(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
    return apply_rope(q, *rope), apply_rope(k, *rope), v


def _k3_row(q, k, v, key):
    """K3 on q, k, v (b, h, S, D) against its plain version, timed beside the
    plain version and SDPA's fastest backend; the bound counts the real D."""
    import torch

    from sesa_tpu_torch.ops.attention import vmem_attention, vmem_attention_plain

    b, heads, n, dh = q.shape
    scale = dh ** -0.5
    out = vmem_attention(q, k, v, scale)
    torch.cuda.synchronize()
    err = compare(f"K3 (BH={b * heads}, S={n}, D={dh})", out,
                  vmem_attention_plain(q, k, v, scale), torch.zeros((), device=q.device))
    del out
    torch.cuda.empty_cache()
    return dict(name=f"vmem_attention (BH={b * heads}, S={n}, D={dh}, strided views)",
                route="cuda", source="sesa_tpu_torch/csrc/vmem_attention.cu",
                replaces="sesa_tpu/ops/attention.py:137", max_abs_err=err,
                ms=time_ms(lambda: vmem_attention(q, k, v, scale)),
                plain_ms=time_ms(lambda: vmem_attention_plain(q, k, v, scale), reps=2, warmup=1),
                **k3_library(q, k, v, scale),
                **_bound(4 * b * heads * n * n * dh, 2 * 4 * b * heads * n * dh), kernel=key)


# I8's bound: the int8 product at the int8 tensor-core peak plus the bf16 P . V
PEAK_INT8_OPS = 1979e12


def _i8_row(q, k, v, leg, key="I8"):
    """I8 on q, k, v (b, h, n, D) against its plain version, timed beside the
    plain version and SDPA's fastest backend on the same bf16 tensors, and
    each of its stages (the tiles route's pre-pass and attention kernel, the
    fused route's one kernel) timed alone with CUDA events. The bound: q, k,
    v read and o written once, against the int8 product at the int8 peak
    plus P . V at the bf16 peak."""
    import torch

    from sesa_tpu_torch.ops.attention import i8_plan, sdpa_int8, sdpa_int8_plain, sdpa_int8_stages

    b, heads, n, dh = q.shape
    bh = b * heads
    route = i8_plan(q, k, v, torch.cuda.get_device_properties(q.device)
                    .multi_processor_count)["route"]
    out = sdpa_int8(q, k, v)
    torch.cuda.synchronize()
    err = compare(f"I8 {leg} leg (BH={bh}, n={n}, D={dh}, {route} route)", out,
                  sdpa_int8_plain(q, k, v), torch.zeros((), device=q.device))
    del out
    torch.cuda.empty_cache()
    t_ops = 2 * bh * n * n * dh / PEAK_INT8_OPS + 2 * bh * n * n * dh / PEAK_BF16_FLOPS
    t_bytes = 4 * 2 * bh * n * dh / PEAK_BYTES_S
    stages = {name: time_ms(launch, reps=20, warmup=3)
              for name, launch in sdpa_int8_stages(q, k, v)}
    row = dict(name=f"sdpa_int8 ({leg} leg, BH={bh}, n={n}, D={dh}, strided views)",
               route="cuda", source="sesa_tpu_torch/csrc/int8_attention.cu",
               replaces="none (beside K3; sesa_tpu/ops/attention.py:62 sdpa_int8 is plain JAX)",
               max_abs_err=err, ms=time_ms(lambda: sdpa_int8(q, k, v), reps=20, warmup=3),
               plain_ms=time_ms(lambda: sdpa_int8_plain(q, k, v), reps=2, warmup=1),
               **k3_library(q, k, v, dh ** -0.5),
               bound_ms=1e3 * max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes", kernel=key,
               i8_route=route, stages_ms=stages)
    log(f"  I8 {leg} leg by stage ({route} route, CUDA events): "
        + "; ".join(f"{name} {ms:.3f} ms" for name, ms in stages.items()))
    return row


def i8_small(gen, dev):
    """I8 at small shapes against its plain version, on both routes: every
    core width (D 8 to 128, D 100 padded for V), n from 1 to past two key
    tiles (n <= 64 the fused route, beyond it the pre-pass and the tiles),
    the freq leg's 62 and the time leg's 690, a sequence of 1600 (the
    pre-pass without clusters), views and 3-D contiguous tensors; f32 runs
    the plain version (no launch); on each route a NaN in one query row
    reaches that row's output only."""
    import torch

    from sesa_tpu_torch.ops.attention import i8_plan, sdpa_int8, sdpa_int8_plain

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    zero = torch.zeros((), device=dev)
    for d in (8, 24, 32, 40, 64, 96, 100, 128):
        for n in (1, 7, 62, 64, 65, 130, 690):
            q, k, v = _k3_views(gen, dev, 3, n, 2, d)
            route = i8_plan(q, k, v, sms)["route"]
            if route != ("fused" if n <= 64 else "tiles"):
                raise RuntimeError(f"I8: n={n} planned on the {route} route")
            compare(f"I8 small (b=3, h=2, n={n}, D={d}, views, {route})", sdpa_int8(q, k, v),
                    sdpa_int8_plain(q, k, v), zero)
    # a sequence too long for the pre-pass's clusters (one block reads k twice)
    q, k, v = _k3_views(gen, dev, 2, 1600, 2, 64)
    if i8_plan(q, k, v, sms)["prepass"]["cluster"] != 1:
        raise RuntimeError("I8: n=1600 planned on the pre-pass's clusters")
    compare("I8 small (b=2, h=2, n=1600, D=64, views, tiles, one pre-pass block a sequence)",
            sdpa_int8(q, k, v), sdpa_int8_plain(q, k, v), zero)
    for n in (50, 77):
        q, k, v = (torch.randn((5, n, 64), generator=gen).to(dev, torch.bfloat16)
                   for _ in range(3))
        route = i8_plan(q, k, v, sms)["route"]
        compare(f"I8 small 3-D contiguous (5, {n}, 64), {route}", sdpa_int8(q, k, v),
                sdpa_int8_plain(q, k, v), zero)
        before = sdpa_int8.launches
        out = sdpa_int8(q.float(), k.float(), v.float())
        if sdpa_int8.launches != before or out.dtype != torch.float32:
            raise RuntimeError("I8: f32 inputs must run the plain version")
        q = q.clone()
        q[2, 5, 3] = float("nan")
        out = sdpa_int8(q, k, v).float()
        torch.cuda.synchronize()
        bad = ~out.isfinite().all(-1)
        if not bool(bad[2, 5]) or int(bad.sum()) != 1:
            raise RuntimeError(f"I8 ({route} route): a NaN query gave {int(bad.sum())} "
                               "non-finite rows")


def _k4_row(args, label, key):
    """K4 on ``args`` (from :func:`_k4_args`) against its plain version, timed
    beside the plain version and the library composite, with the device time
    by sub-kernel; the bound counts the real dim_head."""
    import torch

    from sesa_tpu_torch.ops.attention import (fused_conformer_attention,
                                              fused_conformer_attention_plain)

    x, heads, rel = args[0], args[7], args[4]
    b, n, d = x.shape
    dh = rel.shape[1]
    hd, tokens = heads * dh, b * n
    out = fused_conformer_attention(*args)
    torch.cuda.synchronize()
    err = compare(f"K4 {label} (b={b}, n={n})", out, fused_conformer_attention_plain(*args), x)
    del out
    flops = 2 * tokens * d * 4 * hd + 6 * b * heads * n * n * dh
    nbytes = 2 * (2 * tokens * d + 4 * hd * d + 3 * d + rel.shape[0] * dh)
    row = dict(name=f"fused_conformer_attention ({label}, b={b}, n={n})", route="cuda",
               source="sesa_tpu_torch/csrc/conformer_attention.cu",
               replaces="sesa_tpu/ops/attention.py:641", max_abs_err=err,
               ms=time_ms(lambda: fused_conformer_attention(*args)),
               plain_ms=time_ms(lambda: fused_conformer_attention_plain(*args), reps=2, warmup=1),
               library_ms=time_ms(lambda: k4_library(*args)), **_bound(flops, nbytes), kernel=key)
    log_breakdown(row, f"K4 {label}", lambda: fused_conformer_attention(*args))
    return row


def _k6_row(gen, dev, b, n, d, k, key):
    """K6 at (b, n, d) with k taps against its plain version, timed beside
    the plain version and the library composite, with the device time by
    sub-kernel."""
    import torch

    from sesa_tpu_torch.ops.convblock import fused_apollo_conv, fused_apollo_conv_plain

    tokens, hidden = b * n, 4 * d
    p = _apollo_conv_params(gen, d, k, dev)
    x = (0.5 * torch.randn((b, n, d), generator=gen)).to(dev, torch.bfloat16)
    out = fused_apollo_conv(x, p)
    torch.cuda.synchronize()
    err = compare(f"K6 (b={b}, n={n}, d={d}, k={k})", out, fused_apollo_conv_plain(x, p), x)
    del out
    torch.cuda.empty_cache()
    row = dict(name=f"fused_apollo_conv (b={b}, n={n}, d={d}, hidden={hidden}, k={k})",
               route="cuda", source="sesa_tpu_torch/csrc/apollo_conv.cu",
               replaces="sesa_tpu/ops/convblock.py:200", max_abs_err=err,
               ms=time_ms(lambda: fused_apollo_conv(x, p)),
               plain_ms=time_ms(lambda: fused_apollo_conv_plain(x, p), reps=2, warmup=1),
               library_ms=time_ms(lambda: k6_library(x, p)),
               **_bound(2 * tokens * 2 * d * hidden + 2 * tokens * k * d,
                        2 * (2 * tokens * d + 2 * d * hidden + k * d + 3 * d + hidden)),
               kernel=key)
    log_breakdown(row, f"K6 d={d}", lambda: fused_apollo_conv(x, p))
    return row


def _k5_row(x, p, leg, key):
    """K5 on x (b, n, d) with the conv params ``p`` against its plain version,
    timed beside the plain version and the library composite, with the
    device time by sub-kernel; its bound counts the k taps' FMAs."""
    from sesa_tpu_torch.ops.convblock import fused_conformer_conv, fused_conformer_conv_plain

    import torch

    b, n, d = x.shape
    e, k = p["pw2"]["weight"].shape[1], p["dw"]["weight"].shape[-1]
    tokens = b * n
    out = fused_conformer_conv(x, p)
    torch.cuda.synchronize()
    err = compare(f"K5 {leg} leg (b={b}, n={n}, k={k})", out, fused_conformer_conv_plain(x, p),
                  x)
    del out
    flops = 2 * tokens * (d * 2 * e + e * d) + 2 * tokens * k * e
    nbytes = 2 * (2 * tokens * d + 3 * d * e + k * e + 4 * e + 3 * d)
    row = dict(name=f"fused_conformer_conv ({leg} leg, b={b}, n={n}, k={k})",
               route="cuda", source="sesa_tpu_torch/csrc/convblock.cu",
               replaces="sesa_tpu/ops/convblock.py:110", max_abs_err=err,
               ms=time_ms(lambda: fused_conformer_conv(x, p)),
               plain_ms=time_ms(lambda: fused_conformer_conv_plain(x, p), reps=2, warmup=1),
               library_ms=time_ms(lambda: k5_library(x, p)),
               **_bound(flops, nbytes), kernel=key)
    log_breakdown(row, f"K5 {leg} leg k={k}", lambda: fused_conformer_conv(x, p))
    return row


def _k7_row(gen, dev, b, n, heads, dh, rot, key):
    """K7 at (b, n, heads x dh) with rope ``rot`` wide against its plain
    version, timed beside the plain version and the library composite, with
    its device time by kernel; its bound counts the real dh's bytes. Where
    the plan repacks (dh not a multiple of 8), ``padded_ms`` times the
    kernel on heads already padded to the plan's width, as Apollo's band
    layer hands them over."""
    import torch

    from sesa_tpu_torch.ops.attention import (fused_rope_attention, fused_rope_attention_plain,
                                              k7_plan, pad_heads)

    args = _k7_args(gen, b, n, heads, dh, rot, dev)
    zero = torch.zeros((), device=dev)
    out = fused_rope_attention(*args)
    torch.cuda.synchronize()
    plan_line = _k7_plan_line(b, n, heads, dh, rot)
    err = compare(f"K7 (b={b}, n={n}, {heads}x{dh}, rope {rot}; {plan_line})", out,
                  fused_rope_attention_plain(*args), zero)
    del out
    torch.cuda.empty_cache()
    w = rot or 0
    row = dict(name=f"fused_rope_attention (b={b}, n={n}, {heads} heads x {dh}, rope {w})",
               route="cuda", source="sesa_tpu_torch/csrc/rope_attention.cu",
               replaces="sesa_tpu/ops/attention.py:280", max_abs_err=err,
               ms=time_ms(lambda: fused_rope_attention(*args)),
               plain_ms=time_ms(lambda: fused_rope_attention_plain(*args), reps=2, warmup=1),
               library_ms=time_ms(lambda: k7_library(*args)),
               **_bound(4 * b * heads * n * n * dh, 2 * (b * n * 4 * heads * dh + 2 * n * w)),
               kernel=key)
    plan = k7_plan(b, n, heads, dh, w)
    if plan["repack"]:
        wide = (pad_heads(args[0], dh, plan["width"]),) + args[1:]
        row["padded_ms"] = time_ms(lambda: fused_rope_attention(*wide))
        log(f"  K7 {heads}x{dh}: {row['padded_ms']:.3f} ms on heads padded to {plan['width']} "
            f"(the band layer's route), {row['ms']:.3f} ms with the wrapper's repack")
        del wide
    log_breakdown(row, f"K7 {heads}x{dh}", lambda: fused_rope_attention(*args))
    del args
    torch.cuda.empty_cache()
    return row


def _k8_key(leg, h, p, n, chunk, dtype):
    """The launch-count key of a K8 row off bs_mamba2's sizes."""
    import torch

    return f"K8:{leg}:{h}x{p}x{n}c{chunk}:{'bf16' if dtype == torch.bfloat16 else 'f32'}"


def _k8_row(gen, dev, leg, bsz, l, h, p, n, chunk, dtype, key=None):
    """K8 at (B, L, H, P), state N and ``chunk`` against the wrapper's plain
    version, timed beside it and the einsum scan at the asked chunk; the
    bound counts the real P, N and chunk. ``key`` names its launch count
    (default: the size's, :func:`_k8_key`)."""
    import torch

    from sesa_tpu_torch.ops.ssd import k8_plan, ssd_einsum, ssd_fused, ssd_fused_plain

    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    args = ssd_inputs(gen, bsz, l, h, dtype, dev, p=p, n=n)
    out = ssd_fused(*args, chunk_size=chunk)
    torch.cuda.synchronize()
    ref = ssd_fused_plain(*args, chunk_size=chunk)
    plan = k8_plan(bsz, l, h, dtype, p, n, chunk)
    err = compare_ssd(f"K8 {leg} {tag} (B={bsz}, L={l}, H={h}, P={p}, N={n}, chunk {chunk}; "
                      f"{plan['pseudo_heads']} pseudo-heads of 64, {plan['steps']} steps, "
                      f"{plan['slices']} slices, {plan['variant']})", out, ref)
    del out, ref
    torch.cuda.empty_cache()
    row = dict(name=f"ssd_fused {tag} ({leg}, B={bsz}, L={l}, H={h}, P={p}, N={n}, "
                    f"chunk {chunk})",
               route="cuda", source="sesa_tpu_torch/csrc/ssd.cu",
               replaces="sesa_tpu/ops/ssd.py:128", max_abs_err=err,
               ms=time_ms(lambda: ssd_fused(*args, chunk_size=chunk)),
               plain_ms=time_ms(lambda: ssd_fused_plain(*args, chunk_size=chunk), reps=2,
                                warmup=1),
               library_ms=time_ms(lambda: ssd_einsum(*args, chunk_size=chunk), reps=2,
                                  warmup=1),
               **k8_bound(bsz, l, h, dtype, p, n, chunk),
               kernel=key or _k8_key(leg, h, p, n, chunk, dtype))
    del args
    torch.cuda.empty_cache()
    return row


# bs_mamba2's two legs of the Mamba mixer, (leg, B, L) at d_model 128:
# band_rnn over 690 frames, band_comm over 57 bands
MIXER_LEGS = (("band_rnn", BATCH * 2 * MAMBA_BANDS, FRAMES),
              ("band_comm", BATCH * 2 * FRAMES, MAMBA_BANDS))


def mixer_inputs(gen, d_model, bsz, l, dtype, device):
    """A Mamba-2 mixer's parameters (mamba2_init's, moved off their init
    values, A_log spread over [-4, 2]), its in projection's output zxbcdt ~
    0.5 N and a scan output y ~ 0.5 N (B, Lp, H, 64) for the gate, drawn on
    the card."""
    import torch

    from sesa_tpu_torch.models import bs_mamba2

    p = bs_mamba2.mamba2_init(torch.Generator().manual_seed(d_model), d_model)
    p = {k: (v + 0.1 * torch.randn(v.shape, generator=torch.Generator().manual_seed(i)))
         for i, (k, v) in enumerate(p.items())}
    p["A_log"] = torch.linspace(-4.0, 2.0, p["A_log"].shape[0])
    p = {k: v.to(device, dtype) for k, v in p.items()}
    cols, heads = p["in_proj"].shape[0], p["dt_bias"].shape[0]
    zx = (0.5 * torch.randn((bsz, l, cols), generator=gen, device=gen.device)).to(dtype)
    y = (0.5 * torch.randn((bsz, -(-l // 64) * 64, heads, 64), generator=gen,
                           device=gen.device)).to(dtype)
    return p, zx, y


def compare_mixer(name, outs, refs):
    """The mixer's outputs against their plain versions, each within
    MIXER_F32_REL (f32) or MIXER_BF16_REL (bf16) of its largest value;
    returns the largest |kernel - plain| over the outputs."""
    import torch

    bound = MIXER_BF16_REL if outs[0].dtype == torch.bfloat16 else MIXER_F32_REL
    worst = worst_rel = 0.0
    for o, r in zip(outs, refs):
        o, r = o.float(), r.float()
        if o.shape != r.shape or not bool(o.isfinite().all()):
            raise RuntimeError(f"{name}: shape {tuple(o.shape)} against {tuple(r.shape)}, or "
                               "a non-finite kernel output")
        err = float((o - r).abs().max())
        worst, worst_rel = max(worst, err), max(worst_rel, err / max(float(r.abs().max()), 1e-30))
    log(f"  {name}: max |err| {worst:.4g}, over max |plain| {worst_rel:.4g} (bound {bound:.4g})")
    if worst_rel > bound:
        raise RuntimeError(f"{name}: kernel disagrees with its plain version")
    return worst


def mixer_torch_sequence(p, zx, y, chunk=64):
    """The PyTorch sequence the mixer's kernels replace (bs_mamba2.py's
    mamba2_apply before them), timed only here as a yardstick: (conv step,
    gate step), each a function of no argument."""
    import torch
    import torch.nn.functional as F

    bsz, l, _ = zx.shape
    heads = p["dt_bias"].shape[0]
    di = 64 * heads

    def conv():
        a = -torch.exp(p["A_log"])
        dt = F.softplus(zx[..., -heads:] + p["dt_bias"])
        xbc = zx[..., di:-heads]
        xbc = F.conv1d(F.pad(xbc.transpose(1, 2), (3, 0)), p["conv_w"], p["conv_b"],
                       groups=xbc.shape[-1]).transpose(1, 2)
        xbc = xbc * torch.sigmoid(xbc)
        x = xbc[..., :di].reshape(bsz, l, heads, 64)
        b, c = xbc[..., None, di:di + 128], xbc[..., None, di + 128:]
        lpad = -l % chunk
        xs = F.pad(x, (0, 0, 0, 0, 0, lpad))
        b, c = (F.pad(t, (0, 0, 0, 0, 0, lpad)) for t in (b, c))
        dt = F.pad(dt, (0, 0, 0, lpad))
        return xs * dt[..., None], a * dt, b, c, x

    x = conv()[4]

    def gate():
        g = y[:, :l].contiguous() + x * p["D"][None, None, :, None]  # K8's slice copy
        g = g.reshape(bsz, l, di)
        z = zx[..., :di]
        g = g * (z * torch.sigmoid(z))
        g = g * torch.rsqrt(g.pow(2).mean(dim=-1, keepdim=True) + 1e-5)
        return g * p["norm_w"]

    return conv, gate


def mixer_bytes(bsz, l, di, n, heads, dtype):
    """Bytes the mixer's two steps need: the conv reads the xBC and dt
    columns of L steps and writes x·dt, a·dt, b and c of Lp steps and x of
    L; the gate reads y, x and z and writes a row, of L steps."""
    import torch

    el = 2 if dtype == torch.bfloat16 else 4
    lp = -(-l // 64) * 64
    conv = el * (bsz * l * (di + 2 * n + heads) + bsz * lp * (di + heads + 2 * n)
                 + bsz * l * di)
    return conv, el * 4 * bsz * l * di


def _mixer_rows(gen, dev, leg, bsz, l, dtype):
    """The mixer's two kernels at one leg of bs_mamba2 (d_model 128), both
    directions against their plain versions, then timed (forward) beside
    their plain versions and today's PyTorch sequence; the bound is the
    bytes at PEAK_BYTES_S."""
    import torch

    from sesa_tpu_torch.ops.mamba import (mamba_conv, mamba_conv_plain, mamba_gate_norm,
                                          mamba_gate_norm_plain)

    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    p, zx, y = mixer_inputs(gen, 128, bsz, l, dtype, dev)
    cargs = (zx, p["conv_w"], p["conv_b"], p["dt_bias"], p["A_log"])
    errs = {}
    for reverse in (False, True):
        outs = mamba_conv(*cargs, reverse=reverse)
        torch.cuda.synchronize()
        errs[("conv", reverse)] = compare_mixer(
            f"mamba_conv {tag} {leg} (B={bsz}, L={l}, reverse {reverse})", outs,
            mamba_conv_plain(*cargs, reverse=reverse))
        gargs = (y, outs[4], zx, p["D"], p["norm_w"])
        got = mamba_gate_norm(*gargs, reverse=reverse)
        torch.cuda.synchronize()
        errs[("gate", reverse)] = compare_mixer(
            f"mamba_gate_norm {tag} {leg} (B={bsz}, L={l}, reverse {reverse})", [got],
            [mamba_gate_norm_plain(*gargs, reverse=reverse)])
        del outs, got
    x = mamba_conv(*cargs)[4]
    gargs = (y, x, zx, p["D"], p["norm_w"])
    torch_conv, torch_gate = mixer_torch_sequence(p, zx, y)
    conv_bytes, gate_bytes = mixer_bytes(bsz, l, 512, 128, 8, dtype)
    rows, fn_name = [], {"conv": "mamba_conv", "gate": "mamba_gate_norm"}
    for key, fn, plain, library, nbytes in (
            ("MC", lambda: mamba_conv(*cargs), lambda: mamba_conv_plain(*cargs), torch_conv,
             conv_bytes),
            ("MG", lambda: mamba_gate_norm(*gargs), lambda: mamba_gate_norm_plain(*gargs),
             torch_gate, gate_bytes)):
        step = "conv" if key == "MC" else "gate"
        rows.append(dict(
            name=f"{fn_name[step]} {tag} ({leg}, B={bsz}, L={l}, d_inner 512, state 128, "
                 "8 heads)",
            route="cuda", source="sesa_tpu_torch/csrc/mamba_mixer.cu",
            replaces="none (XLA glue of sesa_tpu/models/bs_mamba2.py:79 mamba2_apply)",
            max_abs_err=max(errs[step, False], errs[step, True]),
            ms=time_ms(fn, reps=20, warmup=3), plain_ms=time_ms(plain, reps=5, warmup=1),
            library_ms=time_ms(library, reps=5, warmup=1), **_bound(0, nbytes),
            kernel=key if dtype == torch.bfloat16 else f"{key}f32"))
    del p, zx, y, x
    torch.cuda.empty_cache()
    return rows


def mixer_small(gen, dev):
    """The mixer's kernels at small shapes against their plain versions:
    d_model 32 and 64 (rows of zxbcdt too narrow for 16-byte loads in bf16,
    the value-by-value path), 256 (four 8-column groups a lane in the gate),
    one step, lengths that are and are not whole chunks, both directions,
    f32 and bf16."""
    import torch

    from sesa_tpu_torch.ops.mamba import (mamba_conv, mamba_conv_plain, mamba_gate_norm,
                                          mamba_gate_norm_plain)

    for d_model, bsz, l in ((32, 3, 1), (32, 2, 70), (64, 5, 57), (128, 3, 130),
                            (256, 2, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            p, zx, y = mixer_inputs(gen, d_model, bsz, l, dtype, dev)
            cargs = (zx, p["conv_w"], p["conv_b"], p["dt_bias"], p["A_log"])
            for reverse in (False, True):
                outs = mamba_conv(*cargs, reverse=reverse)
                compare_mixer(f"mamba_conv small {dtype} (d_model {d_model}, B={bsz}, L={l}, "
                              f"reverse {reverse})", outs,
                              mamba_conv_plain(*cargs, reverse=reverse))
                gargs = (y, outs[4], zx, p["D"], p["norm_w"])
                compare_mixer(f"mamba_gate_norm small {dtype} (d_model {d_model}, B={bsz}, "
                              f"L={l}, reverse {reverse})",
                              [mamba_gate_norm(*gargs, reverse=reverse)],
                              [mamba_gate_norm_plain(*gargs, reverse=reverse)])
    torch.cuda.synchronize()


def mixer_model_call(dev):
    """One bs_mamba2 model call of BATCH chunks at MAMBA_MODEL in bf16 with
    the kernels against the same call with their plain versions
    (model_parity): each mixer kernel and K8 launched 48 times (12 BSNets x
    2 ResMambas x 2 directions)."""
    import torch

    from sesa_tpu_torch.configs import AttrDict
    from sesa_tpu_torch.models import bs_mamba2

    cfg = AttrDict({"model": MAMBA_MODEL})
    params = tree_to_cuda(bs_mamba2.init(torch.Generator().manual_seed(0), cfg))
    res = model_parity("bs_mamba2", params, cfg, _song(SONG_S), with_f32=False)
    bsnets = MAMBA_MODEL["num_repeat_mask"] + MAMBA_MODEL["num_repeat_map"]
    if res["launches"] != _mamba_launches(4 * bsnets):
        raise RuntimeError(f"bs_mamba2 model call: launches {res['launches']}, expected "
                           f"{_mamba_launches(4 * bsnets)}")
    return res


def width_rows(gen, dev, want):
    """The kernels at the widths their cores run padded or that widened them,
    each against its plain version at a model path's shape: K1 at 4 heads x
    128, 16 x 32 and 8 x 96 (padded to 128) on the flagship's legs and at 8
    x 48 on the mel-band roformer's (d 384); K3 at D 48 and 96 (BH 2976 x S
    690, strided views as the four-stream roformer hands them over); K4 at 8
    x 48, 12 x 32 and 3 x 128 on the mel-band conformer's legs; K6 at d 512,
    768, 896 and 1024 on Apollo's shape (b 320 x n 1901, k 7). Each row is
    timed beside the plain version and the library composite, its bound
    counts the real widths; then the small shapes."""
    import torch

    from sesa_tpu_torch.ops.attention import vmem_attention, vmem_attention_plain
    from sesa_tpu_torch.ops.convblock import fused_apollo_conv, fused_apollo_conv_plain

    rows = []
    zero = torch.zeros((), device=dev)
    if want("K1"):
        flagship_legs = (("time", BATCH * BANDS, FRAMES), ("freq", BATCH * FRAMES, BANDS))
        for key, d, heads, dh, legs in (
                ("K1dh128", FLAGSHIP_MODEL["dim"], 4, 128, flagship_legs),
                ("K1dh48", MELBAND_MODEL["dim"], 8, 48,
                 (("time", BATCH * MEL_BANDS, FRAMES), ("freq", BATCH * FRAMES, MEL_BANDS))),
                ("K1dh32", FLAGSHIP_MODEL["dim"], 16, 32, flagship_legs),
                ("K1dh96", FLAGSHIP_MODEL["dim"], 8, 96, flagship_legs)):
            for leg, b, n in legs:
                args, rope = _k1_args(gen, b, n, d, heads, dh, dh, dev)
                rows.append(_k1_row(args, rope, f"{heads} x {dh}, d={d}, {leg} leg", key))
                del args, rope
                torch.cuda.empty_cache()
    if want("K3"):
        for dh in (48, 96):
            q, k, v = _k3_views(gen, dev, BATCH * BANDS, FRAMES, 8, dh)
            rows.append(_k3_row(q, k, v, f"K3dh{dh}"))
            del q, k, v
            torch.cuda.empty_cache()
        for bh, s_len, dh in K3_WIDTHS_SMALL:
            q, k, v = (torch.randn((bh, s_len, dh), generator=gen).to(dev, torch.bfloat16)
                       for _ in range(3))
            compare(f"K3 small (BH={bh}, S={s_len}, D={dh})", vmem_attention(q, k, v, dh ** -0.5),
                    vmem_attention_plain(q, k, v, dh ** -0.5), zero)
        torch.cuda.synchronize()
    if want("K4"):
        d, max_pos = MELCONF_MODEL["dim"], 512
        for heads, dh in ((8, 48), (12, 32), (3, 128)):
            for leg, b, n in (("time", BATCH * MEL_BANDS, FRAMES),
                              ("freq", BATCH * FRAMES, MEL_BANDS)):
                args = _k4_args(gen, b, n, d, heads, dh, max_pos, dev)
                rows.append(_k4_row(args, f"{heads} x {dh}, {leg} leg", f"K4dh{dh}"))
                del args
                torch.cuda.empty_cache()
    if want("K6"):
        b, n = APOLLO_BPRIME * APOLLO_BANDS, APOLLO_FRAMES
        for d in (512, 768, 896, 1024):
            rows.append(_k6_row(gen, dev, b, n, d, 7, f"K6d{d}"))
            torch.cuda.empty_cache()
        for b, n, d, k in K6_WIDTHS_SMALL:
            p = _apollo_conv_params(gen, d, k, dev)
            x = (0.5 * torch.randn((b, n, d), generator=gen)).to(dev, torch.bfloat16)
            compare(f"K6 small (b={b}, n={n}, d={d}, k={k})", fused_apollo_conv(x, p),
                    fused_apollo_conv_plain(x, p), x)
        torch.cuda.synchronize()
    return rows


def phase_kernels(only=None):
    """Each kernel's rows (all, or the kernels in ``only``, e.g. {"K2", "K3"})."""
    import torch

    import torch.nn.functional as F

    from sesa_tpu_torch.ops.attention import (fused_attention_block, fused_attention_block_plain,
                                              fused_conformer_attention,
                                              fused_conformer_attention_plain, k4_plan,
                                              fused_rope_attention, fused_rope_attention_plain,
                                              vmem_attention, vmem_attention_plain)
    from sesa_tpu_torch.ops.convblock import (fused_apollo_conv, fused_apollo_conv_plain,
                                              fused_conformer_conv, fused_conformer_conv_plain)
    from sesa_tpu_torch.ops.ff import fused_ff_residual, fused_ff_residual_plain
    from sesa_tpu_torch.ops.rope import default_freqs, rope_tables
    from sesa_tpu_torch.ops.ssd import ssd_fused, ssd_fused_plain, ssd_plain

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
            rows.append(_k1_row(args, rope, f"{leg} leg", "K1"))
            tokens = b * n
            flops = 2 * tokens * d * (3 * hd + heads + hd) + 4 * b * heads * n * n * dh
            nbytes = 2 * (2 * tokens * d + (3 * hd + heads + hd) * d + heads + d + 2 * n * dh)

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

        # K1 at scnet_tran's shapes, both legs of its two widths: d 128 (even
        # dual-path layers, 346 frames) and d 256 (odd layers, 174 frames after
        # the frame rFFT), 8 heads x 64 (heads x dim_head 512 > d), full rope.
        # The freq legs (57 bands) take the core's n <= 64 route, the time
        # legs the other
        for d, t in ((SCNET_DIM, SCNET_FRAMES), (2 * SCNET_DIM, SCNET_RFFT_FRAMES)):
            for leg, b, n in (("time", BATCH * SCNET_BANDS, t), ("freq", BATCH * t, SCNET_BANDS)):
                args, rope = _k1_args(gen, b, n, d, 8, 64, 64, dev)
                rows.append(_k1_row(args, rope, f"scnet_tran d={d} {leg} leg", "K1scnet"))
                del args, rope
        torch.cuda.empty_cache()

    if want("K2"):
        # K2, both forms: roformer at the flagship shape, conformer at the mel
        # one; the roformer form again at scnet_tran's two widths (every leg
        # of one width has the same tokens: batch x bands x frames)
        for form, tokens, d, key in (
                ("rms", TOKENS, FLAGSHIP_MODEL["dim"], "K2"),
                ("ln", MEL_TOKENS, MELCONF_MODEL["dim"], "K2ln"),
                ("rms", BATCH * SCNET_BANDS * SCNET_FRAMES, SCNET_DIM, "K2scnet"),
                ("rms", BATCH * SCNET_BANDS * SCNET_RFFT_FRAMES, 2 * SCNET_DIM, "K2scnet")):
            hidden = 4 * d
            x = torch.randn((tokens, d), generator=gen).to(dev, torch.bfloat16)
            w1, b1 = _weights(gen, (hidden, d), d, dev), _weights(gen, (hidden,), d, dev)
            w2, b2 = _weights(gen, (d, hidden), hidden, dev), _weights(gen, (d,), hidden, dev)
            args = (x, _near_one(gen, d, dev), w1, b1, w2, b2)
            if form == "rms":
                kw, lib, label = {}, lambda: k2_library(*args), "rms/GELU"
            else:
                beta = _weights(gen, d, 100, dev)
                kw = dict(beta=beta, norm="ln", act="swish", out_scale=0.5)
                lib, label = lambda: k2ln_library(*args, beta), "ln/SiLU/0.5"
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
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        d, heads, dh, max_pos, k = MELCONF_MODEL["dim"], 8, 64, 512, 31
        e = 2 * d
        conv_p = _conv_params(gen, d, e, k, dev)
        for leg, b, n in (("time", BATCH * MEL_BANDS, FRAMES), ("freq", BATCH * FRAMES, MEL_BANDS)):
            args = _k4_args(gen, b, n, d, heads, dh, max_pos, dev)
            x, tokens = args[0], b * n
            rows.append(_k4_row(args, f"{leg} leg", "K4"))
            log(f"  K4 {leg} leg core route: {k4_plan(b, n, d, heads, dh, sms)['core']['route']}")
            torch.cuda.empty_cache()

            rows.append(_k5_row(x, conv_p, leg, "K5"))
            # past 32 taps: two, three and five register blocks
            for taps in K5_TAPS:
                rows.append(_k5_row(x, _conv_params(gen, d, e, taps, dev), leg, f"K5k{taps}"))
                torch.cuda.empty_cache()
            del args, x
            torch.cuda.empty_cache()

        # K4 and K5 at small ragged shapes: both core routes (n 64 and 65, and
        # dim_head 128 on the mma route at any n), the three head widths,
        # clipping of the Shaw distances (P below n) and none (P above n), one
        # and several key tiles, a short sequence; the conv kernel short, even
        # (8 and 32) and at its main size, sequences of one row, of one tile
        # and of several tiles
        for b, n, d, heads, dh, max_pos in K4_SMALL:
            args = _k4_args(gen, b, n, d, heads, dh, max_pos, dev)
            route = k4_plan(b, n, d, heads, dh, sms)["core"]["route"]
            compare(f"K4 small, {route} route (b={b}, n={n}, d={d}, {heads}x{dh}, P={max_pos})",
                    fused_conformer_attention(*args), fused_conformer_attention_plain(*args),
                    args[0])
        for b, n, d, k in K5_SMALL:
            p = _conv_params(gen, d, 2 * d, k, dev)
            x = (0.5 * torch.randn((b, n, d), generator=gen)).to(dev, torch.bfloat16)
            compare(f"K5 small (b={b}, n={n}, d={d}, k={k})", fused_conformer_conv(x, p),
                    fused_conformer_conv_plain(x, p), x)
        torch.cuda.synchronize()

    if want("K6"):
        # K6 at Apollo's shape: 4 x 80 band sequences of 1901 frames, d 256, k 7
        rows.append(_k6_row(gen, dev, APOLLO_BPRIME * APOLLO_BANDS, APOLLO_FRAMES,
                            APOLLO_MODEL["feature_dim"], 7, "K6"))
        torch.cuda.empty_cache()

    if want("K7"):
        # K7 at Apollo's shape: 4 x 1901 frame sequences of 80 bands, 8 heads x 32
        b, n, heads = APOLLO_BPRIME * APOLLO_FRAMES, APOLLO_BANDS, 8
        dh = APOLLO_MODEL["feature_dim"] // heads
        rows.append(_k7_row(gen, dev, b, n, heads, dh, dh, "K7"))
        # the other head widths at Apollo's shape, with Apollo's rope
        for dh in K7_WIDTHS:
            rows.append(_k7_row(gen, dev, b, n, heads, dh, 2 * (dh // 2), f"K7dh{dh}"))

    # K6 and K7 at small ragged shapes: short and long sequences against the
    # 64-row tile, a 3-tap kernel; K7 at K7_SMALL
    if want("K6"):
        for n, k in ((62, 7), (100, 3), (257, 7)):
            p = _apollo_conv_params(gen, 128, k, dev)
            x = (0.5 * torch.randn((3, n, 128), generator=gen)).to(dev, torch.bfloat16)
            compare(f"K6 small (b=3, n={n}, d=128, k={k})", fused_apollo_conv(x, p),
                    fused_apollo_conv_plain(x, p), x)
    if want("K7"):
        for b, n, heads, dh, rot in K7_SMALL:
            args = _k7_args(gen, b, n, heads, dh, rot, dev)
            compare(f"K7 small (b={b}, n={n}, {heads}x{dh}, rope {rot}, plan "
                    f"{_k7_plan_line(b, n, heads, dh, rot)})",
                    fused_rope_attention(*args), fused_rope_attention_plain(*args), zero)
    torch.cuda.synchronize()

    if want("K3"):
        # K3 at the hyper-connection time leg, as attention_apply hands it over:
        # permuted views of the qkv projection, q and k through rope
        heads, dh = FLAGSHIP_MODEL["heads"], FLAGSHIP_MODEL["dim_head"]
        q, k, v = _k3_views(gen, dev, BATCH * BANDS, FRAMES, heads, dh)
        rows.append(_k3_row(q, k, v, "K3"))
        # the same on contiguous copies, to tell the cost of the strides
        scale = dh ** -0.5
        qc, kc, vc = (t.contiguous() for t in (q, k, v))
        rows[-1].update(contiguous_ms=time_ms(lambda: vmem_attention(qc, kc, vc, scale)),
                        copies_ms=time_ms(lambda: [t.contiguous() for t in (q, k, v)]))
        log(f"  K3 on contiguous (b, h, s, d) copies: {rows[-1]['contiguous_ms']:.3f} ms; "
            f"the three copies: {rows[-1]['copies_ms']:.3f} ms")
        del q, k, v, qc, kc, vc
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
            for dtype, key in ((torch.bfloat16, "K8"), (torch.float32, "K8f32")):
                rows.append(_k8_row(gen, dev, leg, bsz, l, MAMBA_HEADS, 64, 128, 64, dtype, key))
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
        # the (P, N, chunk) beside (64, 128, 64) that the JAX gate fuses
        band_rnn, band_comm = K8_LEGS
        for dtype in (torch.bfloat16, torch.float32):
            for h, p, n, chunk in K8_SIZES:
                rows.append(_k8_row(gen, dev, *band_rnn, h, p, n, chunk, dtype))
            rows.append(_k8_row(gen, dev, *band_comm, MAMBA_HEADS, 64, 128, K8_COMM_CHUNK, dtype))
        # small shapes of them: L padded (72 at chunk 8, 176 at 176), P 72 and
        # 16, three slices of N, one chunk at chunk 32, a state carried across
        # padded heads
        for bsz, l, h, p, n, chunk in ((3, 72, 4, 8, 128, 8), (2, 176, 2, 64, 128, 176),
                                       (2, 128, 3, 72, 384, 32), (5, 64, 3, 16, 256, 32),
                                       (2, 192, 2, 128, 256, 64), (7, 32, 8, 24, 128, 8)):
            for dtype in (torch.float32, torch.bfloat16):
                args = ssd_inputs(gen, bsz, l, h, dtype, dev, p=p, n=n)
                compare_ssd(f"K8 small {dtype} (B={bsz}, L={l}, H={h}, P={p}, N={n}, "
                            f"chunk {chunk})", ssd_fused(*args, chunk_size=chunk),
                            ssd_fused_plain(*args, chunk_size=chunk))
        torch.cuda.synchronize()

    if want("MX"):
        # the Mamba mixer's kernels at bs_mamba2's two legs, bf16 (the
        # session's path) and f32 (the rescue's), both directions; small
        # shapes; then one model call: 48 launches of each
        mix_gen = torch.Generator(device=dev).manual_seed(13)
        for leg, bsz, l in MIXER_LEGS:
            for dtype in (torch.bfloat16, torch.float32):
                rows += _mixer_rows(mix_gen, dev, leg, bsz, l, dtype)
        mixer_small(mix_gen, dev)
        mixer_model_call(dev)

    if want("I8"):
        # I8 at the flagship's legs (time: 372 x 8 sequences of 690 frames;
        # freq: 4140 x 8 of 62 bands), on the views the roformer hands it
        heads, dh = FLAGSHIP_MODEL["heads"], FLAGSHIP_MODEL["dim_head"]
        for leg, b, n in (("time", BATCH * BANDS, FRAMES), ("freq", BATCH * FRAMES, BANDS)):
            q, k, v = _k3_views(gen, dev, b, n, heads, dh)
            rows.append(_i8_row(q, k, v, leg))
            del q, k, v
        i8_small(gen, dev)
        torch.cuda.synchronize()

    rows += width_rows(gen, dev, want)
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


def _model_calls(chunk=CHUNK, batch=BATCH, demucs_mode=False):
    """Model calls for one SONG_S song: chunks of the padded song / batch
    (demucs mode pads no border)."""
    length = SONG_S * SR + (0 if demucs_mode else 2 * (chunk - chunk // OVERLAP))
    return -(-(-(-length // (chunk // OVERLAP))) // batch)


def drive_cli(work, model_type, model_cfg, song, expected, chunk=CHUNK, batch=BATCH,
              stem="vocals", instruments=None, k1_modes=None, compute_dtype="bf16",
              sections=None):
    """Separate ``song`` through cli.main; check the stem written, the rescues
    and the launch counts (counters set to 0 just before, read just after);
    time a second, warm separation on the session. ``stem="vocals"`` writes a
    vocals/other config; another name leaves the training section out (the
    model then gives one stem, "restored"). ``instruments`` names the stems
    of a model that gives several. ``k1_modes`` is K1's expected count by
    mode; K8's launches must all be of ``compute_dtype``. ``sections`` adds
    config sections (ConformerMSS reads ``stft``)."""
    import numpy as np
    import torch

    from sesa_tpu_torch import cli
    from sesa_tpu_torch.audio_io import read_audio, write_audio

    os.makedirs(os.path.join(work, "in"))
    write_audio(os.path.join(work, "in", "song.wav"), song, SR)
    cfg = {"audio": {"chunk_size": chunk, "num_channels": 2, "sample_rate": SR},
           "model": model_cfg,
           "inference": {"num_overlap": OVERLAP, "batch_size": batch, "normalize": False},
           **(sections or {})}
    if instruments:
        cfg["training"] = dict(cfg.get("training", {}), instruments=list(instruments))
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
    res = dict(model_type=model_type, song_s=SONG_S,
               model_calls=_model_calls(chunk, batch, session.spec.demucs_mode),
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
    return {"apollo": (APOLLO_CHUNK, APOLLO_BATCH), "mdx23c": (MDX_CHUNK, MDX_BATCH),
            "experimental_mdx23c_stht": (MDX_CHUNK, MDX_BATCH),
            "htdemucs": (DEMUCS_CHUNK, DEMUCS_BATCH),
            "segm_models": (SEGM_CHUNK, SEGM_BATCH),
            "swin_upernet": (SEGM_CHUNK, SEGM_BATCH)}.get(model_type, (CHUNK, BATCH))


def _plain_swaps(model_type):
    """(module, attribute, plain version) for every kernel the model reaches."""
    from sesa_tpu_torch.models import apollo, bs_mamba2, conformer_core, roformer_core
    from sesa_tpu_torch.ops import attention as attention_ops
    from sesa_tpu_torch.ops import mamba as mamba_ops
    from sesa_tpu_torch.ops import ssd as ssd_ops
    from sesa_tpu_torch.ops.attention import (fused_attention_block_plain,
                                              fused_conformer_attention_plain,
                                              fused_rope_attention_plain)
    from sesa_tpu_torch.ops.convblock import (fused_apollo_conv_plain,
                                              fused_conformer_conv_plain)
    from sesa_tpu_torch.ops.ff import fused_ff_residual_plain

    if model_type.startswith("bs_mamba2"):  # ssd() looks ssd_fused up in its module
        return [(ssd_ops, "ssd_fused", ssd_ops.ssd_fused_plain),
                (bs_mamba2, "mamba_conv", mamba_ops.mamba_conv_plain),
                (bs_mamba2, "mamba_gate_norm", mamba_ops.mamba_gate_norm_plain)]
    if model_type.startswith("bs_roformer_experimental_hc"):  # so does sdpa() with K3
        return [(attention_ops, "vmem_attention", attention_ops.vmem_attention_plain)]
    if model_type.startswith("apollo"):
        return [(apollo, "fused_rope_attention", fused_rope_attention_plain),
                (apollo, "fused_apollo_conv", fused_apollo_conv_plain)]
    if model_type.startswith("mel_band_conformer"):
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
        k1_modes = list(counters()["K1"].launches_by_mode)
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
               k1_launches_by_mode=k1_modes, snr_kernel_vs_plain_db=snr_db(kern, plain),
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


# op rows whose device time the profile reports by group: cuFFT's transforms
# (STFT, iSTFT, the frame rFFTs)
PROFILE_OPS = {"aten::_fft_r2c": "fft", "aten::_fft_c2r": "fft", "aten::_fft_c2c": "fft"}
# functions that are many ops or kernels each: during the traced call each
# runs inside a record_function scope of its group, whose time on the
# device's timeline the profile reports (cuDNN's LSTM with its weight
# compaction, cuDNN's convolutions with their layout conversions, the norms'
# f32 statistics, htdemucs's and MaxViT's attention, the bandits' per-band
# loops of band split and mask heads). An op row's device time total is no
# measure for these: it counted cuDNN's convolutions twice, and gave
# bandit_v2's LSTM 75.7 s in a model call of 1.07 s busy
PROFILE_SCOPES = {"lstm": (("sesa_tpu_torch.models.layers", "_lstm"),),
                  "bands": (("sesa_tpu_torch.models.bandit_v2", "band_split"),
                            ("sesa_tpu_torch.models.bandit_v2", "mask_head")),
                  "conv": (("torch.nn.functional", "conv1d"), ("torch.nn.functional", "conv2d"),
                           ("torch.nn.functional", "conv_transpose1d"),
                           ("torch.nn.functional", "conv_transpose2d")),
                  "norm": (("sesa_tpu_torch.models.layers", "instance_norm2d"),
                           ("sesa_tpu_torch.models.layers", "batch_norm2d"),
                           ("sesa_tpu_torch.models.layers", "group_norm"),
                           ("sesa_tpu_torch.models.layers", "layer_norm")),
                  "attention": (("sesa_tpu_torch.models.htdemucs", "_mha"),
                                ("sesa_tpu_torch.models.maxvit_unet", "_partition_attn"))}
# swin_upernet's own groups. On the device's timeline a kernel counts in its
# innermost scope only (under the conv and norm groups above, the head's
# conv modules read 0.16 ms a call on an H100: their ReLUs alone), so here
# the head's conv modules are one group with their convolutions and
# BatchNorms inside; the MLP and patch-merging groups hold their products
# and GELU, and their LayerNorms count under layer_norm
SWIN_PROFILE_SCOPES = {
    "window_attention": (("sesa_tpu_torch.models.swin_upernet", "_window_attention"),),
    "mlp": (("sesa_tpu_torch.models.swin_upernet", "_mlp"),),
    "patch_merge": (("sesa_tpu_torch.models.swin_upernet", "_patch_merge"),),
    "layer_norm": (("sesa_tpu_torch.models.swin_upernet", "_layer_norm"),),
    "head_conv_modules": (("sesa_tpu_torch.models.swin_upernet", "_conv_module"),),
    "resize": (("sesa_tpu_torch.models.swin_upernet", "_resize"),)}


def _scoped(group, fn):
    import functools

    import torch

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with torch.profiler.record_function(f"scope::{group}"):
            return fn(*args, **kwargs)
    return run


def _union_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, run_start, run_end = 0, None, None
    for start, end in sorted(intervals):
        if run_end is None or start > run_end:
            total += 0 if run_end is None else run_end - run_start
            run_start, run_end = start, end
        else:
            run_end = max(run_end, end)
    return total + (0 if run_end is None else run_end - run_start)


def phase_profile(model_type, session, song, label=None, scopes=None):
    """Device time by kernel over one warm model call (torch.profiler). The
    idle share is read from that one traced call: 1 - (time some kernel runs)
    / (first kernel's start to last kernel's end), all on the device's clock;
    busy time sums the kernels, so it exceeds the span where they overlap. The
    profiler slows the host, so it is an upper estimate. The host wall of the
    same call without the profiler is printed beside it. A model whose apply
    takes no compute_dtype runs as the session runs it, in f32. ``scopes``
    replaces PROFILE_SCOPES."""
    import inspect

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sesa_tpu_torch.models import get_model

    model = get_model(model_type)
    chunk, batch = _chunking(model_type)
    model_type = label or model_type
    chunks = _chunks(song, chunk, batch)
    # the weights and dtype as the session's separate hands them to the model
    params = session._prepared.get(torch.bfloat16, session.params)
    kw = ({"compute_dtype": torch.bfloat16}
          if "compute_dtype" in inspect.signature(model.apply).parameters else {})
    import importlib

    scoped = [(importlib.import_module(m), name, group)
              for group, fns in (scopes or PROFILE_SCOPES).items() for m, name in fns]
    with torch.inference_mode():
        walls = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):  # the first call warms up; the wall is the best of the next two
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.apply(params, session.config, chunks, **kw)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        peak = torch.cuda.max_memory_allocated()
        saved = [getattr(m, name) for m, name, _ in scoped]
        for m, name, group in scoped:
            setattr(m, name, _scoped(group, getattr(m, name)))
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                model.apply(params, session.config, chunks, **kw)
                torch.cuda.synchronize()
        finally:
            for (m, name, _), fn in zip(scoped, saved):
                setattr(m, name, fn)
    # kernel events only: an aten op's device time is its kernels' time again
    # a scope leaves a range on the device's timeline as well (a user
    # annotation of device type CUDA): its device time is the scopes' time
    # there, and it is no kernel, so it stays out of the kernel rows and spans
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if e.device_type == DeviceType.CUDA and dev_us > 0 and not e.key.startswith("scope::"):
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    # the retired cp.async GEMM must not run on any path
    stale = [r[2] for r in rows if "gemm_nt_kernel" in r[2]]
    if stale:
        raise RuntimeError(f"profile {model_type}: retired kernel launched: {stale}")
    # a scope group's time: the union of its ranges on the device's timeline
    # (cuDNN's bidirectional LSTM leaves a range on each of its two streams)
    scopes = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.name.startswith("scope::"):
            scopes.setdefault(e.name[len("scope::"):], []).append(
                (e.time_range.start, e.time_range.end))
    op_ms = {group: _union_us(ranges) / 1e3 for group, ranges in scopes.items()}
    # an op row's device time total covers every kernel it launched
    for e in prof.key_averages():
        group = PROFILE_OPS.get(e.key)
        if group is not None and e.device_type == DeviceType.CPU:
            dev_us = getattr(e, "device_time_total", None)
            if dev_us is None:
                dev_us = getattr(e, "cuda_time_total", 0)
            op_ms[group] = op_ms.get(group, 0.0) + dev_us / 1e3
    busy, wall = sum(r[0] for r in rows), min(walls[1:])
    launches = sum(r[1] for r in rows)
    sesa = sum(r[0] for r in rows if r[2].startswith(("sesa::", "void sesa::")))
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start
             and not e.name.startswith("scope::")]
    if not spans:
        raise RuntimeError(f"profile {model_type}: the trace holds no device kernel")
    span = (max(end for _, end in spans) - min(start for start, _ in spans)) / 1e3
    # the time some kernel runs: the union of the kernels' intervals (cuDNN's
    # bidirectional LSTM runs its two directions on two streams at once)
    covered = _union_us(spans) / 1e3
    idle = 1 - covered / span
    log(f"[profile {model_type}] one model call ({batch} chunks): device busy {busy:.1f} ms "
        f"({sesa:.1f} ms in the port's kernels) of a traced span of {span:.1f} ms, idle share "
        f"{idle:.3f}; {launches} kernel launches; host wall without the profiler {wall:.1f} ms; "
        f"peak CUDA memory {peak / 2 ** 30:.2f} GiB")
    if op_ms:
        log("  device time by op: " + ", ".join(f"{k} {v:.2f} ms" for k, v in op_ms.items()))
    for ms, count, key in rows[:20]:
        log(f"  {ms:9.2f} ms  {count:5d}x  {key[:90]}")
    return dict(wall_ms=wall, device_busy_ms=busy, device_covered_ms=covered, sesa_kernels_ms=sesa,
                op_device_ms=op_ms, traced_span_ms=span, idle_share=idle, kernel_launches=launches,
                peak_cuda_mem_gib=peak / 2 ** 30,
                top=[dict(ms=ms, count=c, kernel=k[:120]) for ms, c, k in rows[:30]])


def phase_chain(sessions, song, expected, first="bs_roformer", label="chain"):
    """The device-resident chain of bench.py's bench_ensemble_pipeline on the
    loaded sessions: two vocals separations (``first``'s and the mel-band
    conformer's) whose stems stay on the card -> avg_wave ensemble + phase
    fix against the mix -> Apollo restoration, one host copy at the end.
    ``sessions`` holds those three. The first run is checked (launch counts,
    rescues, shape, finiteness, and the device ensemble + phase fix against
    the host functions on the same stems); its phase fix and Apollo are
    queued once more under the sync debug mode; a second, warm run is
    timed."""
    import numpy as np
    import torch

    from sesa_tpu_torch.postprocess import (ensemble_phase_fix_device, ensemble_waveforms,
                                            phase_fix_arrays)
    from sesa_tpu_torch.runtime import demix_start

    def run():
        mix = torch.from_numpy(song).cuda()
        v1 = sessions[first].separate(mix, transport="device")["vocals"]
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
        raise RuntimeError(f"{label}: bad output: shape {out.shape}, "
                           f"finite {np.isfinite(out).all()}")
    if any(rescues.values()):
        raise RuntimeError(f"{label}: bf16 -> f32 rescues {rescues}")
    if launches != expected:
        raise RuntimeError(f"{label}: launches {launches}, expected {expected}")

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
    log(f"  {label}: device ensemble + phase fix vs host: {snr:.1f} dB over bins 8..1016, "
        f"{snr_full:.1f} dB full band, {close:.4f} of samples within 1e-4")
    if not snr >= CHAIN_FIX_SNR_FLOOR_DB:
        raise RuntimeError(f"{label}: device ensemble + phase fix is {snr:.1f} dB from the host "
                           f"functions, below {CHAIN_FIX_SNR_FLOOR_DB} dB")

    # the phase fix and Apollo's separation queued again under PyTorch's sync
    # debug mode, which raises on a synchronising call (.item(), a pageable
    # host-to-device copy): Apollo through demix_start on its session's
    # prepared weights, as the session's separate runs it but without its
    # rescue check (a read of the device); both against the run above
    restorer = sessions["apollo"]
    apply_fn = restorer._model_apply(restorer.compute_dtype)
    mix = torch.from_numpy(song).cuda()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fixed_q = ensemble_phase_fix_device(mix, [v1, v2], SR, "avg_wave")
        job = demix_start(apply_fn, restorer.params, fixed_q, restorer.spec, transport="device")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    restored_q = job.collect_device(stems=[0])[0].cpu()
    sync_err = dict(phase_fix=float((fixed_q - fixed).abs().max()) / float(fixed.abs().max()),
                    apollo=float((restored_q - torch.from_numpy(out)).abs().max())
                    / float(np.abs(out).max()))
    log(f"  {label}: phase fix and Apollo queued with no synchronising call; relative max "
        f"|err| against the run above {sync_err}")
    if not max(sync_err.values()) <= 1e-5:
        raise RuntimeError(f"{label}: the phase fix and Apollo under the sync debug mode are "
                           f"{sync_err} from the chain's run")
    del v1, v2, fixed, fixed_q, restored_q

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = dict(models=[first, "mel_band_conformer", "apollo"], launches=launches,
               rescues=rescues, chain_warm_s=wall, rtf_chain=SONG_S / wall,
               peak_cuda_mem_gib=peak / 2 ** 30, phase_fix_device_vs_host_snr_db=snr,
               phase_fix_full_band_snr_db=snr_full, phase_fix_share_within_1e_4=close,
               sync_free_rel_err=sync_err)
    log(f"[{label}] {json.dumps(res)}")
    return res


def phase_jobs(sessions, song, expected):
    """demix's job API on the loaded flagship and mel-band conformer sessions:
    one upload_mix of the song, both models' demix_start back to back (the
    compute stream must still be busy when the second returns: dispatch
    does not wait for the card: no synchronising call under PyTorch's sync
    debug mode, the card still busy when it returns), collect_device(stems=) into
    ensemble_phase_fix_device against the same chain through demix; then an
    int16 job within max / 32767 of the exact stems and an f32 job's collect
    bit-equal to demix."""
    import numpy as np
    import torch

    from sesa_tpu_torch.postprocess import ensemble_phase_fix_device
    from sesa_tpu_torch.runtime import demix, demix_start, upload_mix

    fl, mc = sessions["bs_roformer"], sessions["mel_band_conformer"]
    fns = [(s._model_apply(s.compute_dtype), s) for s in (fl, mc)]
    # a spin queued ahead of the jobs keeps the card busy past a dispatch that
    # does not wait for it; PyTorch's sync debug mode raises on the
    # synchronising calls it knows (.item(), pageable copies, torch.istft's
    # window check) made while dispatching. A dispatch may still block once
    # the launch queue is full: that is the queue's depth, not a wait
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(JOBS_SPIN_CYCLES)
    end.record()
    torch.cuda.synchronize()
    spin_s = start.elapsed_time(end) / 1e3
    reset_counts()
    torch.cuda._sleep(JOBS_SPIN_CYCLES)
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        mix_dev = upload_mix(song)
        jobs = [demix_start(fn, s.params, mix_dev, s.spec, transport="device") for fn, s in fns]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    dispatch_s = time.perf_counter() - t0
    busy = not torch.cuda.current_stream().query()
    fixed = ensemble_phase_fix_device(mix_dev, [j.collect_device(stems=[0])[0] for j in jobs],
                                      SR, "avg_wave")
    torch.cuda.synchronize()
    jobs_s = time.perf_counter() - t0
    launches = read_counts()
    mix = torch.from_numpy(song).cuda()
    ref = ensemble_phase_fix_device(
        mix, [demix(fn, s.params, mix, s.spec, transport="device", stems=[0])[0]
              for fn, s in fns], SR, "avg_wave")
    chain_err = float((fixed - ref).abs().max())
    fn = fns[0][0]
    exact = demix(fn, fl.params, song, fl.spec)
    q16 = demix_start(fn, fl.params, mix_dev, fl.spec, transport="int16").collect()
    int16_err, floor = float(np.abs(q16 - exact).max()), float(np.abs(exact).max()) / 32767
    f32_equal = bool(np.array_equal(demix_start(fn, fl.params, song, fl.spec).collect(), exact))
    res = dict(launches=launches, spin_s=spin_s, dispatch_s=dispatch_s,
               stream_busy_after_dispatch=busy,
               jobs_to_phase_fix_s=jobs_s, chain_vs_demix_max_abs_err=chain_err,
               chain_equal=chain_err == 0.0, int16_max_abs_err=int16_err,
               int16_floor=floor, f32_collect_equal=f32_equal, card=gpu_line())
    log(f"[jobs] {json.dumps(res)}")
    if launches != expected:
        raise RuntimeError(f"jobs: launches {launches}, expected {expected}")
    if not busy:
        raise RuntimeError(f"jobs: the card was idle when the second demix_start returned "
                           f"({dispatch_s:.3f} s behind a {spin_s:.3f} s spin)")
    if not chain_err <= 1e-5 * float(ref.abs().max()):
        raise RuntimeError(f"jobs: collect_device chain is {chain_err:.4g} from the demix chain")
    if not int16_err <= floor * 1.01 or not f32_equal:
        raise RuntimeError(f"jobs: int16 {int16_err:.4g} (floor {floor:.4g}), f32 collect "
                           f"equal {f32_equal}")
    return res


def phase_int8(song, calls, layers, bf16_session):
    """The flagship through cli.main with SESA_INT8_ATTN=1 (popped after):
    I8 in every attention layer, K1 refused, K2 on every feed-forward, no
    rescue; its stems against an f32 run of the same weights without int8
    (>= INT8_SNR_FLOOR_DB), printed beside the bf16 session's SNR, and its
    warm separation's seconds beside the bf16 session's, timed after it."""
    import numpy as np
    import torch

    from sesa_tpu_torch.runtime.session import InferenceSession

    os.environ["SESA_INT8_ATTN"] = "1"
    try:
        with tempfile.TemporaryDirectory() as work:
            res, session = drive_cli(work, "bs_roformer", FLAGSHIP_MODEL, song,
                                     expect(I8=layers * calls, K2=layers * calls),
                                     k1_modes=[0, 0, 0])
        int8 = session.separate(song)["vocals"]
    finally:
        os.environ.pop("SESA_INT8_ATTN", None)
    f32 = InferenceSession(session.model_type, session.config, session.params, session.spec,
                           session.device, compute_dtype=None).separate(song)["vocals"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bf16 = bf16_session.separate(song)["vocals"]
    torch.cuda.synchronize()
    bf16_warm = time.perf_counter() - t0
    int8, f32, bf16 = (torch.from_numpy(np.ascontiguousarray(a)) for a in (int8, f32, bf16))
    res.update(snr_int8_vs_f32_db=snr_db(int8, f32), snr_bf16_vs_f32_db=snr_db(bf16, f32),
               bf16_separate_warm_s=bf16_warm, bf16_rtf_warm=SONG_S / bf16_warm,
               finite=bool(torch.isfinite(int8).all()), card=gpu_line())
    log(f"  int8 flagship: {res['snr_int8_vs_f32_db']:.1f} dB against f32 "
        f"(bf16 without int8: {res['snr_bf16_vs_f32_db']:.1f} dB), I8 launches "
        f"{res['launches']['I8']}, K1 {res['launches']['K1']}; warm separation "
        f"{res['separate_warm_s']:.3f} s (rtf_warm {res['rtf_warm']:.1f}), bf16 without int8 "
        f"{bf16_warm:.3f} s (rtf_warm {SONG_S / bf16_warm:.1f})")
    if not res["snr_int8_vs_f32_db"] >= INT8_SNR_FLOOR_DB:
        raise RuntimeError(f"int8 flagship: {res['snr_int8_vs_f32_db']:.1f} dB against f32, "
                           f"below {INT8_SNR_FLOOR_DB}")
    return res


def phase_export():
    """mdx23c at bench.py's InstVocHQ widths (depth cut to one block a scale,
    EXPORT_MDX_MODEL: the trace's time follows the op count) exported in f32
    on the card (convert.export: torch.export with the parameter tree as an
    input), loaded, and one batch run on the card against the direct f32
    apply (within EXPORT_REL of max |apply|); bs_mamba2's export must raise
    naming the mixer's conv kernel."""
    import torch

    from sesa_tpu_torch.configs import AttrDict
    from sesa_tpu_torch.convert.export import export_model, load_exported
    from sesa_tpu_torch.models import bs_mamba2, mdx23c

    cfg = AttrDict({"audio": dict(MDX_AUDIO, chunk_size=MDX_CHUNK), "model": EXPORT_MDX_MODEL,
                    "training": {"instruments": MDX_STEMS, "target_instrument": None}})
    params = tree_to_cuda(mdx23c.init(torch.Generator().manual_seed(0), cfg))
    t0 = time.perf_counter()
    blob = export_model("mdx23c", cfg, params, chunk_size=MDX_CHUNK, batch_size=MDX_BATCH)
    export_s = time.perf_counter() - t0
    fn = load_exported(blob)
    x = (0.1 * torch.randn((MDX_BATCH, 2, MDX_CHUNK), generator=torch.Generator()
                           .manual_seed(3))).cuda()
    got = fn(params, x)
    with torch.inference_mode():
        ref = mdx23c.apply(params, cfg, x)
    torch.cuda.synchronize()
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    # bs_mamba2 at the reference's widths, one block a stage (the trace stops
    # at the first mixer): its f32 forward on the card reaches the mixer's
    # conv kernel, whose wrapper refuses the trace naming it
    # (ops._build.refuse_export)
    mcfg = AttrDict({"model": dict(MAMBA_MODEL, num_repeat_mask=1, num_repeat_map=1)})
    mparams = tree_to_cuda(bs_mamba2.init(torch.Generator().manual_seed(0), mcfg))
    before = read_counts()
    try:
        export_model("bs_mamba2", mcfg, mparams, chunk_size=CHUNK)
        refusal = ""
    except ValueError as e:
        refusal = str(e)
    if read_counts() != before:
        raise RuntimeError("export: a kernel launched during bs_mamba2's trace")
    del mparams
    res = dict(model_type="mdx23c", model=EXPORT_MDX_MODEL, batch=[MDX_BATCH, 2, MDX_CHUNK],
               bytes=len(blob),
               export_s=export_s, max_abs_err=err, ref_max=scale, equal=err == 0.0,
               bs_mamba2_refusal=refusal[:120], card=gpu_line())
    log(f"[export] {json.dumps(res)}")
    if not err <= EXPORT_REL * scale or "mamba_conv:" not in refusal:
        raise RuntimeError(f"export: {res}")
    del got, ref, params
    torch.cuda.empty_cache()
    return res


def istft_repeats():
    """istft_ri on the card gives the same bits on a repeat, both for a hop
    that divides n_fft (slice-adds) and one that does not (the folded
    overlap-add): a (16, 1025, 800) spectrum at n_fft 2048, hops 512 and
    441."""
    import torch

    from sesa_tpu_torch.ops.stft import hann_window, istft_ri

    gen = torch.Generator().manual_seed(9)
    spec = torch.randn((16, 1025, 800, 2), generator=gen).cuda()
    w = hann_window(2048).cuda()
    out = {}
    for hop in (512, 441):
        a, b = istft_ri(spec, 2048, hop, w), istft_ri(spec, 2048, hop, w)
        out[f"hop{hop}_equal"] = bool(torch.equal(a, b))
    log(f"[istft repeats] {json.dumps(out)}")
    if not all(out.values()):
        raise RuntimeError(f"istft repeats: {out}")
    return out


def tree_to_cuda(tree):
    from sesa_tpu_torch.tree import tree_map

    return tree_map(lambda t: t.cuda(), tree)


def phase_mesh(song, calls, layers):
    """parallel/ on one card: a world-size-1 NCCL group on 127.0.0.1,
    make_mesh(1), the flagship's demix(mesh) bit-equal to demix, a session
    created with the mesh (launches as the flagship's), one Trainer(mesh)
    step at the flagship's full width against Trainer()'s step from the
    same parameters and batch (SGD; loss within MESH_TRAIN_REL, every
    parameter within MESH_TRAIN_REL of its largest value), each trainer's
    first and second steps timed; the group is destroyed after."""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    from sesa_tpu_torch.parallel import make_mesh
    from sesa_tpu_torch.runtime import demix
    from sesa_tpu_torch.runtime.session import InferenceSession
    from sesa_tpu_torch.train import Trainer, _flatten

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1)
    out = {}
    try:
        mesh = make_mesh(1)
        out["mesh"] = dict(shape=list(mesh.mesh.shape), names=list(mesh.mesh_dim_names))
        with tempfile.TemporaryDirectory() as work:
            cfg_path = os.path.join(work, "config.json")
            with open(cfg_path, "w") as f:
                json.dump({"audio": {"chunk_size": CHUNK, "num_channels": 2, "sample_rate": SR},
                           "model": FLAGSHIP_MODEL,
                           "inference": {"num_overlap": OVERLAP, "batch_size": BATCH},
                           "training": {"instruments": ["vocals", "other"],
                                        "target_instrument": "vocals"}}, f)
            session = InferenceSession.create("bs_roformer", cfg_path, seed=0, mesh=mesh)
        fn = session._model_apply(session.compute_dtype)
        plain = demix(fn, session.params, song, session.spec)
        meshed = demix(fn, session.params, song, session.spec, mesh=mesh)
        reset_counts()
        stems = session.separate(song)["vocals"]
        torch.cuda.synchronize()
        launches = read_counts()
        out["demix_equal"] = bool(np.array_equal(plain, meshed))
        out["session"] = dict(launches=launches, equal_to_demix=bool(
            np.array_equal(stems, plain[0])), rescues=session.rescues)
        del session, fn
        torch.cuda.empty_cache()

        tcfg = {"model": FLAGSHIP_MODEL, "audio": {"chunk_size": TRAIN_CHUNK, "sample_rate": SR},
                "training": {"instruments": ["vocals", "other"], "target_instrument": "vocals"}}
        item = _train_item(TRAIN_CHUNK / SR)
        sgd = {"optimizer": {"name": "SGD", "kwargs": {"lr": 1e-3}}}
        steps = {}
        for label, kw in (("single", {}), ("mesh", {"mesh": mesh})):
            trainer = Trainer("bs_roformer", tcfg, optimizer=sgd, seed=0, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = trainer.train_batch(item)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            params = {k: (v.full_tensor() if hasattr(v, "full_tensor") else v).detach().clone()
                      for k, v in _flatten(trainer.params).items()}
            # a second step, warm: the first pays each trainer's set-up
            t0 = time.perf_counter()
            trainer.train_batch(item)
            torch.cuda.synchronize()
            steps[label] = (loss, params, ms, 1e3 * (time.perf_counter() - t0))
            del trainer
            torch.cuda.empty_cache()
        (l1, p1, ms1, warm1), (l2, p2, ms2, warm2) = steps["single"], steps["mesh"]
        rel = max(float((p1[k] - p2[k]).abs().max() / (p1[k].abs().max() + 1e-12)) for k in p1)
        out["trainer"] = dict(loss_single=l1, loss_mesh=l2, ms_single=ms1, ms_mesh=ms2,
                              warm_ms_single=warm1, warm_ms_mesh=warm2,
                              param_rel_err=rel, leaves=len(p1),
                              leaves_equal=sum(bool(torch.equal(p1[k], p2[k])) for k in p1))
        del steps, p1, p2
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    out["card"] = gpu_line()
    log(f"[mesh] {json.dumps(out)}")
    want = expect(K1=layers * calls, K2=layers * calls)
    tr = out["trainer"]
    if not out["demix_equal"] or not out["session"]["equal_to_demix"] \
            or out["session"]["launches"] != want or out["mesh"]["shape"] != [1, 1]:
        raise RuntimeError(f"mesh: {out}")
    if not abs(tr["loss_mesh"] - tr["loss_single"]) <= MESH_TRAIN_REL * abs(tr["loss_single"]) \
            or not tr["param_rel_err"] <= MESH_TRAIN_REL:
        raise RuntimeError(f"mesh trainer: {tr}")
    return out


# shapes off the main paths that exercise the per-kernel choices, depth 1
# each: (label, model type, model config)
GATE_PATHS = (("apollo_fd384", "apollo", dict(APOLLO_MODEL, feature_dim=384, layer=1)),
              ("apollo_fd768", "apollo", dict(APOLLO_MODEL, feature_dim=768, layer=1)),
              ("apollo_fd1024", "apollo", dict(APOLLO_MODEL, feature_dim=1024, layer=1)),
              ("mel_band_conformer_dh48", "mel_band_conformer",
               dict(MELCONF_MODEL, depth=1, dim_head=48)),
              ("mel_band_conformer_k33", "mel_band_conformer",
               dict(MELCONF_MODEL, depth=1, conv_kernel_size=33)),
              ("mel_band_conformer_k64", "mel_band_conformer",
               dict(MELCONF_MODEL, depth=1, conv_kernel_size=64)),
              ("mel_band_conformer_k65", "mel_band_conformer",
               dict(MELCONF_MODEL, depth=1, conv_kernel_size=65)),
              ("mel_band_conformer_k129", "mel_band_conformer",
               dict(MELCONF_MODEL, depth=1, conv_kernel_size=129)),
              ("apollo_fd128", "apollo", dict(APOLLO_MODEL, feature_dim=128, layer=1)),
              ("apollo_fd192", "apollo", dict(APOLLO_MODEL, feature_dim=192, layer=1)),
              ("apollo_fd200", "apollo", dict(APOLLO_MODEL, feature_dim=200, layer=1)),
              ("bs_roformer_experimental_hc_dh48", "bs_roformer_experimental",
               dict(HC_MODEL, depth=1, dim_head=48)),
              ("bs_roformer_experimental_hc_dh96", "bs_roformer_experimental",
               dict(HC_MODEL, depth=1, dim_head=96)),
              ("bs_roformer_dh32", "bs_roformer", dict(FLAGSHIP_MODEL, depth=1, heads=16,
                                                       dim_head=32)),
              ("bs_roformer_dh96", "bs_roformer", dict(FLAGSHIP_MODEL, depth=1, heads=8,
                                                       dim_head=96)),
              ("mel_band_conformer_dh32", "mel_band_conformer",
               dict(MELCONF_MODEL, depth=1, heads=12, dim_head=32)),
              ("mel_band_conformer_dh128", "mel_band_conformer",
               dict(MELCONF_MODEL, depth=1, heads=3, dim_head=128)),
              ("mel_band_conformer_k255", "mel_band_conformer",
               dict(MELCONF_MODEL, depth=1, conv_kernel_size=255)),
              ("apollo_fd512", "apollo", dict(APOLLO_MODEL, feature_dim=512, layer=1)),
              ("apollo_fd896", "apollo", dict(APOLLO_MODEL, feature_dim=896, layer=1)))
# the kernels each of them must take: Apollo at feature_dim 384, 512, 768, 896
# and 1024 both (K7 at dim_head 48, 64, 96, 112 and 128, K6 at d 384 to
# 1024), at 128 and 192 both (K7 at 8 x 16 and 8 x 24), at 200 K7 alone (8 x
# 25 on heads padded to 32, rope 24; K6 refuses d % 64); the conformer at
# dim_head 32, 48 and 128 all three (K4 at 12 x 32, on heads padded to 64, at
# 3 x 128), at 33, 64, 65, 129 and 255 taps all three (K5 in two, two, three,
# five and eight register blocks of taps); the four-stream roformer at
# dim_head 48 and 96 K3 on its time legs (690 frames; the freq legs' 62 bands
# are below K3's gate); the roformer at 16 x 32 and 8 x 96 (padded to 128)
# K1 and K2 on both legs
GATE_KERNELS = {"apollo_fd384": {"K6", "K7"}, "apollo_fd768": {"K6", "K7"},
                "apollo_fd1024": {"K6", "K7"}, "mel_band_conformer_dh48": {"K2", "K4", "K5"},
                "mel_band_conformer_k33": {"K2", "K4", "K5"},
                "mel_band_conformer_k64": {"K2", "K4", "K5"},
                "mel_band_conformer_k65": {"K2", "K4", "K5"},
                "mel_band_conformer_k129": {"K2", "K4", "K5"},
                "apollo_fd128": {"K6", "K7"}, "apollo_fd192": {"K6", "K7"},
                "apollo_fd200": {"K7"},
                "bs_roformer_experimental_hc_dh48": {"K3"},
                "bs_roformer_experimental_hc_dh96": {"K3"},
                "bs_roformer_dh32": {"K1", "K2"}, "bs_roformer_dh96": {"K1", "K2"},
                "mel_band_conformer_dh32": {"K2", "K4", "K5"},
                "mel_band_conformer_dh128": {"K2", "K4", "K5"},
                "mel_band_conformer_k255": {"K2", "K4", "K5"},
                "apollo_fd512": {"K6", "K7"}, "apollo_fd896": {"K6", "K7"}}
# the routes the host plans take for the entries that prove one, by leg
# (time, freq; Apollo's band layer alone): K1's core (``k1_plan``: the
# flash_wgmma tiles for n > 64, flash_core for n <= 64) and K4's
# (``k4_plan``: flash_shaw's tiles for n > 64 at 32 and 64, else mma.sync) at
# the core width, K5's register blocks of taps (``k5_plan``), K7's head width
# (``k7_plan``)
GATE_ROUTES = {"bs_roformer_dh32": ("K1 tiles at 32", "K1 short at 32"),
               "bs_roformer_dh96": ("K1 tiles at 128", "K1 short at 128"),
               "mel_band_conformer_dh32": ("K4 tiles at 32, K5 1 tap blocks",
                                           "K4 mma at 32, K5 1 tap blocks"),
               "mel_band_conformer_dh128": ("K4 mma at 128, K5 1 tap blocks",
                                            "K4 mma at 128, K5 1 tap blocks"),
               "mel_band_conformer_k255": ("K4 tiles at 64, K5 8 tap blocks",
                                           "K4 mma at 64, K5 8 tap blocks"),
               "apollo_fd512": ("K7 at 64",), "apollo_fd896": ("K7 at 112",)}


def phase_gates(song):
    """One model call of each of GATE_PATHS (seeded weights) with the kernels
    and with their plain versions (model_parity: finite, >= 20 dB). The
    kernels launched are those the model's choice (``apollo_kernels``,
    ``conformer_kernels``, the roformer's ``use_fused_attention`` and
    ``use_fused_ff``, the four-stream roformer's ``sdpa`` through K3's gate)
    names for the call's shapes, each as often as the layers reach it (K1 in
    mode 0), the choice is GATE_KERNELS, and the routes the host plans take
    are GATE_ROUTES where it names the entry."""
    import torch

    from sesa_tpu_torch.configs import AttrDict
    from sesa_tpu_torch.models import apollo, get_model
    from sesa_tpu_torch.models import conformer_core as cc
    from sesa_tpu_torch.ops.attention import (core_width, k1_plan, k4_plan, k7_plan,
                                              use_fused_attention, use_vmem_attention)
    from sesa_tpu_torch.ops.convblock import k5_plan
    from sesa_tpu_torch.ops.ff import use_fused_ff
    from sesa_tpu_torch.tree import tree_map

    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def x_like(b, n, d):  # a (b, n, d) bf16 tensor on the card for the gates, one element held
        return torch.empty((1, 1, 1), device="cuda", dtype=torch.bfloat16).expand(b, n, d)

    out = []
    for label, model_type, model_cfg in GATE_PATHS:
        config = AttrDict({"model": model_cfg})
        params = get_model(model_type).init(torch.Generator().manual_seed(5), config)
        params = tree_map(lambda p: p.cuda(), params)
        batch = _chunking(model_type)[1]
        routes = ()
        if model_type == "apollo":
            n = model_cfg["feature_dim"]
            chosen = apollo.apollo_kernels("cuda", torch.bfloat16, APOLLO_BPRIME, APOLLO_FRAMES,
                                           APOLLO_BANDS, n)
            per_kernel = {"K7": model_cfg["layer"], "K6": 3 * model_cfg["layer"]}
            dh = n // apollo.NUM_HEAD
            plan = k7_plan(APOLLO_BPRIME * APOLLO_FRAMES, APOLLO_BANDS, apollo.NUM_HEAD, dh,
                           2 * (dh // 2), sms)
            if plan is not None:  # the band layer pads its weights' heads to the plan's width
                routes = (f"K7 at {plan['width']}",)
        elif model_type == "bs_roformer_experimental":
            # the branches' sdpa: K3 where its gate takes a leg's (b, h, n, dh)
            dh = model_cfg["dim_head"]
            chosen = {"K3"} if any(
                use_vmem_attention(*[torch.empty((1, 1, n, dh), device="cuda",
                                                 dtype=torch.bfloat16)] * 3)
                for n in (FRAMES, BANDS)) else set()
            per_kernel = {"K3": model_cfg["depth"] * model_cfg["time_transformer_depth"]}
        elif model_type == "bs_roformer":
            # K1 and K2 by the stacks' own gates on each leg's (b, n, d)
            d, heads, dh = model_cfg["dim"], model_cfg["heads"], model_cfg["dim_head"]
            legs = {}
            for leg, b, n in (("time", batch * BANDS, FRAMES), ("freq", batch * FRAMES, BANDS)):
                x = x_like(b, n, d)
                w1 = params["layers"][0][leg]["layers"][0]["ff"]["lin1_w"]
                legs[leg] = frozenset(k for k, ok in (("K1", use_fused_attention(x, heads, dh)),
                                                      ("K2", use_fused_ff(x, w1))) if ok)
                width = core_width(dh, heads)
                core = k1_plan(b, n, d, heads, width, sms)["core"]
                routes += (f"K1 {core['route']} at {width}",)
            if len(set(legs.values())) != 1:
                raise RuntimeError(f"{label}: the time and freq legs take {legs}")
            chosen = legs["time"]
            layers = 2 * model_cfg["depth"]  # a time and a freq transformer per layer
            per_kernel = {"K1": layers, "K2": layers}
        else:
            dim, dh = model_cfg["dim"], model_cfg.get("dim_head", 64)
            heads, taps = model_cfg.get("heads", 8), model_cfg.get("conv_kernel_size", 31)
            legs = set()
            for b, n in ((batch * MEL_BANDS, FRAMES), (batch * FRAMES, MEL_BANDS)):
                legs.add(cc.conformer_kernels("cuda", torch.bfloat16, b, n, dim, heads, dh,
                                              4 * dim, 2 * dim, taps))
                width = core_width(dh, heads)
                core = k4_plan(b, n, dim, heads, width, sms)["core"]
                tap_blocks = k5_plan(b, n, dim, 2 * dim, sms, taps)["dw"]["tap_blocks"]
                routes += (f"K4 {core['route']} at {width}, K5 {tap_blocks} tap blocks",)
            if len(legs) != 1:
                raise RuntimeError(f"{label}: the time and freq legs take {legs}")
            chosen = legs.pop()
            blocks = 2 * model_cfg["depth"]  # a time and a freq block per layer
            per_kernel = {"K2": 2 * blocks, "K4": blocks, "K5": blocks}
        if chosen != GATE_KERNELS[label]:
            raise RuntimeError(f"{label}: the choice takes {sorted(chosen)}, expected "
                               f"{sorted(GATE_KERNELS[label])}")
        if label in GATE_ROUTES and routes != GATE_ROUTES[label]:
            raise RuntimeError(f"{label}: the plans take the routes {routes}, expected "
                               f"{GATE_ROUTES[label]}")
        res = model_parity(model_type, params, config, song, with_f32=False, label=label)
        expected = expect(**{k: per_kernel[k] for k in chosen})
        if res["launches"] != expected:
            raise RuntimeError(f"{label}: launches {res['launches']}, expected {expected}")
        if res["k1_launches_by_mode"] != [expected["K1"], 0, 0]:
            raise RuntimeError(f"{label}: K1 launches by mode {res['k1_launches_by_mode']}, "
                               f"expected {expected['K1']} in mode 0")
        res.update(kernels_chosen=sorted(chosen), routes=list(routes))
        out.append(res)
        del params
        torch.cuda.empty_cache()
    return out


def phase_widths(song, calls):
    """WIDTH_PATHS through cli.main (drive_cli: stems, 0 rescues, exact
    launch counts, a warm second separation), each kernel chosen by the
    model's choice at its shapes and launched as often as the layers reach
    it; then model parity (kernels against plain versions, >= 20 dB, the
    same counts per call) and the profile of one warm call. Each session is
    dropped before the next model loads."""
    import torch

    from sesa_tpu_torch.models import apollo
    from sesa_tpu_torch.models import conformer_core as cc
    from sesa_tpu_torch.ops.attention import attention_block_shape_ok
    from sesa_tpu_torch.ops.ff import ff_shape_ok

    out = {"runs": {}, "parity": [], "profile": {}}
    for label, model_type, model_cfg in WIDTH_PATHS:
        kw, n_calls = {}, calls
        if model_type == "apollo":
            n = model_cfg["feature_dim"]
            chosen = apollo.apollo_kernels("cuda", torch.bfloat16, APOLLO_BPRIME, APOLLO_FRAMES,
                                           APOLLO_BANDS, n)
            per_call = {"K7": model_cfg["layer"], "K6": 3 * model_cfg["layer"]}
            kw = dict(chunk=APOLLO_CHUNK, batch=APOLLO_BATCH, stem="restored")
            n_calls = _model_calls(APOLLO_CHUNK, APOLLO_BATCH)
        else:
            dim, heads = model_cfg["dim"], model_cfg.get("heads", 8)
            dh = model_cfg.get("dim_head", 64)
            bands = BANDS if model_type == "bs_roformer" else MEL_BANDS
            legs = ((BATCH * bands, FRAMES), (BATCH * FRAMES, bands))
            if model_type == "mel_band_conformer":
                kinds = {cc.conformer_kernels("cuda", torch.bfloat16, b, n, dim, heads, dh,
                                              4 * dim, 2 * dim,
                                              model_cfg.get("conv_kernel_size", 31))
                         for b, n in legs}
                blocks = 2 * model_cfg["depth"]
                per_call = {"K2": 2 * blocks, "K4": blocks, "K5": blocks}
            else:  # the roformer's choice: use_fused_attention on a bf16 CUDA x, K2 likewise
                kinds = {frozenset(k for k, ok in (
                    ("K1", attention_block_shape_ok(b, n, dim, heads, dh)),
                    ("K2", ff_shape_ok(b * n, dim, 4 * dim))) if ok) for b, n in legs}
                layers = 2 * model_cfg["depth"]
                per_call = {"K1": layers, "K2": layers}
            if len(kinds) != 1:
                raise RuntimeError(f"{label}: the time and freq legs take {kinds}")
            chosen = kinds.pop()
        if set(chosen) != set(per_call):
            raise RuntimeError(f"{label}: the choice takes {sorted(chosen)}, expected "
                               f"{sorted(per_call)}")
        k1_modes = [per_call["K1"] * n_calls, 0, 0] if "K1" in per_call else None
        with tempfile.TemporaryDirectory() as work:
            res, session = drive_cli(work, model_type, model_cfg, song,
                                     expect(**{k: v * n_calls for k, v in per_call.items()}),
                                     k1_modes=k1_modes, **kw)
        res["config"] = label
        out["runs"][label] = res
        parity = model_parity(model_type, session.params, session.config, song,
                              with_f32=False, label=f"{model_type}_{label}")
        if parity["launches"] != expect(**per_call):
            raise RuntimeError(f"{label} parity: launches {parity['launches']} in one model "
                               f"call, expected {expect(**per_call)}")
        out["parity"].append(parity)
        out["profile"][label] = phase_profile(model_type, session, song, label=label)
        del session
        torch.cuda.empty_cache()
    return out


def phase_ssd_op():
    """K8's sizes beside bs_mamba2's (64, 128, 64), which no model of the repo
    runs, through the public op a user calls, ``sesa_tpu_torch.ops.ssd.ssd``
    (the counterpart of sesa_tpu's ``ssd``): each (H, P, N, chunk) of
    K8_SIZES at band_rnn's shape and band_comm's at chunk 32, in bf16 and
    f32, once, with the launch counts set to 0 before and read after (one
    launch of K8 each, by dtype), and each output against the wrapper's
    plain version. Returns the launches by row key."""
    import torch

    from sesa_tpu_torch.ops.ssd import ssd, ssd_fused_plain

    dev = torch.device("cuda")
    # inputs drawn on the card: a CPU draw of band_rnn's x (246M values) takes seconds
    gen = torch.Generator(device=dev).manual_seed(11)
    band_rnn, band_comm = K8_LEGS
    cases = [(band_rnn, h, p, n, chunk) for h, p, n, chunk in K8_SIZES]
    cases.append((band_comm, MAMBA_HEADS, 64, 128, K8_COMM_CHUNK))
    launches = {}
    for (leg, bsz, l), h, p, n, chunk in cases:
        for dtype in (torch.bfloat16, torch.float32):
            args = ssd_inputs(gen, bsz, l, h, dtype, dev, p=p, n=n)
            reset_counts()
            with torch.inference_mode():
                out = ssd(*args, chunk_size=chunk)
            torch.cuda.synchronize()
            got = read_counts()
            key = _k8_key(leg, h, p, n, chunk, dtype)
            tag = key.rsplit(":", 1)[1]
            by_dtype = counters()["K8"].launches_by_dtype[tag]
            if got != expect(K8=1) or by_dtype != 1:
                raise RuntimeError(f"ssd op {key}: launches {got}, {by_dtype} in {tag}; "
                                   f"expected {expect(K8=1)}")
            compare_ssd(f"ssd op {leg} {key}", out, ssd_fused_plain(*args, chunk_size=chunk))
            launches[key] = got["K8"]
            del args, out
            torch.cuda.empty_cache()
    log(f"[ssd op] K8 launches by size: {launches}")
    return launches


def phase_new_paths(song, calls):
    """The experimental roformers (value residual; four residual streams) and
    bs_mamba2 through cli.main, then model parity of each (kernels against
    plain versions), then the profile of the value-residual and four-stream
    models and of bs_mamba2. Each session is dropped before the next model
    loads."""
    import torch

    depth = FLAGSHIP_MODEL["depth"]
    bsnets = MAMBA_MODEL["num_repeat_mask"] + MAMBA_MODEL["num_repeat_map"]
    f32_bsnets = MAMBA_F32_MODEL["num_repeat_mask"] + MAMBA_F32_MODEL["num_repeat_map"]
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
        # per BSNet two ResMambas (band_rnn, band_comm) of two directions,
        # each the mixer's two kernels around K8
        ("bs_mamba2", "bs_mamba2", MAMBA_MODEL, _mamba_launches(4 * bsnets * calls),
         dict(instruments=MAMBA_STEMS), _mamba_launches(4 * bsnets)),
        # the same in f32, what a bf16 -> f32 rescue reruns: K8's f32 form,
        # at MAMBA_F32_MODEL's cut depth (three BSNets of twelve)
        ("bs_mamba2_f32", "bs_mamba2", MAMBA_F32_MODEL, _mamba_launches(4 * f32_bsnets * calls),
         dict(instruments=MAMBA_STEMS, compute_dtype="f32"), _mamba_launches(4 * f32_bsnets)),
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


def bf16_vs_f32(label, model, params, config, chunks, bound):
    """One model call in bf16 (on the weights ``prepare`` casts once, as the
    session does) against the same call in f32, both on the card: finite,
    and max |err| below ``bound`` x max |f32|."""
    import torch

    with torch.inference_mode():
        prepared = model.prepare(params, config, torch.bfloat16)
        bf16 = model.apply(prepared, config, chunks, compute_dtype=torch.bfloat16)
        f32 = model.apply(params, config, chunks)
    err, scale = float((bf16 - f32).abs().max()), float(f32.abs().max())
    res = dict(model_type=label, max_abs_err=err, f32_max=scale, rel=err / scale, bound=bound,
               snr_bf16_vs_f32_db=snr_db(bf16, f32), finite=bool(torch.isfinite(bf16).all()))
    log(f"[bf16 vs f32] {json.dumps(res)}")
    if not res["finite"] or not err < bound * scale:
        raise RuntimeError(f"{label}: bf16 is {err:.4g} from f32 (max {scale:.4g}), bound "
                           f"{bound} x max")
    return res


def card_vs_cpu(label, model, params, config, song, chunk_size=CHUNK):
    """One chunk of ``chunk_size`` through a model in f32 on the card and
    through the port on the CPU: max |err| <= CARD_VS_CPU_REL x max |CPU|."""
    import torch

    from sesa_tpu_torch.tree import tree_map

    chunk = _chunks(song, chunk_size, 1)
    with torch.inference_mode():
        card = model.apply(params, config, chunk).cpu()
        cpu = model.apply(tree_map(lambda p: p.cpu(), params), config, chunk.cpu())
    err, scale = float((card - cpu).abs().max()), float(cpu.abs().max())
    res = dict(model_type=label, max_abs_err=err, cpu_max=scale, rel=err / scale,
               bound=CARD_VS_CPU_REL, finite=bool(torch.isfinite(card).all()))
    log(f"[card vs cpu] {json.dumps(res)}")
    if not res["finite"] or not err <= CARD_VS_CPU_REL * scale:
        raise RuntimeError(f"{label}: the card is {err:.4g} from the CPU (max {scale:.4g})")
    return res


def lstm_forms():
    """cuDNN's BiLSTM at SCNet's four shapes (batch, steps, width = hidden):
    bf16, and f32 with TF32 off and on (``cudnn.allow_tf32``), each timed
    and held against f32 without TF32. models/scnet.py runs f32 on inputs
    cast from bf16, under whatever the flag is; the flag is restored."""
    import torch

    from sesa_tpu_torch.models.layers import bilstm

    gen = torch.Generator().manual_seed(7)
    saved = torch.backends.cudnn.allow_tf32
    rows = []
    try:
        for leg, n, t, d in (("freq", BATCH * SCNET_FRAMES, SCNET_BANDS, SCNET_DIM),
                             ("time", BATCH * SCNET_BANDS, SCNET_FRAMES, SCNET_DIM),
                             ("freq", BATCH * SCNET_RFFT_FRAMES, SCNET_BANDS, 2 * SCNET_DIM),
                             ("time", BATCH * SCNET_BANDS, SCNET_RFFT_FRAMES, 2 * SCNET_DIM)):
            p = {dr: {k: ((torch.rand(s, generator=gen) * 2 - 1) / d ** 0.5).cuda()
                      for k, s in (("weight_ih", (4 * d, d)), ("weight_hh", (4 * d, d)),
                                   ("bias_ih", (4 * d,)), ("bias_hh", (4 * d,)))}
                 for dr in ("fwd", "bwd")}
            x = torch.randn((n, t, d), generator=gen).cuda()
            pb = {dr: {k: w.bfloat16() for k, w in v.items()} for dr, v in p.items()}
            xb = x.bfloat16()
            row = dict(leg=leg, batch=n, steps=t, width=d)
            torch.backends.cudnn.allow_tf32 = False
            ref = bilstm(x, p)
            for form, tf32, fn in (("bf16", False, lambda: bilstm(xb, pb)),
                                   ("f32", False, lambda: bilstm(x, p)),
                                   ("f32_tf32", True, lambda: bilstm(x, p))):
                torch.backends.cudnn.allow_tf32 = tf32
                row[f"{form}_ms"] = time_ms(fn)
                row[f"{form}_max_abs_err"] = float((fn().float() - ref).abs().max())
            row["ref_max"] = float(ref.abs().max())
            rows.append(row)
            log(f"  bilstm {leg} ({n} x {t} x {d}): " + ", ".join(
                f"{f} {row[f + '_ms']:.3f} ms (err {row[f + '_max_abs_err']:.2g})"
                for f in ("bf16", "f32", "f32_tf32")))
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    return rows


def phase_scnet(song):
    """bench.py's SCNet through cli.main in bf16 (no kernel: its BiLSTMs are
    cuDNN's), one model call in bf16 against f32 on the card, and the profile
    of one model call. Returns the session for the second chain."""
    import torch

    from sesa_tpu_torch.models import scnet

    with tempfile.TemporaryDirectory() as work:
        res, session = drive_cli(work, "scnet", SCNET_MODEL, song, expect(),
                                 instruments=SCNET_STEMS)
    if list(session._prepared) != [torch.bfloat16]:
        raise RuntimeError(f"scnet: the session prepared {list(session._prepared)}")
    res["bf16_vs_f32"] = bf16_vs_f32("scnet", scnet, session.params, session.config,
                                     _chunks(song), SCNET_BF16_REL)
    res["profile"] = phase_profile("scnet", session, song)
    res["lstm_forms"] = lstm_forms()
    return res, session


def _f32_only(model_type, model_cfg, song, sections=None, instruments=None, chunk=CHUNK,
              batch=BATCH, cpu_chunk=None, profile=False):
    """An f32-only model (its apply takes no compute_dtype) through cli.main
    with the CLI's default bf16 session: it must run f32 (no prepared bf16
    weights), launch no kernel and need no rescue; then one chunk (of
    ``cpu_chunk`` samples if given) on the card against the CPU, and with
    ``profile`` the profile of one model call."""
    import inspect

    from sesa_tpu_torch.models import get_model

    model = get_model(model_type)
    if "compute_dtype" in inspect.signature(model.apply).parameters:
        raise RuntimeError(f"{model_type}: apply takes a compute_dtype")
    with tempfile.TemporaryDirectory() as work:
        res, session = drive_cli(work, model_type, model_cfg, song, expect(),
                                 instruments=instruments, sections=sections, chunk=chunk,
                                 batch=batch)
    if session._prepared:
        raise RuntimeError(f"{model_type}: a bf16 session prepared {list(session._prepared)}")
    res["card_vs_cpu"] = card_vs_cpu(model_type, model, session.params, session.config, song,
                                     cpu_chunk or chunk)
    if profile:
        res["profile"] = phase_profile(model_type, session, song)
    return res


def phase_scnet_family(song, calls):
    """scnet_tran through cli.main (K1 and K2 on both legs of its 6 dual-path
    layers), with its sequence lengths, model parity and profile;
    scnet_masked bf16 against f32; ConformerMSS and scnet_unofficial (f32
    only) through cli.main in a bf16 session, each against the CPU; and
    bs_roformer_custom with the FNO stage through cli.main, with model
    parity. Each session is dropped before the next model loads."""
    import torch

    from sesa_tpu_torch.configs import AttrDict
    from sesa_tpu_torch.models import scnet, scnet_masked, scnet_tran
    from sesa_tpu_torch.tree import tree_map

    out = {}
    layers = 2 * SCNET_MODEL["num_dplayer"]  # a freq and a time transformer per layer
    with tempfile.TemporaryDirectory() as work:
        res, session = drive_cli(work, "scnet_tran", SCNET_MODEL, song,
                                 expect(K1=layers * calls, K2=layers * calls),
                                 instruments=SCNET_STEMS, k1_modes=[layers * calls, 0, 0])
    # the (channels, bands, frames) each dual-path layer sees
    seen, spied = [], scnet._apply_dual_path_tran

    def spy(p, x, *args):
        seen.append(tuple(x.shape[1:]))
        return spied(p, x, *args)

    scnet._apply_dual_path_tran = spy
    try:
        with torch.inference_mode():
            scnet_tran.apply(session._prepared[torch.bfloat16], session.config,
                             _chunks(song), compute_dtype=torch.bfloat16)
    finally:
        scnet._apply_dual_path_tran = spied
    want = [(SCNET_DIM, SCNET_BANDS, SCNET_FRAMES),
            (2 * SCNET_DIM, SCNET_BANDS, SCNET_RFFT_FRAMES)] * (SCNET_MODEL["num_dplayer"] // 2)
    log(f"  scnet_tran dual-path (channels, bands, frames) by layer: {seen}")
    if seen != want:
        raise RuntimeError(f"scnet_tran: dual-path shapes {seen}, expected {want}")
    res["dual_path_shapes"] = seen
    res["parity"] = model_parity("scnet_tran", session.params, session.config, song,
                                 with_f32=False)
    if res["parity"]["launches"] != expect(K1=layers, K2=layers):
        raise RuntimeError(f"scnet_tran parity: launches {res['parity']['launches']} in one "
                           f"model call, expected {layers} each of K1 and K2")
    res["profile"] = phase_profile("scnet_tran", session, song)
    out["scnet_tran"] = res
    del session
    torch.cuda.empty_cache()

    config = AttrDict({"model": SCNET_MODEL})
    params = tree_map(lambda p: p.cuda(), scnet_masked.init(torch.Generator().manual_seed(6),
                                                            config))
    out["scnet_masked"] = bf16_vs_f32("scnet_masked", scnet_masked, params, config,
                                      _chunks(song), SCNET_MASKED_BF16_REL)
    del params
    torch.cuda.empty_cache()

    out["conformer"] = _f32_only("conformer", MSS_MODEL, song, sections={"stft": MSS_STFT},
                                 instruments=["vocals", "other"])
    out["scnet_unofficial"] = _f32_only("scnet_unofficial", {}, song, instruments=SCNET_STEMS)
    torch.cuda.empty_cache()

    # the experimental forward threads V from the first depth layer: K1 runs in
    # mode 1 on every leg (with the residual at depth 0, without it after), K2
    # only at depth 0 (later layers run ff_apply without the residual)
    depth = CUSTOM_MODEL["depth"]
    with tempfile.TemporaryDirectory() as work:
        res, session = drive_cli(work, "bs_roformer_custom", CUSTOM_MODEL, song,
                                 expect(K1=2 * depth * calls, K2=2 * calls),
                                 k1_modes=[0, 2 * depth * calls, 0])
    res["parity"] = model_parity("bs_roformer_custom", session.params, session.config, song,
                                 with_f32=False)
    if res["parity"]["launches"] != expect(K1=2 * depth, K2=2):
        raise RuntimeError(f"bs_roformer_custom parity: launches {res['parity']['launches']}")
    out["bs_roformer_custom"] = res
    del session
    torch.cuda.empty_cache()
    return out


def phase_melband_experimental(song):
    """mel_band_roformer_experimental at _melband_setup's widths with value
    residual learning: one model call with the kernels and with their plain
    versions. The experimental forward threads V from depth 0: K1 in mode 1
    (with the residual) on both legs of depth 0 and in mode 2 after it, K2
    at depth 0 only (later layers run ff_apply without the residual)."""
    import torch

    from sesa_tpu_torch.configs import AttrDict
    from sesa_tpu_torch.models import mel_band_roformer_experimental
    from sesa_tpu_torch.tree import tree_map

    config = AttrDict({"model": MELBAND_VR_MODEL})
    params = mel_band_roformer_experimental.init(torch.Generator().manual_seed(8), config)
    params = tree_map(lambda p: p.cuda(), params)
    res = model_parity("mel_band_roformer_experimental", params, config, song, with_f32=False)
    by_mode = list(counters()["K1"].launches_by_mode)
    depth = MELBAND_VR_MODEL["depth"]
    expected, modes = expect(K1=2 * depth, K2=2), [0, 2, 2 * (depth - 1)]
    if res["launches"] != expected or by_mode != modes:
        raise RuntimeError(f"mel_band_roformer_experimental: launches {res['launches']} by mode "
                           f"{by_mode}, expected {expected} by mode {modes}")
    res["k1_launches_by_mode"] = by_mode
    del params
    torch.cuda.empty_cache()
    return res


def phase_mdx_demucs(song):
    """MDX23C and the Demucs family through cli.main on the song, none of
    which launches a kernel: mdx23c at bench.py's InstVocHQ shape (bf16
    against f32, profile), experimental_mdx23c_stht at the same widths (f32
    only; one chunk on the card against the CPU), htdemucs at the
    htdemucs_ft shape in demucs mode (bf16 against f32, the transformer's
    token counts, profile), hdemucs and legacy demucs at their defaults (one
    chunk in f32 against the CPU). Each session is dropped before the next
    model loads."""
    import torch

    from sesa_tpu_torch.models import htdemucs, mdx23c

    from sesa_tpu_torch import cli

    if cli.build_parser().get_default("model_type") != "mdx23c":
        raise RuntimeError("the CLI's default model type is no longer mdx23c")
    out = {}
    mdx_sections = {"audio": MDX_AUDIO}
    with tempfile.TemporaryDirectory() as work:
        res, session = drive_cli(work, "mdx23c", MDX_MODEL, song, expect(),
                                 instruments=MDX_STEMS, sections=mdx_sections,
                                 chunk=MDX_CHUNK, batch=MDX_BATCH)
    res["bf16_vs_f32"] = bf16_vs_f32("mdx23c", mdx23c, session.params, session.config,
                                     _chunks(song, MDX_CHUNK, MDX_BATCH), MDX_BF16_REL)
    res["profile"] = phase_profile("mdx23c", session, song)
    out["mdx23c"] = res
    del session
    torch.cuda.empty_cache()

    out["experimental_mdx23c_stht"] = _f32_only(
        "experimental_mdx23c_stht", MDX_MODEL, song, sections=mdx_sections,
        instruments=MDX_STEMS, chunk=MDX_CHUNK, batch=MDX_BATCH)
    torch.cuda.empty_cache()

    training = {"channels": 2, "samplerate": SR, "segment": DEMUCS_SEGMENT}
    with tempfile.TemporaryDirectory() as work:
        res, session = drive_cli(work, "htdemucs", "htdemucs", song, expect(),
                                 instruments=DEMUCS_STEMS, batch=DEMUCS_BATCH,
                                 sections={"htdemucs": HT_SECTION, "training": training})
    if not session.spec.demucs_mode or session.spec.chunk_size != DEMUCS_CHUNK:
        raise RuntimeError(f"htdemucs: the session's demix spec is {session.spec}")
    # the transformer's sequences: (frequency tokens, time tokens) of each layer
    seen, spied = [], htdemucs._mha

    def spy(p, q, k, v, heads):
        seen.append((q.shape[1], k.shape[1]))
        return spied(p, q, k, v, heads)

    htdemucs._mha = spy
    try:
        with torch.inference_mode():
            htdemucs.apply(session._prepared[torch.bfloat16], session.config,
                           _chunks(song, DEMUCS_CHUNK, 1), compute_dtype=torch.bfloat16)
    finally:
        htdemucs._mha = spied
    f, t = HT_FREQ_TOKENS, HT_TIME_TOKENS
    want = [(f, f), (t, t), (f, t), (t, f)] * 2 + [(f, f), (t, t)]
    log(f"  htdemucs attention (query, key) tokens by call: {seen}")
    if seen != want:
        raise RuntimeError(f"htdemucs: attention over {seen}, expected {want}")
    res["attention_tokens"] = seen
    res["bf16_vs_f32"] = bf16_vs_f32("htdemucs", htdemucs, session.params, session.config,
                                     _chunks(song, DEMUCS_CHUNK, DEMUCS_BATCH), HT_BF16_REL)
    res["profile"] = phase_profile("htdemucs", session, song)
    out["htdemucs"] = res
    del session
    torch.cuda.empty_cache()

    for variant in ("hdemucs", "demucs"):
        with tempfile.TemporaryDirectory() as work:
            res, session = drive_cli(work, "htdemucs", variant, song, expect(),
                                     instruments=DEMUCS_STEMS, batch=DEMUCS_BATCH,
                                     sections={"training": training})
        res["card_vs_cpu"] = card_vs_cpu(variant, htdemucs, session.params, session.config, song,
                                         DEMUCS_CHUNK)
        out[variant] = res
        del session
        torch.cuda.empty_cache()
    return out


def phase_bandit_segm(song):
    """The band-split RNNs and the segmentation U-Nets, none of which
    launches a kernel and all f32 only, each through cli.main in a bf16
    session with 0 rescues and one chunk on the card against the CPU: bandit
    and bandit_v2 at the mus64 widths (a quarter chunk against the CPU) and
    VitLarge23 (segm_models, MaxViT-Large); with the profile of one model
    call of bandit_v2 and VitLarge23 (cuDNN's LSTM, the per-band loops, conv,
    norm and attention time, the LSTM's share of device busy, launches per
    call). Then the resnet50 (torchseg) and efficientnet-b3 (segm_models)
    U-Nets at VitLarge23's shell widths, one chunk each on the card against
    the CPU. Each model is dropped before the next loads."""
    import torch

    from sesa_tpu_torch.configs import AttrDict
    from sesa_tpu_torch.models import get_model
    from sesa_tpu_torch.tree import tree_map

    out = {}
    for model_type in ("bandit", "bandit_v2"):
        out[model_type] = _f32_only(model_type, BANDIT_MODEL, song, instruments=BANDIT_STEMS,
                                    cpu_chunk=BANDIT_CPU_CHUNK,
                                    profile=model_type == "bandit_v2")
        torch.cuda.empty_cache()
    out["segm_models"] = _f32_only(
        "segm_models", SEGM_MODEL, song, chunk=SEGM_CHUNK, batch=SEGM_BATCH, profile=True,
        sections={"audio": SEGM_AUDIO, "decoder_unet": SEGM_DECODER})
    torch.cuda.empty_cache()
    for label in ("bandit", "bandit_v2", "segm_models"):
        res = out[label]
        line = (f"  {label}: rtf_cli {res['rtf_cli']:.2f}, rtf_warm {res['rtf_warm']:.2f}, "
                f"peak CUDA memory {res['peak_cuda_mem_gib']:.2f} GiB, card vs CPU "
                f"{res['card_vs_cpu']['rel']:.3g} of max")
        if "profile" in res:
            # the LSTM's time on the device's timeline over the time some kernel runs
            prof = res["profile"]
            prof["lstm_share"] = prof["op_device_ms"].get("lstm", 0.0) / prof["device_covered_ms"]
            line += (f"; a model call: {prof['kernel_launches']} launches, device busy "
                     f"{prof['device_busy_ms']:.1f} ms (kernels' sum; covered "
                     f"{prof['device_covered_ms']:.1f} ms), LSTM share {prof['lstm_share']:.3f}, "
                     f"idle share {prof['idle_share']:.3f}")
        log(line)

    for label, model_type, encoder in SEGM_ENCODERS:
        config = AttrDict({"audio": SEGM_AUDIO, "model": dict(SEGM_MODEL, encoder_name=encoder),
                           "decoder_unet": SEGM_DECODER,
                           "training": {"instruments": ["vocals", "other"],
                                        "target_instrument": "vocals"}})
        model = get_model(model_type)
        params = tree_map(lambda p: p.cuda(), model.init(torch.Generator().manual_seed(9), config))
        out[label] = card_vs_cpu(label, model, params, config, song, SEGM_CHUNK)
        del params
        torch.cuda.empty_cache()
    return out


def _squim_phase():
    """SQUIM at squim_objective_base on 4 x 10 s of 16 kHz mono made from a
    seed: ``metrics.squim_objective_scores`` on the card against the CPU,
    each score within CARD_VS_CPU_REL x max |CPU|, and its time per call."""
    import numpy as np
    import torch

    from sesa_tpu_torch import metrics
    from sesa_tpu_torch.models import squim
    from sesa_tpu_torch.tree import tree_map

    rng = np.random.default_rng(11)
    t = np.arange(SQUIM_S * SQUIM_SR) / SQUIM_SR
    f0 = rng.uniform(120, 260, (SQUIM_BATCH, 1))
    speech = np.sin(2 * np.pi * f0 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
    wave = (0.3 * speech + 0.03 * rng.standard_normal(speech.shape)).astype(np.float32)
    cpu_params = squim.init(torch.Generator().manual_seed(12))
    params = tree_map(lambda p: p.cuda(), cpu_params)
    card = metrics.squim_objective_scores(wave, params)
    cpu = metrics.squim_objective_scores(wave, cpu_params)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics.squim_objective_scores(wave, params)  # ends in a copy to the host
        walls.append(1e3 * (time.perf_counter() - t0))
    res = dict(batch=SQUIM_BATCH, seconds=SQUIM_S, sample_rate=SQUIM_SR, ms_per_call=min(walls),
               ms_per_call_all=walls, scores_card={k: v.tolist() for k, v in card.items()},
               rel={k: float(np.abs(card[k] - cpu[k]).max() / np.abs(cpu[k]).max()) for k in cpu},
               bound=CARD_VS_CPU_REL)
    log(f"[squim] {json.dumps(res)}")
    for k, rel in res["rel"].items():
        if not (card[k].shape == (SQUIM_BATCH,) and np.isfinite(card[k]).all()
                and rel <= CARD_VS_CPU_REL):
            raise RuntimeError(f"squim {k}: card {card[k]} against CPU {cpu[k]}")
    return res


def swin_counts(params, config):
    """swin_upernet's parameter count and the FLOP of one chunk's image path
    (backbone and UperNet head; products and convolutions, window padding
    included), counted by torch.utils.flop_counter on meta tensors."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from sesa_tpu_torch.models import swin_upernet
    from sesa_tpu_torch.tree import tree_map

    n_params = [0]

    def meta(p):
        n_params[0] += p.numel()
        return p.to("meta")

    params = tree_map(meta, params)
    kw = swin_upernet._swin_kwargs(config)
    frames = config.audio.chunk_size // config.audio.hop_length + 1
    img = torch.empty((1, config.model.num_channels, frames,
                       config.audio.dim_f // config.model.num_subbands), device="meta")
    with FlopCounterMode(display=False) as count:
        feats = swin_upernet._backbone(params["backbone"], img, kw)
        backbone = count.get_total_flops()
        swin_upernet._decode_head(params["decode_head"], feats, kw)
    return dict(params=n_params[0], backbone_flop=backbone,
                head_flop=count.get_total_flops() - backbone)


def phase_swin_squim(song):
    """swin_upernet (upernet-swin-large in VitLarge23's shell) through
    cli.main in bf16 with 0 rescues and no kernel launch; one model call in
    bf16 against f32 on the card (SWIN_BF16_REL) and one chunk in f32 on the
    card against the CPU; the profile of one model call (window attention,
    MLP, patch merging, LayerNorms, resizes, the head's conv modules by
    scope). Then
    SQUIM's scores on the card against the CPU, and utils.demix of a
    ModelBundle (seed 0) against an f32 InferenceSession on the same
    parameters: equal stems."""
    import numpy as np
    import torch

    from sesa_tpu_torch import utils
    from sesa_tpu_torch.models import swin_upernet
    from sesa_tpu_torch.runtime.session import InferenceSession

    out = {}
    sections = {"audio": SEGM_AUDIO}
    with tempfile.TemporaryDirectory() as work:
        res, session = drive_cli(work, "swin_upernet", SWIN_MODEL, song, expect(),
                                 sections=sections, chunk=SEGM_CHUNK, batch=SEGM_BATCH)
        cfg_path = os.path.join(work, "config.json")
        if list(session._prepared) != [torch.bfloat16]:
            raise RuntimeError(f"swin_upernet: prepared weights {list(session._prepared)}")
        res["bf16_vs_f32"] = bf16_vs_f32("swin_upernet", swin_upernet, session.params,
                                         session.config, _chunks(song, SEGM_CHUNK, SEGM_BATCH),
                                         SWIN_BF16_REL)
        res["card_vs_cpu"] = card_vs_cpu("swin_upernet", swin_upernet, session.params,
                                         session.config, song, SEGM_CHUNK)
        res["profile"] = phase_profile("swin_upernet", session, song,
                                       scopes=SWIN_PROFILE_SCOPES)
        res["counts"] = swin_counts(session.params, session.config)
        log(f"[swin_upernet counts] {json.dumps(res['counts'])}")
        del session
        torch.cuda.empty_cache()

        # the reference-shaped API against the session, both f32 on seed 0's weights
        bundle, config = utils.get_model_from_config("swin_upernet", cfg_path)
        bundle.init(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stems = utils.demix(config, bundle, song)
        torch.cuda.synchronize()
        demix_s = time.perf_counter() - t0
        ref = InferenceSession.create("swin_upernet", cfg_path, compute_dtype=None).separate(song)
    err = max(float(np.abs(stems[k] - ref[k]).max()) for k in ref)
    scale = max(float(np.abs(ref[k]).max()) for k in ref)
    res["utils_demix"] = dict(stems=list(stems), max_abs_err=err, session_max=scale,
                              wall_s=demix_s, rtf=SONG_S / demix_s)
    log(f"[utils.demix vs session f32] {json.dumps(res['utils_demix'])}")
    if list(stems) != list(ref) or not err <= 1e-6 * scale:
        raise RuntimeError(f"utils.demix: stems {list(stems)} differ from the session's "
                           f"{list(ref)} by {err:.4g} (max {scale:.4g})")
    del bundle, stems, ref
    torch.cuda.empty_cache()
    out["swin_upernet"] = res
    prof = res["profile"]
    log(f"  swin_upernet: rtf_cli {res['rtf_cli']:.2f}, rtf_warm {res['rtf_warm']:.2f}, peak CUDA "
        f"memory {res['peak_cuda_mem_gib']:.2f} GiB, bf16 vs f32 {res['bf16_vs_f32']['rel']:.3g} "
        f"of max, card vs CPU {res['card_vs_cpu']['rel']:.3g} of max; a model call: "
        f"{prof['kernel_launches']} launches, device busy {prof['device_busy_ms']:.1f} ms, idle "
        f"share {prof['idle_share']:.3f}")
    out["squim"] = _squim_phase()
    return out


# ---------------------------------------------------------------------------
# the app layer: registry -> checkpoint file -> processing
# ---------------------------------------------------------------------------

# the two custom models phase_app registers (display names), and the URLs
# their entries carry: never fetched, since the files are in place (and the
# phase puts a requests stub in place that refuses any call)
APP_MODELS = (("Chip Smoke BS-Roformer", "bs_roformer", FLAGSHIP_MODEL, 11),
              ("Chip Smoke Mel-Band-Roformer", "mel_band_roformer", MELBAND_MODEL, 12))
APP_URL = "https://models.invalid/chip_smoke"
# the app path against the direct session, the auto ensemble against the host
# ensemble of the single-model stems, and the two bf16 SCNet calls around an
# f32 one: max |a - b| <= this share of max |b|
APP_REL = 1e-6


def roformer_state_dict(params, spec):
    """The port's bs_roformer or mel_band_roformer parameter tree -> a state
    dict in the reference layout: the inverse of
    ``bs_roformer.convert_from_spec``, the port-side mirror of
    tests/test_roformer.py ``export_state_dict``. The transformers' output
    norms and the final norm are written where the tree has them (the
    mel-band and the band-split conventions)."""
    import torch

    def t(a):
        return a.detach().to("cpu", torch.float32).clone()

    def tt(a):
        return t(a).T.contiguous()

    plan = spec.band_plan()
    sd = {}
    for g, ids in enumerate(plan.group_band_ids):
        gp = params["band_split"]["groups"][g]
        for pos, i in enumerate(ids):
            sd[f"band_split.to_features.{i}.0.gamma"] = t(gp["norm_gamma"][pos])
            sd[f"band_split.to_features.{i}.1.weight"] = tt(gp["weight"][pos])
            sd[f"band_split.to_features.{i}.1.bias"] = t(gp["bias"][pos])

    def put_transformer(prefix, tp, linear_attn=False):
        for i, layer in enumerate(tp["layers"]):
            a, f = layer["attn"], layer["ff"]
            ap, fp = f"{prefix}.layers.{i}.0", f"{prefix}.layers.{i}.1"
            if "hc" in a or "hc" in f:
                raise ValueError("roformer_state_dict: hyper-connection trees are not written")
            sd[f"{ap}.norm.gamma"] = t(a["norm_gamma"])
            if linear_attn:
                sd[f"{ap}.to_qkv.0.weight"] = t(a["qkv_w"])
                sd[f"{ap}.temperature"] = t(a["temperature"])
                sd[f"{ap}.to_out.1.weight"] = t(a["out_w"])
            else:
                sd[f"{ap}.to_qkv.weight"] = t(a["qkv_w"])
                sd[f"{ap}.to_gates.weight"] = t(a["gates_w"])
                sd[f"{ap}.to_gates.bias"] = t(a["gates_b"])
                sd[f"{ap}.to_out.0.weight"] = t(a["out_w"])
                if "vr_mix_w" in a:
                    sd[f"{ap}.to_value_residual_mix.weight"] = t(a["vr_mix_w"])
                    sd[f"{ap}.to_value_residual_mix.bias"] = t(a["vr_mix_b"])
            sd[f"{fp}.net.0.gamma"] = t(f["norm_gamma"])
            sd[f"{fp}.net.1.weight"] = t(f["lin1_w"])
            sd[f"{fp}.net.1.bias"] = t(f["lin1_b"])
            sd[f"{fp}.net.4.weight"] = t(f["lin2_w"])
            sd[f"{fp}.net.4.bias"] = t(f["lin2_b"])
        if "norm_gamma" in tp:
            sd[f"{prefix}.norm.gamma"] = t(tp["norm_gamma"])

    for d, layer in enumerate(params["layers"]):
        j = 0
        if "linear" in layer:
            put_transformer(f"layers.{d}.{j}", layer["linear"], linear_attn=True)
            j += 1
        put_transformer(f"layers.{d}.{j}", layer["time"])
        put_transformer(f"layers.{d}.{j + 1}", layer["freq"])
        if "fno" in layer:
            fn = layer["fno"]
            sd[f"layers.{d}.{j + 2}.weight_real"] = t(fn["w_re"])
            sd[f"layers.{d}.{j + 2}.weight_imag"] = t(fn["w_im"])
            sd[f"layers.{d}.{j + 2}.bypass.weight"] = tt(fn["bypass_w"])
            sd[f"layers.{d}.{j + 2}.bypass.bias"] = t(fn["bypass_b"])

    for s, me in enumerate(params["mask_estimators"]):
        pre = f"mask_estimators.{s}.to_freqs"
        for li, h in enumerate(me["hidden"]):
            for i in range(plan.num_bands):
                sd[f"{pre}.{i}.0.{2 * li}.weight"] = tt(h["weight"][i])
                sd[f"{pre}.{i}.0.{2 * li}.bias"] = t(h["bias"][i])
        last = 2 * len(me["hidden"])
        for g, ids in enumerate(plan.group_band_ids):
            gp = me["groups"][g]
            for pos, i in enumerate(ids):
                sd[f"{pre}.{i}.0.{last}.weight"] = tt(gp["weight"][pos])
                sd[f"{pre}.{i}.0.{last}.bias"] = t(gp["bias"][pos])

    sd["time_rotary_embed.freqs"] = t(params["rope_time_freqs"])
    sd["freq_rotary_embed.freqs"] = t(params["rope_freq_freqs"])
    if "final_norm_gamma" in params:
        sd["final_norm.gamma"] = t(params["final_norm_gamma"])
    return sd


def _no_network_requests():
    """A ``requests`` module whose calls raise: the app phase must find every
    file in place and never reach for the network."""
    import types

    def refuse(*args, **kwargs):
        raise RuntimeError(f"chip_smoke: no network; refused requests call {args[:1]}")

    stub = types.ModuleType("requests")
    stub.get = stub.head = stub.post = refuse
    return stub


def _drain(gen, label):
    """Run a processing generator to its end; check that progress never goes
    back and ends at 100. Returns (updates, wall seconds)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    updates = list(gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    progress = [u["progress"] for u in updates]
    if progress != sorted(progress) or progress[-1] != 100:
        raise RuntimeError(f"{label}: progress {progress}")
    return updates, wall


def _separating_statuses(updates):
    import re

    live = [int(m.group(1)) for u in updates
            for m in [re.fullmatch(r"Separating\.\.\. (\d+)%", u["status"])] if m]
    return [p for p in live if 5 < p < 75]


def _rel_err(a, b):
    import numpy as np

    return float(np.abs(a - b).max()), float(np.abs(b).max())


def _app_setup(home):
    """Write the two seeded models' configs and reference-layout checkpoints
    into the registry's CHECKPOINT_DIR and register them as custom models:
    through ``add_custom_model`` (which asks for ``conf_edit``) where pyyaml
    imports, else as entries with a .json config and no conf_edit. Returns
    {name: dict(model_type, params, config_path, checkpoint_path)}."""
    import torch

    from sesa_tpu_torch.configs import AttrDict
    from sesa_tpu_torch.models import get_model
    from sesa_tpu_torch.registry import models as reg

    if reg.BASE_DIR != home:
        raise RuntimeError(f"the registry was imported before SESA_TPU_HOME was set: "
                           f"{reg.BASE_DIR}")
    try:
        import yaml
    except ImportError:
        yaml = None
    log("  registration: " + ("add_custom_model + conf_edit (pyyaml imports)" if yaml else
                              "custom_models.json, .json configs (no pyyaml)"))
    os.makedirs(reg.CHECKPOINT_DIR, exist_ok=True)
    entries, custom = {}, {}
    for name, model_type, model_cfg, seed in APP_MODELS:
        cfg = {"audio": {"chunk_size": CHUNK, "num_channels": 2, "sample_rate": SR},
               "model": model_cfg,
               "training": {"instruments": ["vocals", "other"], "target_instrument": "vocals"},
               "inference": {"num_overlap": OVERLAP, "batch_size": BATCH, "normalize": False}}
        module = get_model(model_type)
        params = module.init(torch.Generator().manual_seed(seed), AttrDict(cfg))
        ckpt_name = f"chip_smoke_{model_type}.ckpt"
        cfg_url = f"{APP_URL}/config_{model_type}.{'yaml' if yaml else 'json'}"
        if yaml is not None:
            ok, msg = reg.add_custom_model(name, model_type, f"{APP_URL}/{ckpt_name}", cfg_url)
            if not ok:
                raise RuntimeError(f"add_custom_model {name}: {msg}")
            cfg_name = reg.load_custom_models()[name]["config_filename"]
            with open(os.path.join(reg.CHECKPOINT_DIR, cfg_name), "w") as f:
                yaml.safe_dump(cfg, f, sort_keys=False)
        else:
            cfg_name = os.path.basename(cfg_url)
            custom[name] = {"model_type": model_type, "checkpoint_url": f"{APP_URL}/{ckpt_name}",
                            "config_url": cfg_url, "checkpoint_filename": ckpt_name,
                            "config_filename": cfg_name, "needs_conf_edit": False}
            with open(os.path.join(reg.CHECKPOINT_DIR, cfg_name), "w") as f:
                json.dump(cfg, f)
        spec = module.spec_from_config(AttrDict(cfg).model)
        ckpt = os.path.join(reg.CHECKPOINT_DIR, ckpt_name)
        torch.save(roformer_state_dict(params, spec), ckpt)
        entries[name] = dict(model_type=model_type, params=params, checkpoint_path=ckpt,
                             config_path=os.path.join(reg.CHECKPOINT_DIR, cfg_name),
                             layers=model_cfg["depth"] * (model_cfg["time_transformer_depth"]
                                                          + model_cfg["freq_transformer_depth"]))
        log(f"  {name}: {os.path.getsize(ckpt) / 2 ** 20:.1f} MiB checkpoint, config {cfg_name}")
    if custom:
        reg.save_custom_models(custom)
    return entries, yaml is not None


def _tf32_repair(song):
    """One SCNet (bench.py's _scnet_setup shape) bf16 model call, an f32 call,
    the same bf16 call again: equal outputs, the TF32 flags each call saw, and
    the LSTMs' device time (CUDA events around each BiLSTM) of a bf16 call after
    an f32 one under today's policy and under the policy before the repair
    (TF32 left off by the f32 call)."""
    import contextlib

    import torch

    from sesa_tpu_torch.configs import AttrDict
    from sesa_tpu_torch.models import scnet
    from sesa_tpu_torch.tree import tree_map

    config = AttrDict({"audio": {"chunk_size": CHUNK, "num_channels": 2, "sample_rate": SR},
                       "model": SCNET_MODEL, "training": {"instruments": SCNET_STEMS}})
    params = tree_map(lambda p: p.cuda(), scnet.init(torch.Generator().manual_seed(5), config))
    prepared = scnet.prepare(params, config, torch.bfloat16)
    chunks = _chunks(song)
    seen, events = [], []
    inner = scnet._bilstm

    def probe(y, p):
        if not events:
            seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(y, p)
        end.record()
        events.append((start, end))
        return out

    def call(dtype):
        events.clear()
        with torch.inference_mode():
            out = scnet.apply(prepared if dtype else params, config, chunks, compute_dtype=dtype)
        torch.cuda.synchronize()
        return out, sum(s.elapsed_time(e) for s, e in events)

    @contextlib.contextmanager
    def policy_before_repair(compute_dtype):
        # the parent's net_dtype: f32 turned TF32 off for the process, bf16
        # left the flags as it found them
        dtype = torch.float32 if compute_dtype is None else compute_dtype
        if dtype == torch.float32:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        yield dtype

    saved_flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    policy = scnet.net_precision
    scnet._bilstm = probe
    try:
        call(torch.bfloat16)  # warm
        first, lstm_first = call(torch.bfloat16)
        _, lstm_f32 = call(None)
        second, lstm_after = call(torch.bfloat16)
        flags = list(seen[-3:])
        scnet.net_precision = policy_before_repair
        try:
            call(None)
            _, lstm_before_repair = call(torch.bfloat16)
            flags_before_repair = seen[-1]
        finally:
            scnet.net_precision = policy
    finally:
        scnet._bilstm = inner
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved_flags
    err, scale = float((first - second).abs().max()), float(second.abs().max())
    res = dict(flags_bf16_f32_bf16=flags, max_abs_err=err, out_max=scale,
               lstm_ms_bf16_first=lstm_first, lstm_ms_f32=lstm_f32,
               lstm_ms_bf16_after_f32=lstm_after,
               lstm_ms_bf16_after_f32_before_repair=lstm_before_repair,
               flags_bf16_after_f32_before_repair=flags_before_repair)
    log(f"[tf32 repair] {json.dumps(res)}")
    if flags != [(True, True), (False, False), (True, True)]:
        raise RuntimeError(f"tf32 repair: the calls saw (matmul, cudnn) allow_tf32 {flags}")
    if not err <= APP_REL * scale:
        raise RuntimeError(f"tf32 repair: bf16 SCNet moved by {err:.4g} (max {scale:.4g}) "
                           "across an f32 call")
    return res


def phase_app(song):
    """The app layer on the card: a display name -> registry -> the port's
    session loaded from a checkpoint file -> processing. Sets SESA_TPU_HOME
    to a temporary directory (the app modules read it at import), registers
    the flagship and mel_band_roformer (seeded, written as reference-layout
    checkpoints) as custom models, then: process_audio of the 60 s song with
    each (live progress, the stems and their slots, K1 and K2 at layers x
    calls, the flagship's stem equal to a direct InferenceSession on the same
    file, the loaded parameters equal to the seeded ones bit for bit);
    auto_ensemble_process of both (K1 and K2 at the sum, the file equal to
    ensemble_waveforms of the two single-model stems); the TF32 repair on
    SCNet; benchmark.main test and benchmark; warmup.main; device_trace of
    one flagship model call, whose trace must name K1's norm kernel."""
    import io
    import re
    import shutil
    import sys as _sys
    from contextlib import redirect_stdout

    import numpy as np
    import torch

    t_phase = time.perf_counter()
    home = tempfile.mkdtemp(prefix="sesa_home_")
    saved_env = os.environ.get("SESA_TPU_HOME")
    saved_requests = _sys.modules.get("requests")
    os.environ["SESA_TPU_HOME"] = home
    _sys.modules["requests"] = _no_network_requests()
    try:
        from sesa_tpu_torch import benchmark, processing, warmup
        from sesa_tpu_torch.audio_io import read_audio, write_audio
        from sesa_tpu_torch.postprocess import ensemble_waveforms
        from sesa_tpu_torch.runtime import profiling
        from sesa_tpu_torch.runtime.session import InferenceSession
        from sesa_tpu_torch.tree import tree_map

        out = {}
        entries, via_yaml = _app_setup(home)
        out["registered_via"] = "add_custom_model" if via_yaml else "custom_models.json"
        (flag_name, flag), (mel_name, mel) = entries.items()
        calls = _model_calls()
        song_path = write_audio(os.path.join(home, "song.wav"), song, SR)

        made = []
        make_session = processing._make_session

        def timed_session(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            session = make_session(*args, **kwargs)
            torch.cuda.synchronize()
            made.append((session, time.perf_counter() - t0))
            return session

        processing._make_session = timed_session
        try:
            single = {}
            for name, entry, instrumental in ((flag_name, flag, True), (mel_name, mel, False)):
                out_dir = os.path.join(home, f"out_{entry['model_type']}")
                reset_counts()
                updates, wall = _drain(processing.process_audio(
                    song_path, name, chunk_size=CHUNK, overlap=OVERLAP,
                    extract_instrumental=instrumental, output_dir=out_dir), name)
                launches = read_counts()
                session, load_s = made[-1]
                final = updates[-1]
                stems = {s: final["slots"][s] for s in ("vocals", "instrumental")}
                if not stems["vocals"] or bool(stems["instrumental"]) != instrumental or \
                        set(final["outputs"]) != {f for f in stems.values() if f}:
                    raise RuntimeError(f"{name}: outputs {final['outputs']}, slots {stems}")
                vocals, sr = read_audio(stems["vocals"])
                if vocals.shape != song.shape or sr != SR or not np.isfinite(vocals).all():
                    raise RuntimeError(f"{name}: vocals {vocals.shape} at {sr} Hz, finite "
                                       f"{np.isfinite(vocals).all()}")
                live = _separating_statuses(updates)
                if not live:
                    raise RuntimeError(f"{name}: no live 'Separating... N%' status in "
                                       f"{[u['status'] for u in updates]}")
                want = expect(K1=entry["layers"] * calls, K2=entry["layers"] * calls)
                if launches != want:
                    raise RuntimeError(f"{name}: launches {launches}, expected {want}")
                same = tree_map(lambda a, b: bool(torch.equal(a.cpu(), b)), session.params,
                                entry["params"])
                flat = []
                tree_map(flat.append, same)
                if not all(flat):
                    raise RuntimeError(f"{name}: {flat.count(False)} of {len(flat)} loaded "
                                       "parameters differ from the seeded ones")
                res = dict(model_type=entry["model_type"], wall_s=wall, rtf_app=SONG_S / wall,
                           checkpoint_load_s=load_s, launches=launches,
                           progress=[u["progress"] for u in updates], live_progress=live,
                           outputs=[os.path.basename(f) for f in final["outputs"]],
                           rescues=session.rescues)
                if name == flag_name:
                    direct = InferenceSession.create(flag["model_type"], flag["config_path"],
                                                     flag["checkpoint_path"], chunk_size=CHUNK,
                                                     num_overlap=OVERLAP)
                    ref = direct.separate(song)["vocals"]
                    del direct
                    err, scale = _rel_err(vocals, ref)
                    res.update(vs_direct_session_max_abs_err=err, direct_max=scale)
                    if not err <= APP_REL * scale:
                        raise RuntimeError(f"{name}: the app's stem is {err:.4g} from the "
                                           f"direct session's (max {scale:.4g})")
                if session.rescues:
                    raise RuntimeError(f"{name}: {session.rescues} rescues")
                single[name] = vocals
                out[f"process_audio_{entry['model_type']}"] = res
                log(f"[app process_audio] {json.dumps(res)}")
                made.clear()
                del session
                torch.cuda.empty_cache()

            reset_counts()
            updates, wall = _drain(processing.auto_ensemble_process(
                song_path, [flag_name, mel_name], chunk_size=CHUNK, overlap=OVERLAP,
                ensemble_type="avg_wave", output_dir=os.path.join(home, "out_ensemble")),
                "auto_ensemble")
            launches = read_counts()
            load_s = [s for _, s in made]
            made.clear()
            torch.cuda.empty_cache()
        finally:
            processing._make_session = make_session
        files = updates[-1]["outputs"]
        want = expect(K1=(flag["layers"] + mel["layers"]) * calls,
                      K2=(flag["layers"] + mel["layers"]) * calls)
        if len(files) != 1 or "_vocals_" not in os.path.basename(files[0]):
            raise RuntimeError(f"auto_ensemble: outputs {files}")
        if launches != want:
            raise RuntimeError(f"auto_ensemble: launches {launches}, expected {want}")
        got, _ = read_audio(files[0])
        err, scale = _rel_err(got, ensemble_waveforms([single[flag_name], single[mel_name]],
                                                      "avg_wave"))
        out["auto_ensemble"] = dict(wall_s=wall, rtf_app_ensemble=SONG_S / wall,
                                    checkpoint_load_s=load_s, launches=launches,
                                    max_abs_err_vs_host_ensemble=err, ensemble_max=scale,
                                    progress=[u["progress"] for u in updates])
        log(f"[app auto_ensemble] {json.dumps(out['auto_ensemble'])}")
        if not err <= APP_REL * scale:
            raise RuntimeError(f"auto_ensemble: {err:.4g} from the host ensemble of the "
                               f"single-model stems (max {scale:.4g})")

        out["tf32_repair"] = _tf32_repair(song)
        torch.cuda.empty_cache()

        args = ["--model_type", flag["model_type"], "--config_path", flag["config_path"],
                "--start_check_point", flag["checkpoint_path"], "--batch_size", "2",
                "--iterations", "3"]
        bench = {}
        for command in ("test", "benchmark"):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with redirect_stdout(buf):
                rc = benchmark.main([command, *args])
            text = buf.getvalue()
            log(f"[app benchmark {command}] rc {rc}, {time.perf_counter() - t0:.1f}s\n{text}")
            if rc != 0:
                raise RuntimeError(f"benchmark {command}: exit {rc}")
            bench[command] = text
        ms = {m: float(v) for m, v in re.findall(r"^\s+(f32|bf16): ([0-9.]+) ms/iter \(",
                                                  bench["benchmark"], re.M)}
        if set(ms) != {"f32", "bf16"}:
            raise RuntimeError(f"benchmark: no ms/iter for both modes in {bench['benchmark']!r}")
        out["benchmark"] = dict(ms_per_iter=ms, batch_size=2, test=bench["test"])
        torch.cuda.empty_cache()

        buf = io.StringIO()
        t0 = time.perf_counter()
        with redirect_stdout(buf):
            rc = warmup.main(["--model_type", flag["model_type"], "--config_path",
                              flag["config_path"], "--song_seconds", "10",
                              "--phase_fix_models", "2"])
        lines = buf.getvalue().splitlines()
        log("[app warmup] " + " | ".join(lines))
        if rc != 0 or len(lines) != 3 or not lines[0].startswith("[warmup] kernels:"):
            raise RuntimeError(f"warmup: exit {rc}, lines {lines}")
        out["warmup"] = dict(wall_s=time.perf_counter() - t0, lines=lines)
        torch.cuda.empty_cache()

        session = InferenceSession.create(flag["model_type"], flag["config_path"],
                                          flag["checkpoint_path"])
        fn = session._model_apply(session.compute_dtype)
        chunks = _chunks(song)
        fn(session.params, chunks)
        trace_dir = os.path.join(home, "trace")
        with profiling.device_trace(trace_dir):
            fn(session.params, chunks)
            torch.cuda.synchronize()
        traces = os.listdir(trace_dir)
        if len(traces) != 1:
            raise RuntimeError(f"device_trace: wrote {traces}")
        with open(os.path.join(trace_dir, traces[0])) as f:
            trace = f.read()
        out["device_trace"] = dict(file=traces[0], bytes=len(trace),
                                   names_k1_norm="rms_norm_gates_kernel" in trace,
                                   model_info=profiling.get_model_info(session.params,
                                                                       flag["model_type"]))
        log(f"[app device_trace] {json.dumps(out['device_trace'])}")
        if not out["device_trace"]["names_k1_norm"]:
            raise RuntimeError("device_trace: the trace does not name rms_norm_gates_kernel")
        del session, fn, chunks
        torch.cuda.empty_cache()
    finally:
        if saved_env is None:
            os.environ.pop("SESA_TPU_HOME", None)
        else:
            os.environ["SESA_TPU_HOME"] = saved_env
        if saved_requests is None:
            _sys.modules.pop("requests", None)
        else:
            _sys.modules["requests"] = saved_requests
        shutil.rmtree(home, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    single_f = out[f"process_audio_{flag['model_type']}"]
    log(f"  app: rtf_app {single_f['rtf_app']:.2f} (checkpoint load "
        f"{single_f['checkpoint_load_s']:.2f} s), rtf_app_ensemble "
        f"{out['auto_ensemble']['rtf_app_ensemble']:.2f}, benchmark f32 / bf16 "
        f"{ms['f32']:.1f} / {ms['bf16']:.1f} ms/iter, phase {out['wall_s']:.1f} s")
    return out


def _train_stems(seconds):
    """Vocals and other of a seeded song (the parts of ``_song``), each (2, T)."""
    import numpy as np

    rng = np.random.default_rng(1)
    t = np.arange(int(seconds * SR)) / SR
    voice = 0.3 * np.sin(2 * np.pi * 220 * t * (1 + 0.01 * np.sin(2 * np.pi * 0.5 * t)))
    band = 0.2 * np.sin(2 * np.pi * 110 * t) + 0.1 * np.sign(np.sin(2 * np.pi * 2 * t))
    vocals = np.stack([voice, 0.8 * voice]) + 0.01 * rng.standard_normal((2, t.size))
    other = np.stack([band, band]) + 0.01 * rng.standard_normal((2, t.size))
    return vocals.astype(np.float32), other.astype(np.float32)


def _train_item(seconds, batched=True):
    vocals, other = _train_stems(seconds)
    audio = {"vocals": vocals, "other": other, "mixture": vocals + other}
    if batched:
        audio = {k: v[None] for k, v in audio.items()}
    return {"audio": audio, "track": "train/seeded"}


def _train_card_vs_cpu(model_type, batch=1):
    """One SGD(1e-2) step of a tiny model on the card and on the CPU from the
    same seeded params and a batch of ``batch`` items (each its own draw of
    the seeded generator): the loss and every gradient leaf."""
    import numpy as np
    import torch

    from sesa_tpu_torch.configs import AttrDict
    from sesa_tpu_torch.models import get_model
    from sesa_tpu_torch.train import Trainer, _flatten

    cfg = AttrDict(dict(TRAIN_TINY[model_type], training={"instruments": ["vocals", "other"],
                                                          "target_instrument": None}))
    params = get_model(model_type).init(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    audio = {s: (0.1 * rng.standard_normal((batch, 2, TRAIN_TINY_SAMPLES[model_type])))
             .astype(np.float32) for s in ("vocals", "other")}
    audio["mixture"] = audio["vocals"] + audio["other"]
    item = {"audio": audio}
    opt = {"optimizer": {"name": "SGD", "kwargs": {"lr": 1e-2}}}
    runs = {}
    for device in ("cuda", "cpu"):
        trainer = Trainer(model_type, cfg, loss={"name": "L1Loss", "kwargs": {}},
                          optimizer=opt, params=params, device=device)
        loss = trainer.train_batch(item)
        runs[device] = (loss, {k: v.grad.cpu() for k, v in _flatten(trainer.params).items()})
    (l_card, g_card), (l_cpu, g_cpu) = runs["cuda"], runs["cpu"]
    worst = max((float((g_card[k] - g_cpu[k]).abs().max())
                 / max(float(g_cpu[k].abs().max()), 1e-30), k) for k in g_cpu)
    res = dict(model_type=model_type, batch=batch, loss_card=l_card, loss_cpu=l_cpu,
               loss_rel=abs(l_card - l_cpu) / abs(l_cpu), leaves=len(g_cpu),
               max_grad_rel=worst[0], worst_leaf=worst[1], bound=TRAIN_CARD_VS_CPU_REL)
    log(f"[train card vs cpu] {json.dumps(res)}")
    if not res["loss_rel"] <= TRAIN_CARD_VS_CPU_REL or not worst[0] <= TRAIN_CARD_VS_CPU_REL:
        raise RuntimeError(f"{model_type} at batch {batch}: a training step on the card is "
                           f"{worst[0]:.3g} (leaf {worst[1]}) and {res['loss_rel']:.3g} (loss) "
                           "from the CPU")
    return res


def _tf32_probe(seen, where):
    """A tensor hook that records both TF32 flags while autograd runs it."""
    import torch

    def hook(grad):
        seen.append((where, torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return grad

    return hook


def phase_train():
    """Training and the UI on the card: phase 18 of the module docstring.
    Raises on any failed check."""
    import subprocess as sp
    import sys as _sys

    import numpy as np
    import torch

    from sesa_tpu_torch.ops.prec import net_precision
    from sesa_tpu_torch.train import Trainer, _flatten

    t_phase = time.perf_counter()
    out = {"card_vs_cpu": [_train_card_vs_cpu(mt, batch) for mt in TRAIN_TINY
                           for batch in (1, 2)]}

    # the flagship at full width in f32: default loss, Adam 1e-4, one batch
    cfg = {"model": FLAGSHIP_MODEL, "audio": {"chunk_size": TRAIN_CHUNK, "sample_rate": SR},
           "training": {"instruments": ["vocals", "other"], "target_instrument": "vocals"}}
    item = _train_item(TRAIN_CHUNK / SR)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer("bs_roformer", cfg, seed=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    seen = []
    probe_loss = trainer.loss_fn

    def probed_loss(recon, target):  # the mask's product with the mix, first in backward
        recon.register_hook(_tf32_probe(seen, "model output"))
        return probe_loss(recon, target)

    first = next(iter(_flatten(trainer.params["band_split"]).values()))
    handle = first.register_hook(_tf32_probe(seen, "band split (last in backward)"))
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    trainer.loss_fn = probed_loss
    try:
        losses_seen = [trainer.train_batch(item) for _ in range(TRAIN_WARMUP)]
        after_flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    finally:
        trainer.loss_fn = probe_loss
        handle.remove()
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    out["tf32_in_backward"] = [list(s) for s in seen]
    log(f"  train: TF32 flags (matmul, cudnn) inside backward: {seen}; after the step "
        f"{after_flags} (set True before)")
    if len(seen) != 2 * TRAIN_WARMUP or any(m or c for _, m, c in seen) \
            or after_flags != (True, True):
        raise RuntimeError(f"train: TF32 inside the backward pass {seen}, after {after_flags}")

    step_ms = []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses_seen.append(trainer.train_batch(item))
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    mix, target = trainer.make_batch(item)
    with torch.no_grad(), net_precision(None):
        loss_after = float(trainer.loss_fn(trainer.model.apply(trainer.params, trainer.config,
                                                               mix), target))
    del mix, target
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    before = losses_seen[TRAIN_WARMUP]
    n_params = sum(p.numel() for p in _flatten(trainer.params).values())
    out["flagship"] = dict(batch=[1, 2, TRAIN_CHUNK], params=n_params, setup_s=setup_s,
                           losses=losses_seen, loss_after=loss_after, step_ms=step_ms,
                           ms_per_step=float(np.mean(step_ms)), peak_gib=peak, card=gpu_line())
    log(f"  train flagship (dim {FLAGSHIP_MODEL['dim']}, depth {FLAGSHIP_MODEL['depth']}, "
        f"{n_params} params, f32, batch 1 x 2 x {TRAIN_CHUNK}, Adam 1e-4, multi_res_stft_l1): {out['flagship']['ms_per_step']:.1f} ms/step over "
        f"{TRAIN_STEPS} steps ({', '.join(f'{m:.1f}' for m in step_ms)}), peak "
        f"{peak:.2f} GiB, loss {before:.5f} -> {loss_after:.5f}; {out['flagship']['card']}")
    if not all(np.isfinite(losses_seen + [loss_after])) or not loss_after < before:
        raise RuntimeError(f"train flagship: losses {losses_seen} then {loss_after}")

    # checkpoint round trip into a fresh trainer
    work = tempfile.mkdtemp(prefix="sesa_train_")
    try:
        t0 = time.perf_counter()
        path = trainer.save(os.path.join(work, "flagship.npz"), extra={"phase": "train"})
        save_s = time.perf_counter() - t0
        fresh = Trainer("bs_roformer", cfg, seed=1)
        t0 = time.perf_counter()
        fresh.load(path)
        load_s = time.perf_counter() - t0
        size = os.path.getsize(path)
    finally:
        import shutil

        shutil.rmtree(work, ignore_errors=True)
    same = all(torch.equal(a, b) for a, b in zip(_flatten(trainer.params).values(),
                                                  _flatten(fresh.params).values()))
    next_a, next_b = trainer.train_batch(item), fresh.train_batch(item)
    out["checkpoint"] = dict(bytes=size, save_s=save_s, load_s=load_s, params_equal=same,
                             step=fresh.step, next_loss=[next_a, next_b])
    log(f"[train checkpoint] {json.dumps(out['checkpoint'])}")
    if not same or next_a != next_b or fresh.step != TRAIN_WARMUP + TRAIN_STEPS + 1:
        raise RuntimeError(f"train checkpoint: {out['checkpoint']}")
    del fresh
    torch.cuda.empty_cache()

    # validation of a seeded song through the port's demix
    track = _train_item(TRAIN_VAL_S, batched=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores = trainer.validate_track(track)
    torch.cuda.synchronize()
    out["validate_track"] = dict(seconds=time.perf_counter() - t0, song_s=TRAIN_VAL_S,
                                 si_snr=scores)
    log(f"[train validate_track] {json.dumps(out['validate_track'])}")
    if not all(np.isfinite(list(scores.values()))):
        raise RuntimeError(f"train validate_track: {scores}")
    del trainer
    torch.cuda.empty_cache()

    # the guard: bs_mamba2 in f32 reaches the mixer's kernels and K8, which
    # have no backward; the mixer's conv comes first
    from sesa_tpu_torch.ops.ssd import ssd_fused

    mamba = Trainer("bs_mamba2", {"model": TRAIN_MAMBA_MODEL,
                                  "training": {"instruments": ["vocals", "other"],
                                               "target_instrument": None}}, seed=0)
    reset_counts()
    try:
        mamba.train_batch(_train_item(2.0))
    except RuntimeError as e:
        guard = str(e)
    else:
        raise RuntimeError("train guard: a bs_mamba2 step on the card did not raise")
    k8_during = read_counts()["K8"] + read_counts()["MC"] + read_counts()["MG"]
    if "mamba_conv:" not in guard or "no backward" not in guard or k8_during:
        raise RuntimeError(f"train guard: {guard!r}, K8 and mixer launches {k8_during}")
    gen = torch.Generator().manual_seed(5)
    x, a, b, c = (t.requires_grad_(True) for t in ssd_inputs(gen, 2, 128, 4, torch.float32,
                                                               mamba.device))
    with torch.no_grad():
        y = ssd_fused(x, a, b, c)
    torch.cuda.synchronize()
    out["guard"] = dict(message=guard[:160], k8_launches_during_step=k8_during,
                        k8_launches_under_no_grad=read_counts()["K8"],
                        finite=bool(torch.isfinite(y).all()))
    log(f"[train guard] {json.dumps(out['guard'])}")
    if out["guard"]["k8_launches_under_no_grad"] != 1 or not out["guard"]["finite"]:
        raise RuntimeError(f"train guard: {out['guard']}")
    del mamba, x, a, b, c, y

    # the UI: the module imports without gradio; the launcher parses its arguments
    from sesa_tpu_torch import gui

    ui = dict(gradio_available=gui.GRADIO_AVAILABLE)
    if gui.GRADIO_AVAILABLE:
        ui["interface"] = type(gui.create_interface()).__name__
    r = sp.run([_sys.executable, "-m", "sesa_tpu_torch.main", "--help"], capture_output=True,
               text=True, timeout=120)
    ui["main_help_rc"] = r.returncode
    out["ui"] = ui
    log(f"[train ui] {json.dumps(ui)}")
    if r.returncode != 0 or "--ngrok-token" not in r.stdout:
        raise RuntimeError(f"train ui: python -m sesa_tpu_torch.main --help: {r.returncode} "
                           f"{r.stderr[-500:]}")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"  train: phase {out['wall_s']:.1f} s")
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
    phase_s = {}

    def timed(phase, fn, /, *args, **kwargs):
        """``fn(*args, **kwargs)``, its wall seconds kept as ``phase_s[phase]``."""
        t = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            phase_s[phase] = time.perf_counter() - t
            log(f"[phase] {phase}: {phase_s[phase]:.1f} s")

    out = dict(card=card, phase_s=phase_s, kernel_rows=timed("kernels", phase_kernels, only))
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
        out["flagship"], sessions["bs_roformer"] = timed(
            "flagship", drive_cli, work, "bs_roformer", FLAGSHIP_MODEL, song,
            expect(K1=layers * calls, K2=layers * calls), k1_modes=[layers * calls, 0, 0])
    blocks = MELCONF_MODEL["depth"] * (MELCONF_MODEL["time_conformer_depth"]
                                       + MELCONF_MODEL["freq_conformer_depth"])
    with tempfile.TemporaryDirectory() as work:
        out["melconf"], sessions["mel_band_conformer"] = timed(
            "melconf", drive_cli, work, "mel_band_conformer", MELCONF_MODEL, song,
            expect(K2=2 * blocks * calls, K4=blocks * calls, K5=blocks * calls))
    apollo_calls, apollo_layers = _model_calls(APOLLO_CHUNK, APOLLO_BATCH), APOLLO_MODEL["layer"]
    apollo_counts = {"K6": 3 * apollo_layers * apollo_calls, "K7": apollo_layers * apollo_calls}
    with tempfile.TemporaryDirectory() as work:
        out["apollo"], sessions["apollo"] = timed(
            "apollo", drive_cli, work, "apollo", APOLLO_MODEL, song, expect(**apollo_counts),
            chunk=APOLLO_CHUNK, batch=APOLLO_BATCH, stem="restored")
    out["chain"] = timed(
        "chain", phase_chain, sessions, song,
        expect(K1=layers * calls, K2=(layers + 2 * blocks) * calls, K4=blocks * calls,
               K5=blocks * calls, **apollo_counts))
    out["jobs"] = timed("jobs", phase_jobs, sessions, song, expect(
        K1=layers * calls, K2=(layers + 2 * blocks) * calls, K4=blocks * calls,
        K5=blocks * calls))
    out["int8"] = timed("int8", phase_int8, song, calls, layers, sessions["bs_roformer"])
    out["parity"] = [model_parity(mt, s.params, s.config, song) for mt, s in sessions.items()]
    per_call = {k: v // apollo_calls for k, v in apollo_counts.items()}
    got = {k: out["parity"][-1]["launches"][k] for k in per_call}
    if got != per_call:
        raise RuntimeError(f"apollo parity: launches {got} in one model call, expected {per_call}")
    out["melband"] = timed("melband", phase_melband, song)
    out["gates"] = timed("gates", phase_gates, song)
    out["ssd_op"] = timed("ssd_op", phase_ssd_op)
    out["profile"] = {mt: phase_profile(mt, s, song) for mt, s in sessions.items()}
    # the sessions above stay loaded for the second chain: the widths' models
    # load one at a time beside them
    out["widths"] = timed("widths", phase_widths, song, calls)
    # bench.py's own chain pair: SCNet's vocals (stem 3) and the mel-band
    # conformer's -> ensemble + phase fix -> Apollo
    out["scnet"], scnet_session = timed("scnet", phase_scnet, song)
    out["chain_scnet"] = timed(
        "chain_scnet", phase_chain,
        {"scnet": scnet_session, "mel_band_conformer": sessions["mel_band_conformer"],
         "apollo": sessions["apollo"]}, song,
        expect(K2=2 * blocks * calls, K4=blocks * calls, K5=blocks * calls, **apollo_counts),
        first="scnet", label="chain_scnet")
    log(f"  rtf_chain: {out['chain']['rtf_chain']:.2f} (bs_roformer + mel-band conformer), "
        f"{out['chain_scnet']['rtf_chain']:.2f} (scnet + mel-band conformer)")
    del scnet_session
    sessions.clear()
    torch.cuda.empty_cache()
    out["new_paths"] = timed("new_paths", phase_new_paths, song, calls)
    out["scnet_family"] = timed("scnet_family", phase_scnet_family, song, calls)
    out["melband_experimental"] = timed("melband_experimental", phase_melband_experimental, song)
    out["mdx_demucs"] = timed("mdx_demucs", phase_mdx_demucs, song)
    out["export"] = timed("export", phase_export)
    out["istft_repeats"] = timed("istft_repeats", istft_repeats)
    out["bandit_segm"] = timed("bandit_segm", phase_bandit_segm, song)
    out["swin_squim"] = timed("swin_squim", phase_swin_squim, song)
    out["app"] = timed("app", phase_app, song)
    out["train"] = timed("train", phase_train)
    out["mesh"] = timed("mesh", phase_mesh, song, calls, layers)
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
                "K8f32": runs["bs_mamba2_f32"]["k8_launches_by_dtype"]["f32"],
                "MC": runs["bs_mamba2"]["launches"]["MC"],
                "MG": runs["bs_mamba2"]["launches"]["MG"],
                "MCf32": runs["bs_mamba2_f32"]["launches"]["MC"],
                "MGf32": runs["bs_mamba2_f32"]["launches"]["MG"],
                "K1scnet": out["scnet_family"]["scnet_tran"]["launches"]["K1"],
                "K2scnet": out["scnet_family"]["scnet_tran"]["launches"]["K2"],
                "I8": out["int8"]["launches"]["I8"]}
    # the widths' rows: their CLI runs, or (K3 at D 48 and 96, K6 at d 1024) the
    # one model call of their GATE_PATHS entry
    widths = out["widths"]["runs"]
    gates = {g["model_type"]: g["launches"] for g in out["gates"]}
    launches.update({"K1dh128": widths["flagship_dh128"]["launches"]["K1"],
                     "K1dh48": widths["melband_dh48"]["launches"]["K1"],
                     "K4dh48": widths["melconf_dh48"]["launches"]["K4"],
                     "K6d768": widths["apollo_fd768"]["launches"]["K6"],
                     "K3dh48": gates["bs_roformer_experimental_hc_dh48"]["K3"],
                     "K3dh96": gates["bs_roformer_experimental_hc_dh96"]["K3"],
                     "K6d1024": gates["apollo_fd1024"]["K6"],
                     # K5 past 32 taps and K7 at the other head widths: the
                     # conformer at 33 taps and Apollo at 8 x 40 through cli.main,
                     # the rest from their GATE_PATHS model call
                     "K5k33": widths["melconf_k33"]["launches"]["K5"],
                     "K5k64": gates["mel_band_conformer_k64"]["K5"],
                     "K5k65": gates["mel_band_conformer_k65"]["K5"],
                     "K5k129": gates["mel_band_conformer_k129"]["K5"],
                     "K7dh16": gates["apollo_fd128"]["K7"],
                     "K7dh24": gates["apollo_fd192"]["K7"],
                     "K7dh25": gates["apollo_fd200"]["K7"],
                     "K7dh40": widths["apollo_fd320"]["launches"]["K7"],
                     # the routes no model had run before: their GATE_PATHS call
                     "K1dh32": gates["bs_roformer_dh32"]["K1"],
                     "K1dh96": gates["bs_roformer_dh96"]["K1"],
                     "K4dh32": gates["mel_band_conformer_dh32"]["K4"],
                     "K4dh128": gates["mel_band_conformer_dh128"]["K4"],
                     "K5k255": gates["mel_band_conformer_k255"]["K5"],
                     "K6d512": gates["apollo_fd512"]["K6"],
                     "K6d896": gates["apollo_fd896"]["K6"],
                     "K7dh64": gates["apollo_fd512"]["K7"],
                     "K7dh112": gates["apollo_fd896"]["K7"]})
    # K8's other sizes: their launches through the public ssd op
    launches.update(out["ssd_op"])
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
