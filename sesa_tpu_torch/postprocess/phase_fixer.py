"""Phase fixer: transfer vocal-model phase into an instrumental stem
(counterpart of sesa_tpu/postprocess/phase_fixer.py).

Behavioural spec: reference phase_fixer.py:6-109. STFT (2048/512 hann) of
source and target; a frequency-dependent blend factor (``base`` below
``low_cutoff``, ``base + scale`` above ``high_cutoff``, a linear ramp
between) mixes the phases; the result is wrapped to (−π, π], the magnitude is
kept from the target, and the signal is resynthesised at the source length.
All of it runs as tensor code where the inputs lie: on the card for tensors
that a separation left there.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from sesa_tpu_torch import get_device
from sesa_tpu_torch.ops.stft import hann_window, istft_ri, stft_ri
from sesa_tpu_torch.postprocess.ensemble import _check_weights, combine_stack_device

N_FFT, HOP = 2048, 512

# curated GUI model lists (reference phase_fixer.py:111-139)
SOURCE_MODELS = [
    "VOCALS-MelBand-Roformer (by Becruily)",
    "VOCALS-Mel-Roformer big beta 4 (by unwa)",
    "VOCALS-Melband-Roformer BigBeta5e (by unwa)",
    "VOCALS-big_beta6 (by Unwa)",
    "VOCALS-big_beta6X (by Unwa)",
    "VOCALS-MelBand-Roformer (by KimberleyJSN)",
    "VOCALS-MelBand-Roformer Kim FT (by Unwa)",
    "VOCALS-MelBand-Roformer Kim FT 2 (by Unwa)",
    "VOCALS-MelBand-Roformer Kim FT 2 Blendless (by unwa)",
    "VOCALS-Mel-Roformer FT 3 Preview (by unwa)",
    "VOCALS-BS-Roformer_1296 (by viperx)",
    "VOCALS-BS-Roformer_1297 (by viperx)",
    "VOCALS-BS-RoformerLargev1 (by unwa)",
    "bs_roformer_revive (by unwa)",
]

TARGET_MODELS = [
    "INST-MelBand-Roformer (by Becruily)",
    "INST-Mel-Roformer v1 (by unwa)",
    "INST-Mel-Roformer v2 (by unwa)",
    "inst_v1e (by unwa)",
    "INST-Mel-Roformer v1e+ (by unwa)",
    "Inst_GaboxV7 (by Gabox)",
    "INST-VOC-Mel-Roformer a.k.a. duality (by unwa)",
    "INST-VOC-Mel-Roformer a.k.a. duality v2 (by unwa)",
    "inst_gabox (by Gabox)",
    "inst_gaboxFlowersV10 (by Gabox)",
]

Audio = Union[np.ndarray, torch.Tensor]


def blend_factors(freqs: torch.Tensor, low_cutoff: float, high_cutoff: float,
                  base_factor: float, scale_factor: float) -> torch.Tensor:
    """Frequency-dependent phase blend factor (reference phase_fixer.py:6-23).

    Raises on low_cutoff >= high_cutoff like the reference (:11-12): the
    ramp's denominator would otherwise give NaN or garbage blends silently."""
    if low_cutoff >= high_cutoff:
        raise ValueError(f"low_cutoff ({low_cutoff}) must be less than high_cutoff "
                         f"({high_cutoff})")
    ramp = base_factor + scale_factor * (freqs - low_cutoff) / (high_cutoff - low_cutoff)
    f = torch.where(freqs < low_cutoff, base_factor, ramp)
    return torch.where(freqs > high_cutoff, base_factor + scale_factor, f)


def blend_spectra(s: torch.Tensor, t: torch.Tensor, sr: int, low_cutoff: float,
                  high_cutoff: float, base_factor: float, scale_factor: float) -> torch.Tensor:
    """Blend source phase into target magnitude on RI spectra (..., F, T, 2).

    The blend works on wrapped angles (like the reference), so bins whose
    angle sits at ±π are chaotically sensitive to STFT rounding: a property
    of the algorithm, not of the implementation."""
    n_fft = 2 * (s.shape[-3] - 1)
    src_phase = torch.atan2(s[..., 1], s[..., 0])
    tgt_phase = torch.atan2(t[..., 1], t[..., 0])
    tgt_mag = torch.sqrt(t[..., 0] ** 2 + t[..., 1] ** 2)

    freqs = torch.linspace(0.0, sr // 2, n_fft // 2 + 1, device=s.device)
    bf = blend_factors(freqs, low_cutoff, high_cutoff, base_factor, scale_factor)
    blended = (1.0 - bf)[:, None] * tgt_phase + bf[:, None] * src_phase
    blended = torch.remainder(blended + math.pi, 2 * math.pi) - math.pi
    return torch.stack([tgt_mag * torch.cos(blended), tgt_mag * torch.sin(blended)], dim=-1)


def _check_span(a: int, b: int) -> None:
    """The reference raises on any shape mismatch (phase_fixer.py:7-8); drift
    below one hop from decoders is tolerated, a real length gap refused:
    zero-padding seconds of output would masquerade as success."""
    if abs(a - b) > HOP:
        raise ValueError(f"source/target lengths differ by {abs(a - b)} samples ({a} vs {b}); "
                         "phase fixing requires the same audio span")


def _fix(src: torch.Tensor, tgt: torch.Tensor, sr, low_cutoff, high_cutoff, base_factor,
         scale_factor, length: int) -> torch.Tensor:
    window = hann_window(N_FFT, device=src.device)
    s = stft_ri(src, N_FFT, HOP, window)
    t = stft_ri(tgt, N_FFT, HOP, window)
    fixed = blend_spectra(s, t, int(sr), float(low_cutoff), float(high_cutoff),
                          float(base_factor), float(scale_factor))
    return istft_ri(fixed, N_FFT, HOP, window, length=length)


def phase_fix_arrays(source: Audio, target: Audio, sr: int, low_cutoff: float = 500.0,
                     high_cutoff: float = 9000.0, base_factor: float = 0.25,
                     scale_factor: float = 1.4, return_device: bool = False,
                     device=None) -> Audio:
    """Blend source phase into target: (ch, T) arrays -> fixed (ch, T_src).

    ``source`` and ``target`` are numpy arrays or tensors. Tensors are used
    where they lie; numpy inputs are moved to CUDA unless ``device="cpu"``.
    ``return_device=True`` returns the tensor without the host copy, so that
    a separation that follows takes it as it is."""
    length = source.shape[-1]
    _check_span(source.shape[-1], target.shape[-1])
    tmin = min(source.shape[-1], target.shape[-1])
    tensors = [a for a in (source, target) if isinstance(a, torch.Tensor)]
    dev = tensors[0].device if tensors and device is None else get_device(device)
    src = torch.as_tensor(source[..., :tmin]).to(device=dev, dtype=torch.float32)
    tgt = torch.as_tensor(target[..., :tmin]).to(device=dev, dtype=torch.float32)
    out = _fix(src, tgt, sr, low_cutoff, high_cutoff, base_factor, scale_factor, length)
    return out if return_device else out.cpu().numpy()


def ensemble_phase_fix_device(source: torch.Tensor, waves: Sequence[torch.Tensor], sr: int,
                              method: str = "avg_wave", weights=None,
                              low_cutoff: float = 500.0, high_cutoff: float = 9000.0,
                              base_factor: float = 0.25,
                              scale_factor: float = 1.4) -> torch.Tensor:
    """Waveform ensemble + phase fix in one function on the stems' device.

    ``source`` is the mix (the phase donor of the auto-ensemble flow);
    ``waves`` are the models' stems, tensors from a separation with
    ``transport="device"``. Returns a tensor at the source length, like
    ``phase_fix_arrays(..., return_device=True)``."""
    if method.endswith("_fft"):
        raise ValueError(f"fused ensemble+phase-fix supports waveform methods only, "
                         f"got {method!r}")
    if not waves:
        raise ValueError("no input waveforms")
    _check_weights(weights, len(waves))
    length = source.shape[-1]
    tmin = min([w.shape[-1] for w in waves] + [length])
    if abs(length - tmin) > HOP:
        raise ValueError(f"source/stem lengths differ by {abs(length - tmin)} samples; "
                         "phase fixing requires the same audio span")
    dev = waves[0].device
    src = torch.as_tensor(source[..., :tmin]).to(device=dev, dtype=torch.float32)
    stack = torch.stack([torch.as_tensor(w[..., :tmin]).to(device=dev, dtype=torch.float32)
                         for w in waves])
    ens = combine_stack_device(stack, method, weights)
    return _fix(src, ens, sr, low_cutoff, high_cutoff, base_factor, scale_factor, length)


def process_phase_fix(source_file: str, target_file: str, output_folder: str,
                      low_cutoff: float = 500.0, high_cutoff: float = 9000.0,
                      scale_factor: float = 1.4, output_format: str = "flac",
                      device=None) -> Tuple[Optional[str], str]:
    """File-level surface matching reference phase_fixer.py:89-109: returns
    (output path or None, message)."""
    from sesa_tpu_torch.audio_io import read_audio, write_audio

    os.makedirs(output_folder, exist_ok=True)
    try:
        src, sr_s = read_audio(source_file)
        tgt, sr_t = read_audio(target_file)
        if sr_s != sr_t:
            raise ValueError("Sample rates of source and target audio files must match.")
        fixed = phase_fix_arrays(src, tgt, sr_s, low_cutoff, high_cutoff,
                                 scale_factor=scale_factor, device=device)
        name = os.path.splitext(os.path.basename(target_file))[0]
        for tag in ("_other", "_vocals", "_instrumental", "_Other", "_Vocals", "_Instrumental"):
            name = name.replace(tag, "")
        ext = ".flac" if output_format == "flac" else ".wav"
        out_path = os.path.join(output_folder, f"{name.strip()} (Fixed Instrumental){ext}")
        written = write_audio(out_path, fixed, sr_s,
                              subtype="PCM_16" if output_format == "flac" else "FLOAT")
        return written, "Phase fix completed successfully!"
    except (OSError, ValueError, RuntimeError) as e:
        return None, f"Error during phase fix: {e}"
