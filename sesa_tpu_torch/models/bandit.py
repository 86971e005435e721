"""BandIt v1, the multi-mask multi-source band-split RNN (BSRNN, DnR)
(counterpart of sesa_tpu/models/bandit.py).

Like bandit_v2, with v1's details: the channels fold into the batch inside
the core, and the band-split features pack as (re/im, bandwidth), the real
bins then the imaginary ones, while the masks unpack as (bandwidth, re/im).
The same GLU mask heads and window-energy-normalised STFT as v2, and the
same parameter tree; the checkpoint keys differ (``convert_torch``).

The model runs in f32 only: its ``apply`` takes no ``compute_dtype``, as the
JAX function has none.
"""

from __future__ import annotations

import torch

from sesa_tpu_torch.models.bandit_v2 import (analysis, band_split, init_tree, lstm_keys,
                                             musical_band_specs, seqband_apply, synthesis)
from sesa_tpu_torch.models.bs_roformer import _make_take
from sesa_tpu_torch.ops.prec import net_precision


def _kwargs(config):
    kw = dict(in_channel=1, stems=["speech", "music", "effects"],
              band_specs="musical", n_bands=64, n_sqm_modules=12, emb_dim=128,
              rnn_dim=256, mlp_dim=512, n_fft=2048, win_length=2048,
              hop_length=512, fs=44100, use_freq_weights=True,
              complex_mask=True)
    kw.update({k: v for k, v in dict(config.model).items() if k in kw})
    return kw


def _specs(kw):
    if "musical" not in str(kw["band_specs"]):
        raise NotImplementedError(
            f"bandit band_specs={kw['band_specs']!r}: only the musical band layout is "
            "implemented (the registry's bandit checkpoint uses mus64)")
    return musical_band_specs(kw["n_fft"], kw["fs"], kw["n_bands"])


def init(generator: torch.Generator, config):
    """Random parameters drawn on the CPU from ``generator`` (the numbers
    differ from the JAX package's init; the tree is the same)."""
    kw = _kwargs(config)
    specs, _ = _specs(kw)
    return init_tree(generator, specs, kw["stems"], kw["n_sqm_modules"], kw["emb_dim"],
                     kw["rnn_dim"], kw["mlp_dim"], kw["in_channel"])


def band_features(spec: torch.Tensor, s: int, e: int) -> torch.Tensor:
    """Bins [s, e) of (B', F, T, 2) packed as (B', T, 2*bw): the real bins,
    then the imaginary ones."""
    return spec[:, s:e].permute(0, 2, 3, 1).reshape(spec.shape[0], spec.shape[2], -1)


def apply(params, config, x: torch.Tensor) -> torch.Tensor:
    """(B, ch, T) -> (B, stems, ch, T), in f32."""
    with net_precision(None):
        kw = _kwargs(config)
        specs, freq_weights = _specs(kw)
        b, ch, t_samples = x.shape
        spec, window, scale = analysis(x, kw)  # (B', F, T, 2)
        z = band_split(params, spec, specs, band_features)
        q = seqband_apply(params["seqband"], z)
        return synthesis(params, kw, specs, freq_weights, q, spec, window, scale, b, ch, t_samples)


def convert_torch(state_dict, config):
    """Key scheme: bsrnn.band_split.norm_fc_modules.{i}.{norm,fc},
    bsrnn.tf_model.seqband.{j}.{norm,rnn,fc} at consecutive j,
    bsrnn.mask_estim.{stem}.norm_mlp.{i}.{norm,hidden.0,output.0}. Every key
    is consumed (the STFT modules' and ``freq_weights`` buffers are
    skipped); leftovers raise."""
    kw = _kwargs(config)
    specs, _ = _specs(kw)
    sd, used, take = _make_take({k.replace("._orig_mod", ""): v for k, v in state_dict.items()})

    def wb(prefix):
        return {"weight": take(f"{prefix}.weight"), "bias": take(f"{prefix}.bias")}

    band_split_p = [{"norm": wb(f"bsrnn.band_split.norm_fc_modules.{i}.norm"),
                     "fc": wb(f"bsrnn.band_split.norm_fc_modules.{i}.fc")}
                    for i in range(len(specs))]
    # v1's SeqBandModellingModule is a ModuleList with consecutive entries
    # (reference bandit/core/model/bsrnn/tfmodel.py:111-137), unlike v2's
    # Sequential with Transpose placeholders at the odd slots
    seqband = [{"norm": wb(f"bsrnn.tf_model.seqband.{j}.norm"),
                "lstm": lstm_keys(take, f"bsrnn.tf_model.seqband.{j}.rnn"),
                "fc": wb(f"bsrnn.tf_model.seqband.{j}.fc")}
               for j in range(2 * kw["n_sqm_modules"])]
    mask_estim = {stem: [{"norm": wb(f"bsrnn.mask_estim.{stem}.norm_mlp.{i}.norm"),
                          "hidden": wb(f"bsrnn.mask_estim.{stem}.norm_mlp.{i}.hidden.0"),
                          "output": wb(f"bsrnn.mask_estim.{stem}.norm_mlp.{i}.output.0")}
                         for i in range(len(specs))]
                  for stem in kw["stems"]}

    unused = {k for k in set(sd) - used
              if not k.startswith(("stft.", "istft.", "bsrnn.stft", "bsrnn.istft"))
              and "freq_weights" not in k}
    if unused:
        raise ValueError(f"unconsumed checkpoint keys: {sorted(unused)[:8]} ...")
    return {"band_split": band_split_p, "seqband": seqband, "mask_estim": mask_estim}
