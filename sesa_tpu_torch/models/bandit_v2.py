"""BandIt v2, the band-split RNN with a musical band layout (cinematic 3-stem)
(counterpart of sesa_tpu/models/bandit_v2.py).

Stereo input is processed as independent mono channels. Window-energy-
normalised STFT (constant padding, scaled by 1/sqrt(sum(win^2))) -> per-band
LayerNorm + Linear embeddings over a 64-band musical (octave-spaced,
overlapping) filterbank -> 12 x [time BiLSTM, band BiLSTM] residual modules
-> per-stem, per-band LayerNorm / MLP / GLU complex masks, scatter-added over
the overlaps with the normalised filterbank weights -> mask x mixture ->
iSTFT. A band packs its bins as (bandwidth, re/im) interleaved.

The model runs in f32 only: its ``apply`` takes no ``compute_dtype``, as the
JAX function has none, so a bf16 session calls it on the f32 weights
(``runtime/session.py``). The per-band loops are copied as JAX has them.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from sesa_tpu_torch.models import layers as L
from sesa_tpu_torch.models.bs_roformer import _make_take
from sesa_tpu_torch.ops.prec import net_precision
from sesa_tpu_torch.ops.stft import hann_window, istft_ri, stft_ri


def hz_to_midi(f):
    return 12.0 * np.log2(np.maximum(np.asarray(f, dtype=np.float64), 1e-12) / 440.0) + 69.0


def midi_to_hz(m):
    return 440.0 * 2.0 ** ((np.asarray(m, dtype=np.float64) - 69.0) / 12.0)


def musical_band_specs(n_fft: int, fs: int, n_bands: int):
    """Octave-spaced overlapping bands (reference utils.py:324-356,90-124).

    Returns (band_specs [(start, end)), freq_weights [per-band (bw,)]).
    """
    n_freqs = n_fft // 2 + 1
    df = fs / n_fft
    f_max = fs / 2
    f_min = fs / n_fft

    n_octaves = np.log2(f_max / f_min)
    bandwidth_mult = 2.0 ** (n_octaves / n_bands)

    low_midi = max(0.0, float(hz_to_midi(f_min)))
    high_midi = float(hz_to_midi(f_max))
    hz_pts = midi_to_hz(np.linspace(low_midi, high_midi, n_bands))

    low_bins = np.floor(hz_pts / bandwidth_mult / df).astype(int)
    high_bins = np.ceil(hz_pts * bandwidth_mult / df).astype(int)

    fb = np.zeros((n_bands, n_freqs))
    for i in range(n_bands):
        fb[i, low_bins[i] : high_bins[i] + 1] = 1.0
    fb[0, : low_bins[0]] = 1.0
    fb[-1, high_bins[-1] + 1 :] = 1.0

    weight_per_bin = fb.sum(axis=0, keepdims=True)
    normalized = fb / weight_per_bin

    band_specs, freq_weights = [], []
    for i in range(n_bands):
        active = np.nonzero(fb[i])[0]
        if len(active) == 0:
            continue
        start, end = int(active[0]), int(active[-1]) + 1
        band_specs.append((start, end))
        freq_weights.append(normalized[i, start:end].astype(np.float32))
    return band_specs, freq_weights


def _kwargs(config):
    kw = dict(in_channels=1, stems=["speech", "music", "effects"], n_bands=64,
              n_sqm_modules=12, emb_dim=128, rnn_dim=256, mlp_dim=512,
              n_fft=2048, win_length=2048, hop_length=512, fs=44100,
              use_freq_weights=True, complex_mask=True)
    src = dict(config.kwargs) if hasattr(config, "kwargs") and config.kwargs else dict(config.model)
    kw.update({k: v for k, v in src.items() if k in kw})
    if kw["in_channels"] != 1:
        # apply() folds audio channels into the batch and treats the
        # spectral channel axis as 1 throughout; accepting a different
        # in_channels would initialise weights the forward cannot run
        raise NotImplementedError(
            f"bandit_v2 in_channels={kw['in_channels']} is not supported: "
            "the port (like every released checkpoint) runs per-channel "
            "with in_channels=1")
    return kw


# --------------------------------------------------------------------------
# init (shared with bandit v1, whose tree is the same)
# --------------------------------------------------------------------------

def init_tree(generator: torch.Generator, specs, stems, n_sqm_modules, emb, rnn_dim, mlp,
              in_ch=1):
    """Random parameters drawn on the CPU from ``generator`` (the numbers
    differ from the JAX package's init; the tree is the same)."""
    def lin(ci, co):
        return {"weight": L.kaiming_uniform((co, ci), ci, generator),
                "bias": L.kaiming_uniform((co,), ci, generator)}

    def lstm_dir(d, h):
        return {"weight_ih": L.kaiming_uniform((4 * h, d), h, generator),
                "weight_hh": L.kaiming_uniform((4 * h, h), h, generator),
                "bias_ih": L.kaiming_uniform((4 * h,), h, generator),
                "bias_hh": L.kaiming_uniform((4 * h,), h, generator)}

    def norm(c):
        return {"weight": torch.ones(c), "bias": torch.zeros(c)}

    band_split = [{"norm": norm(in_ch * (e - s) * 2), "fc": lin(in_ch * (e - s) * 2, emb)}
                  for s, e in specs]
    seqband = [{"norm": norm(emb),
                "lstm": {"fwd": lstm_dir(emb, rnn_dim), "bwd": lstm_dir(emb, rnn_dim)},
                "fc": lin(2 * rnn_dim, emb)}
               for _ in range(2 * n_sqm_modules)]
    mask_estim = {stem: [{"norm": norm(emb), "hidden": lin(emb, mlp),
                          "output": lin(mlp, (e - s) * in_ch * 2 * 2)}  # Linear + GLU
                         for s, e in specs]
                  for stem in stems}
    return {"band_split": band_split, "seqband": seqband, "mask_estim": mask_estim}


def init(generator: torch.Generator, config):
    kw = _kwargs(config)
    specs, _ = musical_band_specs(kw["n_fft"], kw["fs"], kw["n_bands"])
    return init_tree(generator, specs, kw["stems"], kw["n_sqm_modules"], kw["emb_dim"],
                     kw["rnn_dim"], kw["mlp_dim"], kw["in_channels"])


# --------------------------------------------------------------------------
# apply (the parts bandit v1 shares)
# --------------------------------------------------------------------------

def analysis(x: torch.Tensor, kw):
    """(B, ch, T) -> the window-energy-normalised spectrum (B*ch, F, frames, 2),
    the window and the scale (torchaudio Spectrogram(normalized=True))."""
    b, ch, t_samples = x.shape
    window = hann_window(kw["win_length"], device=x.device)
    scale = 1.0 / torch.sqrt(torch.sum(window * window))
    spec = stft_ri(x.reshape(b * ch, t_samples).float(), kw["n_fft"], kw["hop_length"], window,
                   win_length=kw["win_length"], pad_mode="constant") * scale
    return spec, window, scale


def seqband_apply(layers, z: torch.Tensor) -> torch.Tensor:
    """(B', n_bands, T, emb): residual LayerNorm -> BiLSTM -> Linear modules,
    alternating over time and over bands; an even number of modules restores
    the layout."""
    for p in layers:
        zn = L.layer_norm(z, p["norm"])
        bb, d1, d2, emb = zn.shape
        out = L.bilstm(zn.reshape(bb * d1, d2, emb), p["lstm"])
        out = L.linear(out, p["fc"])
        z = (z + out.reshape(bb, d1, d2, emb)).transpose(1, 2)  # Transpose(1, 2) after every module
    return z


def mask_head(p, qb: torch.Tensor, bw: int) -> torch.Tensor:
    """One stem's mask head of one band: (B', T, emb) -> (B', bw, T, 2), the
    GLU output unpacked as (bandwidth, re/im)."""
    h = L.layer_norm(qb, p["norm"])
    h = torch.tanh(L.linear(h, p["hidden"]))
    o = L.glu(L.linear(h, p["output"]))  # (B', T, bw*2)
    return o.reshape(o.shape[0], o.shape[1], bw, 2).transpose(1, 2)


def synthesis(params, kw, specs, freq_weights, q, spec, window, scale, b, ch, t_samples):
    """Per stem: the masks of every band, weighted by the normalised
    filterbank and added over the overlaps in f32, times the mixture, then
    the iSTFT. (B, stems, ch, T)."""
    weighted = kw["use_freq_weights"] and freq_weights is not None
    if weighted:  # every band's weights in one copy to the device
        fw = torch.as_tensor(np.concatenate(freq_weights), device=spec.device)
        offsets = np.cumsum([0] + [e - s for s, e in specs])
    outputs = []
    for stem in kw["stems"]:
        mask = torch.zeros_like(spec)  # (B', F, T, 2)
        for i, (s, e) in enumerate(specs):
            o = mask_head(params["mask_estim"][stem][i], q[:, i], e - s)
            if weighted:
                o = o * fw[offsets[i]:offsets[i + 1], None, None]
            mask[:, s:e] += o
        sr, si = spec[..., 0], spec[..., 1]
        mr, mi = mask[..., 0], mask[..., 1]
        est = torch.stack([sr * mr - si * mi, sr * mi + si * mr], dim=-1) / scale
        wav = istft_ri(est, kw["n_fft"], kw["hop_length"], window,
                       win_length=kw["win_length"], length=t_samples)
        outputs.append(wav.reshape(b, ch, t_samples))
    return torch.stack(outputs, dim=1)


def band_features(spec: torch.Tensor, s: int, e: int) -> torch.Tensor:
    """Bins [s, e) of (B', F, T, 2) packed as (B', T, bw*2): (bandwidth,
    re/im) interleaved."""
    return spec[:, s:e].transpose(1, 2).reshape(spec.shape[0], spec.shape[2], -1)


def band_split(params, spec: torch.Tensor, specs, features) -> torch.Tensor:
    """Per band: LayerNorm -> Linear of the band's bins packed by
    ``features(spec, start, end)``; stacked to (B', n_bands, T, emb)."""
    return torch.stack([L.linear(L.layer_norm(features(spec, s, e), p["norm"]), p["fc"])
                        for p, (s, e) in zip(params["band_split"], specs)], dim=1)


def apply(params, config, x: torch.Tensor) -> torch.Tensor:
    """(B, ch, T) -> (B, stems, ch, T), in f32."""
    with net_precision(None):
        kw = _kwargs(config)
        specs, freq_weights = musical_band_specs(kw["n_fft"], kw["fs"], kw["n_bands"])
        b, ch, t_samples = x.shape
        spec, window, scale = analysis(x, kw)  # (B', F, T, 2)
        z = band_split(params, spec, specs, band_features)
        q = seqband_apply(params["seqband"], z)
        return synthesis(params, kw, specs, freq_weights, q, spec, window, scale, b, ch, t_samples)


# --------------------------------------------------------------------------
# torch checkpoint conversion
# --------------------------------------------------------------------------

def lstm_keys(take, prefix):
    """nn.LSTM's single-layer bidirectional keys under ``prefix``."""
    return {d: {wn: take(f"{prefix}.{wn}_l0{suf}")
                for wn in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}
            for d, suf in (("fwd", ""), ("bwd", "_reverse"))}


def convert_torch(state_dict, config):
    """Reference bandit_v2 state dict -> the port's tree. Key scheme: band
    split ``band_split.norm_fc_modules.{i}.combined.{0,1}``, RNN modules at
    the even slots of the ``tf_model.seqband`` Sequential, mask heads read
    from their ``combined.*`` copies. Every key is consumed (the attribute
    aliases of the mask heads and the ``freq_weights`` buffers, which are
    recomputed, are skipped); leftovers raise."""
    kw = _kwargs(config)
    specs, _ = musical_band_specs(kw["n_fft"], kw["fs"], kw["n_bands"])
    sd, used, take = _make_take({k.replace("._orig_mod", ""): v  # torch.compile remnants
                                 for k, v in state_dict.items()})

    def wb(prefix):
        return {"weight": take(f"{prefix}.weight"), "bias": take(f"{prefix}.bias")}

    band_split_p = [{"norm": wb(f"band_split.norm_fc_modules.{i}.combined.0"),
                     "fc": wb(f"band_split.norm_fc_modules.{i}.combined.1")}
                    for i in range(len(specs))]
    seqband = [{"norm": wb(f"tf_model.seqband.{j}.norm"),
                "lstm": lstm_keys(take, f"tf_model.seqband.{j}.rnn"),
                "fc": wb(f"tf_model.seqband.{j}.fc")}
               for j in range(0, 4 * kw["n_sqm_modules"], 2)]  # RNNs at even Sequential slots
    mask_estim = {stem: [{"norm": wb(f"mask_estim.{stem}.norm_mlp.{i}.combined.0"),
                          "hidden": wb(f"mask_estim.{stem}.norm_mlp.{i}.combined.1.0"),
                          "output": wb(f"mask_estim.{stem}.norm_mlp.{i}.combined.2.0")}
                         for i in range(len(specs))]
                  for stem in kw["stems"]}

    # v2's NormMLP registers its norm / hidden / output modules both as
    # attributes and inside ``combined`` (reference bandit_v2/maskestim.py:
    # 31-79), so real checkpoints carry the same tensors twice
    alias = re.compile(r"\.norm_mlp\.\d+\.(norm|hidden|output)\.")
    unused = {k for k in set(sd) - used
              if not k.startswith(("stft.", "istft.")) and "freq_weights" not in k
              and not alias.search(k)}
    if unused:
        raise ValueError(f"unconsumed checkpoint keys: {sorted(unused)[:8]} ...")
    return {"band_split": band_split_p, "seqband": seqband, "mask_estim": mask_estim}
