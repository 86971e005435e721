"""BS-RoFormer, the band-split RoPE transformer (counterpart of
sesa_tpu/models/bs_roformer.py).

Forward: STFT -> pack (freq·stereo·complex) features -> per-band linear
embed (grouped products, see ``ops/bands.py``) -> depth × [optional linear
transformer over the flattened grid, time transformer over frames, freq
transformer over bands] with RoPE shared across depth -> final RMSNorm ->
per-stem mask estimator -> complex mask × STFT -> iSTFT.

Parameters are a plain tree of tensors laid out as the JAX package's tree
(grouped band weights, torch-layout projections), so
``convert/from_jax.py`` is mostly a copy. A Python loop over depth replaces
the JAX ``lax.scan``.

The experimental variants are spec fields: ``value_residual`` (config key
``use_value_residual_learning``) lerps each later depth layer's V toward the
first depth layer's, ``num_residual_streams > 1`` wraps attention and
feed-forward in hyper-connections, ``experimental_forward`` selects the
experimental Transformer.forward alone (``bs_roformer_experimental.py``).
``use_fno`` adds an FNO1d stage after each depth layer's freq transformer
(``fno_modes`` lowest frames' DFT modes, full channel mixing, a pointwise
bypass, GELU and the residual).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from sesa_tpu_torch import to_device
from sesa_tpu_torch.models import hyper_connections as HC
from sesa_tpu_torch.models import roformer_core as core
from sesa_tpu_torch.models.layers import rms_norm
from sesa_tpu_torch.ops import bands as B
from sesa_tpu_torch.ops.fft import irdft_tables, rdft_tables
from sesa_tpu_torch.ops.prec import net_precision
from sesa_tpu_torch.ops.rope import default_freqs, rope_tables
from sesa_tpu_torch.ops.stft import hann_window, istft_ri, stft_ri
from sesa_tpu_torch.tree import tree_map

DEFAULT_FREQS_PER_BANDS = (
    2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
    2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
    2, 2, 2, 2,
    4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4,
    12, 12, 12, 12, 12, 12, 12, 12,
    24, 24, 24, 24, 24, 24, 24, 24,
    48, 48, 48, 48, 48, 48, 48, 48,
    128, 129,
)


@dataclasses.dataclass(frozen=True)
class RoformerSpec:
    """Static architecture spec shared by the roformer family."""

    dim: int
    depth: int
    stereo: bool = False
    num_stems: int = 1
    time_transformer_depth: int = 2
    freq_transformer_depth: int = 2
    linear_transformer_depth: int = 0
    dim_head: int = 64
    heads: int = 8
    stft_n_fft: int = 2048
    stft_hop_length: int = 512
    stft_win_length: int = 2048
    stft_normalized: bool = False
    mask_estimator_depth: int = 2
    mlp_expansion_factor: int = 4
    skip_connection: bool = False
    band_feats: Tuple[tuple, ...] = ()
    match_input_audio_length: bool = False
    value_residual: bool = False
    num_residual_streams: int = 1
    use_fno: bool = False
    fno_modes: int = 16
    experimental_forward: bool = False
    # the mel files' MLP constructor (mel_band_roformer, mel_band_conformer) has
    # mask_estimator_depth hidden layers; the bs file's has one fewer
    mel_mlp_convention: bool = False

    @property
    def mask_hidden_layers(self) -> int:
        return self.mask_estimator_depth - 1 + int(self.mel_mlp_convention)

    @property
    def audio_channels(self) -> int:
        return 2 if self.stereo else 1

    @property
    def num_freqs(self) -> int:
        return self.stft_n_fft // 2 + 1

    @property
    def num_features(self) -> int:
        return self.num_freqs * self.audio_channels * 2

    def band_plan(self) -> B.BandPlan:
        return _band_plan(self.band_feats, self.num_features)


@functools.lru_cache(maxsize=8)
def _band_plan(band_feats, num_features) -> B.BandPlan:
    return B.make_band_plan([np.asarray(f, dtype=np.int32) for f in band_feats],
                            num_features)


_IGNORED_CONFIG_KEYS = {
    "multi_stft_resolution_loss_weight", "multi_stft_resolutions_window_sizes",
    "multi_stft_hop_size", "multi_stft_normalized", "multi_stft_window_fn",
    "stft_window_fn", "attn_dropout", "ff_dropout", "flash_attn",
    "use_torch_checkpoint", "sage_attention", "dim_freqs_in", "debug",
    "use_shared_bias", "norm_output",
}


def spec_from_config(model_cfg) -> RoformerSpec:
    """BSRoformer(**config.model) equivalent (reference utils.py:104-106)."""
    cfg = {k: v for k, v in dict(model_cfg).items() if k not in _IGNORED_CONFIG_KEYS}
    if "use_value_residual_learning" in cfg:
        cfg["value_residual"] = bool(cfg.pop("use_value_residual_learning"))
    freqs_per_bands = tuple(cfg.pop("freqs_per_bands", DEFAULT_FREQS_PER_BANDS))
    ch = 2 if bool(cfg.get("stereo", False)) else 1
    n_fft = int(cfg.get("stft_n_fft", 2048))
    if sum(freqs_per_bands) != n_fft // 2 + 1:
        raise ValueError(f"bands must cover {n_fft // 2 + 1} freqs, got {sum(freqs_per_bands)}")
    widths = [2 * f * ch for f in freqs_per_bands]
    feats = tuple(tuple(f.tolist()) for f in B.contiguous_band_feats(widths))
    return RoformerSpec(band_feats=feats, **cfg)


def _fno_init(generator: torch.Generator, dim: int, modes: int):
    s = 1.0 / dim
    return {
        "w_re": s * torch.randn((modes, dim, dim), generator=generator),
        "w_im": s * torch.randn((modes, dim, dim), generator=generator),
        "bypass_w": s * torch.randn((dim, dim), generator=generator),
        "bypass_b": torch.zeros(dim),
    }


def _fno_apply(p, x: torch.Tensor) -> torch.Tensor:
    """FNO1d stage along the frame axis: x (B, Tf, NB, D) -> the same shape
    (sesa_tpu/models/bs_roformer.py:173-202).

    A spectral convolution over the lowest ``modes`` rDFT modes of the
    frames with full channel mixing, plus a pointwise bypass, GELU and the
    residual. The truncated DFT is a product with the first ``modes``
    columns (rows) of the DFT tables, rounded to x's dtype as the JAX stage
    rounds them: in bf16 every product takes bf16 operands.
    """
    t = x.shape[1]
    modes = p["w_re"].shape[0]
    c, s = rdft_tables(t)
    ci, si = irdft_tables(t)

    def table(a):
        return to_device(a, x.device).to(x.dtype)

    cm, sm, cim, sim = table(c[:, :modes]), table(s[:, :modes]), table(ci[:modes]), table(si[:modes])
    xr = torch.einsum("btnd,tk->bknd", x, cm)
    xi = torch.einsum("btnd,tk->bknd", x, sm)
    yr = (torch.einsum("bknd,kde->bkne", xr, p["w_re"])
          - torch.einsum("bknd,kde->bkne", xi, p["w_im"]))
    yi = (torch.einsum("bknd,kde->bkne", xr, p["w_im"])
          + torch.einsum("bknd,kde->bkne", xi, p["w_re"]))
    spectral = (torch.einsum("bknd,kt->btnd", yr, cim)
                + torch.einsum("bknd,kt->btnd", yi, sim))
    bypass = x @ p["bypass_w"] + p["bypass_b"]
    return x + torch.nn.functional.gelu(spectral + bypass)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init_from_spec(generator: torch.Generator, spec: RoformerSpec,
                   transformer_norm_output: bool = False, final_norm: bool = True):
    """Random parameters drawn on the CPU from ``generator`` (torch-style
    fan-in uniform; the numbers differ from the JAX package's init)."""
    plan = spec.band_plan()
    layers = []
    for layer_index in range(spec.depth):
        # the mix projection exists only after the first depth layer
        vr = spec.value_residual and layer_index > 0
        layer = {}
        if spec.linear_transformer_depth > 0:
            layer["linear"] = core.transformer_init(
                generator, spec.dim, spec.linear_transformer_depth, spec.heads,
                spec.dim_head, norm_output=transformer_norm_output, linear_attn=True)
        for axis, depth in (("time", spec.time_transformer_depth),
                            ("freq", spec.freq_transformer_depth)):
            layer[axis] = core.transformer_init(
                generator, spec.dim, depth, spec.heads, spec.dim_head,
                norm_output=transformer_norm_output, value_residual=vr,
                num_residual_streams=spec.num_residual_streams)
        if spec.use_fno:
            layer["fno"] = _fno_init(generator, spec.dim, spec.fno_modes)
        layers.append(layer)
    params = {
        "band_split": B.band_split_init(generator, plan, spec.dim),
        "layers": layers,
        "mask_estimators": [
            B.mask_estimator_init(generator, plan, spec.dim, spec.mask_hidden_layers,
                                  spec.mlp_expansion_factor)
            for _ in range(spec.num_stems)],
        "rope_time_freqs": torch.from_numpy(default_freqs(spec.dim_head)),
        "rope_freq_freqs": torch.from_numpy(default_freqs(spec.dim_head)),
    }
    if final_norm:
        params["final_norm_gamma"] = torch.ones(spec.dim)
    return params


def init(generator: torch.Generator, config):
    return init_from_spec(generator, spec_from_config(config.model))


# --------------------------------------------------------------------------
# apply
# --------------------------------------------------------------------------

def apply_from_spec(params, spec: RoformerSpec, x: torch.Tensor, compute_dtype=None):
    """x (B, ch, T) -> (B, num_stems, ch, T).

    ``compute_dtype=torch.bfloat16`` runs the band split, transformers and
    mask estimators in bf16 (kernels K1 and K2 on CUDA) while the STFT, mask
    multiply and iSTFT stay f32.
    """
    with net_precision(compute_dtype) as dtype:
        plan = spec.band_plan()
        b, ch, t = x.shape
        if ch != spec.audio_channels:
            raise ValueError(f"expected {spec.audio_channels} channels, got {ch}")

        window = hann_window(spec.stft_win_length, device=x.device)
        s = stft_ri(x, spec.stft_n_fft, spec.stft_hop_length, window,
                    win_length=spec.stft_win_length, normalized=spec.stft_normalized)
        tf = s.shape[-2]
        # pack (f, s, c) minor-to-major order: feature = (f*ch + s)*2 + c
        sp = s.permute(0, 3, 2, 1, 4).reshape(b, tf, spec.num_features)

        nb = plan.num_bands
        # RoPE tables in f32, then cast to the compute dtype with everything else
        rope_time = rope_tables(params["rope_time_freqs"].float(), tf)
        rope_freq = rope_tables(params["rope_freq_freqs"].float(), nb)
        if dtype != torch.float32:
            params = tree_map(lambda p: p.to(dtype), params)
            rope_time = tuple(r.to(dtype) for r in rope_time)
            rope_freq = tuple(r.to(dtype) for r in rope_freq)
        xb = B.band_split_apply(plan, params["band_split"], sp.to(dtype))

        streams = spec.num_residual_streams
        vr_forward = spec.value_residual or spec.experimental_forward or streams > 1
        # the residual streams are expanded once before the depth loop and summed
        # after it (reference bs_roformer_experimental.py:558-560, 608-610)
        xb = HC.expand_streams(xb, streams)

        store = []
        first_values = {"time": None, "freq": None}  # the first depth layer's V, per axis

        def stack(layer, axis, z, rope):
            if not vr_forward:
                return core.transformer_apply(layer[axis], z, spec.heads, rope=rope)
            z, values = core.transformer_apply_vr(layer[axis], z, spec.heads, rope=rope,
                                                  value_residual=first_values[axis],
                                                  streams=streams)
            if first_values[axis] is None:
                first_values[axis] = values
            return z

        for layer in params["layers"]:
            # reference order (bs_roformer.py:510-524): the linear transformer
            # runs first, then the skip sums are added
            if "linear" in layer:
                z = core.transformer_apply(layer["linear"], xb.reshape(-1, tf * nb, spec.dim),
                                           spec.heads, linear_attn=True)
                xb = z.reshape(-1, tf, nb, spec.dim)
            if spec.skip_connection and store:
                xb = xb + sum(store)
            z = xb.permute(0, 2, 1, 3).contiguous()  # (B, NB, Tf, D): sequence = frames
            z = stack(layer, "time", z, rope_time)
            z = z.permute(0, 2, 1, 3).contiguous()  # (B, Tf, NB, D): sequence = bands
            xb = stack(layer, "freq", z, rope_freq)
            if "fno" in layer:
                xb = _fno_apply(layer["fno"], xb)
            if spec.skip_connection:
                store.append(xb)

        xb = HC.reduce_streams(xb, streams)

        if "final_norm_gamma" in params:
            xb = rms_norm(xb, params["final_norm_gamma"])

        masks = torch.stack([B.mask_estimator_apply(plan, p, xb)
                             for p in params["mask_estimators"]], dim=1).float()

        # complex multiply mask × stft in packed RI features
        nstems = masks.shape[1]
        m = masks.reshape(b, nstems, tf, spec.num_features // 2, 2)
        sr = sp.reshape(b, 1, tf, spec.num_features // 2, 2)
        re = m[..., 0] * sr[..., 0] - m[..., 1] * sr[..., 1]
        im = m[..., 0] * sr[..., 1] + m[..., 1] * sr[..., 0]
        out = torch.stack([re, im], dim=-1)
        # unpack rows (f, s) -> (B, S, ch, F, Tf, 2)
        out = out.reshape(b, nstems, tf, spec.num_freqs, ch, 2).permute(0, 1, 4, 3, 2, 5)
        return istft_ri(out, spec.stft_n_fft, spec.stft_hop_length, window,
                        win_length=spec.stft_win_length, normalized=spec.stft_normalized,
                        length=t)


def apply(params, config, x, compute_dtype=None):
    return apply_from_spec(params, spec_from_config(config.model), x,
                           compute_dtype=compute_dtype)


# --------------------------------------------------------------------------
# torch checkpoint conversion
# --------------------------------------------------------------------------

def _make_take(state_dict):
    sd = {k: (v.detach().cpu() if isinstance(v, torch.Tensor)
              else torch.as_tensor(np.array(v))) for k, v in state_dict.items()}
    used = set()

    def take(key):
        used.add(key)
        try:
            return sd[key]
        except KeyError:
            import difflib

            near = difflib.get_close_matches(key, sd.keys(), n=3, cutoff=0.5)
            raise KeyError(f"checkpoint key {key!r} not found; closest present "
                           f"keys: {near}") from None

    return sd, used, take


def convert_from_spec(state_dict, spec: RoformerSpec,
                      transformer_norm_output: bool = False, final_norm: bool = True):
    """Community checkpoint keys -> the port's parameter tree. Every key is
    consumed; leftovers raise."""
    plan = spec.band_plan()
    sd, used, take = _make_take(state_dict)

    bs_groups = []
    for ids in plan.group_band_ids:
        bs_groups.append({
            "norm_gamma": torch.stack([take(f"band_split.to_features.{i}.0.gamma") for i in ids]),
            # torch Linear weight (out, in) -> stacked (m, in, out)
            "weight": torch.stack([take(f"band_split.to_features.{i}.1.weight").T for i in ids]),
            "bias": torch.stack([take(f"band_split.to_features.{i}.1.bias") for i in ids]),
        })

    layers = []
    for d in range(spec.depth):
        vr = spec.value_residual and d > 0
        j = 0
        layer = {}
        if spec.linear_transformer_depth > 0:
            layer["linear"] = core.convert_transformer(
                take, f"layers.{d}.{j}", spec.linear_transformer_depth,
                norm_output=transformer_norm_output, linear_attn=True)
            j += 1
        layer["time"] = core.convert_transformer(
            take, f"layers.{d}.{j}", spec.time_transformer_depth,
            norm_output=transformer_norm_output, value_residual=vr,
            num_residual_streams=spec.num_residual_streams)
        layer["freq"] = core.convert_transformer(
            take, f"layers.{d}.{j + 1}", spec.freq_transformer_depth,
            norm_output=transformer_norm_output, value_residual=vr,
            num_residual_streams=spec.num_residual_streams)
        if spec.use_fno:
            fno = f"layers.{d}.{j + 2}"
            layer["fno"] = {"w_re": take(f"{fno}.weight_real"),
                            "w_im": take(f"{fno}.weight_imag"),
                            "bypass_w": take(f"{fno}.bypass.weight").T,
                            "bypass_b": take(f"{fno}.bypass.bias")}
        layers.append(layer)

    mask_estimators = []
    for s in range(spec.num_stems):
        n_hidden = spec.mask_hidden_layers
        hidden = []
        for li in range(n_hidden):  # MLP Sequential: Linear at even indices
            pre = f"mask_estimators.{s}.to_freqs"
            hidden.append({
                "weight": torch.stack([take(f"{pre}.{i}.0.{2 * li}.weight").T
                                       for i in range(plan.num_bands)]),
                "bias": torch.stack([take(f"{pre}.{i}.0.{2 * li}.bias")
                                     for i in range(plan.num_bands)]),
            })
        last = 2 * n_hidden
        groups = [{
            "weight": torch.stack([take(f"mask_estimators.{s}.to_freqs.{i}.0.{last}.weight").T
                                   for i in ids]),
            "bias": torch.stack([take(f"mask_estimators.{s}.to_freqs.{i}.0.{last}.bias")
                                 for i in ids]),
        } for ids in plan.group_band_ids]
        mask_estimators.append({"hidden": hidden, "groups": groups})

    # one shared RotaryEmbedding per axis, registered under every attention
    # layer in real checkpoints; older exports have top-level keys
    j0 = 1 if spec.linear_transformer_depth > 0 else 0

    def rope_freqs(legacy_key, j):
        if legacy_key in sd:
            return take(legacy_key)
        key = f"layers.0.{j}.layers.0.0.rotary_embed.freqs"
        if key in sd:
            return take(key)
        # num_residual_streams > 1: the hyper-connection wrapper nests the
        # attention under '.branch'
        return take(f"layers.0.{j}.layers.0.0.branch.rotary_embed.freqs")

    params = {
        "band_split": {"groups": bs_groups},
        "layers": layers,
        "mask_estimators": mask_estimators,
        "rope_time_freqs": rope_freqs("time_rotary_embed.freqs", j0),
        "rope_freq_freqs": rope_freqs("freq_rotary_embed.freqs", j0 + 1),
    }
    if final_norm:
        params["final_norm_gamma"] = take("final_norm.gamma")

    unused = {k for k in set(sd) - used if not k.endswith((
        "freqs_per_band", "freq_indices", "num_freqs_per_band", "num_bands_per_freq",
        ".rotary_embed.freqs"))}
    if unused:
        raise ValueError(f"unconsumed checkpoint keys: {sorted(unused)[:8]} ...")
    return tree_map(lambda v: v.contiguous(), params)


def convert_torch(state_dict, config):
    return convert_from_spec(state_dict, spec_from_config(config.model))
