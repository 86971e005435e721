"""TS-BS-Mamba2, a band-split separator with bidirectional Mamba-2 blocks
(counterpart of sesa_tpu/models/bs_mamba2.py).

Architecture: STFT -> psychoacoustic band split (57 bands at 44.1 kHz and a
2048 window: 20 of 2 bins, 10 of 4, 8 of 11, 8 of 23, 8 of 46, 2 of 92 and
one of 121) -> per-band GroupNorm + 1x1 bottlenecks into parallel mask and
map feature stacks -> mask branch: ``num_repeat_mask`` x BSNet
(band-sequence ResMamba over frames, band-communication ResMamba over
bands, TAC channel mixing) -> fused with the map features -> map branch ->
per-band grouped heads give a sum-to-one complex mask (applied to the
mixture) plus an additive complex map -> iSTFT.

Mamba blocks run in both directions (forward, and backward scanning from
the sequence's end, concatenated). Between its in and out projections (torch
matmuls, as XLA's in the JAX package) a Mamba-2 mixer runs three steps, each
a hand-written kernel on CUDA: ``ops/mamba.py`` ``mamba_conv`` (the causal
depthwise conv, SiLU, dt and the scan's operands; ``csrc/mamba_mixer.cu``),
the chunked SSD scan of ``ops/ssd.py`` (kernel K8) and ``mamba_gate_norm``
(the D skip, the gate and the RMSNorm; ``csrc/mamba_mixer.cu``). The backward
direction reads and writes its rows in reverse, with no flipped copy. The
norms, the ResMamba and TAC linears, the residual adds and the
concatenation stay torch calls. The parameter tree is the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from sesa_tpu_torch.models import layers as L
from sesa_tpu_torch.models.bs_roformer import _make_take
from sesa_tpu_torch.ops.mamba import mamba_conv, mamba_gate_norm
from sesa_tpu_torch.ops.prec import net_precision
from sesa_tpu_torch.ops.ssd import ssd
from sesa_tpu_torch.ops.stft import hann_window, istft_ri, stft_ri
from sesa_tpu_torch.runtime.profiling import span
from sesa_tpu_torch.tree import tree_map

_EPS_F32 = float(np.finfo(np.float32).eps)

# Mamba2 block hyperparameters fixed by the reference (ts_bs_mamba2.py:20-34)
_D_STATE = 128
_D_CONV = 4
_EXPAND = 4
_HEADDIM = 64
_CHUNK = 64


def _model_kwargs(config):
    kw = dict(sr=44100, win=2048, stride=512, feature_dim=128,
              num_repeat_mask=8, num_repeat_map=4, num_output=4)
    kw.update({k: v for k, v in dict(config.model).items() if k in kw})
    return kw


def band_widths(sr: int, win: int):
    """Psychoacoustic band layout (reference ts_bs_mamba2.py:153-167)."""
    enc_dim = win // 2 + 1

    def bw(hz):
        return int(np.floor(hz / (sr / 2.0) * enc_dim))

    widths = [bw(50)] * 20 + [bw(100)] * 10 + [bw(250)] * 8 + [bw(500)] * 8
    widths += [bw(1000)] * 8 + [bw(2000)] * 2
    widths.append(enc_dim - int(np.sum(widths)))
    return widths


# --------------------------------------------------------------------------
# Mamba2 core
# --------------------------------------------------------------------------

def mamba2_init(generator, d_model):
    d_inner = _EXPAND * d_model
    nheads = d_inner // _HEADDIM
    d_in_proj = 2 * d_inner + 2 * _D_STATE + nheads
    conv_dim = d_inner + 2 * _D_STATE

    def uniform(n):
        return torch.rand(n, generator=generator)

    return {
        "in_proj": L.kaiming_uniform((d_in_proj, d_model), d_model, generator),
        "conv_w": L.kaiming_uniform((conv_dim, 1, _D_CONV), _D_CONV, generator),
        "conv_b": L.kaiming_uniform((conv_dim,), _D_CONV, generator),
        "dt_bias": uniform(nheads),
        "A_log": uniform(nheads),
        "D": uniform(nheads),
        "norm_w": torch.ones(d_inner),
        "out_proj": L.kaiming_uniform((d_model, d_inner), d_inner, generator),
    }


def mamba2_apply(p, u, reverse=False):
    """u (B, L, D) -> (B, L, D) (reference ex_bi_mamba2.py:55-95). The glue
    between the projections is ``ops/mamba.py``'s two steps around the scan.
    ``reverse=True`` gives flip(mamba2_apply(p, flip(u))) along L without the
    flips."""
    zxbcdt = u @ p["in_proj"].T
    # K8's operands, L zero-padded to a chunk multiple: zero x, a and b add
    # nothing to the state and decay it by exp(0) = 1, and the tail is unread
    xdt, adt, b, c, x = mamba_conv(zxbcdt, p["conv_w"], p["conv_b"], p["dt_bias"], p["A_log"],
                                   reverse=reverse, chunk=_CHUNK)
    y = ssd(xdt, adt, b, c, chunk_size=_CHUNK)
    # the D skip and the gated RMSNorm (reference ex_bi_mamba2.py:13-21)
    y = mamba_gate_norm(y, x, zxbcdt, p["D"], p["norm_w"], reverse=reverse)
    return y @ p["out_proj"].T


def mamba_block_apply(p, x):
    """Both directions: concat(fwd(x) + x, flip(bwd(flip(x))) + x)
    (reference ts_bs_mamba2.py:35-42), the backward one scanning from the end
    (``mamba2_apply``'s ``reverse``)."""
    fwd = mamba2_apply(p["forward"], x)
    bwd = mamba2_apply(p["backward"], x, reverse=True)
    return torch.cat([fwd + x, bwd + x], dim=-1)


# --------------------------------------------------------------------------
# ResMamba / TAC / BSNet
# --------------------------------------------------------------------------

def _lin_init(generator, ci, co):
    return {"weight": L.kaiming_uniform((co, ci), ci, generator),
            "bias": L.kaiming_uniform((co,), ci, generator)}


def _norm_init(n):
    return {"weight": torch.ones(n), "bias": torch.zeros(n)}


def _res_mamba_init(generator, n):
    return {
        "norm": _norm_init(n),
        "mamba": {"forward": mamba2_init(generator, n), "backward": mamba2_init(generator, n)},
        "proj": _lin_init(generator, 2 * n, n),
    }


def _res_mamba_apply(p, x):
    """(B, N, T) -> (B, N, T) (reference ts_bs_mamba2.py:104-111)."""
    # (B, T, N), copied: the projections then read rows of N contiguous values
    # (T is odd in the band direction, and a transposed view of it sends the
    # in projection to an unaligned GEMM)
    y = L.group_norm(x, p["norm"], 1, eps=_EPS_F32).transpose(1, 2).contiguous()
    y = L.linear(mamba_block_apply(p["mamba"], y), p["proj"])
    return x + y.transpose(1, 2)


def _tac_init(generator, n, h):
    return {
        "norm": _norm_init(n),
        "input": _lin_init(generator, n, h),
        "mean": _lin_init(generator, h, h),
        "output": _lin_init(generator, 2 * h, n),
    }


def _tac_apply(p, x):
    """Transform-average-concatenate over groups: (B, G, N, T)
    (reference ts_bs_mamba2.py:65-88)."""
    bsz, g, n, t = x.shape
    y = L.group_norm(x.reshape(bsz * g, n, t), p["norm"], 1, eps=_EPS_F32)
    y = y.reshape(bsz, g, n, t).permute(0, 3, 1, 2)  # (B, T, G, N)
    gi = torch.tanh(L.linear(y, p["input"]))  # (B, T, G, H)
    gm = torch.tanh(L.linear(gi.mean(dim=2), p["mean"]))
    gm = gm[:, :, None, :].expand(gi.shape)
    go = torch.tanh(L.linear(torch.cat([gi, gm], dim=-1), p["output"]))  # (B, T, G, N)
    return x + go.permute(0, 2, 3, 1)


def _bsnet_init(generator, n):
    return {
        "band_rnn": _res_mamba_init(generator, n),
        "band_comm": _res_mamba_init(generator, n),
        "channel_comm": _tac_init(generator, n, 3 * n),
    }


def _bsnet_apply(p, x, nband):
    """(B, nch, nband*N, T) (reference ts_bs_mamba2.py:124-138)."""
    bsz, nch, nn, t = x.shape
    n = nn // nband
    y = _res_mamba_apply(p["band_rnn"], x.reshape(bsz * nch * nband, n, t))
    y = y.reshape(bsz * nch, nband, n, t)

    y = y.permute(0, 3, 2, 1).reshape(bsz * nch * t, n, nband)
    y = _res_mamba_apply(p["band_comm"], y)
    y = y.reshape(bsz * nch, t, n, nband).permute(0, 3, 2, 1)

    y = y.reshape(bsz, nch, nband, n, t).transpose(1, 2).reshape(bsz * nband, nch, n, t)
    y = _tac_apply(p["channel_comm"], y)
    return y.reshape(bsz, nband, nch, n, t).transpose(1, 2).reshape(bsz, nch, nn, t)


# --------------------------------------------------------------------------
# Separator
# --------------------------------------------------------------------------

def init(generator, config):
    """Random parameters drawn on the CPU from ``generator`` (the numbers
    differ from the JAX package's init; the tree is the same)."""
    kw = _model_kwargs(config)
    widths = band_widths(kw["sr"], kw["win"])
    n = kw["feature_dim"]
    k_out = kw["num_output"]

    def bn(bw):
        return {"norm": _norm_init(bw * 2), "conv": _lin_init(generator, bw * 2, n)}

    def head(bw):
        def conv(co):
            return {"weight": L.kaiming_uniform((co, n, 1), n, generator),
                    "bias": L.kaiming_uniform((co,), n, generator)}

        return {"norm": _norm_init(n), "conv1": _lin_init(generator, n, n * k_out),
                "conv2": conv(n * k_out), "conv3": conv(bw * 4 * k_out)}

    return {
        "bn_mask": [bn(w) for w in widths],
        "bn_map": [bn(w) for w in widths],
        "separator_mask": [_bsnet_init(generator, n) for _ in range(kw["num_repeat_mask"])],
        "separator_map": [_bsnet_init(generator, n) for _ in range(kw["num_repeat_map"])],
        "in_conv": _lin_init(generator, 2 * n, n),
        "mask": [head(w) for w in widths],
        "map": [head(w) for w in widths],
    }


def _pointwise(x, p):
    """A 1x1 conv on (B, C, T) with a Linear's (out, in) weight."""
    return torch.einsum("bct,oc->bot", x, p["weight"]) + p["bias"][None, :, None]


def _head_apply(p, x, k_out):
    """Per-band output head: (B', N, T) -> (B', bw*4*K, T), a Sequential of
    [GroupNorm, 1x1, Tanh, grouped 1x1, Tanh, grouped 1x1] (reference
    ts_bs_mamba2.py:199-205)."""
    y = torch.tanh(_pointwise(L.group_norm(x, p["norm"], 1, eps=_EPS_F32), p["conv1"]))
    y = torch.tanh(L.conv1d(y, p["conv2"]["weight"], p["conv2"]["bias"], groups=k_out))
    return L.conv1d(y, p["conv3"]["weight"], p["conv3"]["bias"], groups=k_out)


def apply(params, config, x, compute_dtype=None):
    """(B, ch, T) -> (B, num_output, ch, T).

    ``compute_dtype=torch.bfloat16`` runs the band bottlenecks, the Mamba
    separators and the heads in bf16; the STFT, the iSTFT and the complex
    mask stay f32, and the SSD scan sums in f32 inside its kernel whatever
    the dtype it is handed. Host spans (``runtime.profiling.span``) mark the
    phases of a call: ``sesa.mamba.split`` (both bottleneck banks),
    ``sesa.mamba.mask`` and ``sesa.mamba.map`` (the separator stacks, the
    latter with ``in_conv``) and ``sesa.mamba.heads`` (the per-band heads).
    """
    with net_precision(compute_dtype) as dtype:
        kw = _model_kwargs(config)
        widths = band_widths(kw["sr"], kw["win"])
        nband = len(widths)
        n = kw["feature_dim"]
        k_out = kw["num_output"]
        bsz, nch, nsample = x.shape

        window = hann_window(kw["win"], device=x.device)
        spec = stft_ri(x.reshape(bsz * nch, nsample), kw["win"], kw["stride"], window)
        t = spec.shape[-2]
        enc_dim = kw["win"] // 2 + 1

        # (B', 2, F, T): real and imaginary parts as channels
        spec_ri = torch.stack([spec[..., 0], spec[..., 1]], dim=1).to(dtype)
        if dtype != torch.float32:
            params = tree_map(lambda p: p.to(dtype), params)

        offsets = np.concatenate([[0], np.cumsum(widths)[:-1]]).astype(int).tolist()

        def bottleneck(p, start, bw):
            sub = spec_ri[:, :, start:start + bw].reshape(bsz * nch, bw * 2, t)
            return _pointwise(L.group_norm(sub, p["norm"], 1, eps=_EPS_F32), p["conv"])

        def features(bns):  # (B', nband, N, T)
            return torch.stack([bottleneck(p, o, w) for p, o, w in zip(bns, offsets, widths)],
                               dim=1)

        with span("sesa.mamba.split"):
            feat_mask, feat_map = features(params["bn_mask"]), features(params["bn_map"])

        with span("sesa.mamba.mask"):
            z = feat_mask.reshape(bsz, nch, nband * n, t)
            for p in params["separator_mask"]:
                z = _bsnet_apply(p, z, nband)
            sep_mask = z.reshape(bsz * nch, nband, n, t)

        with span("sesa.mamba.map"):
            combined = torch.cat([feat_map, sep_mask], dim=2).reshape(bsz * nch * nband, 2 * n, t)
            z = torch.tanh(_pointwise(combined, params["in_conv"])).reshape(bsz, nch, nband * n, t)
            for p in params["separator_map"]:
                z = _bsnet_apply(p, z, nband)
            sep_map = z.reshape(bsz * nch, nband, n, t)

        with span("sesa.mamba.heads"):
            est_parts = []
            for i, (start, bw) in enumerate(zip(offsets, widths)):
                sub_re = spec[:, start:start + bw, :, 0]  # (B', bw, T)
                sub_im = spec[:, start:start + bw, :, 1]

                # the masks apply to the f32 spectrum
                out = _head_apply(params["mask"][i], sep_mask[:, i], k_out).float()
                out = out.reshape(bsz * nch, 2, 2, k_out, bw, t)
                m = out[:, 0] * torch.sigmoid(out[:, 1])  # (B', 2, K, bw, T)
                m_re, m_im = m[:, 0], m[:, 1]
                # the masks sum to one across the outputs (ts_bs_mamba2.py:280-284)
                m_re = m_re - (m_re.sum(dim=1, keepdim=True) - 1.0) / k_out
                m_im = m_im - m_im.sum(dim=1, keepdim=True) / k_out
                est_re = sub_re[:, None] * m_re - sub_im[:, None] * m_im
                est_im = sub_re[:, None] * m_im + sub_im[:, None] * m_re

                out2 = _head_apply(params["map"][i], sep_map[:, i], k_out).float()
                out2 = out2.reshape(bsz * nch, 2, 2, k_out, bw, t)
                mp = out2[:, 0] * torch.sigmoid(out2[:, 1])
                est_parts.append(torch.stack([est_re + mp[:, 0], est_im + mp[:, 1]], dim=-1))

            est = torch.cat(est_parts, dim=2).reshape(bsz * nch * k_out, enc_dim, t, 2)
        wav = istft_ri(est, kw["win"], kw["stride"], window, length=nsample)
        return wav.reshape(bsz, nch, k_out, nsample).transpose(1, 2)  # (B, K, ch, T)


# --------------------------------------------------------------------------
# torch checkpoint conversion
# --------------------------------------------------------------------------

def convert_torch(state_dict, config):
    """Reference checkpoint keys -> the port's parameter tree. Every key is
    consumed; leftovers raise."""
    kw = _model_kwargs(config)
    nband = len(band_widths(kw["sr"], kw["win"]))
    sd, used, take = _make_take(state_dict)

    def wb(prefix, squeeze=False):
        w = take(f"{prefix}.weight")
        return {"weight": w[..., 0] if squeeze else w, "bias": take(f"{prefix}.bias")}

    def mamba(prefix):
        return {
            "in_proj": take(f"{prefix}.in_proj.weight"),
            "conv_w": take(f"{prefix}.conv1d.weight"),
            "conv_b": take(f"{prefix}.conv1d.bias"),
            "dt_bias": take(f"{prefix}.dt_bias"),
            "A_log": take(f"{prefix}.A_log"),
            "D": take(f"{prefix}.D"),
            "norm_w": take(f"{prefix}.norm.weight"),
            "out_proj": take(f"{prefix}.out_proj.weight"),
        }

    def res_mamba(prefix):
        return {
            "norm": wb(f"{prefix}.norm"),
            "mamba": {"forward": mamba(f"{prefix}.rnn.forward_mamba2"),
                      "backward": mamba(f"{prefix}.rnn.backward_mamba2")},
            "proj": wb(f"{prefix}.proj"),
        }

    def tac(prefix):
        return {
            "norm": wb(f"{prefix}.input_norm"),
            "input": wb(f"{prefix}.TAC_input.0"),
            "mean": wb(f"{prefix}.TAC_mean.0"),
            "output": wb(f"{prefix}.TAC_output.0"),
        }

    def bsnet(prefix):
        return {
            "band_rnn": res_mamba(f"{prefix}.band_rnn"),
            "band_comm": res_mamba(f"{prefix}.band_comm"),
            "channel_comm": tac(f"{prefix}.channel_comm"),
        }

    def bn(prefix):
        return {"norm": wb(f"{prefix}.0"), "conv": wb(f"{prefix}.1", squeeze=True)}

    def head(prefix):
        return {
            "norm": wb(f"{prefix}.0"),
            "conv1": wb(f"{prefix}.1", squeeze=True),
            "conv2": wb(f"{prefix}.3"),
            "conv3": wb(f"{prefix}.5"),
        }

    params = {
        "bn_mask": [bn(f"BN_mask.{i}") for i in range(nband)],
        "bn_map": [bn(f"BN_map.{i}") for i in range(nband)],
        "separator_mask": [bsnet(f"separator_mask.{i}") for i in range(kw["num_repeat_mask"])],
        "separator_map": [bsnet(f"separator_map.{i}") for i in range(kw["num_repeat_map"])],
        "in_conv": wb("in_conv", squeeze=True),
        "mask": [head(f"mask.{i}") for i in range(nband)],
        "map": [head(f"map.{i}") for i in range(nband)],
    }
    unused = set(sd) - used
    if unused:
        raise ValueError(f"unconsumed checkpoint keys: {sorted(unused)[:8]} ...")
    return tree_map(lambda v: v.contiguous(), params)
