"""TS-BS-Mamba2's forward pass, plain PyTorch in f32.

The ``Separator`` of ``models/ts_bs_mamba2.py`` (test4373/SESA-Audio-Separation,
:140-319; the same module in ZFTurbo's Music-Source-Separation-Training) with
the Mamba-2 of its fallback, ``models/ex_bi_mamba2.py``, written as functions
of the published checkpoint's state dict: the module names are the
checkpoint's keys. It has its own band layout (ts_bs_mamba2.py:153-167) and
its own scan: the fallback's chunked segment-sum SSD (ex_bi_mamba2.py:98-150).
Departures from the published code:

- the published module runs ``mamba_ssm.Mamba2`` where that package is
  installed; this follows the fallback's equations (in projection, causal
  depthwise conv, SiLU, SSD, skip, gated RMSNorm, out projection);
- the fallback's scan takes only lengths that are whole chunks of 64, which
  a chunk's 690 frames and 57 bands are not: the scan's inputs are
  zero-padded at the end to whole chunks and its output cut back. The scan
  is causal, so the first L outputs are the unpadded scan's;
- the fallback's einsums are written as matrix products (the same sums in
  another order), so that each goes through ``products``;
- the imaginary parts of the DC and Nyquist bins are zeroed before the
  inverse STFT: a real signal's spectrum has none, pocketfft's inverse
  ignores them, cuFFT's does not;
- ``checkpoint_sequential`` around the separator stacks only saves memory in
  training and is left out.

Every matrix product goes through a ``products`` object, as in
``reference/roformer.py``: :class:`~h100_bench.reference.roformer.F32`, the
reference, run under ``strict_f32`` (TF32 off), or ``FP8``, the control. That
covers the bottlenecks, the Mamba in and out projections, the scan's C·Bᵀ,
its masked product with x and its three state products, the ResMamba and TAC
linears, ``in_conv`` and the heads. Enter ``products.context()`` around a
forward.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from h100_bench.reference.roformer import F32

EPS = float(np.finfo(np.float32).eps)  # the Separator's GroupNorm eps
RMS_EPS = 1e-5  # the gated RMSNorm's (ex_bi_mamba2.py)
# the Separator's arguments and their published defaults: what a configuration's
# model section may set
DEFAULTS = dict(sr=44100, win=2048, stride=512, feature_dim=128, num_repeat_mask=8,
                num_repeat_map=4, num_output=4)
# MambaBlock's Mamba2 arguments (ts_bs_mamba2.py:20-34): fixed there, and in
# the program, whatever the configuration
MAMBA = dict(d_state=128, d_conv=4, expand=4, headdim=64, chunk_size=64)


def sizes(model: dict) -> dict:
    """The Separator's sizes (the model section over the published defaults)
    and its Mamba-2's fixed ones."""
    s = dict(DEFAULTS)
    s.update({k: model[k] for k in DEFAULTS if k in model})
    return dict(s, **MAMBA)


def band_widths(sr: int, win: int) -> list:
    """Bins of each of the psychoacoustic bands (ts_bs_mamba2.py:153-167):
    20 of 50 Hz, 10 of 100, 8 of 250, 8 of 500, 8 of 1 kHz, 2 of 2 kHz, and
    the rest of the spectrum."""
    enc_dim = win // 2 + 1

    def bins(hz):
        return int(np.floor(hz / (sr / 2.0) * enc_dim))

    widths = ([bins(50)] * 20 + [bins(100)] * 10 + [bins(250)] * 8 + [bins(500)] * 8
              + [bins(1000)] * 8 + [bins(2000)] * 2)
    return widths + [enc_dim - sum(widths)]


# -- the scan ----------------------------------------------------------------------

def segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): [i, j] = x[j+1] + ... + x[i] below the
    diagonal, 0 on it, -inf above (ex_bi_mamba2.py:98-107, each segment
    summed on its own)."""
    t = x.shape[-1]
    x = x[..., None].expand(*x.shape, t)
    below = torch.ones(t, t, dtype=torch.bool, device=x.device).tril(-1)
    sums = torch.cumsum(x.masked_fill(~below, 0.0), dim=-2)
    lower = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    return sums.masked_fill(~lower, float("-inf"))


def ssd(mm, x, a, b, c, chunk: int) -> torch.Tensor:
    """The chunked scan (ex_bi_mamba2.py:108-150) from a zero state.
    x (B, L, H, P), a (B, L, H), b and c (B, L, N) shared by the heads, L
    whole chunks -> y (B, L, H, P): y_t = c_t · h_t with
    h_t = exp(a_t) h_{t-1} + x_t ⊗ b_t."""
    bsz, length, h, p = x.shape
    n = b.shape[-1]
    nc = length // chunk
    xs = x.reshape(bsz, nc, chunk, h, p).permute(0, 3, 1, 2, 4)  # (B, H, c, l, P)
    a = a.reshape(bsz, nc, chunk, h).permute(0, 3, 1, 2)  # (B, H, c, l)
    b = b.reshape(bsz, 1, nc, chunk, n)
    c = c.reshape(bsz, 1, nc, chunk, n)
    a_cum = torch.cumsum(a, dim=-1)

    # 1. inside each chunk: (C·Bᵀ masked by the decays) · x
    decay = torch.exp(segsum(a))  # (B, H, c, l, s)
    y_diag = mm.matmul(mm.matmul(c, b.transpose(-1, -2)) * decay, xs)

    # 2. each chunk's state from its own steps: (decayed x)ᵀ · B, (P, N)
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)
    states = mm.matmul((xs * decay_states[..., None]).transpose(-1, -2), b)

    # 3. the states carried over the chunk boundaries, from a zero state
    states = torch.cat([torch.zeros_like(states[:, :, :1]), states], dim=2)
    decay_chunk = torch.exp(segsum(F.pad(a_cum[..., -1], (1, 0))))  # (B, H, c+1, c+1)
    states = mm.matmul(decay_chunk, states.reshape(bsz, h, nc + 1, p * n))
    states = states.reshape(bsz, h, nc + 1, p, n)[:, :, :-1]

    # 4. the carried state read out at each step
    y_off = mm.matmul(c, states.transpose(-1, -2)) * torch.exp(a_cum)[..., None]
    return (y_diag + y_off).permute(0, 2, 3, 1, 4).reshape(bsz, length, h, p)


# -- Mamba-2 and the blocks around it ------------------------------------------------

def mamba2(mm, sd, prefix: str, u: torch.Tensor, s: dict) -> torch.Tensor:
    """One direction's Mamba2 (ex_bi_mamba2.py:55-95): u (B, L, D) -> (B, L, D)."""
    bsz, length, d_model = u.shape
    d_inner, n = s["expand"] * d_model, s["d_state"]
    heads = d_inner // s["headdim"]
    a = -torch.exp(sd[f"{prefix}.A_log"])
    z, xbc, dt = torch.split(mm.linear(u, sd[f"{prefix}.in_proj.weight"]),
                             [d_inner, d_inner + 2 * n, heads], dim=-1)
    dt = F.softplus(dt + sd[f"{prefix}.dt_bias"])
    # the causal depthwise conv: padded d_conv - 1 on both sides, the first L kept
    xbc = F.conv1d(xbc.transpose(1, 2), sd[f"{prefix}.conv1d.weight"],
                   sd[f"{prefix}.conv1d.bias"], padding=s["d_conv"] - 1, groups=xbc.shape[-1])
    xbc = F.silu(xbc[..., :length].transpose(1, 2))
    x, b, c = torch.split(xbc, [d_inner, n, n], dim=-1)
    x = x.reshape(bsz, length, heads, s["headdim"])

    pad = -length % s["chunk_size"]

    def padded(t):
        return F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad)) if pad else t

    y = ssd(mm, padded(x * dt[..., None]), padded(a * dt), padded(b), padded(c),
            s["chunk_size"])[:, :length]
    y = (y + x * sd[f"{prefix}.D"][:, None]).reshape(bsz, length, d_inner)
    # the gated RMSNorm
    y = y * F.silu(z)
    y = y * torch.rsqrt(y.pow(2).mean(-1, keepdim=True) + RMS_EPS) * sd[f"{prefix}.norm.weight"]
    return mm.linear(y, sd[f"{prefix}.out_proj.weight"])


def group_norm(sd, prefix: str, x: torch.Tensor) -> torch.Tensor:
    return F.group_norm(x, 1, sd[f"{prefix}.weight"], sd[f"{prefix}.bias"], eps=EPS)


def res_mamba(mm, sd, prefix: str, x: torch.Tensor, s: dict) -> torch.Tensor:
    """ResMamba (ts_bs_mamba2.py:97-111) over the last axis: (B, N, T) ->
    (B, N, T); its MambaBlock (:17-42) runs forward and on the flipped
    sequence, each added to its input, the two concatenated."""
    y = group_norm(sd, f"{prefix}.norm", x).transpose(1, 2)
    fwd = mamba2(mm, sd, f"{prefix}.rnn.forward_mamba2", y, s)
    bwd = mamba2(mm, sd, f"{prefix}.rnn.backward_mamba2", y.flip(1), s).flip(1)
    out = mm.linear(torch.cat([fwd + y, bwd + y], dim=-1), sd[f"{prefix}.proj.weight"],
                    sd[f"{prefix}.proj.bias"])
    return x + out.transpose(1, 2)


def tac(mm, sd, prefix: str, x: torch.Tensor) -> torch.Tensor:
    """Transform-average-concatenate over the channels (ts_bs_mamba2.py:44-88):
    x (B, G, N, T)."""
    bsz, g, n, t = x.shape
    y = group_norm(sd, f"{prefix}.input_norm", x.reshape(bsz * g, n, t))
    y = y.reshape(bsz, g, n, t).permute(0, 3, 1, 2)  # (B, T, G, N)

    def lin(name, v):
        return torch.tanh(mm.linear(v, sd[f"{prefix}.{name}.0.weight"],
                                    sd[f"{prefix}.{name}.0.bias"]))

    each = lin("TAC_input", y)
    mean = lin("TAC_mean", each.mean(dim=2))[:, :, None].expand(each.shape)
    out = lin("TAC_output", torch.cat([each, mean], dim=-1))
    return x + out.permute(0, 2, 3, 1)


def bsnet(mm, sd, prefix: str, x: torch.Tensor, nband: int, s: dict) -> torch.Tensor:
    """BSNet (ts_bs_mamba2.py:113-138): x (B, nch, nband·N, T); the bands'
    sequences over frames, then over bands, then the channels mixed."""
    bsz, nch, nn, t = x.shape
    n = nn // nband
    y = res_mamba(mm, sd, f"{prefix}.band_rnn", x.reshape(bsz * nch * nband, n, t), s)
    y = y.reshape(bsz * nch, nband, n, t).permute(0, 3, 2, 1).reshape(bsz * nch * t, n, nband)
    y = res_mamba(mm, sd, f"{prefix}.band_comm", y, s)
    y = y.reshape(bsz, nch, t, n, nband).permute(0, 4, 1, 3, 2).reshape(bsz * nband, nch, n, t)
    y = tac(mm, sd, f"{prefix}.channel_comm", y)
    return y.reshape(bsz, nband, nch, n, t).transpose(1, 2).reshape(bsz, nch, nn, t)


def conv1x1(mm, sd, prefix: str, x: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """A Conv1d of kernel 1 on (B, C, T), weight (O, C / groups, 1)."""
    w, bias = sd[f"{prefix}.weight"][..., 0], sd[f"{prefix}.bias"]
    if groups == 1:
        return mm.linear(x.transpose(1, 2), w, bias).transpose(1, 2)
    bsz, ch, t = x.shape
    w = w.reshape(groups, -1, ch // groups)
    y = mm.matmul(w, x.reshape(bsz, groups, ch // groups, t))  # (B, groups, O / groups, T)
    return y.reshape(bsz, -1, t) + bias[:, None]


def head(mm, sd, prefix: str, x: torch.Tensor, k: int) -> torch.Tensor:
    """A band's output head (ts_bs_mamba2.py:199-205): GroupNorm, 1x1, Tanh,
    grouped 1x1, Tanh, grouped 1x1; (B, N, T) -> (B, bw·4·K, T)."""
    y = torch.tanh(conv1x1(mm, sd, f"{prefix}.1", group_norm(sd, f"{prefix}.0", x)))
    y = torch.tanh(conv1x1(mm, sd, f"{prefix}.3", y, k))
    return conv1x1(mm, sd, f"{prefix}.5", y, k)


@torch.no_grad()
def forward(sd, model: dict, x: torch.Tensor, products=None) -> torch.Tensor:
    """x (B, ch, T) f32 -> stems (B, num_output, ch, T); ``products``: F32
    unless given."""
    mm = F32() if products is None else products
    s = sizes(model)
    widths = band_widths(s["sr"], s["win"])
    nband, n, k, win = len(widths), s["feature_dim"], s["num_output"], s["win"]
    bsz, nch, length = x.shape
    window = torch.hann_window(win, device=x.device)
    spec = torch.stft(x.reshape(bsz * nch, length), n_fft=win, hop_length=s["stride"],
                      window=window, return_complex=True)  # (B', F, T)
    t = spec.shape[-1]
    spec_ri = torch.stack([spec.real, spec.imag], dim=1)  # (B', 2, F, T)
    starts = np.concatenate([[0], np.cumsum(widths)[:-1]]).tolist()

    def features(bank):  # (B', nband, N, T)
        out = []
        for i, (lo, bw) in enumerate(zip(starts, widths)):
            sub = spec_ri[:, :, lo:lo + bw].reshape(bsz * nch, 2 * bw, t)
            sub = group_norm(sd, f"{bank}.{i}.0", sub)
            out.append(conv1x1(mm, sd, f"{bank}.{i}.1", sub))
        return torch.stack(out, dim=1)

    feat_mask, feat_map = features("BN_mask"), features("BN_map")
    z = feat_mask.reshape(bsz, nch, nband * n, t)
    for i in range(s["num_repeat_mask"]):
        z = bsnet(mm, sd, f"separator_mask.{i}", z, nband, s)
    sep_mask = z.reshape(bsz * nch, nband, n, t)
    combined = torch.cat([feat_map, sep_mask], dim=2).reshape(bsz * nch * nband, 2 * n, t)
    z = torch.tanh(conv1x1(mm, sd, "in_conv", combined)).reshape(bsz, nch, nband * n, t)
    for i in range(s["num_repeat_map"]):
        z = bsnet(mm, sd, f"separator_map.{i}", z, nband, s)
    sep_map = z.reshape(bsz * nch, nband, n, t)

    parts = []
    for i, (lo, bw) in enumerate(zip(starts, widths)):
        mix = spec[:, None, lo:lo + bw]  # (B', 1, bw, T)
        out = head(mm, sd, f"mask.{i}", sep_mask[:, i], k).reshape(bsz * nch, 2, 2, k, bw, t)
        m = out[:, 0] * torch.sigmoid(out[:, 1])  # (B', 2, K, bw, T)
        # the masks sum to one over the outputs
        m_re = m[:, 0] - (m[:, 0].sum(1, keepdim=True) - 1.0) / k
        m_im = m[:, 1] - m[:, 1].sum(1, keepdim=True) / k
        est = mix * torch.complex(m_re, m_im)
        out = head(mm, sd, f"map.{i}", sep_map[:, i], k).reshape(bsz * nch, 2, 2, k, bw, t)
        add = out[:, 0] * torch.sigmoid(out[:, 1])
        parts.append(est + torch.complex(add[:, 0], add[:, 1]))
    est = torch.cat(parts, dim=2).reshape(bsz * nch * k, win // 2 + 1, t).clone()
    est.imag[:, 0] = 0.0
    est.imag[:, -1] = 0.0
    wav = torch.istft(est, n_fft=win, hop_length=s["stride"], window=window, length=length)
    return wav.reshape(bsz, nch, k, length).transpose(1, 2)
