"""SQUIM objective speech-quality model: STOI, PESQ and SI-SDR predicted
without a reference (counterpart of sesa_tpu/models/squim.py).

torchaudio's SquimObjective, as the reference vendors it: a Conv1d encoder,
a DPRNN over overlapped chunks (row and column BiLSTMs with GroupNorm
residuals), then three branches, each a post-norm transformer encoder
layer, AutoPool over time and a small PReLU head; the STOI and PESQ heads
end in a range sigmoid. Defaults are torchaudio's ``squim_objective_base``:
feat_dim 256, win_len 64, d_model 256, 4 heads, hidden 256, 2 DPRNN blocks,
chunk 71. Input is 16 kHz mono (B, T), the rate the trained weights assume.

f32 only: ``apply`` takes no ``compute_dtype`` (the JAX function runs every
product at HIGHEST), and on the card TF32 is off (``ops/prec.py``).
"""

from __future__ import annotations

import math

import torch

from sesa_tpu_torch.models import layers as L
from sesa_tpu_torch.models.bs_roformer import _make_take
from sesa_tpu_torch.ops.prec import net_precision

# wide-band PESQ range: 0.999 + 4/(1+exp(-1.3669·4.5+3.8224)) upper bound
_PESQ_LO = 1.0
_PESQ_HI = 0.999 + (4.999 - 0.999) / (1.0 + math.exp(-1.3669 * 4.5 + 3.8224))

METRICS = ("stoi", "pesq", "sisdr")


def _kwargs(config):
    kw = dict(feat_dim=256, win_len=64, d_model=256, nhead=4,
              hidden_dim=256, num_blocks=2, chunk_size=71, chunk_stride=None)
    if config is not None and "model" in config:
        kw.update({k: v for k, v in dict(config.model).items() if k in kw})
    if kw["chunk_stride"] is None:
        kw["chunk_stride"] = kw["chunk_size"] // 2
    return kw


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init(generator: torch.Generator, config=None):
    """Random parameters drawn on the CPU from ``generator`` (torch's
    default fan-in uniform; the numbers differ from the JAX package's init,
    the tree is the same)."""
    kw = _kwargs(config)
    fd, hd, d = kw["feat_dim"], kw["hidden_dim"], kw["d_model"]

    def uniform(shape, fan_in):
        return L.kaiming_uniform(shape, fan_in, generator)

    def lin(ci, co):
        return {"weight": uniform((co, ci), ci), "bias": uniform((co,), ci)}

    def lstm_dir(ci, h):
        return {"weight_ih": uniform((4 * h, ci), h), "weight_hh": uniform((4 * h, h), h),
                "bias_ih": uniform((4 * h,), h), "bias_hh": uniform((4 * h,), h)}

    def single_rnn():
        return {"lstm": {"fwd": lstm_dir(fd, hd), "bwd": lstm_dir(fd, hd)},
                "proj": lin(2 * hd, fd)}

    def norm(n):
        return {"weight": torch.ones(n), "bias": torch.zeros(n)}

    def branch():
        return {"attn": {"in_proj": lin(d, 3 * d), "out_proj": lin(d, d)},
                "linear1": lin(d, 4 * d), "linear2": lin(4 * d, d),
                "norm1": norm(d), "norm2": norm(d),
                "autopool_alpha": torch.ones(1),
                "head1": lin(d, d), "head_prelu": torch.full((1,), 0.25), "head2": lin(d, 1)}

    blocks = [{"row_rnn": single_rnn(), "col_rnn": single_rnn(),
               "row_norm": norm(fd), "col_norm": norm(fd)} for _ in range(kw["num_blocks"])]
    return {
        "encoder": {"weight": uniform((fd, 1, kw["win_len"]), kw["win_len"])},
        "dprnn": {"blocks": blocks,
                  "conv": {**lin(fd, d), "prelu": torch.full((1,), 0.25)}},
        "branches": [branch() for _ in METRICS],
    }


# --------------------------------------------------------------------------
# apply
# --------------------------------------------------------------------------

def _single_rnn(p, x):
    """(B, T, N) -> (B, T, N): BiLSTM and a linear projection."""
    return L.linear(L.bilstm(x, p["lstm"]), p["proj"])


def _chunking(x, chunk, stride):
    """(B, N, T) -> (B, N, chunk, 2K), rest. ``rest`` is ``chunk``, not 0,
    when (stride + T mod chunk) is a multiple of chunk, as the reference
    computes it."""
    b, n, seq = x.shape
    rest = chunk - (stride + seq % chunk) % chunk
    out = torch.nn.functional.pad(x, (stride, rest + stride))
    seg1 = out[:, :, :-stride].reshape(b, n, -1, chunk)
    seg2 = out[:, :, stride:].reshape(b, n, -1, chunk)
    out = torch.cat([seg1, seg2], dim=3).reshape(b, n, -1, chunk).transpose(2, 3)
    return out, rest


def _merging(x, rest, chunk, stride):
    """(B, D, chunk, 2K) -> (B, D, T), overlap-add of the two halves."""
    b, d = x.shape[:2]
    out = x.transpose(2, 3).reshape(b, d, -1, chunk * 2)
    out1 = out[:, :, :, :chunk].reshape(b, d, -1)[:, :, stride:]
    out2 = out[:, :, :, chunk:].reshape(b, d, -1)[:, :, :-stride]
    out = out1 + out2
    return out[:, :, :-rest] if rest > 0 else out


def _dprnn(p, x, kw):
    """(B, N, T) -> (B, T', d_model)."""
    chunk, stride = kw["chunk_size"], kw["chunk_stride"]
    out, rest = _chunking(x, chunk, stride)
    b, n, dim1, dim2 = out.shape
    for blk in p["blocks"]:
        row_in = out.permute(0, 3, 2, 1).reshape(b * dim2, dim1, n)
        row_out = _single_rnn(blk["row_rnn"], row_in)
        row_out = row_out.reshape(b, dim2, dim1, n).permute(0, 3, 2, 1)
        out = out + L.group_norm(row_out, blk["row_norm"], 1, eps=1e-8)

        col_in = out.permute(0, 2, 3, 1).reshape(b * dim1, dim2, n)
        col_out = _single_rnn(blk["col_rnn"], col_in)
        col_out = col_out.reshape(b, dim1, dim2, n).permute(0, 3, 1, 2)
        out = out + L.group_norm(col_out, blk["col_norm"], 1, eps=1e-8)
    # the 1x1 Conv2d + PReLU is a per-position linear (weight (D, N))
    conv = p["conv"]
    out = torch.einsum("bnct,dn->bdct", out, conv["weight"]) + conv["bias"][None, :, None, None]
    out = _merging(L.prelu(out, conv["prelu"]), rest, chunk, stride)
    return out.transpose(1, 2)


def _transformer_layer(p, x, nhead):
    """torch nn.TransformerEncoderLayer in eval mode: post-norm, relu."""
    b, t, d = x.shape
    dh = d // nhead
    q, k, v = (z.reshape(b, t, nhead, dh).transpose(1, 2)
               for z in L.linear(x, p["attn"]["in_proj"]).chunk(3, dim=-1))
    a = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh), dim=-1)
    o = torch.matmul(a, v).transpose(1, 2).reshape(b, t, d)
    x = L.layer_norm(x + L.linear(o, p["attn"]["out_proj"]), p["norm1"])
    ff = L.linear(L.relu(L.linear(x, p["linear1"])), p["linear2"])
    return L.layer_norm(x + ff, p["norm2"])


def _autopool(x, alpha):
    """softmax(x·alpha) attention pool over time."""
    return torch.sum(x * torch.softmax(x * alpha, dim=1), dim=1)


def _range_sigmoid(x, lo, hi):
    return torch.sigmoid(x) * (hi - lo) + lo


def _branch(p, x, metric, nhead):
    out = _autopool(_transformer_layer(p, x, nhead), p["autopool_alpha"])
    out = L.prelu(L.linear(out, p["head1"]), p["head_prelu"])
    out = L.linear(out, p["head2"])[..., 0]
    if metric == "stoi":
        return _range_sigmoid(out, 0.0, 1.0)
    if metric == "pesq":
        return _range_sigmoid(out, _PESQ_LO, _PESQ_HI)
    return out


def apply(params, config, x: torch.Tensor):
    """(B, T) 16 kHz mono -> {stoi, pesq, sisdr} of (B,) scores:
    RMS-normalise to 1/20, encode, DPRNN, one transformer branch a metric."""
    with net_precision(None):
        kw = _kwargs(config)
        if x.ndim != 2:
            raise ValueError(f"input must be (batch, time), got {tuple(x.shape)}")
        x = x / (torch.sqrt(torch.mean(x ** 2, dim=1, keepdim=True)) * 20.0)
        feats = L.relu(L.conv1d(x[:, None, :], params["encoder"]["weight"],
                                stride=kw["win_len"] // 2))
        out = _dprnn(params["dprnn"], feats, kw)
        return {m: _branch(p, out, m, kw["nhead"]) for m, p in zip(METRICS, params["branches"])}


# --------------------------------------------------------------------------
# torch checkpoint conversion (torchaudio SquimObjective key layout)
# --------------------------------------------------------------------------

def convert_torch(state_dict, config=None):
    """torchaudio SquimObjective state dict -> the parameter tree. Every key
    is consumed; leftovers raise."""
    kw = _kwargs(config)
    sd, used, take = _make_take(state_dict)

    def pair(prefix, w="weight", b="bias"):
        return {"weight": take(f"{prefix}.{w}").float(), "bias": take(f"{prefix}.{b}").float()}

    def lstm_dir(prefix, suffix=""):
        return {k: take(f"{prefix}.{k}_l0{suffix}").float()
                for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}

    def single_rnn(prefix):
        return {"lstm": {"fwd": lstm_dir(f"{prefix}.rnn"),
                         "bwd": lstm_dir(f"{prefix}.rnn", "_reverse")},
                "proj": pair(f"{prefix}.proj")}

    blocks = [{"row_rnn": single_rnn(f"dprnn.row_rnn.{i}"),
               "col_rnn": single_rnn(f"dprnn.col_rnn.{i}"),
               "row_norm": pair(f"dprnn.row_norm.{i}"),
               "col_norm": pair(f"dprnn.col_norm.{i}")} for i in range(kw["num_blocks"])]
    branches = []
    for j in range(len(METRICS)):
        b = f"branches.{j}"
        branches.append({
            "attn": {"in_proj": pair(f"{b}.0.self_attn", "in_proj_weight", "in_proj_bias"),
                     "out_proj": pair(f"{b}.0.self_attn.out_proj")},
            "linear1": pair(f"{b}.0.linear1"),
            "linear2": pair(f"{b}.0.linear2"),
            "norm1": pair(f"{b}.0.norm1"),
            "norm2": pair(f"{b}.0.norm2"),
            "autopool_alpha": take(f"{b}.1.alpha").float(),
            "head1": pair(f"{b}.2.0"),
            "head_prelu": take(f"{b}.2.1.weight").float(),
            "head2": pair(f"{b}.2.2"),
        })
    params = {
        "encoder": {"weight": take("encoder.conv1d.weight").float()},
        "dprnn": {"blocks": blocks,
                  "conv": {"weight": take("dprnn.conv.0.weight").float()[:, :, 0, 0],
                           "bias": take("dprnn.conv.0.bias").float(),
                           "prelu": take("dprnn.conv.1.weight").float()}},
        "branches": branches,
    }
    unused = set(sd) - used
    if unused:
        raise ValueError(f"unconsumed checkpoint keys: {sorted(unused)[:8]} ...")
    return params
