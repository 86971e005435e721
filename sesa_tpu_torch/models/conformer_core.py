"""Conformer block stack, lucidrains ``conformer`` semantics (counterpart of
sesa_tpu/models/conformer_core.py).

ConformerBlock = 0.5·FF → self-attention with Shaw relative-position
embeddings → conv module (pointwise-GLU → depthwise → eval BatchNorm →
swish → pointwise) → 0.5·FF → LayerNorm, all pre-normed with residuals.
Parameters are plain dicts of tensors with the JAX package's names and
torch layouts; converter keys follow the lucidrains module layout
(``layers.{i}.{ff1,attn,conv,ff2,post_norm}``).

Tensor parallelism (``parallel.shard_params`` with ``conformer_tp_rule``):
the feed-forwards' and the attention's products run on DTensor shards; each
of those branches starts with ``tp_input`` and ends in ``local_replicated``
(one all-reduce of its partial sums), so the residual stream stays a plain
tensor.

Dispatch: on bf16 CUDA tensors ``use_fused_conformer`` chooses, per
sub-module, kernel K2 (LayerNorm/SiLU/0.5 form) for both feed-forwards, K4
for the attention and K5 for the conv where each takes the shape; a
sub-module whose kernel does not runs its plain chain, and everything else
(f32, the CPU) runs the plain chain throughout.
"""

from __future__ import annotations

import json
import os

import torch
import torch.nn.functional as F

from sesa_tpu_torch import to_device
from sesa_tpu_torch.models.layers import kaiming_uniform, layer_norm, swish
from sesa_tpu_torch.ops.attention import (conformer_attention_shape_ok,
                                          fused_conformer_attention, shaw_rel_index)
from sesa_tpu_torch.ops.convblock import conformer_conv_shape_ok, conv_pad, fused_conformer_conv
from sesa_tpu_torch.ops.ff import ff_shape_ok, fused_ff_residual
from sesa_tpu_torch.parallel.mesh import local_replicated, per_head, replicated, tp_input

MAX_POS_EMB = 512


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _lin(generator, ci, co, bias=True):
    p = {"weight": kaiming_uniform((co, ci), ci, generator)}
    if bias:
        p["bias"] = kaiming_uniform((co,), ci, generator)
    return p


def _norm(dim):
    return {"weight": torch.ones(dim), "bias": torch.zeros(dim)}


def conformer_block_init(generator, dim, dim_head=64, heads=8, ff_mult=4,
                         conv_expansion_factor=2, conv_kernel_size=31):
    """Random block parameters drawn on the CPU from ``generator`` (the numbers
    differ from the JAX package's init)."""
    inner = dim_head * heads
    conv_inner = dim * conv_expansion_factor

    def ff():
        return {"norm": _norm(dim), "lin1": _lin(generator, dim, dim * ff_mult),
                "lin2": _lin(generator, dim * ff_mult, dim)}

    return {
        "ff1": ff(),
        "attn": {
            "norm": _norm(dim),
            "to_q": _lin(generator, dim, inner, bias=False),
            "to_kv": _lin(generator, dim, inner * 2, bias=False),
            "to_out": _lin(generator, inner, dim),
            "rel_pos_emb": 0.02 * torch.randn((2 * MAX_POS_EMB + 1, dim_head),
                                              generator=generator),
        },
        "conv": {
            "norm": _norm(dim),
            "pw1": {"weight": kaiming_uniform((conv_inner * 2, dim, 1), dim, generator),
                    "bias": kaiming_uniform((conv_inner * 2,), dim, generator)},
            "dw": {"weight": kaiming_uniform((conv_inner, 1, conv_kernel_size),
                                             conv_kernel_size, generator),
                   "bias": kaiming_uniform((conv_inner,), conv_kernel_size, generator)},
            "bn": {"weight": torch.ones(conv_inner), "bias": torch.zeros(conv_inner),
                   "running_mean": torch.zeros(conv_inner),
                   "running_var": torch.ones(conv_inner)},
            "pw2": {"weight": kaiming_uniform((dim, conv_inner, 1), conv_inner, generator),
                    "bias": kaiming_uniform((dim,), conv_inner, generator)},
        },
        "ff2": ff(),
        "post_norm": _norm(dim),
    }


def conformer_init(generator, dim, depth, **kwargs):
    return {"layers": [conformer_block_init(generator, dim, **kwargs) for _ in range(depth)]}


# --------------------------------------------------------------------------
# apply: the plain chain
# --------------------------------------------------------------------------

def _ff_apply(p, x):
    y = layer_norm(tp_input(x, p), p["norm"])
    y = swish(y @ p["lin1"]["weight"].T + p["lin1"]["bias"])
    return local_replicated(0.5 * (y @ p["lin2"]["weight"].T + p["lin2"]["bias"]))


def _attn_apply(p, x, heads):
    """(b, n, d) -> the attention branch (no residual); Shaw bias with
    dist[i, j] = i - j and P from the table's own rows."""
    b, n, dim = x.shape
    xn = layer_norm(tp_input(x, p), p["norm"])
    q = xn @ p["to_q"]["weight"].T
    kv = xn @ p["to_kv"]["weight"].T
    dh = q.shape[-1] // heads
    q = q.reshape(b, n, heads, dh).permute(0, 2, 1, 3)
    # under tensor parallelism kv's rows are split across K and V: the
    # product's output is made whole before the heads are split (per_head)
    k, v = replicated(kv).reshape(b, n, 2, heads, dh).permute(2, 0, 3, 1, 4)
    scale = dh ** -0.5

    max_pos = (p["rel_pos_emb"].shape[0] - 1) // 2
    dist = to_device(shaw_rel_index(n, max_pos), x.device)

    def core(q, k, v, table):
        rel = table[dist]  # (n, n, dh)
        pos_attn = torch.einsum("bhnd,nrd->bhnr", q, rel) * scale
        sim = torch.einsum("bhid,bhjd->bhij", q, k) * scale + pos_attn
        attn = torch.softmax(sim.float(), dim=-1).to(q.dtype)
        return torch.einsum("bhij,bhjd->bhid", attn, v)

    out = per_head(core, q, k, v, shared=(p["rel_pos_emb"],))
    out = out.permute(0, 2, 1, 3).reshape(b, n, heads * dh)
    return local_replicated(out @ p["to_out"]["weight"].T + p["to_out"]["bias"])


def _conv_apply(p, x):
    """(b, n, d) conv module, channels last; lucidrains 'same' padding
    (k // 2, k // 2 - (k + 1) % 2), eval BatchNorm."""
    y = layer_norm(x, p["norm"])
    y = y @ p["pw1"]["weight"][:, :, 0].T + p["pw1"]["bias"]
    a, g = y.chunk(2, dim=-1)
    y = a * torch.sigmoid(g)  # GLU over channels
    kernel = p["dw"]["weight"].shape[-1]
    y = F.conv1d(F.pad(y.transpose(1, 2), conv_pad(kernel)), p["dw"]["weight"],
                 p["dw"]["bias"], groups=y.shape[-1]).transpose(1, 2)
    bn = p["bn"]
    scale = bn["weight"].float() * torch.rsqrt(bn["running_var"].float() + 1e-5)
    shift = bn["bias"].float() - bn["running_mean"].float() * scale
    y = swish(y * scale.to(y.dtype) + shift.to(y.dtype))
    return y @ p["pw2"]["weight"][:, :, 0].T + p["pw2"]["bias"]


# --------------------------------------------------------------------------
# apply: dispatch
# --------------------------------------------------------------------------

def fused_conformer_shape_ok(n: int, dim_head: int, dim: int) -> bool:
    """The shapes the TPU gate admits (sesa_tpu conformer_core.py:172-179):
    n <= 2048, dim_head <= 128 and a model dim that is a multiple of 64."""
    return n <= 2048 and dim_head <= 128 and dim % 64 == 0


def conformer_kernels(device_type: str, dtype, batch: int, n: int, dim: int, heads: int,
                      dim_head: int, hidden: int, e: int, k: int) -> frozenset:
    """The kernels a conformer block runs, a subset of {"K2", "K4", "K5"}: a
    pure function of the device type, the dtype and the shapes (``batch``
    sequences of ``n`` tokens of width ``dim``, ``heads`` × ``dim_head``,
    feed-forward ``hidden``, conv width ``e`` and ``k`` taps).

    Only bf16 CUDA blocks of a shape :func:`fused_conformer_shape_ok`
    admits take kernels, and each kernel only where its wrapper takes the
    shape: K2 (both feed-forwards) :func:`ff_shape_ok`, K4
    :func:`conformer_attention_shape_ok`, K5 :func:`conformer_conv_shape_ok`.
    A sub-module whose kernel is not taken runs its unfused chain and the
    residual, as sesa_tpu/models/conformer_core.py:182-216 does for the conv."""
    if device_type != "cuda" or dtype != torch.bfloat16 \
            or not fused_conformer_shape_ok(n, dim_head, dim):
        return frozenset()
    take = {"K2": ff_shape_ok(batch * n, dim, hidden),
            "K4": conformer_attention_shape_ok(batch, n, dim, heads, dim_head),
            "K5": conformer_conv_shape_ok(batch, n, dim, e, k)}
    return frozenset(name for name, ok in take.items() if ok)


def use_fused_conformer(x, p, heads) -> frozenset:
    """:func:`conformer_kernels` for x (..., n, dim) and the block ``p``; empty
    (false) on the CPU and in f32, with no state and no environment knobs."""
    n, dim = x.shape[-2:]
    dh = p["attn"]["to_q"]["weight"].shape[0] // heads
    conv = p["conv"]
    return conformer_kernels(x.device.type, x.dtype, x.numel() // max(n * dim, 1), n, dim, heads,
                             dh, p["ff1"]["lin1"]["weight"].shape[0],
                             conv["pw2"]["weight"].shape[1], conv["dw"]["weight"].shape[-1])


def _ff_fused(p, x):
    out = fused_ff_residual(x.reshape(-1, x.shape[-1]), p["norm"]["weight"],
                            p["lin1"]["weight"], p["lin1"]["bias"], p["lin2"]["weight"],
                            p["lin2"]["bias"], beta=p["norm"]["bias"], norm="ln", act="swish",
                            out_scale=0.5)
    return out.reshape(x.shape)


def conformer_block_apply(p, x, heads):
    """(b, n, d) -> (b, n, d); each sub-module through its kernel where
    :func:`use_fused_conformer` takes it, else its plain chain."""
    fused = use_fused_conformer(x, p, heads)
    x = _ff_fused(p["ff1"], x) if "K2" in fused else _ff_apply(p["ff1"], x) + x
    if "K4" in fused:
        a = p["attn"]
        wqkv = torch.cat([a["to_q"]["weight"], a["to_kv"]["weight"]], dim=0)
        x = fused_conformer_attention(x, a["norm"]["weight"], a["norm"]["bias"], wqkv,
                                      a["rel_pos_emb"], a["to_out"]["weight"],
                                      a["to_out"]["bias"], heads)
    else:
        x = _attn_apply(p["attn"], x, heads) + x
    x = fused_conformer_conv(x, p["conv"]) if "K5" in fused else _conv_apply(p["conv"], x) + x
    x = _ff_fused(p["ff2"], x) if "K2" in fused else _ff_apply(p["ff2"], x) + x
    return layer_norm(x, p["post_norm"])


def conformer_apply(params, x, heads):
    """(B, N, D) -> (B, N, D)."""
    for block in params["layers"]:
        x = conformer_block_apply(block, x, heads)
    return x


# --------------------------------------------------------------------------
# torch conversion (lucidrains conformer key layout)
# --------------------------------------------------------------------------

def apply_key_map(state_dict):
    """Field-recovery hatch for conformer-family checkpoints whose module
    layout differs from the assumed lucidrains reconstruction. Set
    ``SESA_CONFORMER_KEY_MAP`` to a JSON file of
    ``{"actual_key_or_prefix": "expected_key_or_prefix"}``; checkpoint keys
    are renamed (exact match first, else the longest matching prefix; suffix
    a map key with ``$`` to forbid prefix matching) before conversion. See
    README 'Conformer checkpoint layout recovery'.
    """
    path = os.environ.get("SESA_CONFORMER_KEY_MAP")
    if not path:
        return state_dict
    with open(path, encoding="utf-8") as f:
        key_map = json.load(f)
    prefixes = sorted((k for k in key_map if not k.endswith("$")), key=len, reverse=True)
    out = {}
    for k, v in state_dict.items():
        if k in key_map or k + "$" in key_map:
            out[key_map.get(k, key_map.get(k + "$"))] = v
            continue
        for pre in prefixes:
            if k.startswith(pre):
                out[key_map[pre] + k[len(pre):]] = v
                break
        else:
            out[k] = v
    return out


def convert_conformer(take, prefix, depth):
    """Convert one lucidrains Conformer given a ``take(key)`` accessor."""
    def wb(pfx, bias=True):
        p = {"weight": take(f"{pfx}.weight")}
        if bias:
            p["bias"] = take(f"{pfx}.bias")
        return p

    def ff(fp):
        return {"norm": wb(f"{fp}.fn.norm"), "lin1": wb(f"{fp}.fn.fn.net.0"),
                "lin2": wb(f"{fp}.fn.fn.net.3")}

    layers = []
    for i in range(depth):
        b = f"{prefix}.layers.{i}"
        layers.append({
            "ff1": ff(f"{b}.ff1"),
            "attn": {
                "norm": wb(f"{b}.attn.norm"),
                "to_q": wb(f"{b}.attn.fn.to_q", bias=False),
                "to_kv": wb(f"{b}.attn.fn.to_kv", bias=False),
                "to_out": wb(f"{b}.attn.fn.to_out"),
                "rel_pos_emb": take(f"{b}.attn.fn.rel_pos_emb.weight"),
            },
            "conv": {
                "norm": wb(f"{b}.conv.net.0"),
                "pw1": wb(f"{b}.conv.net.2"),
                "dw": wb(f"{b}.conv.net.4.conv"),
                "bn": {**wb(f"{b}.conv.net.5"),
                       "running_mean": take(f"{b}.conv.net.5.running_mean"),
                       "running_var": take(f"{b}.conv.net.5.running_var")},
                "pw2": wb(f"{b}.conv.net.7"),
            },
            "ff2": ff(f"{b}.ff2"),
            "post_norm": wb(f"{b}.post_norm"),
        })
    return {"layers": layers}
