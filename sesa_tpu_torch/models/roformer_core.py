"""Shared transformer stack for the roformer family (counterpart of
sesa_tpu/models/roformer_core.py).

Attention with sigmoid per-head output gates, RMSNorm pre-norm, GELU
FeedForward, optional XCiT-style linear attention, optional output RMSNorm.
Parameters are plain dicts of tensors with the JAX package's names and
torch (out, in) layouts.

Dispatch follows the JAX package: bf16 tensors on CUDA run kernels K1
(``fused_attention_block``) and K2 (``fused_ff_residual``); everything else
(f32, the CPU) runs the plain chain. The value-residual and
hyper-connection stacks (``transformer_apply_vr`` / ``_hc``) are not ported
yet (ROADMAP queue 1).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sesa_tpu_torch.models.layers import kaiming_uniform, rms_norm
from sesa_tpu_torch.ops.attention import fused_attention_block, l2norm, sdpa
from sesa_tpu_torch.ops.ff import fused_ff_residual
from sesa_tpu_torch.ops.rope import apply_rope


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def attention_init(generator, dim, heads, dim_head):
    inner = heads * dim_head
    return {
        "norm_gamma": torch.ones(dim),
        "qkv_w": kaiming_uniform((inner * 3, dim), dim, generator),
        "gates_w": kaiming_uniform((heads, dim), dim, generator),
        "gates_b": kaiming_uniform((heads,), dim, generator),
        "out_w": kaiming_uniform((dim, inner), inner, generator),
    }


def linear_attention_init(generator, dim, heads, dim_head):
    inner = heads * dim_head
    return {
        "norm_gamma": torch.ones(dim),
        "qkv_w": kaiming_uniform((inner * 3, dim), dim, generator),
        "temperature": torch.ones((heads, 1, 1)),
        "out_w": kaiming_uniform((dim, inner), inner, generator),
    }


def ff_init(generator, dim, mult):
    inner = int(dim * mult)
    return {
        "norm_gamma": torch.ones(dim),
        "lin1_w": kaiming_uniform((inner, dim), dim, generator),
        "lin1_b": kaiming_uniform((inner,), dim, generator),
        "lin2_w": kaiming_uniform((dim, inner), inner, generator),
        "lin2_b": kaiming_uniform((dim,), inner, generator),
    }


def transformer_init(generator, dim, depth, heads, dim_head, ff_mult=4,
                     norm_output=False, linear_attn=False):
    layers = []
    for _ in range(depth):
        attn = (linear_attention_init if linear_attn else attention_init)(
            generator, dim, heads, dim_head)
        layers.append({"attn": attn, "ff": ff_init(generator, dim, ff_mult)})
    params = {"layers": layers}
    if norm_output:
        params["norm_gamma"] = torch.ones(dim)
    return params


# --------------------------------------------------------------------------
# apply
# --------------------------------------------------------------------------

def _fused(x: torch.Tensor) -> bool:
    return x.device.type == "cuda" and x.dtype == torch.bfloat16


def attention_apply(p, x, heads, rope=None):
    """x (..., n, dim) -> (..., n, dim); rope = (cos, sin) tables for n."""
    lead = x.shape[:-2]
    n, dim = x.shape[-2:]
    xn = rms_norm(x, p["norm_gamma"]).reshape(-1, n, dim)
    b = xn.shape[0]
    qkv = xn.reshape(b * n, dim) @ p["qkv_w"].T
    dim_head = qkv.shape[-1] // (3 * heads)
    q, k, v = qkv.reshape(b, n, 3, heads, dim_head).permute(2, 0, 3, 1, 4)
    if rope is not None:
        q = apply_rope(q, *rope)
        k = apply_rope(k, *rope)
    out = sdpa(q, k, v)  # (b, h, n, dh)
    gates = torch.einsum("bnd,hd->bnh", xn, p["gates_w"]) + p["gates_b"]
    out = out * torch.sigmoid(gates.permute(0, 2, 1))[..., None]
    out = out.permute(0, 2, 1, 3).reshape(b * n, heads * dim_head) @ p["out_w"].T
    return out.reshape(lead + (n, dim))


def attention_apply_residual(p, x, heads, rope=None):
    """attention_apply(x) + x; bf16 on CUDA runs the whole block as K1."""
    n, dim = x.shape[-2:]
    dim_head = p["qkv_w"].shape[0] // (3 * heads)
    if _fused(x):
        out = fused_attention_block(
            x.reshape(-1, n, dim), p["norm_gamma"], p["qkv_w"], p["gates_w"],
            p["gates_b"], p["out_w"], heads, dim_head ** -0.5, rope=rope)
        return out.reshape(x.shape)
    return attention_apply(p, x, heads, rope=rope) + x


def linear_attention_apply(p, x, heads, scale=8.0):
    """XCiT-style linear attention (reference bs_roformer.py:124-175)."""
    lead = x.shape[:-2]
    n, dim = x.shape[-2:]
    xn = rms_norm(x, p["norm_gamma"]).reshape(-1, n, dim)
    b = xn.shape[0]
    qkv = xn @ p["qkv_w"].T
    dim_head = qkv.shape[-1] // (3 * heads)
    # reference packs 'b n (qkv h d) -> qkv b h d n'
    q, k, v = qkv.reshape(b, n, 3, heads, dim_head).permute(2, 0, 3, 4, 1)
    q = l2norm(q) * torch.exp(p["temperature"])
    k = l2norm(k)
    out = sdpa(q, k, v, scale=scale)  # (b, h, dh, n)
    out = out.permute(0, 3, 1, 2).reshape(b, n, heads * dim_head) @ p["out_w"].T
    return out.reshape(lead + (n, dim))


def ff_apply(p, x):
    shape = x.shape
    xn = rms_norm(x, p["norm_gamma"]).reshape(-1, shape[-1])
    h = xn @ p["lin1_w"].T + p["lin1_b"]
    # tanh-GELU under bf16, exact erf in f32 (sesa_tpu roformer_core.py:205-207)
    h = F.gelu(h, approximate="tanh" if x.dtype == torch.bfloat16 else "none")
    h = h @ p["lin2_w"].T + p["lin2_b"]
    return h.reshape(shape)


def ff_apply_residual(p, x):
    """ff_apply(x) + x; bf16 on CUDA runs as K2."""
    if _fused(x):
        out = fused_ff_residual(x.reshape(-1, x.shape[-1]), p["norm_gamma"],
                                p["lin1_w"], p["lin1_b"], p["lin2_w"], p["lin2_b"])
        return out.reshape(x.shape)
    return ff_apply(p, x) + x


def transformer_apply(params, x, heads, rope=None, linear_attn=False):
    for layer in params["layers"]:
        if linear_attn:
            x = linear_attention_apply(layer["attn"], x, heads) + x
        else:
            x = attention_apply_residual(layer["attn"], x, heads, rope=rope)
        x = ff_apply_residual(layer["ff"], x)
    if "norm_gamma" in params:
        x = rms_norm(x, params["norm_gamma"])
    return x


# --------------------------------------------------------------------------
# torch state-dict conversion
# --------------------------------------------------------------------------

def convert_transformer(take, prefix, depth, norm_output=False, linear_attn=False):
    """Convert one reference Transformer given a ``take(key)`` accessor."""
    layers = []
    for i in range(depth):
        a = f"{prefix}.layers.{i}.0"
        f = f"{prefix}.layers.{i}.1"
        if linear_attn:
            attn = {
                "norm_gamma": take(f"{a}.norm.gamma"),
                "qkv_w": take(f"{a}.to_qkv.0.weight"),
                "temperature": take(f"{a}.temperature"),
                "out_w": take(f"{a}.to_out.1.weight"),
            }
        else:
            attn = {
                "norm_gamma": take(f"{a}.norm.gamma"),
                "qkv_w": take(f"{a}.to_qkv.weight"),
                "gates_w": take(f"{a}.to_gates.weight"),
                "gates_b": take(f"{a}.to_gates.bias"),
                "out_w": take(f"{a}.to_out.0.weight"),
            }
        ff = {
            "norm_gamma": take(f"{f}.net.0.gamma"),
            "lin1_w": take(f"{f}.net.1.weight"),
            "lin1_b": take(f"{f}.net.1.bias"),
            "lin2_w": take(f"{f}.net.4.weight"),
            "lin2_b": take(f"{f}.net.4.bias"),
        }
        layers.append({"attn": attn, "ff": ff})
    params = {"layers": layers}
    if norm_output:
        params["norm_gamma"] = take(f"{prefix}.norm.gamma")
    return params
