"""Shared transformer stack for the roformer family (counterpart of
sesa_tpu/models/roformer_core.py).

Attention with sigmoid per-head output gates, RMSNorm pre-norm, GELU
FeedForward, optional XCiT-style linear attention, optional output RMSNorm.
Parameters are plain dicts of tensors with the JAX package's names and
torch (out, in) layouts.

Dispatch follows the JAX package and depends on device, dtype and shape
only: bf16 tensors on CUDA run kernel K2 (``fused_ff_residual``) and, at the
shapes ``use_fused_attention`` takes, kernel K1 (``fused_attention_block``);
at other shapes the attention block is the unfused chain, whose ``sdpa``
reaches kernel K3 for long sequences. f32 and the CPU run the plain chain.
With ``SESA_INT8_ATTN`` set, K1 is refused and every softmax attention of
``attention_apply`` runs ``sdpa_int8`` (kernel I8 on bf16 CUDA tensors), as
in the JAX package.
Tensor parallelism (``parallel.shard_params``, ``roformer_tp_rule``): the
qkv / out and ff-in / ff-out products run on DTensor shards; each branch
starts with ``tp_input`` and ends in ``local_replicated`` (one all-reduce),
so the residual stream stays a plain tensor.
``transformer_apply_vr`` / ``_hc`` are the value-residual and
hyper-connection stacks of the experimental roformers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sesa_tpu_torch.models import hyper_connections as HC
from sesa_tpu_torch.models.layers import kaiming_uniform, rms_norm
from sesa_tpu_torch.ops.attention import (fused_attention_block, int8_attention_enabled,
                                          l2norm, sdpa, sdpa_int8, use_fused_attention)
from sesa_tpu_torch.ops.ff import fused_ff_residual, use_fused_ff
from sesa_tpu_torch.ops.rope import apply_rope
from sesa_tpu_torch.parallel.mesh import local_replicated, per_head, replicated, tp_input


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def attention_init(generator, dim, heads, dim_head, value_residual=False):
    inner = heads * dim_head
    p = {
        "norm_gamma": torch.ones(dim),
        "qkv_w": kaiming_uniform((inner * 3, dim), dim, generator),
        "gates_w": kaiming_uniform((heads, dim), dim, generator),
        "gates_b": kaiming_uniform((heads,), dim, generator),
        "out_w": kaiming_uniform((dim, inner), inner, generator),
    }
    if value_residual:
        p["vr_mix_w"] = kaiming_uniform((heads, dim), dim, generator)
        p["vr_mix_b"] = kaiming_uniform((heads,), dim, generator)
    return p


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
                     norm_output=False, linear_attn=False, value_residual=False,
                     num_residual_streams=1):
    layers = []
    for i in range(depth):
        attn = (linear_attention_init(generator, dim, heads, dim_head) if linear_attn
                else attention_init(generator, dim, heads, dim_head,
                                    value_residual=value_residual))
        ff = ff_init(generator, dim, ff_mult)
        if num_residual_streams > 1 and not linear_attn:
            # hyper-connections wrap attn and ff (reference
            # bs_roformer_experimental.py:219-228); linear attention stays bare
            attn = {"hc": HC.hc_init(None, dim, num_residual_streams, 2 * i), "branch": attn}
            ff = {"hc": HC.hc_init(None, dim, num_residual_streams, 2 * i + 1), "branch": ff}
        layers.append({"attn": attn, "ff": ff})
    params = {"layers": layers}
    if norm_output:
        params["norm_gamma"] = torch.ones(dim)
    return params


# --------------------------------------------------------------------------
# apply
# --------------------------------------------------------------------------

def attention_apply(p, x, heads, rope=None, value_residual=None, return_values=False):
    """x (..., n, dim) -> (..., n, dim); rope = (cos, sin) tables for n.

    ``value_residual`` is value-residual learning (reference
    bs_roformer_experimental.py:111-135): V is lerped toward the first
    layer's V, given as (b, h, n, dh), with a learned per-head sigmoid mix.
    ``return_values`` also returns the pre-mix V for the layers after.
    """
    lead = x.shape[:-2]
    n, dim = x.shape[-2:]
    xn = rms_norm(tp_input(x, p), p["norm_gamma"]).reshape(-1, n, dim)
    b = xn.shape[0]
    qkv = xn.reshape(b * n, dim) @ p["qkv_w"].T
    dim_head = qkv.shape[-1] // (3 * heads)
    # under tensor parallelism qkv's rows are split across q, k and v: the
    # product's output is made whole before the heads are split (per_head)
    q, k, v = replicated(qkv).reshape(b, n, 3, heads, dim_head).permute(2, 0, 3, 1, 4)
    orig_v = v
    if "vr_mix_w" in p:
        if value_residual is None:
            raise ValueError("a layer with a value-residual mix needs the first layer's values")
        mix = torch.einsum("bnd,hd->bnh", xn, p["vr_mix_w"]) + p["vr_mix_b"]
        mix = torch.sigmoid(mix.permute(0, 2, 1))[..., None]  # (b, h, n, 1)
        v = v + (value_residual.reshape(v.shape) - v) * mix  # lerp
    attend = sdpa_int8 if int8_attention_enabled() else sdpa  # int8: kernel I8

    def core(q, k, v, *tables):
        if tables:
            q, k = apply_rope(q, *tables), apply_rope(k, *tables)
        return attend(q, k, v)  # (b, h, n, dh)

    out = per_head(core, q, k, v, shared=rope or ())
    gates = torch.einsum("bnd,hd->bnh", xn, p["gates_w"]) + p["gates_b"]
    out = out * torch.sigmoid(gates.permute(0, 2, 1))[..., None]
    out = out.permute(0, 2, 1, 3).reshape(b * n, heads * dim_head) @ p["out_w"].T
    out = local_replicated(out.reshape(lead + (n, dim)))
    if return_values:
        return out, orig_v
    return out


def attention_apply_residual(p, x, heads, rope=None):
    """attention_apply(x) + x; at the shapes ``use_fused_attention`` takes
    (bf16 on CUDA) the whole block runs as K1."""
    n, dim = x.shape[-2:]
    dim_head = p["qkv_w"].shape[0] // (3 * heads)
    if "vr_mix_w" not in p and use_fused_attention(x, heads, dim_head):
        out = fused_attention_block(
            x.reshape(-1, n, dim), p["norm_gamma"], p["qkv_w"], p["gates_w"],
            p["gates_b"], p["out_w"], heads, dim_head ** -0.5, rope=rope)
        return out.reshape(x.shape)
    return attention_apply(p, x, heads, rope=rope) + x


def linear_attention_apply(p, x, heads, scale=8.0):
    """XCiT-style linear attention (reference bs_roformer.py:124-175)."""
    lead = x.shape[:-2]
    n, dim = x.shape[-2:]
    xn = rms_norm(tp_input(x, p), p["norm_gamma"]).reshape(-1, n, dim)
    b = xn.shape[0]
    qkv = xn @ p["qkv_w"].T
    dim_head = qkv.shape[-1] // (3 * heads)
    # reference packs 'b n (qkv h d) -> qkv b h d n'
    q, k, v = qkv.reshape(b, n, 3, heads, dim_head).permute(2, 0, 3, 4, 1)
    q = l2norm(q) * torch.exp(p["temperature"])
    k = l2norm(k)
    out = per_head(lambda a, b_, c: sdpa(a, b_, c, scale=scale), q, k, v)  # (b, h, dh, n)
    out = out.permute(0, 3, 1, 2).reshape(b, n, heads * dim_head) @ p["out_w"].T
    return local_replicated(out.reshape(lead + (n, dim)))


def ff_apply(p, x):
    shape = x.shape
    xn = rms_norm(tp_input(x, p), p["norm_gamma"]).reshape(-1, shape[-1])
    h = xn @ p["lin1_w"].T + p["lin1_b"]
    # tanh-GELU under bf16, exact erf in f32 (sesa_tpu roformer_core.py:205-207)
    h = F.gelu(h, approximate="tanh" if x.dtype == torch.bfloat16 else "none")
    h = h @ p["lin2_w"].T + p["lin2_b"]
    return local_replicated(h.reshape(shape))


def ff_apply_residual(p, x):
    """ff_apply(x) + x; at the shapes ``use_fused_ff`` takes (bf16 on CUDA)
    it runs as K2."""
    if use_fused_ff(x, p["lin1_w"]):
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


def transformer_apply_hc(params, x, heads, rope=None, value_residual=None, streams=2):
    """Experimental transformer with hyper-connections (streams > 1).

    x arrives with the streams folded into the leading batch dims (the model
    expands once before the depth loop, reference
    bs_roformer_experimental.py:558-560). As the reference
    Transformer.forward: the first call of a value-residual thread
    (``value_residual`` None) runs the "old weights" path with explicit
    residual adds on top of the hyper-connection writes; later calls let the
    hyper-connections own the residual stream. The branches see one mixed
    input, (b, n, d) with b the leading dims over the streams, so their
    attention is the unfused chain (``sdpa`` reaches K3 for long sequences).
    Returns (x, first_layer_values).
    """
    lead = x.shape[:-2]
    n, dim = x.shape[-2:]
    xb = x.reshape(-1, n, dim)
    old_style = value_residual is None
    first_values = None
    for layer in params["layers"]:
        pa, pf = layer["attn"], layer["ff"]

        def attn_branch(bi, _pa=pa["branch"]):
            return attention_apply(_pa, bi, heads, rope=rope, value_residual=value_residual,
                                   return_values=True)

        def ff_branch(bi, _pf=pf["branch"]):
            return ff_apply(_pf, bi)

        out, next_values = HC.hc_apply(pa["hc"], xb, streams, attn_branch)
        if first_values is None:
            first_values = next_values
        if old_style:
            xb = out + xb
            xb = HC.hc_apply(pf["hc"], xb, streams, ff_branch) + xb
        else:
            xb = HC.hc_apply(pf["hc"], out, streams, ff_branch)
    xb = xb.reshape(lead + (n, dim))
    if "norm_gamma" in params:
        xb = rms_norm(xb, params["norm_gamma"])
    return xb, first_values


def transformer_apply_vr(params, x, heads, rope=None, value_residual=None, streams=1):
    """Transformer with value-residual threading (reference
    bs_roformer_experimental.py:239-258). Returns (x, first_layer_values).

    With ``value_residual`` given, the reference's new-style forward applies
    no explicit residual adds around attn and ff; with None it is the
    standard residual form. Where ``use_fused_attention`` takes the shape,
    every layer runs K1 in its value-residual modes and V is threaded as
    (..., n, h·dh); elsewhere the unfused chain threads it as (b, h, n, dh).
    The gate depends on device, dtype and shape only, which are the same for
    every stack of one model run, so one run never mixes the two layouts.
    (The first depth layer has no ``vr_mix_w``.)
    """
    if streams > 1:
        return transformer_apply_hc(params, x, heads, rope=rope,
                                    value_residual=value_residual, streams=streams)
    n, dim = x.shape[-2:]
    p0 = params["layers"][0]["attn"]
    dim_head = p0["qkv_w"].shape[0] // (3 * heads)

    first_values = None
    if use_fused_attention(x, heads, dim_head):
        shape = x.shape
        vres = (None if value_residual is None
                else value_residual.reshape(-1, n, heads * dim_head))
        for layer in params["layers"]:
            p = layer["attn"]
            has_mix = "vr_mix_w" in p
            if has_mix and vres is None:
                raise ValueError("a layer with a value-residual mix needs the first "
                                 "layer's values")
            out, next_values = fused_attention_block(
                x.reshape(-1, n, dim), p["norm_gamma"], p["qkv_w"], p["gates_w"],
                p["gates_b"], p["out_w"], heads, dim_head ** -0.5, rope=rope,
                vr=(p.get("vr_mix_w"), p.get("vr_mix_b"), vres if has_mix else None),
                add_residual=vres is None)
            if first_values is None:
                first_values = next_values
            out = out.reshape(shape)
            # old-style forward: explicit residuals around attn and ff
            x = ff_apply_residual(layer["ff"], out) if vres is None else ff_apply(layer["ff"], out)
        first_values = first_values.reshape(shape[:-1] + (heads * dim_head,))
    elif value_residual is not None:
        for layer in params["layers"]:
            x, next_values = attention_apply(layer["attn"], x, heads, rope=rope,
                                             value_residual=value_residual, return_values=True)
            if first_values is None:
                first_values = next_values
            x = ff_apply(layer["ff"], x)
    else:
        for layer in params["layers"]:
            attn_out, next_values = attention_apply(layer["attn"], x, heads, rope=rope,
                                                    return_values=True)
            if first_values is None:
                first_values = next_values
            x = ff_apply_residual(layer["ff"], attn_out + x)
    if "norm_gamma" in params:
        x = rms_norm(x, params["norm_gamma"])
    return x, first_values


# --------------------------------------------------------------------------
# torch state-dict conversion
# --------------------------------------------------------------------------

def convert_transformer(take, prefix, depth, norm_output=False, linear_attn=False,
                        value_residual=False, num_residual_streams=1):
    """Convert one reference Transformer given a ``take(key)`` accessor."""
    layers = []
    hc = num_residual_streams > 1 and not linear_attn
    for i in range(depth):
        a = f"{prefix}.layers.{i}.0"
        f = f"{prefix}.layers.{i}.1"
        if hc:
            # hyper-connection wrappers hold the branch under '.branch'
            a_hc, f_hc = HC.hc_convert(take, a), HC.hc_convert(take, f)
            a, f = f"{a}.branch", f"{f}.branch"
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
            if value_residual:
                attn["vr_mix_w"] = take(f"{a}.to_value_residual_mix.weight")
                attn["vr_mix_b"] = take(f"{a}.to_value_residual_mix.bias")
        ff = {
            "norm_gamma": take(f"{f}.net.0.gamma"),
            "lin1_w": take(f"{f}.net.1.weight"),
            "lin1_b": take(f"{f}.net.1.bias"),
            "lin2_w": take(f"{f}.net.4.weight"),
            "lin2_b": take(f"{f}.net.4.bias"),
        }
        if hc:
            attn = {"hc": a_hc, "branch": attn}
            ff = {"hc": f_hc, "branch": ff}
        layers.append({"attn": attn, "ff": ff})
    params = {"layers": layers}
    if norm_output:
        params["norm_gamma"] = take(f"{prefix}.norm.gamma")
    return params
