"""swin_upernet, an STFT image through a Swin-backbone UperNet (counterpart
of sesa_tpu/models/swin_upernet.py).

The mdx23c-style shell of ``segm_models`` (STFT with complex as channels,
subband fold, 1x1 first conv, the net's output gated by the first conv's,
final 1x1 convs, iSTFT) around HuggingFace's
``UperNetForSemanticSegmentation`` with a Swin backbone, at inference:

* Swin backbone: patch embed (conv + LayerNorm), stages of shifted-window
  attention blocks with a relative position bias (always partitioned, as
  HF's SwinBackbone does), patch merging between stages, a LayerNorm on
  each stage's feature map.
* UperNet decode head: pyramid pooling over the top stage, FPN lateral and
  top-down fusion, conv + BatchNorm + ReLU modules, bilinear resizes.
* The auxiliary FCN head only feeds the training loss: ``convert_torch``
  accepts its weights and nothing runs them.

Window attention is plain products and an f32 softmax, as in the JAX
package (no kernel of the port). Defaults are openmmlab/upernet-swin-large's:
embed 192, depths 2/2/18/2, heads 6/12/24/48, window 12, UperNet hidden 512,
pool scales 1/2/3/6; config.model overrides each.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from sesa_tpu_torch.models import layers as L
from sesa_tpu_torch.models.bs_roformer import _make_take
from sesa_tpu_torch.models.mdx23c import (_cac2cws, _cws2cac, inverse_spectrogram,
                                          num_target_instruments, prepare, spectrogram)
from sesa_tpu_torch.models.segm_models import _dims
from sesa_tpu_torch.ops.prec import net_precision


def _swin_kwargs(config):
    kw = dict(embed_dim=192, depths=[2, 2, 18, 2], num_heads=[6, 12, 24, 48],
              window_size=12, patch_size=4, mlp_ratio=4.0, qkv_bias=True,
              layer_norm_eps=1e-5, upernet_hidden=512, pool_scales=[1, 2, 3, 6])
    kw.update({k: v for k, v in dict(config.model).items() if k in kw})
    for key in ("depths", "num_heads", "pool_scales"):
        kw[key] = list(kw[key])
    return kw


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init(generator: torch.Generator, config):
    """Random parameters drawn on the CPU from ``generator`` (the numbers
    differ from the JAX package's init; the tree is the same)."""
    _, dim_c, c = _dims(config)
    kw = _swin_kwargs(config)
    s = num_target_instruments(config)
    emb, win, hid = kw["embed_dim"], kw["window_size"], kw["upernet_hidden"]

    def dense(ci, co, bias=True):
        d = {"weight": L.kaiming_uniform((co, ci), ci, generator)}
        if bias:
            d["bias"] = torch.zeros(co)
        return d

    def ln(d):
        return {"weight": torch.ones(d), "bias": torch.zeros(d)}

    def conv(ci, co, kh, kwd):
        return L.kaiming_uniform((co, ci, kh, kwd), ci * kh * kwd, generator)

    def conv_module(ci, co, kk):
        return {"conv_w": conv(ci, co, kk, kk),
                "bn": {"weight": torch.ones(co), "bias": torch.zeros(co),
                       "running_mean": torch.zeros(co), "running_var": torch.ones(co)}}

    def block(dim, heads):
        hidden = int(kw["mlp_ratio"] * dim)
        return {"ln1": ln(dim), "q": dense(dim, dim), "k": dense(dim, dim),
                "v": dense(dim, dim), "proj": dense(dim, dim),
                "rel_bias": 0.02 * torch.randn(((2 * win - 1) ** 2, heads), generator=generator),
                "ln2": ln(dim), "mlp1": dense(dim, hidden), "mlp2": dense(hidden, dim)}

    n_stages = len(kw["depths"])
    in_ch = [emb * 2 ** i for i in range(n_stages)]
    stages = []
    for i, (depth, heads) in enumerate(zip(kw["depths"], kw["num_heads"])):
        st = {"blocks": [block(in_ch[i], heads) for _ in range(depth)]}
        if i < n_stages - 1:
            st["downsample"] = {"norm": ln(4 * in_ch[i]),
                                "reduction": dense(4 * in_ch[i], 2 * in_ch[i], bias=False)}
        stages.append(st)

    head = {
        "psp": [conv_module(in_ch[-1], hid, 1) for _ in kw["pool_scales"]],
        "bottleneck": conv_module(in_ch[-1] + len(kw["pool_scales"]) * hid, hid, 3),
        "laterals": [conv_module(ci, hid, 1) for ci in in_ch[:-1]],
        "fpn": [conv_module(hid, hid, 3) for _ in in_ch[:-1]],
        "fpn_bottleneck": conv_module(n_stages * hid, hid, 3),
        "classifier": {"weight": conv(hid, c, 1, 1), "bias": torch.zeros(c)},
    }
    return {
        "first_conv": conv(dim_c, c, 1, 1),
        "backbone": {
            "patch_proj": {"weight": conv(c, emb, kw["patch_size"], kw["patch_size"]),
                           "bias": torch.zeros(emb)},
            "embed_norm": ln(emb),
            "stages": stages,
            "stage_norms": [ln(d) for d in in_ch],
        },
        "decode_head": head,
        "final_conv1": conv(c + dim_c, c, 1, 1),
        "final_conv2": conv(c, s * dim_c, 1, 1),
    }


# --------------------------------------------------------------------------
# swin backbone
# --------------------------------------------------------------------------

# LayerNorm with its statistics in x's dtype, as the JAX function has it
_layer_norm = L.layer_norm


# The index and the mask are built on the device: uploaded from host memory,
# each copy would make the host wait for the queued kernels


def _rel_position_index(win, device=None):
    """(N, N) index of each window position pair into the bias table."""
    coords = torch.stack(torch.meshgrid(torch.arange(win, device=device),
                                        torch.arange(win, device=device), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # (2, N, N)
    return (rel[0] + win - 1) * (2 * win - 1) + rel[1] + win - 1


def _shift_mask(hp, wp, win, shift, device=None):
    """HF get_attn_mask: (num_windows, N, N) additive f32 mask of 0 / -100 on
    the padded map."""
    img = torch.zeros((hp, wp), device=device)
    cnt = 0
    for hs in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
        for ws in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    m = img.reshape(hp // win, win, wp // win, win).permute(0, 2, 1, 3).reshape(-1, win * win)
    diff = m[:, None, :] - m[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)


def _window_partition(x, win):
    b, h, w, ch = x.shape
    x = x.reshape(b, h // win, win, w // win, win, ch)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, win * win, ch)


def _window_reverse(x, win, b, h, w):
    ch = x.shape[-1]
    x = x.reshape(b, h // win, w // win, win, win, ch)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, ch)


def _window_attention(p, xw, heads, rel_index, mask):
    """Multi-head attention inside each window of (B·nw, N, C), with the
    relative position bias and, for shifted windows, the (nw, N, N) mask
    (f32: the masked scores are f32 in the JAX function too)."""
    bw, n, ch = xw.shape
    dh = ch // heads

    def split(d):
        return L.linear(xw, d).reshape(bw, n, heads, dh).transpose(1, 2)

    q, k, v = split(p["q"]), split(p["k"]), split(p["v"])
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh)
    bias = p["rel_bias"][rel_index.reshape(-1)].reshape(n, n, heads)
    scores = scores + bias.permute(2, 0, 1)[None]
    if mask is not None:
        nw = mask.shape[0]
        scores = (scores.reshape(-1, nw, heads, n, n) + mask[None, :, None]).reshape(-1, heads, n, n)
    attn = torch.softmax(scores.float(), dim=-1).to(xw.dtype)
    out = torch.matmul(attn, v).transpose(1, 2).reshape(bw, n, ch)
    return L.linear(out, p["proj"])


def _mlp(p, x, eps):
    y = L.gelu(L.linear(_layer_norm(x, p["ln2"], eps), p["mlp1"]))
    return L.linear(y, p["mlp2"])


def _swin_block(p, x, hw, heads, win, shift, eps, rel_index, mask):
    """x (B, H*W, C) -> same; HF SwinLayer.forward, always partitioned. The
    map is padded to whole windows without a mask in the unshifted blocks;
    ``mask`` is ``_shift_mask`` of the padded map for the shifted ones."""
    h, w = hw
    b, _, ch = x.shape
    shortcut = x
    x = _layer_norm(x, p["ln1"], eps).reshape(b, h, w, ch)
    hp, wp = h + (-h) % win, w + (-w) % win
    if hp != h or wp != w:
        x = F.pad(x, (0, 0, 0, wp - w, 0, hp - h))
    if shift > 0:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))

    out = _window_attention(p, _window_partition(x, win), heads, rel_index,
                            mask if shift > 0 else None)
    out = _window_reverse(out, win, b, hp, wp)
    if shift > 0:
        out = torch.roll(out, (shift, shift), dims=(1, 2))
    x = shortcut + out[:, :h, :w].reshape(b, h * w, ch)
    return x + _mlp(p, x, eps)


def _patch_merge(p, x, hw, eps):
    """(B, H*W, C) -> (B, ⌈H/2⌉·⌈W/2⌉, 2C): odd maps padded, quadrants in the
    order (0,0), (1,0), (0,1), (1,1)."""
    h, w = hw
    b, _, ch = x.shape
    x = x.reshape(b, h, w, ch)
    if h % 2 or w % 2:
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
    x = _layer_norm(x.reshape(b, -1, 4 * ch), p["norm"], eps)
    return L.linear(x, p["reduction"])


def _backbone(p, pixels, kw):
    """(B, C, H, W) -> the stages' feature maps [(B, Ci, Hi, Wi)]."""
    eps, ps, win = kw["layer_norm_eps"], kw["patch_size"], kw["window_size"]
    b, _, h0, w0 = pixels.shape
    pixels = F.pad(pixels, (0, (-w0) % ps, 0, (-h0) % ps))
    x = L.conv2d(pixels, p["patch_proj"]["weight"], p["patch_proj"]["bias"], stride=(ps, ps))
    _, emb, h, w = x.shape
    x = _layer_norm(x.reshape(b, emb, h * w).transpose(1, 2), p["embed_norm"], eps)

    rel_index = _rel_position_index(win, x.device)
    feats = []
    for i, st in enumerate(p["stages"]):
        shift = win // 2
        # the shifted blocks' mask, built once a stage on its padded map
        mask = (_shift_mask(h + (-h) % win, w + (-w) % win, win, shift, x.device)
                if len(st["blocks"]) > 1 else None)
        for j, blk in enumerate(st["blocks"]):
            x = _swin_block(blk, x, (h, w), kw["num_heads"][i], win, shift if j % 2 else 0,
                            eps, rel_index, mask)
        # the stage's feature is taken before downsampling, through its own LayerNorm
        f = _layer_norm(x, p["stage_norms"][i], eps)
        feats.append(f.reshape(b, h, w, f.shape[-1]).permute(0, 3, 1, 2))
        if "downsample" in st:
            x = _patch_merge(st["downsample"], x, (h, w), eps)
            h, w = (h + 1) // 2, (w + 1) // 2
    return feats


# --------------------------------------------------------------------------
# upernet head
# --------------------------------------------------------------------------

def _resize(x, size):
    """Bilinear resize (align_corners=False) that antialiases when it
    shrinks, as ``jax.image.resize`` does (HF's plain ``interpolate`` does
    not: ROADMAP queue 3). Computed in f32 (PyTorch's antialiased form takes
    no bf16 on the CPU) and rounded back to x's dtype."""
    y = F.interpolate(x.float(), size=tuple(size), mode="bilinear", align_corners=False,
                      antialias=True)
    return y.to(x.dtype)


def _conv_module(p, x, padding):
    return L.relu(L.batch_norm2d(L.conv2d(x, p["conv_w"], padding=padding), p["bn"]))


def _adaptive_avg_pool(x, out):
    """torch adaptive_avg_pool2d: bin i spans [⌊i·n/out⌋, ⌈(i+1)·n/out⌉)."""
    return F.adaptive_avg_pool2d(x, out)


def _decode_head(p, feats, kw):
    top = feats[-1]
    psp = [top]
    for scale, blk in zip(kw["pool_scales"], p["psp"]):
        y = _conv_module(blk, _adaptive_avg_pool(top, scale), (0, 0))
        psp.append(_resize(y, top.shape[2:]))
    x = _conv_module(p["bottleneck"], torch.cat(psp, dim=1), (1, 1))

    laterals = [_conv_module(blk, f, (0, 0)) for blk, f in zip(p["laterals"], feats[:-1])]
    laterals.append(x)
    for i in range(len(laterals) - 1, 0, -1):
        laterals[i - 1] = laterals[i - 1] + _resize(laterals[i], laterals[i - 1].shape[2:])

    outs = [_conv_module(p["fpn"][i], laterals[i], (1, 1)) for i in range(len(laterals) - 1)]
    outs.append(laterals[-1])
    outs = [outs[0]] + [_resize(o, outs[0].shape[2:]) for o in outs[1:]]
    x = _conv_module(p["fpn_bottleneck"], torch.cat(outs, dim=1), (1, 1))
    return L.conv2d(x, p["classifier"]["weight"], p["classifier"]["bias"])


# --------------------------------------------------------------------------
# full model
# --------------------------------------------------------------------------

def apply(params, config, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """(B, ch, T) -> (B, S, ch, T) (shell identical to segm_models'). With
    ``compute_dtype`` the spectrum and every weight are cast to it (the JAX
    function's rounding points: LayerNorm statistics in that dtype, softmax
    and resizes in f32); the iSTFT runs f32."""
    with net_precision(compute_dtype) as dtype:
        kw = _swin_kwargs(config)
        k, dim_c, _ = _dims(config)
        act = L.make_act(config.model.act)
        s_stems = num_target_instruments(config)
        length = x.shape[-1]

        params = prepare(params, config, compute_dtype)
        mix = xx = _cac2cws(spectrogram(x.float(), config).to(dtype), k)
        first_out = xx = L.conv2d(xx, params["first_conv"])
        xx = xx.transpose(-1, -2)  # (B, c, T, F)

        feats = _backbone(params["backbone"], xx, kw)
        xx = _resize(_decode_head(params["decode_head"], feats, kw), xx.shape[2:])

        xx = xx.transpose(-1, -2) * first_out
        xx = L.conv2d(torch.cat([mix, xx], dim=1), params["final_conv1"])
        xx = L.conv2d(act(xx), params["final_conv2"])
        xx = _cws2cac(xx, k).float()
        xx = xx.reshape(xx.shape[0], s_stems, dim_c // k, xx.shape[-2], xx.shape[-1])
        wav = inverse_spectrogram(xx, config, length)
        if wav.shape[-1] < length:
            wav = F.pad(wav, (0, length - wav.shape[-1]))
        return wav[..., :length]


# --------------------------------------------------------------------------
# torch checkpoint conversion
# --------------------------------------------------------------------------

def convert_torch(state_dict, config):
    """Map a reference Swin_UperNet_Model state dict (HF's
    ``UperNetForSemanticSegmentation`` under ``swin_upernet_model.``) onto
    the parameter tree. Buffers and the auxiliary head are consumed and not
    executed; any other leftover key raises."""
    kw = _swin_kwargs(config)
    sd, used, take = _make_take(state_dict)
    take_f = lambda key: take(key).float()  # noqa: E731

    def dense(prefix, bias=True):
        d = {"weight": take_f(prefix + ".weight")}
        if bias:
            d["bias"] = take_f(prefix + ".bias")
        return d

    def conv_module(prefix):
        bn = prefix + ".batch_norm."
        return {"conv_w": take_f(prefix + ".conv.weight"),
                "bn": {name: take_f(bn + name)
                       for name in ("weight", "bias", "running_mean", "running_var")}}

    bb = "swin_upernet_model.backbone"
    n_stages = len(kw["depths"])
    stages = []
    for i in range(n_stages):
        blocks = []
        for j in range(kw["depths"][i]):
            p = f"{bb}.encoder.layers.{i}.blocks.{j}"
            blocks.append({
                "ln1": dense(p + ".layernorm_before"),
                "q": dense(p + ".attention.self.query"),
                "k": dense(p + ".attention.self.key"),
                "v": dense(p + ".attention.self.value"),
                "proj": dense(p + ".attention.output.dense"),
                "rel_bias": take_f(p + ".attention.self.relative_position_bias_table"),
                "ln2": dense(p + ".layernorm_after"),
                "mlp1": dense(p + ".intermediate.dense"),
                "mlp2": dense(p + ".output.dense"),
            })
        st = {"blocks": blocks}
        if i < n_stages - 1:
            d = f"{bb}.encoder.layers.{i}.downsample"
            st["downsample"] = {"norm": dense(d + ".norm"),
                                "reduction": dense(d + ".reduction", bias=False)}
        stages.append(st)

    dh = "swin_upernet_model.decode_head"
    head = {
        "psp": [conv_module(f"{dh}.psp_modules.{i}.1") for i in range(len(kw["pool_scales"]))],
        "bottleneck": conv_module(dh + ".bottleneck"),
        "laterals": [conv_module(f"{dh}.lateral_convs.{i}") for i in range(n_stages - 1)],
        "fpn": [conv_module(f"{dh}.fpn_convs.{i}") for i in range(n_stages - 1)],
        "fpn_bottleneck": conv_module(dh + ".fpn_bottleneck"),
        "classifier": dense(dh + ".classifier"),
    }
    params = {
        "first_conv": take_f("first_conv.weight"),
        "backbone": {
            "patch_proj": dense(bb + ".embeddings.patch_embeddings.projection"),
            "embed_norm": dense(bb + ".embeddings.norm"),
            "stages": stages,
            "stage_norms": [dense(f"{bb}.hidden_states_norms.stage{i + 1}")
                            for i in range(n_stages)],
        },
        "decode_head": head,
        "final_conv1": take_f("final_conv.0.weight"),
        "final_conv2": take_f("final_conv.2.weight"),
    }

    # buffers and the training-only auxiliary head
    used.update(key for key in sd
                if key.endswith(("relative_position_index", "num_batches_tracked", "attn_mask"))
                or ".auxiliary_head." in key)
    unused = set(sd) - used
    if unused:
        raise ValueError(f"unconsumed checkpoint keys: {sorted(unused)[:10]} ...")
    return params
