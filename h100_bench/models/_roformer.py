"""The yardstick of the roformer family: the published checkpoint's keys
and shapes, the work a chunk needs, and the launch shapes of K1 and K2.

Everything here follows from the configuration's model section and the
band layout of ``reference/``; nothing is read from the program.
"""

from __future__ import annotations

import numpy as np

from h100_bench import roofline
from h100_bench.reference import roformer as ref


def _sizes(model: dict, mel: bool):
    dim, heads, dh = model["dim"], model.get("heads", 8), model.get("dim_head", 64)
    mask_depth = model.get("mask_estimator_depth", 1 if mel else 2)
    return dict(dim=dim, heads=heads, dh=dh, hd=heads * dh, depth=model["depth"],
                t_depth=model.get("time_transformer_depth", 2),
                f_depth=model.get("freq_transformer_depth", 2),
                hidden=dim * model.get("mlp_expansion_factor", 4),
                ff=int(dim * 4), stems=model.get("num_stems", 1),
                mask_hidden=mask_depth if mel else mask_depth - 1)


def band_widths(model_type: str, model: dict):
    return ref.band_layout(model_type, model)[1]


def frames(model: dict, chunk: int) -> int:
    """STFT frames of one chunk (centred)."""
    return chunk // model.get("stft_hop_length", 512) + 1


def state_dict_layout(model_type: str, model: dict):
    """[(key, shape, kind, fan_in)] of the published checkpoint, in its
    order. ``kind``: "gamma" (an RMSNorm scale), "linear" (a weight or bias,
    drawn as torch's Linear draws it, by fan-in) or "rope" (fixed)."""
    mel = model_type == "mel_band_roformer"
    s = _sizes(model, mel)
    dim, hd, heads = s["dim"], s["hd"], s["heads"]
    widths = band_widths(model_type, model)
    out = []
    for i, w in enumerate(widths):
        p = f"band_split.to_features.{i}"
        out += [(f"{p}.0.gamma", (w,), "gamma", w), (f"{p}.1.weight", (dim, w), "linear", w),
                (f"{p}.1.bias", (dim,), "linear", w)]
    for d in range(s["depth"]):
        for j, depth in ((0, s["t_depth"]), (1, s["f_depth"])):
            for i in range(depth):
                a, f = f"layers.{d}.{j}.layers.{i}.0", f"layers.{d}.{j}.layers.{i}.1"
                out += [(f"{a}.norm.gamma", (dim,), "gamma", dim),
                        (f"{a}.to_qkv.weight", (3 * hd, dim), "linear", dim),
                        (f"{a}.to_gates.weight", (heads, dim), "linear", dim),
                        (f"{a}.to_gates.bias", (heads,), "linear", dim),
                        (f"{a}.to_out.0.weight", (dim, hd), "linear", hd),
                        (f"{a}.rotary_embed.freqs", (s["dh"] // 2,), "rope", 0),
                        (f"{f}.net.0.gamma", (dim,), "gamma", dim),
                        (f"{f}.net.1.weight", (s["ff"], dim), "linear", dim),
                        (f"{f}.net.1.bias", (s["ff"],), "linear", dim),
                        (f"{f}.net.4.weight", (dim, s["ff"]), "linear", s["ff"]),
                        (f"{f}.net.4.bias", (dim,), "linear", s["ff"])]
            if mel:
                out.append((f"layers.{d}.{j}.norm.gamma", (dim,), "gamma", dim))
    if not mel:
        out.append(("final_norm.gamma", (dim,), "gamma", dim))
    for st in range(s["stems"]):
        for i, w in enumerate(widths):
            dims = [dim] + [s["hidden"]] * s["mask_hidden"] + [2 * w]
            for li in range(len(dims) - 1):
                p = f"mask_estimators.{st}.to_freqs.{i}.0.{2 * li}"
                out += [(f"{p}.weight", (dims[li + 1], dims[li]), "linear", dims[li]),
                        (f"{p}.bias", (dims[li + 1],), "linear", dims[li])]
    return out


def _legs(model: dict, s: dict, nb: int, tf: int, batch: int):
    """(launches, sequences, length) of each transformer leg for ``batch`` chunks."""
    return ((s["depth"] * s["t_depth"], batch * nb, tf),
            (s["depth"] * s["f_depth"], batch * tf, nb))


def model_flops_per_chunk(model_type: str, model: dict, chunk: int) -> float:
    """Every matrix product and attention product of one chunk: band split,
    each attention (qkv, gates, scores, weighted sum, out) and feed-forward,
    the mask estimators. Norms, rope, softmax, the STFTs and the mask
    product are not counted."""
    mel = model_type == "mel_band_roformer"
    s = _sizes(model, mel)
    widths = band_widths(model_type, model)
    nb, tf, dim = len(widths), frames(model, chunk), s["dim"]
    total = 2.0 * tf * sum(widths) * dim
    for launches, b, n in _legs(model, s, nb, tf, 1):
        tokens = b * n
        attn = 2.0 * tokens * dim * (3 * s["hd"] + s["heads"] + s["hd"]) \
            + 4.0 * b * s["heads"] * n * n * s["dh"]
        total += launches * (attn + 4.0 * tokens * dim * s["ff"])
    for w in widths:
        dims = [dim] + [s["hidden"]] * s["mask_hidden"] + [2 * w]
        total += s["stems"] * sum(2.0 * tf * a * b for a, b in zip(dims, dims[1:]))
    return total


def kernel_bound_s(model_type: str, model: dict, chunk: int, batch: int) -> dict:
    """{family: seconds at the roofline} of one model call of ``batch``
    chunks, launch by launch: the larger of its FLOPs at the bf16 peak and
    its bytes (inputs read once, outputs written once) at the HBM peak."""
    s = _sizes(model, model_type == "mel_band_roformer")
    nb, tf, d = len(band_widths(model_type, model)), frames(model, chunk), s["dim"]
    hd, h, dh, hidden = s["hd"], s["heads"], s["dh"], s["ff"]
    k1 = k2 = 0.0
    for launches, b, n in _legs(model, s, nb, tf, batch):
        tokens = b * n
        flops = 2 * tokens * d * (3 * hd + h + hd) + 4 * b * h * n * n * dh
        nbytes = 2 * (2 * tokens * d + (3 * hd + h + hd) * d + h + d + 2 * n * dh)
        k1 += launches * roofline.bound_s(flops, nbytes)
        k2 += launches * roofline.bound_s(
            4 * tokens * d * hidden, 2 * (2 * tokens * d + 2 * hidden * d + hidden + 3 * d))
    return {"K1": k1, "K2": k2}


def kernel_launches(model_type: str, model: dict, batch: int) -> dict:
    """{family: launches} of one model call (each leg's layers; K1 and K2
    once a layer whatever the batch)."""
    s = _sizes(model, model_type == "mel_band_roformer")
    n = s["depth"] * (s["t_depth"] + s["f_depth"])
    return {"K1": n, "K2": n}


def rope_freqs(dh: int) -> np.ndarray:
    """rotary_embedding_torch's default frequencies (theta 10000)."""
    return 1.0 / (10000 ** (np.arange(0, dh, 2)[: dh // 2].astype(np.float64) / dh))
