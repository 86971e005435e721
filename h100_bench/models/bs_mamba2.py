"""The yardstick of ``bs_mamba2`` (TS-BS-Mamba2): the published checkpoint's
keys and shapes, the work a chunk needs, and K8's launches and bound.

Everything here follows from the configuration's model section and the band
layout of ``reference/bs_mamba2.py``; nothing is read from the program (not
its launch plan ``k8_plan``: the scan is counted at the lengths the model
needs, 690 frames and 57 bands, not at the kernel's padded 704 and 64).
"""

from __future__ import annotations


from h100_bench import roofline
from h100_bench.reference import bs_mamba2 as ref

KERNEL_LIBRARIES = ("ssd",)
# dense TF32 of one H100 SXM at 700 W (NVIDIA's data sheet), as chip_smoke.py prices K8
PEAK_TF32_FLOPS = 494.7e12
# the cells' audio is stereo; the Separator runs each channel as a batch row
CHANNELS = 2
# the cells run the scan in bf16 (the traffic's compute_dtype)
SCAN_BYTES = 2
# weights.py draws a "linear" leaf uniform within ±fan_in**-0.5. A_log is
# drawn within ±10, which takes in mamba_ssm's own init (A = -exp(A_log) in
# [-16, -1]): a head with A_log below -5 decays by under 1% a step, so its
# state lives across many 64-step chunks of the scan and a carry lost between
# them shows in the stems. (A wider dt_bias, its other lever, would give the
# heads that forget at once a larger dt and so the larger share of the output.)
A_LOG_FAN_IN = 10.0 ** -2


def frames(model: dict, chunk: int) -> int:
    """STFT frames of one chunk (centred)."""
    return chunk // ref.sizes(model)["stride"] + 1


def _mamba(prefix: str, d: int, s: dict) -> list:
    di, n = s["expand"] * d, s["d_state"]
    heads, conv_dim = di // s["headdim"], di + 2 * n
    return [(f"{prefix}.dt_bias", (heads,), "linear", 1),
            (f"{prefix}.A_log", (heads,), "linear", A_LOG_FAN_IN),
            (f"{prefix}.D", (heads,), "gamma", 1),
            (f"{prefix}.in_proj.weight", (2 * di + 2 * n + heads, d), "linear", d),
            (f"{prefix}.conv1d.weight", (conv_dim, 1, s["d_conv"]), "linear", s["d_conv"]),
            (f"{prefix}.conv1d.bias", (conv_dim,), "linear", s["d_conv"]),
            (f"{prefix}.norm.weight", (di,), "gamma", di),
            (f"{prefix}.out_proj.weight", (d, di), "linear", di)]


def _norm(prefix: str, c: int) -> list:
    return [(f"{prefix}.weight", (c,), "gamma", c), (f"{prefix}.bias", (c,), "linear", c)]


def _lin(prefix: str, ci: int, co: int, conv: bool = False) -> list:
    shape = (co, ci, 1) if conv else (co, ci)
    return [(f"{prefix}.weight", shape, "linear", ci), (f"{prefix}.bias", (co,), "linear", ci)]


def state_dict_layout(model: dict) -> list:
    """[(key, shape, kind, fan_in)] of the published checkpoint, in the
    order of the Separator's modules; ``kind`` as ``weights.py`` draws it
    (norm scales and D "gamma", everything else "linear"; A_log wide, see
    ``A_LOG_FAN_IN``)."""
    s = ref.sizes(model)
    n, k = s["feature_dim"], s["num_output"]
    widths = ref.band_widths(s["sr"], s["win"])
    out = []
    for bank in ("BN_mask", "BN_map"):
        for i, bw in enumerate(widths):
            out += _norm(f"{bank}.{i}.0", 2 * bw) + _lin(f"{bank}.{i}.1", 2 * bw, n, conv=True)
    for stack, depth in (("separator_mask", s["num_repeat_mask"]),
                         ("separator_map", s["num_repeat_map"])):
        for i in range(depth):
            for leg in ("band_rnn", "band_comm"):
                p = f"{stack}.{i}.{leg}"
                out += _norm(f"{p}.norm", n)
                out += _mamba(f"{p}.rnn.forward_mamba2", n, s)
                out += _mamba(f"{p}.rnn.backward_mamba2", n, s)
                out += _lin(f"{p}.proj", 2 * n, n)
            p = f"{stack}.{i}.channel_comm"
            out += (_lin(f"{p}.TAC_input.0", n, 3 * n) + _lin(f"{p}.TAC_mean.0", 3 * n, 3 * n)
                    + _lin(f"{p}.TAC_output.0", 6 * n, n) + _norm(f"{p}.input_norm", n))
    out += _lin("in_conv", 2 * n, n, conv=True)
    for bank in ("mask", "map"):
        for i, bw in enumerate(widths):
            p = f"{bank}.{i}"
            out += (_norm(f"{p}.0", n) + _lin(f"{p}.1", n, n * k, conv=True)
                    + _lin(f"{p}.3", n, n * k, conv=True)
                    + _lin(f"{p}.5", n, bw * 4 * k, conv=True))
    return out


def _legs(model: dict, chunk: int, batch: int) -> list:
    """(rows, length) of each ResMamba leg's scans for ``batch`` chunks:
    band_rnn over frames, one row a (chunk, channel, band); band_comm over
    bands, one row a (chunk, channel, frame)."""
    s = ref.sizes(model)
    nband, t = len(ref.band_widths(s["sr"], s["win"])), frames(model, chunk)
    return [(batch * CHANNELS * nband, t), (batch * CHANNELS * t, nband)]


def scan_flops(rows: int, length: int, s: dict, d: int) -> tuple:
    """(C·Bᵀ, the rest) FLOPs that one direction's scan needs: C·Bᵀ once for
    the heads and, per head, its masked product with x, both over the lower
    triangle of each chunk (the last may be short); the two state products
    only where a state is handed on (every chunk but the last) or read
    (every chunk but the first)."""
    q, n, p = s["chunk_size"], s["d_state"], s["headdim"]
    h = s["expand"] * d // p
    sizes = [q] * (length // q) + ([length % q] if length % q else [])
    tri = sum(c * (c + 1) for c in sizes)  # 2 FLOP x c(c+1)/2 pairs
    handed, read = length - sizes[-1], length - sizes[0]
    return rows * tri * n, rows * h * (tri * p + 2 * n * p * (handed + read))


def model_flops_per_chunk(model: dict, chunk: int) -> float:
    """Every matrix product of one chunk: the bottlenecks, each Mamba's in
    and out projections and scan (``scan_flops``), the ResMamba and TAC
    linears, ``in_conv`` and the heads. The norms, the depthwise conv, the
    activations, the STFTs and the masks are not counted."""
    s = ref.sizes(model)
    n, k = s["feature_dim"], s["num_output"]
    di, ns = s["expand"] * n, s["d_state"]
    widths = ref.band_widths(s["sr"], s["win"])
    nband, t = len(widths), frames(model, chunk)
    tokens = CHANNELS * t  # of one band
    total = 2 * 2.0 * tokens * sum(2 * bw * n for bw in widths)  # two banks of bottlenecks
    bsnet = 0.0
    for rows, length in _legs(model, chunk, 1):
        proj = 2.0 * rows * length * (n * (2 * di + 2 * ns + di // s["headdim"]) + di * n)
        bsnet += 2 * (proj + sum(scan_flops(rows, length, s, n)))  # two directions
        bsnet += 2.0 * rows * length * 2 * n * n  # proj
    bsnet += 2.0 * nband * t * (CHANNELS * (n * 3 * n + 6 * n * n) + 9 * n * n)  # TAC
    total += (s["num_repeat_mask"] + s["num_repeat_map"]) * bsnet
    total += 2.0 * nband * tokens * 2 * n * n  # in_conv
    total += 2 * 2.0 * tokens * sum(2 * n * n * k + 4 * bw * k * n for bw in widths)  # heads
    return total


def scan_bound_s(rows: int, length: int, s: dict, d: int) -> float:
    """Seconds one direction's scan needs at the roofline: chip_smoke.py
    ``k8_bound``'s pricing in bf16. C·Bᵀ, whose operands are exact, one bf16
    pass; the other products, one f32 operand times an exact one, the
    cheaper of two TF32 and three bf16 passes; against the bytes (x, a, b,
    c read once, y written once)."""
    h, p, n = s["expand"] * d // s["headdim"], s["headdim"], s["d_state"]
    cbt, rest = scan_flops(rows, length, s, d)
    t_ops = (cbt / roofline.PEAK_BF16_FLOPS
             + rest * min(2 / PEAK_TF32_FLOPS, 3 / roofline.PEAK_BF16_FLOPS))
    nbytes = SCAN_BYTES * rows * length * (2 * h * p + h + 2 * n)
    return max(t_ops, nbytes / roofline.PEAK_BYTES_S)


def kernel_bound_s(model: dict, chunk: int, batch: int) -> dict:
    """{"K8": seconds at the roofline} of one model call of ``batch``
    chunks, launch by launch (``scan_bound_s``) at the lengths the model
    needs."""
    s = ref.sizes(model)
    launches = 2 * (s["num_repeat_mask"] + s["num_repeat_map"])  # of each leg: two directions
    return {"K8": sum(launches * scan_bound_s(rows, length, s, s["feature_dim"])
                      for rows, length in _legs(model, chunk, batch))}


def kernel_launches(model: dict, batch: int) -> dict:
    """{"K8": launches} of one model call whatever the batch: a scan per
    direction of both legs of every BSNet."""
    s = ref.sizes(model)
    return {"K8": 4 * (s["num_repeat_mask"] + s["num_repeat_map"])}


def reference_forward(sd, model: dict, x, products=None):
    """The plain forward: x (B, ch, T) -> (B, num_output, ch, T)."""
    return ref.forward(sd, model, x, products)
