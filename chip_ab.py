"""Time kernels K1 to K8 and I8 of two trees of the repository against each
other on one NVIDIA GPU, in turns.

    git archive <commit> | tar -x -C chip_parent    # the base tree (gitignored)
    python3 chip_ab.py --base chip_parent --pairs 4
    python3 chip_ab.py --base chip_parent --pairs 3 --kernels K1,K6
    python3 chip_ab.py --base chip_parent --pairs 2 --kernels CLI
    python3 chip_ab.py --base chip_parent --pairs 3 --kernels I8

Each turn is a subprocess that imports ``sesa_tpu_torch`` from one tree
(``--base`` or this checkout), builds that tree's libraries of the kernels
asked for (``--kernels``, default K1 to K8 and I8), makes the inputs of
``chip_smoke.py``'s kernels phase from one seed at the main paths' shapes (K1
at the flagship's time leg b 372 x n 690 and freq leg b 4140 x n 62 in mode 0
and the time leg in mode 2, d 512, 8 heads x 64; K2 at the flagship's 256,680
x 512 -> 2048 rms/GELU form and the mel-band conformer's 248,400 x 384 -> 1536
ln/SiLU/0.5 form; K3 at BH 2976 x S 690 x D 64 through strided views; K4 and
K5 at the mel-band conformer's time leg b 360 x n 690 and freq leg b 4140 x n
60, d 384 (K4: 8 heads x 64, P 512; K5: e 768, k 31); K6 at
Apollo's b 320 x n 1901, d 256 -> 1024, k 7; K7 at Apollo's b 7604 x n 80,
8 heads x 32, full rope; K8 at bs_mamba2's band_rnn B 684
x L 704 and band_comm B 8280 x L 64, H 8, in bf16 and in f32; I8 at the
flagship's legs, BH 2976 x n 690 and BH 33120 x n 62, D 64, through strided
views, and each of its stages alone where the tree has them), checks each
kernel against its plain version, and times it with CUDA events, beside the
library yardsticks (cuBLAS + SDPA, the F.linear composites, SDPA under each
backend, LayerNorm + cuBLAS + SDPA with the Shaw bias as a mask, the cuDNN
conv composites, rope in torch ops + SDPA, the einsum scan ``ssd_einsum``).
K1's, K4's, K5's, K6's and K7's rows also give device time by kernel
(torch.profiler) in each tree's first turn. Turns run base, new, new, base,
base, new, ... so that drift of the card falls on both trees. ``--kernels
CLI`` times three main paths end to end instead (``cli_paths``: the flagship,
the mel-band conformer and the int8 flagship through each tree's
``cli.main``, their warm real-time factor and one model call's device busy
time). Prints each
turn, the median and range of each kernel by tree, and last the card's name
and power limit; writes everything to chiprun_out/chip_ab.json.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


# the rows of each kernel in the summary, each with its library yardstick
ROWS = {"K1": ["K1_time", "K1_freq", "K1m2_time"], "K2": ["K2", "K2ln"], "K3": ["K3"],
        "K4": ["K4_time", "K4_freq"], "K5": ["K5_time", "K5_freq"], "K6": ["K6"], "K7": ["K7"],
        "K8": [f"K8_{leg}_{tag}" for leg in ("band_rnn", "band_comm") for tag in ("bf16", "f32")],
        # the flagship's two legs, and each stage alone where the tree has them
        "I8": ["I8_time", "I8_freq", "I8_time_prepass", "I8_time_attention",
               "I8_freq_attention"],
        # not a kernel: three main paths end to end (cli_paths), with no yardstick
        "CLI": [f"{path}_{metric}" for path in ("flagship", "melconf", "int8")
                for metric in ("rtf_warm", "warm_s", "busy_ms", "idle_share")]}
# the libraries each entry of ROWS builds
BUILDS = {"CLI": ["K1", "K2", "K4", "K5", "I8"]}


def worker(tree: str, kernels, breakdown: bool) -> None:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import sesa_tpu_torch
    from sesa_tpu_torch.ops import _build

    if not os.path.abspath(sesa_tpu_torch.__file__).startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {sesa_tpu_torch.__file__}, not the tree {tree}")
    # this checkout's chip_smoke.py (the base tree may hold an older one)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    _build.build_all(sorted({cs.LIBRARIES[b] for k in kernels for b in BUILDS.get(k, [k])}))
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(6)
    res = {"tree": tree}
    if "K1" in kernels:
        k1(cs, dev, res, tree, breakdown)
    if "K4" in kernels:
        k4(cs, dev, res, tree, breakdown)
    if "K5" in kernels:
        k5(cs, dev, res, tree, breakdown)
    if "K6" in kernels:
        k6(cs, dev, res, tree, breakdown)
    if "K7" in kernels:
        k7(cs, dev, res, tree, breakdown)
    if "K2" in kernels:
        k2(cs, gen, dev, res, tree)
    if "K3" in kernels:
        k3(cs, gen, dev, res, tree)
    if "K8" in kernels:
        k8(cs, dev, res, tree)
    if "I8" in kernels:
        i8(cs, dev, res, tree)
    if "CLI" in kernels:
        cli_paths(cs, res)
    print("AB " + json.dumps(res), flush=True)


def cli_paths(cs, res):
    """The flagship (bs_roformer), the mel-band conformer and the int8
    flagship (bs_roformer with SESA_INT8_ATTN=1: I8 in every attention
    layer) through the tree's cli.main on chip_smoke.py's 60 s song in bf16,
    as chip_smoke's drive_cli configures them; then three warm separations
    on the session (rtf_warm and warm_s from the fastest: demix, its
    segments and copies included) and one model call traced by
    chip_smoke.phase_profile (device busy time, the kernels' sum, and the
    idle share of the traced span)."""
    song = cs._song(cs.SONG_S)
    for key, model_type, model_cfg in (("flagship", "bs_roformer", cs.FLAGSHIP_MODEL),
                                       ("melconf", "mel_band_conformer", cs.MELCONF_MODEL),
                                       ("int8", "bs_roformer", cs.FLAGSHIP_MODEL)):
        if key == "int8":
            os.environ["SESA_INT8_ATTN"] = "1"
        try:
            cli_path(cs, res, key, model_type, model_cfg, song)
        finally:
            os.environ.pop("SESA_INT8_ATTN", None)


def cli_path(cs, res, key, model_type, model_cfg, song):
    """One path of :func:`cli_paths`, its numbers under ``key``."""
    import tempfile
    import time

    import torch

    from sesa_tpu_torch import cli
    from sesa_tpu_torch.audio_io import write_audio

    sessions = []
    with tempfile.TemporaryDirectory() as work:
        os.makedirs(os.path.join(work, "in"))
        write_audio(os.path.join(work, "in", "song.wav"), song, cs.SR)
        cfg = {"audio": {"chunk_size": cs.CHUNK, "num_channels": 2, "sample_rate": cs.SR},
               "model": model_cfg,
               "inference": {"num_overlap": cs.OVERLAP, "batch_size": cs.BATCH,
                             "normalize": False},
               "training": {"instruments": ["vocals", "other"], "target_instrument": "vocals"}}
        with open(os.path.join(work, "config.json"), "w") as f:
            json.dump(cfg, f)
        rc = cli.main(["--model_type", model_type, "--config_path",
                       os.path.join(work, "config.json"), "--input_folder",
                       os.path.join(work, "in"), "--store_dir", os.path.join(work, "out"),
                       "--compute_dtype", "bf16"], session_out=sessions)
    if rc != 0:
        raise RuntimeError(f"{model_type}: cli.main returned {rc}")
    session = sessions[0]
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        session.separate(song)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    if session.rescues:
        raise RuntimeError(f"{model_type}: {session.rescues} bf16 -> f32 rescues")
    prof = cs.phase_profile(model_type, session, song)
    res.update({f"{key}_warm_s": min(walls), f"{key}_rtf_warm": cs.SONG_S / min(walls),
                f"{key}_busy_ms": prof["device_busy_ms"],
                f"{key}_idle_share": prof["idle_share"]})
    del session, sessions
    torch.cuda.empty_cache()


def k1(cs, dev, res, tree, breakdown):
    """K1 at the flagship's two legs in mode 0 and the time leg in mode 2
    (the value-residual model's later layers: V lerped, no residual), each
    checked against fused_attention_block_plain; cuBLAS + SDPA (with
    torch.lerp in mode 2) is the yardstick."""
    import torch

    from sesa_tpu_torch.ops.attention import fused_attention_block, fused_attention_block_plain

    gen = torch.Generator().manual_seed(1)
    d, heads, dh = 512, 8, 64
    for key, b, n, mode in (("K1_time", cs.BATCH * cs.BANDS, cs.FRAMES, 0),
                            ("K1_freq", cs.BATCH * cs.FRAMES, cs.BANDS, 0),
                            ("K1m2_time", cs.BATCH * cs.BANDS, cs.FRAMES, 2)):
        args, rope = cs._k1_args(gen, b, n, d, heads, dh, dh, dev)
        x = args[0]
        if mode == 0:
            kw = dict(rope=rope)
            lib = lambda: cs.k1_library(*args, rope)  # noqa: E731
        else:
            vr = (cs._weights(gen, (heads, d), d, dev), cs._weights(gen, (heads,), d, dev),
                  torch.randn((b, n, heads * dh), generator=gen).to(dev, torch.bfloat16))
            kw = dict(rope=rope, vr=vr, add_residual=False)
            lib = lambda: cs.k1_vr_library(*args, rope, vr, False)  # noqa: E731
        out, ref = fused_attention_block(*args, **kw), fused_attention_block_plain(*args, **kw)
        if mode == 2:
            cs.compare(f"{tree} {key}, pre-mix V", out[1], ref[1], torch.zeros((), device=dev))
            out, ref = out[0], ref[0]
        cs.compare(f"{tree} {key}", out, ref, x if mode == 0 else torch.zeros((), device=dev))
        del out, ref
        res[key] = cs.time_ms(lambda: fused_attention_block(*args, **kw), reps=20, warmup=3)
        res[key + "_library"] = cs.time_ms(lib, reps=20, warmup=3)
        if breakdown:
            res[key + "_parts"] = cs.device_breakdown(lambda: fused_attention_block(*args, **kw))
        del x, args
        torch.cuda.empty_cache()


def _conformer_legs(cs):
    """The mel-band conformer's two legs, (row suffix, b, n)."""
    return (("time", cs.BATCH * cs.MEL_BANDS, cs.FRAMES),
            ("freq", cs.BATCH * cs.FRAMES, cs.MEL_BANDS))


def k4(cs, dev, res, tree, breakdown):
    """K4 at the mel-band conformer's two legs, checked against
    fused_conformer_attention_plain; LayerNorm + cuBLAS + SDPA with the Shaw
    bias as attn_mask is the yardstick."""
    import torch

    from sesa_tpu_torch.ops.attention import (fused_conformer_attention,
                                              fused_conformer_attention_plain)

    gen = torch.Generator().manual_seed(4)
    d, heads, dh, max_pos = cs.MELCONF_MODEL["dim"], 8, 64, 512
    for leg, b, n in _conformer_legs(cs):
        key = f"K4_{leg}"
        args = cs._k4_args(gen, b, n, d, heads, dh, max_pos, dev)
        cs.compare(f"{tree} {key}", fused_conformer_attention(*args),
                   fused_conformer_attention_plain(*args), args[0])
        res[key] = cs.time_ms(lambda: fused_conformer_attention(*args), reps=20, warmup=3)
        res[key + "_library"] = cs.time_ms(lambda: cs.k4_library(*args), reps=5, warmup=1)
        if breakdown:
            res[key + "_parts"] = cs.device_breakdown(lambda: fused_conformer_attention(*args))
        del args
        torch.cuda.empty_cache()


def k5(cs, dev, res, tree, breakdown):
    """K5 at the mel-band conformer's two legs (e 768, k 31), checked against
    fused_conformer_conv_plain; LayerNorm + cuBLAS + cuDNN's grouped conv is
    the yardstick."""
    import torch

    from sesa_tpu_torch.ops.convblock import fused_conformer_conv, fused_conformer_conv_plain

    gen = torch.Generator().manual_seed(5)
    d = cs.MELCONF_MODEL["dim"]
    p = cs._conv_params(gen, d, 2 * d, 31, dev)
    for leg, b, n in _conformer_legs(cs):
        key = f"K5_{leg}"
        x = (0.5 * torch.randn((b, n, d), generator=gen)).to(dev, torch.bfloat16)
        cs.compare(f"{tree} {key}", fused_conformer_conv(x, p), fused_conformer_conv_plain(x, p), x)
        res[key] = cs.time_ms(lambda: fused_conformer_conv(x, p), reps=20, warmup=3)
        res[key + "_library"] = cs.time_ms(lambda: cs.k5_library(x, p), reps=5, warmup=1)
        if breakdown:
            res[key + "_parts"] = cs.device_breakdown(lambda: fused_conformer_conv(x, p))
        del x
        torch.cuda.empty_cache()


def k6(cs, dev, res, tree, breakdown):
    """K6 at Apollo's shape, checked against fused_apollo_conv_plain; the
    cuDNN grouped conv + F.linear composite is the yardstick."""
    import torch

    from sesa_tpu_torch.ops.convblock import fused_apollo_conv, fused_apollo_conv_plain

    gen = torch.Generator().manual_seed(3)
    b, n, d = cs.APOLLO_BPRIME * cs.APOLLO_BANDS, cs.APOLLO_FRAMES, cs.APOLLO_MODEL["feature_dim"]
    p = cs._apollo_conv_params(gen, d, 7, dev)
    x = (0.5 * torch.randn((b, n, d), generator=gen)).to(dev, torch.bfloat16)
    cs.compare(f"{tree} K6", fused_apollo_conv(x, p), fused_apollo_conv_plain(x, p), x)
    res["K6"] = cs.time_ms(lambda: fused_apollo_conv(x, p), reps=20, warmup=3)
    res["K6_library"] = cs.time_ms(lambda: cs.k6_library(x, p), reps=20, warmup=3)
    if breakdown:
        res["K6_parts"] = cs.device_breakdown(lambda: fused_apollo_conv(x, p))
    del x
    torch.cuda.empty_cache()


def k7(cs, dev, res, tree, breakdown):
    """K7 at Apollo's shape (b 7604 x n 80, 8 heads x 32, full rope), checked
    against fused_rope_attention_plain; rope in torch ops + SDPA is the
    yardstick."""
    import torch

    from sesa_tpu_torch.ops.attention import fused_rope_attention, fused_rope_attention_plain

    gen = torch.Generator().manual_seed(7)
    b, n, heads = cs.APOLLO_BPRIME * cs.APOLLO_FRAMES, cs.APOLLO_BANDS, 8
    dh = cs.APOLLO_MODEL["feature_dim"] // heads
    args = cs._k7_args(gen, b, n, heads, dh, dh, dev)
    cs.compare(f"{tree} K7", fused_rope_attention(*args), fused_rope_attention_plain(*args),
               torch.zeros((), device=dev))
    res["K7"] = cs.time_ms(lambda: fused_rope_attention(*args), reps=20, warmup=3)
    res["K7_library"] = cs.time_ms(lambda: cs.k7_library(*args), reps=20, warmup=3)
    if breakdown:
        res["K7_parts"] = cs.device_breakdown(lambda: fused_rope_attention(*args))
    del args
    torch.cuda.empty_cache()


def k2(cs, gen, dev, res, tree):
    import torch

    from sesa_tpu_torch.ops.ff import fused_ff_residual, fused_ff_residual_plain

    for form, tokens, d in (("rms", cs.TOKENS, 512), ("ln", cs.MEL_TOKENS, 384)):
        hidden = 4 * d
        x = torch.randn((tokens, d), generator=gen).to(dev, torch.bfloat16)
        args = (x, cs._near_one(gen, d, dev), cs._weights(gen, (hidden, d), d, dev),
                cs._weights(gen, (hidden,), d, dev), cs._weights(gen, (d, hidden), hidden, dev),
                cs._weights(gen, (d,), hidden, dev))
        if form == "rms":
            kw, lib, key = {}, (lambda: cs.k2_library(*args)), "K2"
        else:
            beta = cs._weights(gen, d, 100, dev)
            kw = dict(beta=beta, norm="ln", act="swish", out_scale=0.5)
            lib, key = (lambda: cs.k2ln_library(*args, beta)), "K2ln"
        cs.compare(f"{tree} {key}", fused_ff_residual(*args, **kw),
                   fused_ff_residual_plain(*args, **kw), x)
        res[key] = cs.time_ms(lambda: fused_ff_residual(*args, **kw), reps=20, warmup=3)
        res[key + "_library"] = cs.time_ms(lib, reps=20, warmup=3)
        del x, args
        torch.cuda.empty_cache()


def k3(cs, gen, dev, res, tree):
    import torch

    from sesa_tpu_torch.ops.attention import vmem_attention, vmem_attention_plain
    from sesa_tpu_torch.ops.rope import apply_rope, default_freqs, rope_tables

    heads, dh, n, b = 8, 64, cs.FRAMES, cs.BATCH * cs.BANDS
    qkv = torch.randn((b * n, 3 * heads * dh), generator=gen).to(dev, torch.bfloat16)
    rope = tuple(r.to(dev, torch.bfloat16)
                 for r in rope_tables(torch.from_numpy(default_freqs(dh)).to(dev), n))
    q, k, v = qkv.reshape(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
    q, k = apply_rope(q, *rope), apply_rope(k, *rope)
    cs.compare(f"{tree} K3", vmem_attention(q, k, v, dh ** -0.5),
               vmem_attention_plain(q, k, v, dh ** -0.5), torch.zeros((), device=dev))
    res["K3"] = cs.time_ms(lambda: vmem_attention(q, k, v, dh ** -0.5), reps=20, warmup=3)
    lib = cs.k3_library(q, k, v, dh ** -0.5)
    res["K3_library"], res["K3_library_name"] = lib["library_ms"], lib["library"]
    res["K3_sdpa_ms"] = lib["sdpa_ms"]
    del qkv, q, k, v
    torch.cuda.empty_cache()


def k8(cs, dev, res, tree):
    """K8 at both legs and both dtypes, inputs from one seed, each checked
    against ssd_plain before it is timed; ssd_einsum is the yardstick."""
    import torch

    from sesa_tpu_torch.ops.ssd import ssd_einsum, ssd_fused, ssd_plain

    gen = torch.Generator().manual_seed(8)
    for leg, bsz, l in cs.K8_LEGS:
        for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            key = f"K8_{leg}_{tag}"
            args = cs.ssd_inputs(gen, bsz, l, cs.MAMBA_HEADS, dtype, dev)
            cs.compare_ssd(f"{tree} {key}", ssd_fused(*args), ssd_plain(*args))
            res[key] = cs.time_ms(lambda: ssd_fused(*args), reps=20, warmup=3)
            res[key + "_library"] = cs.time_ms(lambda: ssd_einsum(*args), reps=3, warmup=1)
            del args
            torch.cuda.empty_cache()


def i8(cs, dev, res, tree):
    """I8 at the flagship's two legs (time: 372 x 8 sequences of 690 frames;
    freq: 4140 x 8 of 62 bands; dim_head 64) on the views the roformer hands
    it (chip_smoke._k3_views), checked against sdpa_int8_plain; SDPA's
    fastest backend on the same bf16 tensors is the yardstick. Where the
    tree's wrapper exposes its stages (sdpa_int8_stages), each is timed
    alone with CUDA events too."""
    import torch

    from sesa_tpu_torch.ops import attention as A

    gen = torch.Generator().manual_seed(9)
    heads, dh = cs.FLAGSHIP_MODEL["heads"], cs.FLAGSHIP_MODEL["dim_head"]
    for leg, b, n in (("time", cs.BATCH * cs.BANDS, cs.FRAMES),
                      ("freq", cs.BATCH * cs.FRAMES, cs.BANDS)):
        key = f"I8_{leg}"
        q, k, v = cs._k3_views(gen, dev, b, n, heads, dh)
        cs.compare(f"{tree} {key}", A.sdpa_int8(q, k, v), A.sdpa_int8_plain(q, k, v),
                   torch.zeros((), device=dev))
        res[key] = cs.time_ms(lambda: A.sdpa_int8(q, k, v), reps=20, warmup=3)
        lib = cs.k3_library(q, k, v, dh ** -0.5)
        res[key + "_library"], res[key + "_library_name"] = lib["library_ms"], lib["library"]
        if hasattr(A, "sdpa_int8_stages"):
            for name, launch in A.sdpa_int8_stages(q, k, v):
                res[f"{key}_{name}"] = cs.time_ms(launch, reps=20, warmup=3)
        del q, k, v
        torch.cuda.empty_cache()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--base", help="the base tree (e.g. the parent commit, unpacked)")
    parser.add_argument("--pairs", type=int, default=4)
    parser.add_argument("--kernels", type=lambda v: v.split(","),
                        default=[k for k in ROWS if k != "CLI"],
                        help=f"a subset of {list(ROWS)}")
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    parser.add_argument("--breakdown", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not set(args.kernels) <= set(ROWS):
        parser.error(f"--kernels takes a subset of {list(ROWS)}")
    if args.worker:
        worker(args.worker, args.kernels, args.breakdown)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device visible", file=sys.stderr)
        return 1
    if not args.base or not os.path.isdir(os.path.join(args.base, "sesa_tpu_torch")):
        parser.error("--base must name a tree that holds sesa_tpu_torch/")
    order = []
    for i in range(args.pairs):
        order += [args.base, HERE] if i % 2 == 0 else [HERE, args.base]
    turns = []
    for i, tree in enumerate(order):
        # device time by kernel in each tree's first turn
        first = order.index(tree) == i
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", tree,
                            "--kernels", ",".join(args.kernels)] + (["--breakdown"] if first else []),
                           capture_output=True, text=True, timeout=600)
        sys.stdout.write(r.stdout)
        if r.returncode != 0:
            sys.stderr.write(r.stderr[-4000:])
            raise RuntimeError(f"turn on {tree} failed ({r.returncode})")
        turns.append(next(json.loads(line[3:]) for line in r.stdout.splitlines()
                          if line.startswith("AB ")))
    rows = [r for k in args.kernels for r in ROWS[k]]
    summary = {}
    for name, tree in (("base", args.base), ("new", HERE)):
        mine = [t for t in turns if t["tree"] == tree]
        summary[name] = {k: dict(median=statistics.median(t[k] for t in mine),
                                 lo=min(t[k] for t in mine), hi=max(t[k] for t in mine))
                         for r in rows for k in (r, r + "_library") if k in mine[0]}

    def cell(v, unit):
        return f"{v['median']:.4f} [{v['lo']:.4f}-{v['hi']:.4f}]{unit}"

    for k in rows:
        unit = "" if k.startswith(("flagship_", "melconf_", "int8_")) else " ms"
        # a row one tree lacks (the stages of a kernel the base runs as one call)
        got = {tree: cell(summary[tree][k], unit) if k in summary[tree] else "-"
               for tree in ("base", "new")}
        line = f"{k}: base {got['base']}, new {got['new']}"
        if k + "_library" in summary["new"]:
            line += f", library {cell(summary['new'][k + '_library'], unit)}"
        print(line)
    for t in turns:
        for k in rows:
            for ms, n, name in t.get(k + "_parts", []):
                print(f"{k} {'base' if t['tree'] == args.base else 'new'} by kernel: "
                      f"{ms:.3f} ms x{n:g} {name[:90]}")
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_ab.json"), "w") as f:
        json.dump(dict(card=card, order=order, turns=turns, summary=summary), f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
