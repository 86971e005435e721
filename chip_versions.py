"""Time one kernel in one tree of the repository on one NVIDIA GPU: the
yardstick of a kernel's versions. K7 (the default) at Apollo's shape with and
without rope; I8 at the flagship's two legs, by stage.

    mkdir -p chip_proof/v1 && git archive <commit> | tar -x -C chip_proof/v1
    for t in chip_parent chip_proof/v1 chip_proof/v1 chip_parent; do
        python3 chip_versions.py $t; done
    python3 chip_versions.py chip_proof/v1 --kernel I8

Imports ``sesa_tpu_torch`` from the tree given (a directory that
``.gitignore`` lists, so that the copy reaches the card) and builds the
kernel's library. K7: ``fused_rope_attention`` on b 7604 x n 80, 8 heads x
32 (seeded inputs) with the full rotary width and with no rope, the first
held against ``fused_rope_attention_plain``. I8: ``sdpa_int8`` on the
views the roformer hands it at the time leg (372 x 8 sequences of 690
frames) and the freq leg (4140 x 8 of 62 bands), dim_head 64, each held
against ``sdpa_int8_plain``, and each of its stages alone where the tree's
wrapper exposes them (``sdpa_int8_stages``). Prints one line: the tree, the
times (CUDA events over 30 launches after 3 warm-ups) and the max |kernel -
plain|. Run the trees in turns in one call, so that drift of the card falls
on all of them.
"""

from __future__ import annotations

import argparse
import os
import sys


def time_ms(fn, reps=30):
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k7(tree, dev):
    import torch

    from sesa_tpu_torch.ops.attention import fused_rope_attention, fused_rope_attention_plain
    from sesa_tpu_torch.ops.rope import default_freqs, rope_tables

    gen = torch.Generator().manual_seed(1)
    b, n, heads, dh = 7604, 80, 8, 32
    qkv = torch.randn((b, n, 3 * heads * dh), generator=gen).to(dev, torch.bfloat16)
    rope = tuple(r.to(dev, torch.bfloat16).contiguous()
                 for r in rope_tables(torch.from_numpy(default_freqs(dh)).to(dev), n))
    err = float((fused_rope_attention(qkv, heads, dh ** -0.5, rope).float()
                 - fused_rope_attention_plain(qkv, heads, dh ** -0.5, rope).float()).abs().max())
    with_rope = time_ms(lambda: fused_rope_attention(qkv, heads, dh ** -0.5, rope))
    no_rope = time_ms(lambda: fused_rope_attention(qkv, heads, dh ** -0.5, None))
    print(f"K7 {os.path.relpath(tree)}: rope {with_rope:.4f} ms, no rope {no_rope:.4f} ms, "
          f"max |kernel - plain| {err:.4g}", flush=True)


def i8(tree, dev):
    import torch

    from sesa_tpu_torch.ops import attention as A
    from sesa_tpu_torch.ops.rope import apply_rope, default_freqs, rope_tables

    gen = torch.Generator().manual_seed(21)
    heads, dh = 8, 64
    parts = []
    for leg, b, n in (("time", 372, 690), ("freq", 4140, 62)):
        qkv = torch.randn((b * n, 3 * heads * dh), generator=gen).to(dev, torch.bfloat16)
        rope = tuple(r.to(dev, torch.bfloat16)
                     for r in rope_tables(torch.from_numpy(default_freqs(dh)).to(dev), n))
        q, k, v = qkv.reshape(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
        q, k = apply_rope(q, *rope), apply_rope(k, *rope)
        err = float((A.sdpa_int8(q, k, v).float() - A.sdpa_int8_plain(q, k, v).float())
                    .abs().max())
        line = f"{leg} {time_ms(lambda: A.sdpa_int8(q, k, v)):.4f} ms"
        if hasattr(A, "sdpa_int8_stages"):
            line += " (" + ", ".join(f"{name} {time_ms(launch):.4f}"
                                     for name, launch in A.sdpa_int8_stages(q, k, v)) + ")"
        parts.append(f"{line}, max |kernel - plain| {err:.4g}")
        del qkv, q, k, v
        torch.cuda.empty_cache()
    print(f"I8 {os.path.relpath(tree)}: " + "; ".join(parts), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("tree")
    parser.add_argument("--kernel", choices=("K7", "I8"), default="K7")
    args = parser.parse_args()
    if not os.path.isdir(os.path.join(args.tree, "sesa_tpu_torch")):
        parser.error("the tree must hold sesa_tpu_torch/")
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    import sesa_tpu_torch

    if not torch.cuda.is_available():
        print("chip_versions: no CUDA device visible", file=sys.stderr)
        return 1
    if not os.path.abspath(sesa_tpu_torch.__file__).startswith(tree):
        raise RuntimeError(f"imported {sesa_tpu_torch.__file__}, not the tree {tree}")
    (k7 if args.kernel == "K7" else i8)(tree, torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
