"""Time K7 at Apollo's shape in one tree of the repository, with and without
rope, on one NVIDIA GPU: the yardstick of K7's versions.

    mkdir -p chip_proof/v1 && git archive <commit> | tar -x -C chip_proof/v1
    for t in chip_parent chip_proof/v1 chip_proof/v1 chip_parent; do
        python3 chip_versions.py $t; done

Imports ``sesa_tpu_torch`` from the tree given (a directory that
``.gitignore`` lists, so that the copy reaches the card), builds its
``rope_attention`` library, runs ``fused_rope_attention`` on b 7604 x n 80,
8 heads x 32 (seeded inputs) with the full rotary width and with no rope,
holds the first against ``fused_rope_attention_plain`` and prints one line:
the tree, both times (CUDA events over 30 launches after 3 warm-ups) and
the max |kernel - plain|. Run the trees in turns in one call, so that
drift of the card falls on all of them.
"""

from __future__ import annotations

import os
import sys


def main() -> int:
    if len(sys.argv) != 2 or not os.path.isdir(os.path.join(sys.argv[1], "sesa_tpu_torch")):
        print(__doc__, file=sys.stderr)
        return 2
    tree = os.path.abspath(sys.argv[1])
    sys.path.insert(0, tree)
    import torch

    import sesa_tpu_torch
    from sesa_tpu_torch.ops.attention import fused_rope_attention, fused_rope_attention_plain
    from sesa_tpu_torch.ops.rope import default_freqs, rope_tables

    if not torch.cuda.is_available():
        print("chip_versions: no CUDA device visible", file=sys.stderr)
        return 1
    if not os.path.abspath(sesa_tpu_torch.__file__).startswith(tree):
        raise RuntimeError(f"imported {sesa_tpu_torch.__file__}, not the tree {tree}")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    b, n, heads, dh = 7604, 80, 8, 32
    qkv = torch.randn((b, n, 3 * heads * dh), generator=gen).to(dev, torch.bfloat16)
    rope = tuple(r.to(dev, torch.bfloat16).contiguous()
                 for r in rope_tables(torch.from_numpy(default_freqs(dh)).to(dev), n))

    def time_ms(fn, reps=30):
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

    err = float((fused_rope_attention(qkv, heads, dh ** -0.5, rope).float()
                 - fused_rope_attention_plain(qkv, heads, dh ** -0.5, rope).float()).abs().max())
    with_rope = time_ms(lambda: fused_rope_attention(qkv, heads, dh ** -0.5, rope))
    no_rope = time_ms(lambda: fused_rope_attention(qkv, heads, dh ** -0.5, None))
    print(f"K7 {os.path.relpath(tree)}: rope {with_rope:.4f} ms, no rope {no_rope:.4f} ms, "
          f"max |kernel - plain| {err:.4g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
