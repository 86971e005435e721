"""Does the restoration end of the chain queue without waiting? On one NVIDIA GPU.

Runs Apollo's ``apply`` (f32, and bf16 through K6 and K7) on prepared
weights and ``ensemble_phase_fix_device`` once to warm them, then once more
under ``torch.cuda.set_sync_debug_mode("error")``, which raises on a
synchronising call (``.item()``, a copy from pageable host memory), and
reports for each whether it raised. ``--tree`` names a checkout of the repo
(for example a parent commit unpacked beside this one) whose
``sesa_tpu_torch`` is imported instead of this one's:

    mkdir chip_parent; git archive <commit> | tar -x -C chip_parent
    python3 tools/sync_probe.py; python3 tools/sync_probe.py --tree chip_parent

Prints one JSON object and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def _queued(fn):
    """What ``fn()`` does under the sync debug mode, after a warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
        return "no synchronising call"
    except RuntimeError as e:
        return f"raised: {str(e)[:120]}"
    finally:
        torch.cuda.set_sync_debug_mode("default")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=None, help="a checkout whose sesa_tpu_torch to import")
    args = parser.parse_args(argv)
    tree = os.path.abspath(args.tree or os.path.dirname(os.path.dirname(__file__)))
    sys.path.insert(0, tree)

    import torch

    if not torch.cuda.is_available():
        print("sync_probe: no CUDA device visible", file=sys.stderr)
        return 1
    from sesa_tpu_torch.configs import AttrDict
    from sesa_tpu_torch.models import apollo
    from sesa_tpu_torch.postprocess import ensemble_phase_fix_device
    from sesa_tpu_torch.tree import tree_map

    cfg = AttrDict({"model": dict(sr=44100, win=20, feature_dim=64, layer=1)})
    params = tree_map(lambda p: p.cuda(), apollo.init(torch.Generator().manual_seed(0), cfg))
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((1, 2, 2 * 44100), device="cuda", generator=gen)
    res = {"tree": tree}
    for name, dtype in (("apollo_f32", None), ("apollo_bf16", torch.bfloat16)):
        prepared = apollo.prepare(params, cfg, dtype)
        res[name] = _queued(lambda: apollo.apply(prepared, cfg, x, compute_dtype=dtype))
    mix = torch.randn((2, 3 * 44100), device="cuda", generator=gen)
    res["phase_fix"] = _queued(lambda: ensemble_phase_fix_device(mix, [0.5 * mix, 0.4 * mix],
                                                                 44100))
    print(json.dumps(res))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
          .stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
