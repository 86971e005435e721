"""Readings for the limits of ``correct``: the numbers that the check
compares, for the program on many seeds and for the control on a few, in one
process.

    python3 h100_bench/calibrate.py --workload bsrof_songs --seconds 8 \\
        --seeds 101-112 --control-seeds 201-203

Each seed makes its own weights and inputs and runs a short window at the
cell's own load, long enough to finish the mix's longest items and to
compare as many as a run does. The control is the reference put in the
program's place in the session, every product's operands rounded to fp8
(``reference.roformer.FP8``): the precision below the configuration's bf16.
(The program's own lower path, int8 attention, changes the stems by less
than bf16 does elsewhere, so it cannot serve: PERF.md.) The last line is a
JSON object of every reading. The benchmark's own runs never run the
control.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from h100_bench import check, manifest, weights  # noqa: E402
from h100_bench import run as bench  # noqa: E402
from h100_bench.reference.roformer import FP8  # noqa: E402


def _seeds(text: str) -> list:
    out = []
    for part in filter(None, text.split(",")):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def fp8_in_place(run, session) -> None:
    """Put the reference, its products in fp8, in the program's place: the
    session's demix calls it on each batch of chunks."""
    import torch

    sd = weights.make_state_dict(run.model_mod.state_dict_layout(run.config["model"]),
                                 run.seed, run.device)
    products = FP8()

    def apply_fn(params, chunks):
        with products.context():
            return run.model_mod.reference_forward(sd, run.config["model"],
                                                   chunks.float(), products)

    session._model_apply = lambda compute_dtype: apply_fn
    if run.device == "cuda":
        torch.cuda.synchronize()


def reading(name: str, seed: int, seconds: float, control: bool) -> dict:
    import torch

    run = bench.Run(manifest.Cell(name), seed, "cuda")
    session = bench.setup_session(run)
    if control:
        fp8_in_place(run, session)
    bench.measure(run, session, seconds, False)
    del session
    torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = check.compare(run, run.mix.checked(len(run.items)))
    out = dict(seed=seed, control=control, items=len(run.items), failed=run.failed,
               launches=run.launches,
               check_s=time.perf_counter() - t, **numbers)
    bench.log(json.dumps(out))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--seeds", default="101-112")
    p.add_argument("--control-seeds", default="201-203")
    p.add_argument("--control-seconds", type=float, default=None,
                   help="the control's window (default --seconds): the fp8 reference is slower "
                        "than the program, and has to finish as many items as a run compares")
    args = p.parse_args(argv)
    rows = [reading(args.workload, s, args.seconds, False) for s in _seeds(args.seeds)]
    rows += [reading(args.workload, s, args.control_seconds or args.seconds, True)
             for s in _seeds(args.control_seeds)]
    summary = {}
    for key in rows[0]:
        if key.endswith("_rel_err"):
            prog = [r[key] for r in rows if not r["control"]]
            ctrl = [r[key] for r in rows if r["control"]]
            summary[key] = {"program_max": max(prog), "control_min": min(ctrl) if ctrl else None}
    print(json.dumps({"workload": args.workload, "rows": rows, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
