"""Where does a session call wait for the card, and what do its host spans cost? On one NVIDIA GPU.

For each benchmark cell named (every cell of ``BENCHMARK.json`` by default)
the cell's session is built as ``h100_bench/run.py`` builds it (weights made
from ``--seed``, warmed on every batch size of its mix), then the mix's
first item is separated with ``separate_with_extras`` as the benchmark calls
it, twice more:

- under ``torch.cuda.set_sync_debug_mode("warn")``: each synchronising call
  is listed by the program line it came from, and whether that line lies
  inside a ``with span("sesa.sync.<what>")`` block of ``runtime/session.py``
  or ``runtime/demix.py`` (warnings raised outside the call, such as one
  when the mode is set, are listed apart). The mode reports implicit waits
  (a copy to or from pageable memory, a value read back); an explicit wait
  on an event is a ``sesa.sync`` span it does not see;
- under ``torch.profiler`` (CPU and CUDA): the call's program spans by name,
  and every device event whose name starts with ``sesa.`` (a span mirrored
  onto the device's timeline; there should be none).

The first cell is also separated with the "int16" and "device" transports
under the sync debug mode. Last, ``runtime.profiling.span`` is timed with no
profiler and under one. Run from the repository's root:

    python3 tools/span_probe.py [--cells bsrof_clips ...] [--seed N]

Prints one JSON object, the card's name and power limit in it.
"""

from __future__ import annotations

import argparse
import ast
import collections
import json
import os
import subprocess
import sys
import time
import traceback
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SYNC_FILES = ("runtime/session.py", "runtime/demix.py")


def sync_blocks() -> dict:
    """{(path, first line, last line): span name} of every ``with
    span("sesa.sync.…")`` block of the session and demix."""
    import sesa_tpu_torch

    blocks = {}
    for rel in SYNC_FILES:
        path = os.path.join(os.path.dirname(sesa_tpu_torch.__file__), rel)
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if not isinstance(node, ast.With):
                continue
            for item in node.items:
                call = item.context_expr
                if (isinstance(call, ast.Call) and getattr(call.func, "id", None) == "span"
                        and isinstance(call.args[0], ast.Constant)
                        and call.args[0].value.startswith("sesa.sync.")):
                    blocks[(path, node.lineno, node.end_lineno)] = call.args[0].value
    return blocks


def synchronising_calls(fn, blocks: dict) -> tuple:
    """([{line, code, span}] of each synchronising call ``fn`` makes: the
    innermost program line of its stack and the ``sesa.sync`` span around it
    or None; [messages] of the warnings raised outside ``fn``)."""
    import torch

    found, outside = [], []

    def show(message, category, filename, lineno, file=None, line=None):
        stack = traceback.extract_stack()[:-1]
        if not any(f.name == "_probed_call" for f in stack):
            outside.append(str(message)[:200])
            return
        program = [f for f in stack if f"{os.sep}sesa_tpu_torch{os.sep}" in f.filename]
        where = program[-1] if program else stack[-1]
        inside = [name for f in stack for (path, a, b), name in blocks.items()
                  if os.path.samefile(f.filename, path) and a <= f.lineno <= b]
        found.append({"line": f"{os.path.relpath(where.filename, ROOT)}:{where.lineno}",
                      "code": where.line, "span": inside[-1] if inside else None,
                      "message": str(message)[:80]})

    def _probed_call():
        fn()

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _probed_call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return found, outside


def profiled_spans(fn) -> dict:
    """The program spans of one call by name, and the device events named
    ``sesa.``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    host, device = collections.Counter(), collections.Counter()
    for e in prof.events():
        if e.name.startswith("sesa."):
            (device if e.device_type == DeviceType.CUDA else host)[e.name] += 1
    return {"host": dict(host), "device": dict(device),
            "syncs": sum(n for name, n in host.items() if name.startswith("sesa.sync."))}


def span_cost_us(n: int) -> dict:
    """Microseconds a ``with span(...)`` costs, less an empty loop's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sesa_tpu_torch.runtime.profiling import span

    def loop(body):
        t = time.perf_counter()
        for _ in range(n):
            body()
        return (time.perf_counter() - t) / n * 1e6

    def one():
        with span("sesa.probe"):
            pass

    empty = loop(lambda: None)
    off = loop(one) - empty
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        on = loop(one) - empty
        torch.cuda.synchronize()
    return {"no_profiler": off, "under_profiler": on, "spans_timed": n}


def probe_cell(name: str, seed: int, blocks: dict, every_transport: bool) -> dict:
    import torch

    from h100_bench import manifest
    from h100_bench import run as bench

    run = bench.Run(manifest.Cell(name), seed, "cuda")
    session = bench.setup_session(run)
    sess = run.traffic["session"]
    audio = run.mix.audio(0)
    out = {"item_s": audio.shape[-1] / run.mix.sr}
    transports = [sess.get("transport", "f32")]
    if every_transport:
        transports += [t for t in ("f32", "int16", "device") if t not in transports]
    for transport in transports:
        def call():
            session.separate_with_extras(
                audio, extract_instrumental=run.extract_instrumental,
                use_tta=bool(sess.get("use_tta", False)), transport=transport)

        call()  # this transport's shapes warm
        torch.cuda.synchronize()
        syncs, outside = synchronising_calls(call, blocks)
        torch.cuda.synchronize()
        spans = profiled_spans(call)
        out[transport] = {"synchronising_calls": syncs, "warnings_outside_the_call": outside,
                          "spans": spans,
                          "uncovered": [s for s in syncs if s["span"] is None],
                          "count_matches": len(syncs) == spans["syncs"]}
    out["rescues"] = session.rescues
    del session
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cells", nargs="*", default=None, help="benchmark cells (default all)")
    parser.add_argument("--seed", type=int, default=2 ** 31 + 25)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("span_probe: no CUDA device visible", file=sys.stderr)
        return 1
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cells = args.cells or [w["name"] for w in json.load(f)["workloads"]]
    blocks = sync_blocks()
    res = {"seed": args.seed, "sync_blocks": sorted(
        f"{os.path.relpath(p, ROOT)}:{a}-{b} {n}" for (p, a, b), n in blocks.items())}
    for i, name in enumerate(cells):
        res[name] = probe_cell(name, args.seed, blocks, every_transport=i == 0)
    res["span_cost_us"] = span_cost_us(20000)
    res["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True,
                                 text=True).stdout.strip()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
