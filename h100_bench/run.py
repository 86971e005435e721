"""The benchmark of sesa_tpu_torch on NVIDIA H100 cards: one run of one cell.

    python3 h100_bench/run.py --workload bsrof_songs --seed 7 --seconds 30 --trace 0

A cell (``BENCHMARK.json``) is a model configuration under a traffic mix.
The run makes the weights on the card from the seed in the published
checkpoint's layout, hands them to the program through its own load path
(``convert_checkpoint``), builds an ``InferenceSession`` as the CLI does,
warms up every call shape the mix uses, then separates the mix's items
back to back (one client, closed loop), each through
``separate_with_extras(mix, extract_instrumental=True)``, the call the CLI
makes per file. The window closes at the end of the first item that ends
after ``--seconds`` of call time. After it, the stems of a sample of the
items are compared with the plain reference (``check.py``).

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics, read from a ``torch.profiler`` trace of a window of at
most ``TRACE_SECONDS`` of calls. The
last line of standard output is the result as JSON; the numbers compared
with their limits are the last lines of standard error. Without a CUDA card
(or with fewer than the cell asks for) the run prints no result and exits
with 2. It exits with 3, printing no result, if the JAX package or JAX was
loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the program's kernel libraries build once per checkout, at a fixed path inside it
os.environ["SESA_CACHE_DIR"] = os.path.join(ROOT, "sesa_tpu_torch", "build")
# the configuration states bf16 attention; the int8 path is the control's, not the cell's
os.environ.pop("SESA_INT8_ATTN", None)

from h100_bench import check, guard, manifest, traffic  # noqa: E402
from h100_bench.reference.demix import Layout  # noqa: E402
from h100_bench.trace import Trace, load_kernel_table  # noqa: E402


# A traced run's window: the profiler's post-processing grows with the events
# (about 7 s per traced second of Kim's model on the card, 270 s for 30 s),
# and a traced run must end within 360 s.
TRACE_SECONDS = 12.0


def log(msg: str) -> None:
    print(msg, flush=True)


class Run:
    """One run's measurements, which the metric readers read."""

    def __init__(self, cell: manifest.Cell, seed: int, device: str, overrides=None):
        self.cell, self.seed, self.device = cell, seed, device
        self.config = json.loads(json.dumps(cell.config))
        self.traffic = dict(cell.traffic)
        for key, val in (overrides or {}).items():  # tests run tiny sizes on the CPU
            section, _, name = key.partition(".")
            (self.traffic if section == "traffic" else self.config.setdefault(section, {}))[
                name] = val
        self.model_mod = cell.model_mod
        sess = self.traffic["session"]
        self.chunk = int(self.config["audio"]["chunk_size"])
        self.overlap, self.batch = int(sess["num_overlap"]), int(sess["batch_size"])
        self.extract_instrumental = bool(sess.get("extract_instrumental", True))
        self.mix = traffic.Mix(self.traffic, seed)
        self.items, self.kept = [], {}
        self.failed, self.setup, self.setup_s = 0, {}, 0.0
        self.peak_bytes, self.trace, self.launches = 0, None, {}

    def batches(self, length: int) -> list:
        """The model calls' batch sizes for an item: every chunk once."""
        n = Layout(length, self.chunk, self.overlap).n_chunks
        return [min(self.batch, n - k) for k in range(0, n, self.batch)]

    def item_chunks(self) -> int:
        return sum(it["chunks"] for it in self.items)

    def kernel_bound_s(self, family: str) -> float:
        """Seconds the window's items need of ``family`` at its roofline."""
        model = self.config["model"]
        return sum(self.model_mod.kernel_bound_s(model, self.chunk, b)[family]
                   for it in self.items for b in it["batches"])

    def model_flops(self) -> float:
        per = self.model_mod.model_flops_per_chunk(self.config["model"], self.chunk)
        return per * self.item_chunks()

    def walls_s(self) -> list:
        return [it["wall_s"] for it in self.items if it["ok"]]


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().replace("\n", "; ") or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unknown ({e})"


def _warm_lengths(run: Run) -> list:
    """Item lengths whose separations make every model-call batch size the
    mix's lengths make, the shortest such length for each size."""
    sr = run.mix.sr
    lo, hi = run.traffic["length_s"]
    needed = set()
    for k in range(int(lo * 10), int(hi * 10) + 1):  # 0.1 s steps over the range
        needed.update(run.batches(int(k * sr / 10)))
    chosen = {}
    k = 5  # from half a second up, in half seconds
    while needed - set(chosen) and k <= int(hi * 10):
        for b in run.batches(int(k * sr / 10)):
            chosen.setdefault(b, int(k * sr / 10))
        k += 5
    return sorted(set(chosen.values()))


def setup_session(run: Run):
    """Everything before the window, each part timed into ``run.setup``."""
    import torch

    from sesa_tpu_torch.convert import convert_checkpoint
    from sesa_tpu_torch.configs import config_from_dict
    from sesa_tpu_torch.runtime.session import InferenceSession, demix_spec
    from sesa_tpu_torch.tree import tree_map
    run.setup["import"] = time.perf_counter() - T0
    cuda = run.device == "cuda"

    t = time.perf_counter()
    if cuda:
        torch.cuda.init()
        torch.empty(1, device="cuda")
        torch.cuda.synchronize()
    run.setup["cuda_init"] = time.perf_counter() - t

    t = time.perf_counter()
    if cuda:
        from sesa_tpu_torch.ops import _build
        built = _build.build_all(run.model_mod.KERNEL_LIBRARIES)
        for name in run.model_mod.KERNEL_LIBRARIES:
            _build.load(name)
        log("[build] " + (", ".join(f"{k} {v:.1f} s" for k, v in built.items())
                          or "nothing built: every library was in " + _build.build_dir()))
    run.setup["libraries"] = time.perf_counter() - t

    t = time.perf_counter()
    from h100_bench import weights
    sd = weights.make_state_dict(run.model_mod.state_dict_layout(run.config["model"]),
                                 run.seed, run.device)
    if cuda:
        torch.cuda.synchronize()
    run.setup["weights"] = time.perf_counter() - t

    t = time.perf_counter()
    config = config_from_dict(run.config)
    model_type = run.cell.model_type
    params = convert_checkpoint(model_type, sd, config)
    del sd
    params = tree_map(lambda p: p.to(device=run.device, dtype=torch.float32), params)
    sess = run.traffic["session"]
    dtype = {"bf16": torch.bfloat16, "f32": None}[sess["compute_dtype"]]
    spec = demix_spec(config, model_type, num_overlap=run.overlap, batch_size=run.batch)
    session = InferenceSession(model_type, config, params, spec, torch.device(run.device), dtype)
    if cuda:
        torch.cuda.synchronize()
    run.setup["convert"] = time.perf_counter() - t

    t = time.perf_counter()
    for n in _warm_lengths(run):
        audio = run.mix.warm_audio(n)
        session.separate_with_extras(audio, extract_instrumental=run.extract_instrumental,
                                     use_tta=bool(sess.get("use_tta", False)),
                                     transport=sess.get("transport", "f32"))
    if cuda:
        torch.cuda.synchronize()
    run.setup["warm_up"] = time.perf_counter() - t
    return session


def _counters(table) -> dict:
    import importlib

    out = {}
    for fam, entry in table.items():
        mod, _, name = entry["counter"].rpartition(".")
        out[fam] = getattr(importlib.import_module(mod), name).launches
    return out


def measure(run: Run, session, seconds: float, trace: bool) -> None:
    """The window: items back to back until ``seconds`` of call time
    (``TRACE_SECONDS`` at most in a traced run)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = run.device == "cuda"
    sess = run.traffic["session"]
    kind = run.traffic.get("item", "item")
    table = load_kernel_table(os.path.join(ROOT, "h100_bench", "kernels"))
    before = _counters(table) if cuda else {}
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    prof = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if trace
            else contextlib.nullcontext())
    call_time, i = 0.0, 0
    if trace:
        seconds = min(seconds, TRACE_SECONDS)
    with prof:
        while call_time < seconds and run.failed < 3:
            audio = run.mix.audio(i)  # made off the clock, as a decoder would
            spans = run.mix.spans(i, run.chunk // run.overlap)
            span = record_function(f"bench::{kind}#{i}") if trace else contextlib.nullcontext()
            out, ok = None, True
            t0 = time.perf_counter()
            with span:
                try:
                    out = session.separate_with_extras(
                        audio, extract_instrumental=run.extract_instrumental,
                        use_tta=bool(sess.get("use_tta", False)),
                        transport=sess.get("transport", "f32"))
                    if cuda:
                        torch.cuda.synchronize()
                except Exception:  # a failed call is counted and reported, and the run goes on
                    ok = False
                    run.failed += 1
                    traceback.print_exc()
            wall = time.perf_counter() - t0
            call_time += wall
            n, batches = audio.shape[-1], run.batches(audio.shape[-1])
            run.items.append(dict(index=i, length=n, audio_s=n / run.mix.sr, wall_s=wall, ok=ok,
                                  batches=batches, chunks=sum(batches)))
            run.kept[i] = (check.keep(out, audio, check.instruments(run.config), spans,
                                      run.extract_instrumental) if ok
                           else {"problem": "the call raised"})
            i += 1
    if cuda:
        torch.cuda.synchronize()
        run.peak_bytes = torch.cuda.max_memory_allocated()
        after = _counters(table)
        run.launches = {f: after[f] - before[f] for f in table}
    if trace:
        run.trace = Trace(prof.events(), table, run.launches)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             overrides=None) -> dict:
    """One run; returns the result line's object. ``device="cpu"`` and
    ``overrides`` are for the tests, which drive tiny sizes on the CPU."""
    import torch

    cell = manifest.Cell(name)
    run = Run(cell, seed, device, overrides)
    session = setup_session(run)
    run.setup_s = time.perf_counter() - T0
    log("[setup] " + ", ".join(f"{k} {v:.3f} s" for k, v in run.setup.items())
        + f"; setup_s {run.setup_s:.3f}")
    measure(run, session, seconds, trace)
    lens = [round(it["audio_s"], 3) for it in run.items]
    log(f"[window] {len(run.items)} {run.traffic.get('item', 'item')}s attempted, "
        f"{run.failed} failed, lengths s {lens}; call walls s "
        f"{[round(it['wall_s'], 4) for it in run.items]}")
    predicted = {}
    for it in run.items:
        for b in it["batches"]:
            for fam, n in run.model_mod.kernel_launches(run.config["model"], b).items():
                predicted[fam] = predicted.get(fam, 0) + n
    log(f"[rescues] {session.rescues} (bf16 -> f32 reruns); kernel launches {run.launches}, "
        f"the model's path needs {predicted}")
    found = guard.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        raise SystemExit(3)

    metrics = {}
    for entry, read in cell.metrics(trace):
        value = read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    result = {"correct": False, "attempted": len(run.items), "failed": run.failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if device == "cuda" else device,
                         "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
                         "count": cell.chips, "memory_peak_bytes": run.peak_bytes}}
    if trace:
        result["device"]["busy_s"] = run.trace.busy_us() * 1e-6
        result["device"]["window_s"] = run.trace.window_us() * 1e-6
        result["breakdown"] = run.trace.breakdown()
        log("[trace] " + json.dumps({
            "families_s": {k: v * 1e-6 for k, v in run.trace.families.items()},
            "kernels": run.trace.kernel_count(), "events": len(run.trace.device),
            "sesa_s": {n: us * 1e-6 for n, us in run.trace.by_name.items() if "sesa::" in n}}))

    # the program's state goes before the reference runs on the same card
    del session
    if device == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    done = [it["index"] for it in run.items]
    numbers = check.compare(run, run.mix.checked(len(done)))
    log(f"[check] items {run.mix.checked(len(done))} compared in "
        f"{time.perf_counter() - t:.1f} s")
    result["correct"] = run.failed == 0 and all(
        numbers[k] <= cell.limits[k] for k in numbers)
    result["check"] = {k: {"value": numbers[k] if numbers[k] != float("inf") else None,
                           "limit": cell.limits[k]} for k in numbers}
    for k in numbers:
        print(f"check {k} {numbers[k]} limit {cell.limits[k]}", file=sys.stderr, flush=True)
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    chips = manifest.Cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    log(f"[card] {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
        f"{_power_limit()}; torch {torch.__version__} cuda {torch.version.cuda}")
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = guard.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
