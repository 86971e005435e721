"""band_loop_host_ms (ms/chunk, program spans): the host's own work in the
57-band loops of bs_mamba2's bottlenecks and heads, which queue a few kernels
a band: the time inside the program's ``sesa.mamba.split`` and
``sesa.mamba.heads`` spans within the calls, less the time inside the CUDA
runtime and driver calls among them (``cudaLaunchKernel``, ``cuLaunchKernel``,
...), where the host waits while the launch queue is full; per chunk the
window computed. What is left is the Python and ATen work of issuing the
loops' kernels, which a faster device does not shorten. None where the trace
holds no such span: a program that records none."""

import re

from h100_bench import spans
from h100_bench.trace import covered, union_runs

LOOPS = ("sesa.mamba.split", "sesa.mamba.heads")
DRIVER = re.compile(r"^cu(da)?[A-Z]")


def read(run):
    calls = run.trace.spans
    loops = [(s, e) for n, s, e in spans.program_spans(run) if n in LOOPS
             and any(w0 <= s and e <= w1 for _, w0, w1 in calls)]
    chunks = run.item_chunks()
    if not loops or not chunks:
        return None
    driver = union_runs((s, e) for n, s, e, _ in run.trace._cpu if DRIVER.match(n))
    return sum(e - s - covered(driver, s, e) for s, e in loops) / 1e3 / chunks
