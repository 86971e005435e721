"""The program's own host spans inside each call, read from a traced run.

The session and demix record ``sesa.<phase>`` spans (``cpu_op`` events of the
thread that runs the calls; ``sesa_tpu_torch/runtime/profiling.py``
``span``). Each harness call span is split at the start of its first
``sesa.dispatch`` and at the end of its last one into three parts:

- pre-dispatch: from the call's start to the first dispatch (the mix's
  upload, and whatever the session does first);
- dispatch: the segment loops that queue the model calls (device idle here
  is the host not keeping the card fed);
- post-dispatch: from the last dispatch's end to the call's end (the
  rescue flag, the stems' copy to the host, the derived stems).

A part's idle time is its length less the device's busy union inside it
(``Trace.busy_us``), so the three parts of a call add up to the call's idle
time as ``host_ms_per_clip`` and ``idle_pct`` read it. A call with no
dispatch span counts whole as pre-dispatch. Every reader returns None for a
trace without ``sesa.dispatch`` spans: a program that records none.
"""

from __future__ import annotations

from typing import List, Optional

DISPATCH = "sesa.dispatch"
SYNC_PREFIX = "sesa.sync."


def program_spans(run) -> list:
    """(name, start, end) of the program's ``sesa.`` spans."""
    return [(n, s, e) for n, s, e, _ in run.trace._cpu if n.startswith("sesa.")]


def _idle_us(trace, lo: float, hi: float) -> float:
    return (hi - lo) - trace.busy_us(lo, hi)


def idle_parts(run) -> Optional[List[tuple]]:
    """[(pre, dispatch, post)] device idle in microseconds, one tuple a call,
    or None where the trace holds no dispatch span."""
    program = program_spans(run)
    dispatch = [(s, e) for n, s, e in program if n == DISPATCH]
    if not dispatch:
        return None
    parts = []
    for _, w0, w1 in run.trace.spans:
        inside = [(s, e) for s, e in dispatch if w0 <= s and e <= w1]
        a0 = min((s for s, _ in inside), default=w1)
        a1 = max((e for _, e in inside), default=w1)
        parts.append((_idle_us(run.trace, w0, a0), _idle_us(run.trace, a0, a1),
                      _idle_us(run.trace, a1, w1)))
    return parts


def idle_ms_per_call(run, part: int) -> Optional[float]:
    """Mean device idle of one part (0 pre, 1 dispatch, 2 post) a call, in ms."""
    parts = idle_parts(run)
    if not parts:
        return None
    return sum(p[part] for p in parts) / len(parts) / 1e3


def syncs_per_call(run) -> Optional[float]:
    """``sesa.sync.*`` spans inside the calls, a call."""
    program = program_spans(run)
    if not any(n == DISPATCH for n, _, _ in program):
        return None
    calls = run.trace.spans
    syncs = sum(1 for n, s, e in program if n.startswith(SYNC_PREFIX)
                and any(w0 <= s and e <= w1 for _, w0, w1 in calls))
    return syncs / len(calls)
