"""The readers of the program's host spans (``spans.py`` and the seven
metrics over it) on hand-made traces: each call's idle time split at its
first and last ``sesa.dispatch``, the parts adding up to the harness's own
idle readings, the sync count, silence without program spans, and the
breakdown naming a gap by the program span it falls in."""

from types import SimpleNamespace

import pytest

from h100_bench import manifest, spans
from h100_bench.tests.test_h100_trace import TABLE, ev
from h100_bench.trace import Trace

KERNEL = "void at::native::elementwise_kernel<4>"
COPY = "Memcpy DtoH (Device -> Pageable)"
NEW = {"pre_idle_ms", "dispatch_idle_ms", "post_idle_ms", "pre_idle_ms.clips",
       "dispatch_idle_ms.clips", "post_idle_ms.clips", "syncs_per_clip"}


def _host(name, start, end):
    return ev(name, start, end, device=False)


def _calls(kind="song"):
    """Two calls. Call 0 (0-100): dispatch 12-60, device busy 11-20, 25-50,
    70-78; idle 11 before, 15 inside, 32 after. Call 1 (150-250): two
    dispatches (a rescue) 160-200 and 205-230, busy 165-195 and 210-225;
    idle 10, 25, 20."""
    return [
        _host(f"bench::{kind}#0", 0, 100), ev(f"bench::{kind}#0", 1, 99),
        _host(f"bench::{kind}#1", 150, 250),
        ev(KERNEL, 11, 20), ev(KERNEL, 25, 50), ev(COPY, 70, 78),
        ev(KERNEL, 165, 195), ev(KERNEL, 210, 225),
    ]


def _program():
    return [
        _host("sesa.separate", 2, 80), _host("sesa.upload", 3, 10),
        _host("sesa.dispatch", 12, 60), _host("sesa.model", 15, 30), _host("sesa.model", 35, 55),
        _host("sesa.sync.rescue", 61, 65), _host("sesa.sync.to_host", 66, 79),
        _host("sesa.extras", 82, 98),
        _host("sesa.sync.stats", 120, 125),  # between calls: not counted
        _host("sesa.separate", 152, 245), _host("sesa.dispatch", 160, 200),
        _host("sesa.dispatch", 205, 230), _host("sesa.sync.to_host", 232, 240),
    ]


def _run(events, items=2):
    return SimpleNamespace(trace=Trace(events, TABLE, {}), items=[{}] * items)


def _readers(cell):
    return {m["name"]: read for m, read in manifest.Cell(cell).metrics(True)}


def test_parts_split_each_call():
    run = _run(_calls() + _program())
    assert spans.idle_parts(run) == [(11, 15, 32), (10, 25, 20)]
    assert spans.syncs_per_call(run) == 1.5


def test_clip_parts_add_up_to_host_ms_per_clip():
    run = _run(_calls("clip") + _program())
    read = _readers("bsrof_clips")
    assert NEW - set(read) == {"pre_idle_ms", "dispatch_idle_ms", "post_idle_ms"}
    parts = [read[f"{p}_idle_ms.clips"](run) for p in ("pre", "dispatch", "post")]
    assert parts == [pytest.approx(10.5e-3), pytest.approx(20e-3), pytest.approx(26e-3)]
    assert sum(parts) == pytest.approx(read["host_ms_per_clip"](run), rel=1e-12)
    assert read["syncs_per_clip"](run) == 1.5


@pytest.mark.parametrize("cell", ["bsrof_songs", "melrof_songs"])
def test_song_parts_add_up_to_the_idle_share(cell):
    run = _run(_calls() + _program())
    read = _readers(cell)
    assert {"pre_idle_ms", "dispatch_idle_ms", "post_idle_ms"} <= set(read)
    assert not {n for n in read if n.endswith(".clips")} | ({"syncs_per_clip"} & set(read))
    parts = sum(read[f"{p}_idle_ms"](run) for p in ("pre", "dispatch", "post"))
    window_ms = run.trace.window_us() / 1e3
    assert parts == pytest.approx(read["idle_pct"](run) / 100 * window_ms / len(run.items),
                                  rel=1e-12)


def test_a_call_without_dispatch_counts_whole_as_pre():
    run = _run(_calls() + _program()[:8])  # call 1 records no program span
    assert spans.idle_parts(run) == [(11, 15, 32), (55, 0, 0)]


@pytest.mark.parametrize("cell", ["bsrof_songs", "bsrof_clips"])
def test_silent_without_program_spans(cell):
    """The parent program records no span: every new reader returns None,
    also where only spans other than ``sesa.dispatch`` are there."""
    read = _readers(cell)
    for events in (_calls(), _calls() + [_host("sesa.separate", 2, 80)]):
        run = _run(events)
        assert all(read[n](run) is None for n in NEW & set(read))


def test_breakdown_names_the_program_span_of_a_gap():
    t = Trace(_calls() + _program(), TABLE, {})
    gaps = dict(t.breakdown()["idle_gaps"])
    assert gaps["bench::song#0 / sesa.extras"] == pytest.approx(22e-6)  # 78-100
    assert "bench::song#0 / sesa.dispatch" in gaps  # 50-60, between the model calls
    assert not any(label.endswith("/ python") for label in gaps)
