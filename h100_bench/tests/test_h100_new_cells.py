"""Whole runs of the cells ``melrof_clips`` and ``mamba2_songs`` on the CPU at
tiny sizes: a sound run is correct and reports every compared number, K8's
metrics among the cell's traced readers, and Kim's clips cell reports what
the flagship's does; the timed path broken underneath (the Mamba scan's state
dropped at every 64-step chunk among the faults), or the control in its
place, is not correct."""

import math

import pytest

from h100_bench import calibrate, manifest
from h100_bench import run as bench
from h100_bench.tests.h100_tiny import SESSION, overrides
from h100_bench.tests.test_h100_faults import _altered, _arm, _break_model, _half_batch, _raises

SEED = 2 ** 31 + 2727
# TS-BS-Mamba2 at feature_dim 16 (one head of 64, state 128, the published
# 57 bands), one BSNet a stack, one-second chunks
MAMBA = {"model.feature_dim": 16, "model.num_repeat_mask": 1, "model.num_repeat_map": 1,
         "audio.chunk_size": 44100, "traffic.length_s": [3, 5], "traffic.check_items": 2,
         "traffic.motifs": 4, "traffic.session": dict(SESSION)}
NUMBERS = {"mamba2_songs": {"vocals_rel_err", "drums_rel_err", "bass_rel_err",
                            "other_rel_err", "instrumental_rel_err"},
           "melrof_clips": {"vocals_rel_err", "instrumental_rel_err"}}


def _run(cell):
    ov = MAMBA if cell == "mamba2_songs" else overrides(lengths=(3, 6))
    return bench.run_cell(cell, SEED, 1.0, False, device="cpu", overrides=ov)


@pytest.mark.parametrize("cell", sorted(NUMBERS))
def test_a_sound_run_is_correct_and_reports_every_number(cell):
    res = _run(cell)
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["check"]) == NUMBERS[cell] == set(manifest.Cell(cell).limits)
    assert all(v["value"] is not None and v["value"] < v["limit"] for v in res["check"].values())


def test_the_mamba_cells_traced_metrics():
    read = {m["name"] for m, _ in manifest.Cell("mamba2_songs").metrics(True)}
    assert {"k8_roofline_pct", "mamba_glue_ms_per_chunk", "band_loop_host_ms", "mfu_pct",
            "idle_pct", "pre_idle_ms", "dispatch_idle_ms", "post_idle_ms", "copy_ms_per_song",
            "launches_per_chunk"} == read
    assert {m["name"] for m, _ in manifest.Cell("mamba2_songs").metrics(False)} == {
        "rtf", "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("traced", [False, True])
def test_kims_clips_cell_reports_what_the_flagships_does(traced):
    def names(cell):
        return {m["name"] for m, _ in manifest.Cell(cell).metrics(traced)}

    assert names("melrof_clips") == names("bsrof_clips")


def _no_carry(monkeypatch):
    """The program's scan run on each 64-step chunk from a zero state: the
    state carried across the chunks (K8's ``ssd_carried`` on the card) lost."""
    from sesa_tpu_torch.models import bs_mamba2

    scan = bs_mamba2.ssd

    def each_chunk_from_zero(x, a, b, c, chunk_size=64):
        n = x.shape[0] * (x.shape[1] // chunk_size)

        def fold(t):
            return t.reshape(n, chunk_size, *t.shape[2:])

        return scan(fold(x), fold(a), fold(b), fold(c), chunk_size=chunk_size).reshape(x.shape)

    monkeypatch.setattr(bs_mamba2, "ssd", each_chunk_from_zero)


def test_a_scan_without_its_carried_state_is_not_correct(monkeypatch):
    _no_carry(monkeypatch)
    res = _run("mamba2_songs")
    assert not res["correct"], res["check"]
    assert res["failed"] == 0
    assert max(v["value"] / v["limit"] for v in res["check"].values()) > 1.0


@pytest.mark.parametrize("cell", sorted(NUMBERS))
@pytest.mark.parametrize("fault", [_half_batch, _altered, _raises])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    _break_model(monkeypatch, fault)
    res = _run(cell)
    assert not res["correct"]
    if fault is _raises:
        assert res["failed"] > 0
    else:
        worst = max(v["value"] / v["limit"] for v in res["check"].values())
        assert worst > 1.0 or math.isinf(worst)


@pytest.mark.parametrize("cell", sorted(NUMBERS))
def test_the_control_is_not_correct(monkeypatch, cell):
    _arm(monkeypatch, calibrate.fp8_in_place)
    res = _run(cell)
    assert not res["correct"], res["check"]
