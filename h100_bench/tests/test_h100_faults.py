"""Whole runs of the harness on the CPU at tiny sizes (the look for a card
skipped), sound and with the timed path broken underneath: ``correct`` must
come out true for the sound run and false for each fault the cells can
have, and for the control (the reference in fp8 put in the program's
place)."""

import math

import pytest
import torch

from h100_bench import calibrate
from h100_bench import run as bench
from h100_bench.tests.h100_tiny import overrides

CELLS = ["bsrof_songs", "melrof_songs", "bsrof_clips"]
SEED = 2 ** 31 + 99


def _arm(monkeypatch, before_window):
    """Call ``before_window(run, session)`` as the window opens."""
    measure = bench.measure

    def armed(run, session, seconds, trace):
        before_window(run, session)
        return measure(run, session, seconds, trace)

    monkeypatch.setattr(bench, "measure", armed)


def _break_model(monkeypatch, fault):
    def before(run, session):
        apply = session._model_apply(session.compute_dtype)

        def broken(params, chunks):
            return fault(apply, params, chunks)

        session._model_apply = lambda dtype: broken

    _arm(monkeypatch, before)


def _half_batch(apply, params, chunks):
    """Half of the batch left out, the mean of the rest in its place."""
    keep = -(-chunks.shape[0] // 2)
    out = apply(params, chunks[:keep])
    rest = out.mean(0, keepdim=True).expand((chunks.shape[0] - keep,) + out.shape[1:])
    return torch.cat([out, rest])


def _altered(apply, params, chunks):
    """Every stem altered by 10% where the model produces it."""
    return apply(params, chunks) * 1.1


def _raises(apply, params, chunks):
    raise RuntimeError("a call of the timed path that fails")


def _lengths(cell):
    return (3, 6) if "clips" in cell else (3, 9)


def _run(cell):
    return bench.run_cell(cell, SEED, 1.0, False, device="cpu",
                          overrides=overrides(lengths=_lengths(cell)))


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "check"


@pytest.mark.parametrize("cell", CELLS)
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


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(monkeypatch, cell):
    _arm(monkeypatch, calibrate.fp8_in_place)
    res = _run(cell)
    assert not res["correct"], res["check"]
