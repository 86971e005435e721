"""On the card, at the cells' own sizes: a short run is correct, and the
control (the reference in fp8 in the program's place) is not. Marked
``chip``; without a card they skip.

    python -m pytest h100_bench/tests/test_h100_chip.py -q
"""

import pytest

from h100_bench import calibrate
from h100_bench import run as bench
from h100_bench.tests.test_h100_faults import _arm

SEED = 2 ** 31 + 4242


@pytest.mark.chip
@pytest.mark.parametrize("cell", ["bsrof_songs", "melrof_songs", "bsrof_clips"])
def test_a_short_run_is_correct(cuda_card, cell):
    res = bench.run_cell(cell, SEED, 5.0, False)
    assert res["correct"], res["check"]


@pytest.mark.chip
@pytest.mark.parametrize("cell", ["bsrof_songs", "bsrof_clips"])
def test_the_control_is_not_correct(cuda_card, monkeypatch, cell):
    _arm(monkeypatch, calibrate.fp8_in_place)
    res = bench.run_cell(cell, SEED, 15.0, False)
    assert not res["correct"], res["check"]
