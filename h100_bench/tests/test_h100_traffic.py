"""The traffic generator: deterministic per seed, 16-bit exact, lengths in
their strata, seeds that differ in order and not in work."""

import json
import os

import numpy as np
import pytest

from h100_bench import traffic

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = [0, 7, 2 ** 31 + 11, 2 ** 40 + 3]


def _mix(name, seed):
    with open(os.path.join(HERE, "traffic", name + ".json")) as f:
        return traffic.Mix(json.load(f), seed)


@pytest.mark.parametrize("name", ["songs", "clips"])
@pytest.mark.parametrize("seed", SEEDS)
def test_items_repeat_for_a_seed_and_are_16_bit(name, seed):
    a, b = _mix(name, seed), _mix(name, seed)
    for i in (0, 5):
        x, y = a.audio(i), b.audio(i)
        assert x.dtype == np.float32 and x.shape == (2, a.length(i))
        assert np.array_equal(x, y)
        assert np.array_equal(np.round(x * 32768.0) / 32768.0, x)
        assert np.abs(x).max() <= 32767 / 32768 and np.abs(x).max() > 0.1
        assert a.spans(i, 176400) == b.spans(i, 176400)
    assert a.checked(9) == b.checked(9)


@pytest.mark.parametrize("name", ["songs", "clips"])
def test_lengths_cover_every_stratum_in_each_block(name):
    for seed in SEEDS:
        mix = _mix(name, seed)
        lo, hi = mix.spec["length_s"]
        k = mix.spec["strata"]
        for block in range(3):
            secs = sorted(mix.length(block * k + j) / mix.sr for j in range(k))
            for j, s in enumerate(secs):
                assert lo + (hi - lo) * j / k <= s <= lo + (hi - lo) * (j + 1) / k


def test_seeds_change_the_order_not_the_work():
    per_seed = []
    for seed in SEEDS:
        mix = _mix("songs", seed)
        per_seed.append(sum(mix.length(i) for i in range(12)) / mix.sr)
    # 12 items = 3 blocks of one length per stratum: totals within a stratum's width
    assert max(per_seed) - min(per_seed) < 3 * 45
    assert len({_mix("songs", s).length(0) for s in SEEDS}) > 1


def test_spans_and_checked_items():
    mix = _mix("songs", 3)
    step = 176400
    spans = mix.spans(2, step)
    n = mix.length(2)
    assert spans[0] == (0, step) and spans[-1] == (n - step, n) and len(spans) == 3
    clips = _mix("clips", 3)
    assert clips.spans(1, step) == [(0, clips.length(1))]
    done = 10
    picked = clips.checked(done)
    assert len(picked) == 4 and max(range(done), key=clips.length) in picked
