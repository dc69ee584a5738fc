"""The roofline counts against small cases worked by hand."""

import pytest

from sdrbench import roofline as rl


def test_union_of_windows():
    assert rl.union_samples([0, 5, 20], [10, 12, 25]) == 17
    assert rl.union_samples([3], [3]) == 0
    assert rl.union_samples([0, 0], [4, 4]) == 4


def test_bound_takes_the_slowest_unit():
    t, by = rl.bound_s(3.35e12, 0, 0)
    assert (t, by) == (1.0, "bytes")
    t, by = rl.bound_s(0, 67e12, 34e12 * 1.5)
    assert by == "fp64" and t == pytest.approx(1.5)


def test_operations_per_sample():
    # 3 taps, no DC: 12 + 2·3 float32 and 2·3 float64 per sample
    assert rl.ops(10, 3, False) == (180, 60)
    # 25 taps with DC removal: 12 + 50 + 4 and 50
    assert rl.ops(1, 25, True) == (66, 50)


def test_chunk_bound_by_hand():
    # 2 channels over [0, 1000) and [500, 1500): 1500 int8 pairs, two code
    # tables, 10 blocks of records (3 taps: 24 B of sums + 64 B), state
    n_bytes = 1500 * 2 + 2 * 4092 + 10 * 2 * 88 + 2 * 80
    t, by = rl.chunk_bound([0, 500], [1000, 1500], 2000, 10, 2, 3, False, 1)
    assert by == "bytes"
    assert t == pytest.approx(n_bytes / 3.35e12)
    # with enough samples the float32 work bounds it
    t, by = rl.chunk_bound([0], [10], 1e9, 1, 1, 3, False, 1)
    assert by == "fp32" and t == pytest.approx(18e9 / 67e12)


def test_bank_bound_by_hand():
    # windows: 2 × 100 int16 pairs read as they are; 5 words a channel
    n_bytes = 200 * 2 * 2 + 2 * 4092 + 2 * 5 * 8 + 3 * 8 + 2 * 3 * 8
    t, by = rl.bank_bound([0, 50], [100, 100], 3, True, 2, windows=True)
    assert t == pytest.approx(n_bytes / 3.35e12) and by == "bytes"
    # fetching: the union, 150 pairs; 6 words a channel
    n_bytes = 150 * 2 * 2 + 2 * 4092 + 2 * 6 * 8 + 3 * 8 + 2 * 3 * 8
    t, _ = rl.bank_bound([0, 50], [100, 100], 3, True, 2, windows=False)
    assert t == pytest.approx(n_bytes / 3.35e12)
