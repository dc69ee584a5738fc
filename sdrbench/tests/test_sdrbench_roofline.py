"""The roofline counts against small cases worked by hand, and the
launches an output kind works out from a pass's records at other widths
and on the serial schedule."""

from types import SimpleNamespace

import numpy as np
import pytest

from sdrbench import harness
from sdrbench import roofline as rl

GRID25 = [round(0.6 - 0.05 * i, 4) for i in range(25)]
GRID25[12] = 0.05
SERIAL25 = {"taps": GRID25, "epl": [2, 12, 22], "rounding": "ceil",
            "dll_sign": 1.0, "schedule": "serial"}
GRID29 = [round(0.7 - 0.05 * i, 4) for i in range(29)]


def context(kind, tracker, S, ptr, T, dc, sample_bytes, pass_kw=None):
    """A pass of T rows of nominal S samples from the pointers `ptr`, run
    with the keywords `pass_kw`, and the context a reader is handed."""
    ptr = np.asarray(ptr, np.int64)
    num = np.full((T, len(ptr)), S, np.int64)
    rec = {"num_sample": num,
           "absolute_sample": ptr[None, :] + np.cumsum(num, axis=0)}
    cfg = {"receiver": {"track": {"correlator_spacing": 0.5,
                                  "ms_eph_1ms": 1000}}}
    case = SimpleNamespace(S=S, dc=dc, init={"ptr": ptr}, cfg=cfg,
                           mix={"output": kind, "tracker": tracker,
                                "pass": ["track_for_eph", pass_kw or {}]})
    ctx = SimpleNamespace(case=case, cfg=cfg, sample_bytes=sample_bytes)
    return harness.load_output(kind).launches(ctx, rec)


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


def test_b1_serial_chunk_at_25_taps_with_dc_on_int16():
    # 2 channels of 1000 rows of 26 000 int16 pairs from 100 and 5000:
    # the union is 26e6 + 4900 pairs; 25 taps of records (200 B of sums
    # + 64 B) a row and channel.  2 × 26e6 samples of 12 + 2·25 + 4
    # float32 and 2·25 float64 operations: the float64 adds bound it.
    got = context("track", SERIAL25, 26000, [100, 5000], 1000, True, 2)
    assert set(got) == {"b1"} and len(got["b1"]) == 1
    (t, by), = got["b1"]
    n = 2 * 26e6
    n_bytes = ((26e6 + 4900) * 2 * 2 + 2 * 4092 + 1000 * 2 * (200 + 64)
               + 2 * 80)
    assert rl.ops(n, 25, True) == (n * 66, n * 50)
    assert by == "fp64" and t == pytest.approx(n * 50 / 34e12)
    assert n_bytes / 3.35e12 < t
    # one channel at 3 taps without DC: the bytes bound it
    (t, by), = context("track", dict(SERIAL25, taps=[0.5, 0.05, -0.5],
                                     epl=[0, 1, 2]), 26000, [100], 1000,
                       False, 2)["b1"]
    n_bytes = 26e6 * 2 * 2 + 4092 + 1000 * (24 + 64) + 80
    assert by == "bytes" and t == pytest.approx(n_bytes / 3.35e12)


@pytest.mark.parametrize("pass_kw,chunks", [
    ({}, (1000, 1000, 500)),
    ({"chunk_ms": 300}, (300,) * 8 + (100,))])
def test_serial_launches_follow_run_tracking_chunks(pass_kw, chunks):
    # run_tracking at pdi 1 ms issues one track_chunk per chunk_ms rows
    # (1000 where the pass leaves it out): a 2500-row pass is chunks of
    # 1000, 1000 and 500 rows, or at chunk_ms 300 eight of 300 and one of
    # 100, each from where the chunk before left the pointers
    got = context("track", SERIAL25, 2500, [7, 40], 2500, False, 1,
                  pass_kw)["b1"]
    assert len(got) == len(chunks)
    rec_bytes = 2 * (25 * 8 + 64)
    for (t, by), rows in zip(got, chunks):
        union = rows * 2500 + 33
        n_bytes = union * 2 + 2 * 4092 + rows * rec_bytes + 2 * 80
        f32, f64 = rl.ops(2 * rows * 2500, 25, False)
        assert (t, by) == rl.bound_s(n_bytes, f32, f64)


def test_b2_at_29_taps():
    # two VT steps of 2 channels, 2600 int16 pairs at 0 and 1000 (then
    # 2600 and 3600): the union of each step's windows is 3600 pairs; 6
    # words a channel, 29 tap offsets, 29 taps of sums a channel; at 29
    # taps the float64 adds bound it
    got = context("vt", {"taps": GRID29, "epl": [4, 14, 24]}, 2600,
                  [2600, 3600], 2, True, 2)
    assert set(got) == {"b2"} and len(got["b2"]) == 2
    n_bytes = 3600 * 2 * 2 + 2 * 4092 + 2 * 6 * 8 + 29 * 8 + 2 * 29 * 8
    f32, f64 = 5200 * (12 + 58 + 4), 5200 * 58
    for t, by in got["b2"]:
        assert (t, by) == rl.bound_s(n_bytes, f32, f64)
    assert by == "fp64" and t == pytest.approx(f64 / 34e12)
    assert n_bytes / 3.35e12 < t
