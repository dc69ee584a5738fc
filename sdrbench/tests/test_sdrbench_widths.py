"""The check at the widths and on the schedule that no cell runs yet: the
serial schedule at 25 taps and vector tracking at 29, each named by the
mix's `tracker`, on the CPU at a tiny size.  A sound run reads `correct`;
the control and faults planted in the tracker's parameters read false.

The Receiver's serial stage at 25 taps is `ct_position` on the Urban
preset (the CT-POS multicorrelator tracker at 1 ms), which decodes 30 s
of bits first and returns fixes besides; their output kind comes with
that stage's cell.  Here `track_for_eph`'s serial pass is handed the same
tracker (`TrackParams.pos_multicorr`: the +0.05-chip prompt, E/P/L
columns 2/12/22, ceil block lengths, DLL sign +1) in place of the E/P/L
one, so B1 runs 25 taps with DC removal on Urban's int16 samples through
the same `run_tracking`."""

import dataclasses
import time
from types import SimpleNamespace

import numpy as np
import pytest

from sdrbench import harness

SEED = 2 ** 31 + 303
GRID25 = [round(0.6 - 0.05 * i, 4) for i in range(25)]
GRID25[12] = 0.05
MC25 = {"taps": GRID25, "epl": [2, 12, 22], "rounding": "ceil",
        "dll_sign": 1.0, "schedule": "serial"}
GRID29 = [round(0.7 - 0.05 * i, 4) for i in range(29)]
# Urban's front end at 2.5 MHz: the amplitude scaled by √(26 / 2.5) to
# keep its C/N0
URBAN = {"config": {"receiver": {"signal": {"fs": 2.5e6}},
                    "sky": {"amp_scale": 2.6884367777004363 * 3.22},
                    "capture_ms": 3500},
         "mix": {"check_blocks": 24, "limits": {"acq_code_chips": 1.5},
                 "pass": ["track_for_eph", {"n_ms": 2500}],
                 "tracker": MC25}}
VT29 = {"config": {"receiver": {"signal": {"fs": 2.5e6, "f_if": 0.6e6}},
                   "sky": {"amp_scale": 0.09 * 4.8}},
        "mix": {"check_blocks": 24, "limits": {"acq_code_chips": 1.5},
                "pass": ["vt_position", {"n_ms": 1200, "ct_n_ms": 3300,
                                         "multicorr": True}],
                "tracker": {"taps": GRID29, "epl": [4, 14, 24]}}}


def tracking_module():
    from gps_sdr_tpu_torch import tracking
    return tracking


def use_tracker(mp, fault=None):
    """`track_for_eph`'s tracker replaced by the CT-POS multicorrelator
    one, with `fault` applied to its parameters."""
    tp = tracking_module().TrackParams
    mc = tp.__dict__["pos_multicorr"].__func__

    def params(cfg, pdi_ms=1, **kw):
        p = mc(cfg, pdi_ms, **kw)
        return fault(p) if fault else p
    mp.setattr(tp, "epl", staticmethod(params))


@pytest.fixture(scope="module")
def serial25():
    with pytest.MonkeyPatch.context() as mp:
        use_tracker(mp)
        run = harness.Run("urban.eph_ref", SEED, device="cpu",
                          overrides=URBAN)
        run.setup(time.perf_counter())
        yield run
        run.close()


@pytest.fixture(scope="module")
def vt29():
    run = harness.Run("opensky.vt", SEED, device="cpu", overrides=VT29)
    run.setup(time.perf_counter())
    yield run
    run.close()


def correct(run):
    run.window(0.0, False)
    return all(run.verdict(run.judge())["ok"])


def control_fails(run):
    run.window(0.0, False)
    return not all(run.verdict(run.judge(np.float32))["ok"])


def test_serial_25_taps_sound_run_is_correct(serial25, monkeypatch):
    """Correct, with as many B1 launches worked out from the records as
    `run_tracking` issued."""
    tracking = tracking_module()
    calls = []
    orig = tracking.track_chunk

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)
    monkeypatch.setattr(tracking, "track_chunk", counted)
    assert correct(serial25)
    rec = serial25.passes[0]
    assert rec["corr"].shape[2] == 25 and serial25.case.dc
    ctx = SimpleNamespace(case=serial25.case, cfg=serial25.cfg,
                          sample_bytes=serial25.values.itemsize)
    counts = serial25.output.launches(ctx, rec)
    assert set(counts) == {"b1"}
    assert len(counts["b1"]) == len(calls) == 3


def test_serial_25_taps_control_fails(serial25):
    assert control_fails(serial25)


def moved_tap(p):
    taps = list(p.taps)
    taps[0] += 0.05
    return dataclasses.replace(p, taps=tuple(taps))


@pytest.mark.parametrize("fault", [
    moved_tap,
    lambda p: dataclasses.replace(p, rounding="round"),
    lambda p: dataclasses.replace(p, i_early=p.i_late, i_late=p.i_early)],
    ids=["tap_moved", "round_not_ceil", "early_late_swapped"])
def test_serial_25_taps_faults_fail(serial25, monkeypatch, fault):
    use_tracker(monkeypatch, fault)
    assert not correct(serial25)


def test_vt_29_taps_sound_and_control(vt29):
    assert correct(vt29)
    assert vt29.passes[0]["corr"].shape[2] == 29
    assert control_fails(vt29)


def test_vt_29_taps_early_late_swapped_fails(vt29, monkeypatch):
    from gps_sdr_tpu_torch.receiver import vt
    mc = vt.VTParams.__dict__["multicorr"].__func__

    def swapped(**kw):
        p = mc(**kw)
        return dataclasses.replace(p, i_early=p.i_late, i_late=p.i_early)
    monkeypatch.setattr(vt.VTParams, "multicorr", staticmethod(swapped))
    assert not correct(vt29)


def test_a_tracker_key_of_another_kind_is_refused():
    run = harness.Run("opensky.vt", SEED, device="cpu",
                      overrides={"mix": {"tracker": {"rounding": "ceil"}}})
    case = SimpleNamespace(mix=run.mix, cfg=run.cfg)
    with pytest.raises(ValueError, match="rounding"):
        run.output.tracker(case)
