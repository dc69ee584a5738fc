"""`correct` fails where it must: the control (the reference in float32
put in the program's place) and the faults the cells can have, planted
underneath the timed path, each on a run the reference otherwise passes.
The harness's look for a card is skipped (device "cpu"); the sizes are
tiny, so the limits that scale with the sample rate are set for them
(`acq_code_chips`: at 2.5 MHz one sample is 0.41 chip)."""

import time

import numpy as np
import pytest
import torch

from sdrbench import harness

SEED = 2 ** 31 + 101
TINY = {"config": {"receiver": {"signal": {"fs": 2.5e6, "f_if": 0.6e6},
                                "track": {"ms_eph_10ms": 2000}},
                   "sky": {"amp_scale": 0.09 * 4.8}, "capture_ms": 3500},
        "mix": {"check_blocks": 24, "limits": {"acq_code_chips": 1.5}}}
TINY_VT = {"config": {"receiver": {"signal": {"fs": 2.5e6, "f_if": 0.6e6}},
                      "sky": {"amp_scale": 0.09 * 4.8}},
           "mix": {"check_blocks": 24, "limits": {"acq_code_chips": 1.5},
                   "pass": ["vt_position", {"n_ms": 1200,
                                            "ct_n_ms": 3300}]}}


def make(cell, over):
    run = harness.Run(cell, SEED, device="cpu", overrides=over)
    run.setup(time.perf_counter())
    return run


@pytest.fixture(scope="module")
def scheduled():
    run = make("opensky.eph_ref", TINY)
    yield run
    run.close()


@pytest.fixture(scope="module")
def vector():
    run = make("opensky.vt", TINY_VT)
    yield run
    run.close()


def correct(run):
    run.window(0.0, False)
    return all(run.verdict(run.judge())["ok"])


def control_fails(run):
    run.window(0.0, False)
    gaps = run.judge(np.float32)
    return not all(run.verdict(gaps)["ok"])


# ---------------------------------------------------------------- faults


def state_unchanged(mp, module, name):
    """The tracker returns the state it was given: the next chunk starts
    where this one did."""
    orig = getattr(module, name)

    def wrapper(*a, **kw):
        out = orig(*a, **kw)
        if name == "vt_scan":
            return a[2], out[1]
        return out[0], a[2]
    mp.setattr(module, name, wrapper)


def corr_fault(mp, target, attr, how):
    """The correlator sums altered where they are made: `half` leaves the
    second half of the channels out (their sums 0), `alter` moves one
    tap of every channel."""
    orig = getattr(target, attr)

    def wrapper(*a, **kw):
        out = orig(*a, **kw).clone()
        n = out.shape[0]
        if how == "half":
            out[n // 2:] = 0
        else:
            out[:, 0, 0] += 0.05 * out[:, 1].abs().sum(dim=-1) + 1.0
        return out
    mp.setattr(target, attr, wrapper)


def test_sound_runs_are_correct(scheduled):
    assert correct(scheduled)


def test_control_fails(scheduled):
    assert control_fails(scheduled)


@pytest.mark.parametrize("fault", ["state_unchanged", "half", "alter"])
def test_tracking_faults_fail(scheduled, monkeypatch, fault):
    """Planted in the 1 ms phases' B1 path (`track_chunk` and its plain
    sums on the CPU)."""
    from gps_sdr_tpu_torch import tracking
    from gps_sdr_tpu_torch.ops import track_chunk as tc
    if fault == "state_unchanged":
        state_unchanged(monkeypatch, tracking, "track_chunk")
    else:
        corr_fault(monkeypatch, tc, "correlate_blocks", fault)
    assert not correct(scheduled)


def test_scheduled_answer_altered_fails(scheduled, monkeypatch):
    """The 10 ms phase's records altered as track_scan returns them."""
    from gps_sdr_tpu_torch import tracking
    orig = tracking.track_scan

    def wrapper(*a, **kw):
        rec, st = orig(*a, **kw)
        rec["corr"] = rec["corr"].clone()
        rec["corr"][0, :, 1, 1] += 1000.0
        return rec, st
    monkeypatch.setattr(tracking, "track_scan", wrapper)
    assert not correct(scheduled)


def test_acquisition_off_by_a_chip_fails(monkeypatch):
    from gps_sdr_tpu_torch import pipeline
    orig = pipeline.run_acquisition

    def wrapper(*a, **kw):
        res = orig(*a, **kw)
        res.code_delay = res.code_delay + 6     # 2.5 chips at 2.5 MHz
        return res
    monkeypatch.setattr(pipeline, "run_acquisition", wrapper)
    run = make("opensky.eph_ref", TINY)
    try:
        assert not correct(run)
    finally:
        run.close()


def test_vt_sound_and_control(vector):
    assert correct(vector)
    assert control_fails(vector)


def frozen_covariance(mp, vt):
    """The EKF's covariance carried unchanged from step to step."""
    orig = vt._VTChunk.update

    def update(self, m, rows, r_update):
        new, rec = orig(self, m, rows, r_update)
        return dict(new, state_cov=self.st["state_cov"]), rec
    mp.setattr(vt._VTChunk, "update", update)


def half_rows(mp, vt):
    """The second half of the channels' measurement rows (z_pr and z_prr)
    left out of the EKF's update."""
    orig = vt._VTChunk.measure

    def measure(self, first, window):
        m = orig(self, first, window)
        n = m["z_pr"].shape[0]
        keep = (torch.arange(n, device=m["z_pr"].device) < n // 2
                ).to(m["z_pr"].dtype)
        return dict(m, z_pr=m["z_pr"] * keep, z_prr=m["z_prr"] * keep)
    mp.setattr(vt._VTChunk, "measure", measure)


@pytest.mark.parametrize("fault", ["state_unchanged", "half", "alter",
                                   "frozen_covariance", "half_rows"])
def test_vt_faults_fail(vector, monkeypatch, fault):
    from gps_sdr_tpu_torch.ops import corr_bank
    from gps_sdr_tpu_torch.receiver import vt
    if fault == "state_unchanged":
        state_unchanged(monkeypatch, vt, "vt_scan")
    elif fault == "frozen_covariance":
        frozen_covariance(monkeypatch, vt)
    elif fault == "half_rows":
        half_rows(monkeypatch, vt)
    else:
        corr_fault(monkeypatch, corr_bank.BankPlan, "__call__", fault)
    assert not correct(vector)


@pytest.mark.gpu
def test_a_cell_on_the_card():
    """Each cell once on the card, a short window: correct."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    for cell in ("opensky.eph_ref", "urban.eph_ref", "opensky.vt"):
        res = harness.run_cell(cell, SEED, 1.0, False, time.perf_counter())
        assert res["line"]["correct"], res["line"]["checks"]
