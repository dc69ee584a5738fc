"""The output kind "ct" (`outputs/ct.py`) of the cell `urban.ct_mc25`, on
the CPU at a small size: Urban's front end at 2.5 MHz (int16 at zero IF,
DC 230 − 95j, the amplitude scaled to keep its C/N0, as
test_sdrbench_widths.py's URBAN), five of its SVs, the capture started
0.5 s before a subframe, and `ct_position` at 1 ms on the 25-tap bank over
1100 rows in chunks of 400.

The set-up's decode is made from the synthesizer's own navigation bits at
each channel's transmit time, as `decode` would find them from row 200 of
a 40 s track (tests/test_torch_distributed.py's rule): at this rate the
command's 3-phase eph stage loses channels in its 10 ms phase, and the
serial one would take most of a minute alone.

A sound run reads `correct`; the control and each planted fault read
false; the kind counts B1's launches as `run_tracking` issues them, and
every limit of the cell's mix names a gap the judge emits."""

import dataclasses
import json
import math
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from conftest import ROOT

from sdrbench import harness

SEED = 2 ** 31 + 2121
DECODE_FROM = 200
N_MS, CHUNK_MS = 1100, 400
SMALL = {"config": {"receiver": {"signal": {"fs": 2.5e6}},
                    "sky": {"amp_scale": 2.6884367777004363 * 3.22,
                            "tow0": 388799.5, "prns": [3, 7, 16, 22, 27],
                            "amplitudes": [3.0, 2.6, 2.8, 2.4, 2.7]},
                    "capture_ms": 1300},
         "mix": {"check_blocks": 24, "limits": {"acq_code_chips": 1.5},
                 "setup": [["acquisition", {}],
                           ["decode", {"start_offset_ms": DECODE_FROM}]],
                 "pass": ["ct_position", {"n_ms": N_MS, "multicorr": True,
                                          "chunk_ms": CHUNK_MS}]}}


def decode_artifact(gs, cfg, acq):
    """(eph, sbf) as `decode` finds them: each channel's ideal prompt
    stream, its sign the synthesizer's navigation bit at the transmit ms of
    each record row (row 0 starts at the acquisition's code epoch)."""
    from gps_sdr_tpu_torch import navdecode
    S = cfg.signal.samples_per_ms
    rebase = gs.tow0 - gs.msg_tow0
    streams = {}
    for prn, delay in zip(acq.sv, acq.code_delay):
        tau = (S - int(delay) + 1) / cfg.signal.fs
        t_tx = rebase + tau + float(gs.sv_clock_delta(
            int(prn), torch.tensor([tau], dtype=torch.float64))[0])
        ms = int(round(t_tx * 1000)) + np.arange(40000)
        streams[int(prn)] = 1.0 - 2.0 * gs.bits[int(prn)][ms // 20]
    return navdecode.decode_all(streams, start_offset_ms=DECODE_FROM)


@pytest.fixture(scope="module")
def ct():
    from gps_sdr_tpu_torch.pipeline import Receiver
    from sdrbench import sky
    decode = Receiver.decode

    def seeded(self, start_offset_ms=3000):
        stem = f"eph_{self.cfg.file.name}.pkl"
        if not self._have(stem):
            gs = sky.geometry_signal(run.cfg, "cpu")
            self._save_pickle(stem, decode_artifact(gs, self.cfg,
                                                    self.acquisition()))
        return decode(self, start_offset_ms)

    run = harness.Run("urban.ct_mc25", SEED, device="cpu", overrides=SMALL)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Receiver, "decode", seeded)
        run.setup(time.perf_counter())
    yield run
    run.close()


def judged(run, dtype=np.float64):
    run.window(0.0, False)
    gaps = run.judge(dtype)
    return gaps, all(run.verdict(gaps)["ok"])


def over(run, gaps):
    """The names of the gaps past their limits."""
    lim = run.mix["limits"]
    return {n for g in gaps for n, v in g.items() if v > lim.get(n, math.inf)}


@pytest.fixture(scope="module")
def sound(ct):
    return judged(ct)


def test_sound_run_is_correct(ct, sound):
    gaps, ok = sound
    assert ok, ct.verdict(gaps)["numbers"]
    rec = ct.passes[0]
    assert rec["corr"].shape[1:] == (5, 25, 2) and ct.case.dc
    assert len(rec["nav_usr_pos"]) >= 20
    assert gaps[1]["wls_epochs_checked"] == len(rec["nav_usr_pos"])


def test_every_limit_names_a_gap_the_judge_emits(sound):
    with open(os.path.join(ROOT, "sdrbench", "traffic", "ct_mc25.json")) as f:
        limits = json.load(f)["limits"]
    emitted = set().union(*[set(g) for g in sound[0]])
    assert set(limits) <= emitted, sorted(set(limits) - emitted)


def test_control_fails(ct):
    gaps, ok = judged(ct, np.float32)
    past = over(ct, gaps)
    assert not ok
    assert any(n.startswith("wls_") for n in past), past
    assert any(n.startswith(("loop_", "bank_")) for n in past), past


def test_b1_launches_as_run_tracking_issues_them(ct, monkeypatch):
    from gps_sdr_tpu_torch import tracking
    calls = []
    orig = tracking.track_chunk

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)
    monkeypatch.setattr(tracking, "track_chunk", counted)
    ct.window(0.0, False)
    ctx = SimpleNamespace(case=ct.case, cfg=ct.cfg,
                          sample_bytes=ct.values.itemsize)
    counts = ct.output.launches(ctx, ct.passes[0])
    assert set(counts) == {"b1"}
    assert len(counts["b1"]) == len(calls) == math.ceil(N_MS / CHUNK_MS)


def nav_fault(mp, how):
    """The fixes altered as the stage hands them on."""
    from gps_sdr_tpu_torch import pipeline
    orig = pipeline.run_ct_positioning

    def wrapper(*a, **kw):
        nav = orig(*a, **kw)
        k = len(nav.usr_pos) // 2
        if how == "fix_moved":
            nav.usr_pos[k, 0] += 1.0
        else:
            nav.valid[k, 0] = not nav.valid[k, 0]
        return nav
    mp.setattr(pipeline, "run_ct_positioning", wrapper)


def pseudorange_off(mp):
    """One channel's pseudorange 1 m long in every fix."""
    from gps_sdr_tpu_torch.receiver import ct as rct
    orig = rct.iterated_ls_position

    def wrapper(pr, sv, state, *a, **kw):
        pr = pr.clone()
        pr[0] += 1.0
        return orig(pr, sv, state, *a, **kw)
    mp.setattr(rct, "iterated_ls_position", wrapper)


def tracker_fault(mp, how):
    from gps_sdr_tpu_torch.tracking import TrackParams
    mc = TrackParams.__dict__["pos_multicorr"].__func__
    epl = TrackParams.__dict__["pos_epl"].__func__

    def params(cfg, pdi_ms=1, **kw):
        if how == "epl_bank":
            return epl(cfg, pdi_ms, **kw)
        p = mc(cfg, pdi_ms, **kw)
        return dataclasses.replace(p, i_early=p.i_late, i_late=p.i_early)
    mp.setattr(TrackParams, "pos_multicorr", staticmethod(params))


@pytest.mark.parametrize("fault, caught", [
    ("fix_moved", "wls_pos_m"), ("valid_flipped", "wls_valid_mismatch"),
    ("pseudorange_off", "wls_pos_m"),
    ("early_late_swapped", "loop_code_freq_hz"),
    ("epl_bank", "bank_corr_rel")])
def test_faults_fail(ct, monkeypatch, fault, caught):
    if fault in ("fix_moved", "valid_flipped"):
        nav_fault(monkeypatch, fault)
    elif fault == "pseudorange_off":
        pseudorange_off(monkeypatch)
    else:
        tracker_fault(monkeypatch, fault)
    gaps, ok = judged(ct)
    assert not ok and caught in over(ct, gaps), over(ct, gaps)


SPAN_METRICS = ("ct.track_ms_per_s", "ct.wls_us_per_epoch",
                "ct.outside_ms_per_s")


def traced_metrics(run):
    run.window(0.0, True)
    run.peak = 0                 # read by `close`, which the fixture calls
    return run.line(run.judge(), 0.0)["metrics"]


def test_a_traced_run_reads_the_span_metrics(ct):
    got = traced_metrics(ct)
    for name in SPAN_METRICS:
        assert np.isfinite(got[name]["value"]) and got[name]["value"] >= 0
    assert got["ct.wls_us_per_epoch"]["value"] > 0


def test_a_program_without_the_ct_spans_reads_only_the_chunks(ct,
                                                              monkeypatch):
    """As a program older than the WLS spans: the chunks' metric reads,
    the two that need `ct.epochs` read nothing, and none raises."""
    from gps_sdr_tpu_torch.receiver import ct as rct
    from gps_sdr_tpu_torch.utils import spans
    monkeypatch.setattr(rct, "span", lambda *a, **kw: spans.OFF)
    got = traced_metrics(ct)
    assert "ct.track_ms_per_s" in got
    assert not {"ct.wls_us_per_epoch", "ct.outside_ms_per_s"} & set(got)
