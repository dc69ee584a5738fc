"""The port's legacy position filter (`solu.mode == 1`: positioning/relpr,
receiver/ct_legacy, geo's alternates) against the JAX package, on the CPU —
the cases of tests/test_legacy_components.py.

The filter is host float64 arithmetic, so fed the same records, ephemerides
and sbf both packages should give the same epochs to round-off (~1e-6 m).
The records come from a small capture of this file's own (never .cache/):
the scenario constellation at 2.5 MHz for 2.3 s, written by the JAX
`write_file_fast` into pytest's temporary directory and tracked by the JAX
package with the CT-POS E/P/L loop.  No subframe is decoded in 2.3 s, so
the ephemerides are the broadcast set the capture was made from, and each
channel's first-subframe anchor is put at row 100 with its transmit time
from the generator's own light-time solve there: what a decode would give.
The filter's convergence on a real decode is held on the slice capture
(tests/test_torch_slice.py).
"""

import numpy as np
import pytest
import torch

from gps_sdr_tpu_torch import convert
from gps_sdr_tpu_torch.navdecode import decode_channel
from gps_sdr_tpu_torch.positioning import relpr
from gps_sdr_tpu_torch.receiver import ct_legacy

torch.set_num_threads(2)

FS, F_IF = 2.5e6, 0.6e6
DURATION_MS, TRACK_MS = 2300, 2000
NAV1, SFB1 = 1, 5          # anchor row nav1 + sfb1·20 − 1 = 100


def build_scene(root):
    """Capture, JAX CT-POS records and a decode-equivalent (eph, sbf) for
    both packages; shared with tests/test_torch_matref.py's replay case."""
    import scenario as sc
    from gps_sdr_tpu.acquisition import run_acquisition
    from gps_sdr_tpu.config import SignalConfig
    from gps_sdr_tpu.geo.coords import llh2xyz
    from gps_sdr_tpu.io.ifdata import IFSampleSource
    from gps_sdr_tpu.io.synthetic import GeometrySignal, GeometrySV
    from gps_sdr_tpu.navdecode import EphemerisRecord
    from gps_sdr_tpu.tracking import (TrackParams, init_track_state,
                                      run_tracking)

    cfg = sc.CFG.replace(signal=SignalConfig(f_if=F_IF, fs=FS))
    prns = list(sc.SCN_PRNS)
    usr = np.asarray(llh2xyz(np.asarray(sc.TRUTH_LLH)))
    ephs = sc.visible_constellation(len(prns))
    gs = GeometrySignal(
        cfg, [GeometrySV(prn=p, eph=e, amplitude=a)
              for p, e, a in zip(prns, ephs, sc.AMPLITUDES)],
        usr, sc.TOW0, clk_bias_s=sc.CLK_BIAS_S,
        clk_drift_sps=sc.CLK_DRIFT_SPS, atmosphere=True,
        iono_alpha=cfg.cmn.iono_alpha, iono_beta=cfg.cmn.iono_beta,
        doy=cfg.cmn.day_of_year)
    path = str(root / "capture.bin")
    gs.write_file_fast(path, DURATION_MS, noise_std=sc.NOISE_STD, seed=11)
    src = IFSampleSource(path, cfg.file)
    acq = run_acquisition(src, cfg, prns=prns)
    assert list(acq.sv) == prns
    rec, _ = run_tracking(
        src, cfg, prns, init_track_state(cfg, acq.code_delay,
                                         acq.fine_freq_hz),
        TrackParams.pos_epl(cfg), TRACK_MS)
    # tow of the anchor row: the SV-clock time at its block end, less the
    # code phase left there, snapped to the ms the records count from
    row = NAV1 + SFB1 * 20 - 1
    eph, sbf = {}, {"nav1": {}, "sfb1": {}}
    for ch, (p, e) in enumerate(zip(prns, ephs)):
        tau = rec.absolute_sample[row, ch] / FS
        t_sv = sc.TOW0 + tau + gs.sv_clock_delta(p, np.array([tau]))[0]
        rem_s = rec.rem_chip[row, ch] / cfg.signal.code_freq_basis
        tow1 = float(np.round((t_sv - rem_s) * 1e3) / 1e3)
        fields = {k: [v] for k, v in e.items()
                  if k in EphemerisRecord.__dataclass_fields__}
        eph[p] = EphemerisRecord(
            **fields, tow=[tow1], tow1=[tow1], sfb=[SFB1], sfb1=[SFB1],
            iode2=[e["iode"]], iode3=[e["iode"]], weeknum=[sc.WEEK],
            updateflag=1)
        sbf["nav1"][p], sbf["sfb1"][p] = NAV1, SFB1
    t_eph, t_sbf = convert.ephemeris_from_jax(eph, sbf)
    return dict(cfg=cfg, tcfg=convert.config_from_jax(cfg), prns=prns,
                usr=usr, rec=rec, trec=convert.records_from_jax(rec),
                eph=eph, sbf=sbf, t_eph=t_eph, t_sbf=t_sbf)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return build_scene(tmp_path_factory.mktemp("torch_legacy"))


def _fields(nav):
    return {k: np.asarray(v) for k, v in vars(nav).items()}


def test_relative_pseudorange_samples():
    """pr_est.m:29-46: subframe starts 1 ms of samples apart → one light-ms
    of pseudorange apart; the same numbers as the JAX package's."""
    from gps_sdr_tpu.positioning.relpr import relative_pseudorange_samples
    fs = 5e6
    args = dict(sfb1=[10, 10], nav1=[40, 40],
                code_delay=[1.0, 1.0 + fs * 1e-3], fs=fs)
    pr, rel = relpr.relative_pseudorange_samples(**args)
    assert rel[0] == 0.0 and abs(rel[1] - 1e-3) < 1e-12
    assert abs(pr[0] - 299792458.0 * 75e-3) < 1e-6
    assert abs((pr[1] - pr[0]) - 299792458.0 * 1e-3) < 1e-6
    jpr, jrel = relative_pseudorange_samples(**args)
    np.testing.assert_allclose(pr, jpr, rtol=1e-9, atol=0)
    np.testing.assert_allclose(rel, jrel, rtol=1e-9, atol=0)


def test_relative_pseudorange_transmit_time_matches_sample_form():
    from gps_sdr_tpu.positioning.relpr import (
        relative_pseudorange_from_transmit_time)
    tt = np.array([388800.070, 388800.0655, 388800.0721])
    pr_t, rel_t = relpr.relative_pseudorange_from_transmit_time(tt)
    dat = (tt.max() - tt) * 58e6
    pr_s, rel_s = relpr.relative_pseudorange_samples(
        sfb1=np.zeros(3), nav1=np.zeros(3), code_delay=dat + 1.0, fs=58e6)
    np.testing.assert_allclose(pr_t, pr_s, rtol=0, atol=1e-6)
    np.testing.assert_allclose(rel_t, rel_s, rtol=0, atol=1e-12)
    jpr, jrel = relative_pseudorange_from_transmit_time(tt)
    np.testing.assert_allclose(pr_t, jpr, rtol=1e-9, atol=0)
    np.testing.assert_allclose(rel_t, jrel, rtol=1e-9, atol=0)


def test_igs_tec_slant_delay():
    """igs_iono.m's model: the corner value at the corner and epoch, the
    mean of all 8 at the cell centre half-way, slant above vertical and
    falling with elevation; every value within 1e-9 relative of the JAX
    package's."""
    from gps_sdr_tpu.geo.atmosphere import igs_tec_slant_delay as jigs
    from gps_sdr_tpu_torch.geo.atmosphere import igs_tec_slant_delay
    grid_e = [129.0, 112.0, 110.0, 123.0]   # igs_iono.m:10-13
    grid_l = [114.0, 108.0, 107.0, 108.0]
    t0, t1 = 396015.0, 396015.0 + 7200.0
    k = 40.3 / 1575.42e6 ** 2 * 1e16
    cases = [((t0, 22.5, 120.0, np.pi / 2), k * 129.0),
             (((t0 + t1) / 2, 23.75, 122.5, np.pi / 2),
              k * np.mean(grid_e + grid_l)),
             ((t0, 22.5, 120.0, np.deg2rad(45.0)), None),
             ((t0, 22.5, 120.0, np.deg2rad(20.0)), None)]
    got = []
    for args, expect in cases:
        d = float(igs_tec_slant_delay(*args, grid_e, grid_l, t0, t1))
        assert abs(d - float(jigs(*args, grid_e, grid_l, t0, t1))) \
            <= 1e-9 * abs(d)
        if expect is not None:
            assert abs(d - expect) < 1e-9
        got.append(d)
    assert got[3] > got[2] > got[0]


def test_hopfield_and_enu2xyz_match_jax():
    """The other two leftovers of geo/: Hopfield's troposphere and ENU →
    ECEF, within 1e-9 relative of the JAX package's; enu2xyz inverts
    xyz2enu."""
    from gps_sdr_tpu.geo.atmosphere import tropo_hopfield_delay as jhop
    from gps_sdr_tpu.geo.coords import enu2xyz as jenu2xyz
    from gps_sdr_tpu_torch.geo.atmosphere import tropo_hopfield_delay
    from gps_sdr_tpu_torch.geo.coords import enu2xyz, xyz2enu
    el = np.array([5.0, 15.0, 45.0, 89.0])
    for h in (0.0, 1500.0):
        np.testing.assert_allclose(tropo_hopfield_delay(el, h).numpy(),
                                   np.asarray(jhop(el, h)), rtol=1e-9,
                                   atol=0)
    rng = np.random.default_rng(5)
    org = np.array([-2.4e6, 5.38e6, 2.41e6])
    enu = rng.normal(scale=3e3, size=(6, 3))
    xyz = enu2xyz(enu, org).numpy()
    np.testing.assert_allclose(xyz, np.asarray(jenu2xyz(enu, org)),
                               rtol=1e-9, atol=0)
    np.testing.assert_allclose(xyz2enu(xyz, org).numpy(), enu, rtol=0,
                               atol=1e-6)


def test_navdecode_legacy_flags():
    """naviDecode.m = the _updated variant minus startOffset and outlier
    repair: on a clean stream both decode the same ephemeris."""
    import scenario as sc
    from gps_sdr_tpu_torch.io import lnav
    bits = lnav.encode_frames(sc.BASE_EPH, sc.WEEK, sc.TOW0 + 1.0, 7)
    p_i = np.repeat(1.0 - 2.0 * np.asarray(bits, np.float64), 20) * 1000.0
    legacy = decode_channel(p_i, start_offset_ms=0, repair_outliers=False)
    modern = decode_channel(p_i, start_offset_ms=0, repair_outliers=True)
    assert legacy.eph.updateflag == modern.eph.updateflag == 1
    assert legacy.eph.sqrta[0] == modern.eph.sqrta[0]


@pytest.mark.parametrize("epoch_ms,rows", [(None, TRACK_MS), (1, 1000)])
def test_kf_matches_jax(scene, epoch_ms, rows):
    """Fed the same records (the first `rows`), ephemerides and sbf, the
    port's filter gives every NavSolutionsKF field of the JAX one within
    1e-6 (m, m/s, s; the llh angles in degrees within 1e-9), at the 20 ms
    default and at the reference's 1 ms cadence."""
    from gps_sdr_tpu.receiver.ct_legacy import run_ct_positioning_kf as jkf
    from gps_sdr_tpu.tracking import TrackRecords as JRecords
    rec = scene["rec"]
    cut = JRecords(**{f: getattr(rec, f)[:rows] for f in (
        "corr", "code_err", "carr_err", "code_freq", "carr_freq",
        "num_sample", "rem_chip", "rem_phase", "absolute_sample")})
    init = scene["usr"] + np.array([3000.0, -2000.0, 1500.0])
    ref = _fields(jkf(cut, scene["cfg"], scene["prns"], scene["eph"],
                      scene["sbf"], init, epoch_ms=epoch_ms))
    got = _fields(ct_legacy.run_ct_positioning_kf(
        convert.records_from_jax(cut), scene["tcfg"], scene["prns"],
        scene["t_eph"], scene["t_sbf"], init, epoch_ms=epoch_ms))
    assert got.keys() == ref.keys()
    step = 20 if epoch_ms is None else 1
    assert len(got["clk_bias_m"]) > (rows - 110) // step
    for k in got:
        assert got[k].shape == ref[k].shape, k
        if k == "usr_pos_llh":
            np.testing.assert_allclose(got[k][:, :2], ref[k][:, :2],
                                       rtol=0, atol=1e-9)
            np.testing.assert_allclose(got[k][:, 2], ref[k][:, 2], rtol=0,
                                       atol=1e-6)
        else:
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-6,
                                       err_msg=k)
    # the common 75 ms-base offset went into the clock state, and the
    # filter pulled the 4 km start in
    assert 1e5 < abs(got["clk_bias_m"][-1]) < 3e6
    err = np.linalg.norm(got["usr_pos"] - scene["usr"], axis=1)
    assert err[-1] < 0.1 * np.linalg.norm(init - scene["usr"]), err[-1]
