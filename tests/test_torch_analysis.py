"""The port's analysis modules (analysis/acf, multipath, plots) and report
formatting (utils/metrics) against the JAX package, on the CPU: the cases
of tests/test_analysis.py and the ACF case of tests/test_multicorr_e2e.py.

The numpy functions take the same inputs, made from a seed, in both
packages and must give the same numbers exactly; the text outputs must be
the same text.  The plots are held to what tests/test_report.py holds the
JAX package's to: the files exist and are not small.  Receiver.report is
held on the slice capture (tests/test_torch_slice.py).
"""

import os

import numpy as np
import pytest
import torch

from gps_sdr_tpu_torch.analysis import acf, multipath, plots
from gps_sdr_tpu_torch.utils import metrics

torch.set_num_threads(2)


def _fields(obj):
    return {k: np.asarray(v) for k, v in vars(obj).items()}


def test_multipath_acf_equals_jax():
    """MultipathSimulator.m's ACF sweep: the LOS triangle peaks at tap 0,
    an in-phase echo raises the peak, a 2-chip echo no longer overlaps;
    every array equal to the JAX package's."""
    from gps_sdr_tpu.analysis.multipath import multipath_acf as jacf
    kw = dict(prn=3, fs=20.46e6,
              delays_chips=np.array([0.0, 0.25, 0.5, 1.0, 2.0]), alpha=0.5,
              n_ms=1)
    res = multipath.multipath_acf(**kw)
    ref = jacf(**kw)
    for k, v in _fields(res).items():
        np.testing.assert_array_equal(v, _fields(ref)[k], err_msg=k)
    k0 = np.argmin(np.abs(res.taps_chips))
    assert np.argmax(res.acf_los) == k0
    assert res.acf[1].max() > res.acf_los.max()
    np.testing.assert_allclose(res.acf[4][k0 - 8:k0 + 9],
                               res.acf_los[k0 - 8:k0 + 9], rtol=0.12)


def test_multipath_pseudorange_bias_equals_jax():
    from gps_sdr_tpu.analysis.multipath import (multipath_acf as jacf,
                                                pseudorange_bias_chips as jb)
    kw = dict(prn=3, fs=20.46e6, delays_chips=np.linspace(0.05, 1.2, 12),
              alpha=0.5)
    bias = multipath.pseudorange_bias_chips(multipath.multipath_acf(**kw),
                                            spacing=0.5)
    np.testing.assert_array_equal(bias, jb(jacf(**kw), spacing=0.5))
    assert np.max(np.abs(bias)) > 0.05
    assert abs(bias[-1]) < np.max(np.abs(bias))


def test_acf_features_equal_jax():
    """CalculateFeatures.m's five features per 100 ms window: shapes, the
    clean channel's lower delay and discriminator variance, and every
    number equal to the JAX package's."""
    from gps_sdr_tpu.analysis.acf import acf_envelope as jenv
    from gps_sdr_tpu.analysis.acf import acf_features as jfeat
    rng = np.random.default_rng(0)
    T, N, K = 400, 2, 25
    taps = np.linspace(0.6, -0.6, K)
    corr = rng.normal(0, 1, (T, N, K, 2))
    corr[:, 0, :, 0] += np.maximum(0, 1 - np.abs(taps)) * 50
    corr[:, 1, :, 0] += 25.0
    code_err = rng.normal(0, 0.05, (T, N))
    code_err[:, 1] *= 4
    f = acf.acf_features(corr, code_err, taps, window_ms=100)
    assert f.f1_amp.shape == (4, 2) and f.matrix().shape == (8, 5)
    assert f.f3_delay_var[:, 0].mean() < f.f3_delay_var[:, 1].mean()
    assert f.f5_disc_var[:, 0].mean() < f.f5_disc_var[:, 1].mean()
    np.testing.assert_array_equal(
        f.matrix(), jfeat(corr, code_err, taps, window_ms=100).matrix())
    el, poly = rng.uniform(20, 80, (4, 2)), [1e-4, -0.01, 0.5, 20.0]
    np.testing.assert_array_equal(
        acf.acf_features(corr, code_err, taps, elevation_deg=el,
                         amp_poly=poly).matrix(),
        jfeat(corr, code_err, taps, elevation_deg=el,
              amp_poly=poly).matrix())
    np.testing.assert_array_equal(acf.acf_envelope(corr), jenv(corr))


class _Acq:
    sv = np.array([3, 16, 27])
    snr_db = np.array([18.1, 26.4, 41.27])
    doppler_hz = np.array([1000.0, 0.0, -2500.0])
    fine_freq_hz = np.array([4580990.0, 4579695.0, 4577512.25])
    code_delay = np.array([3683, 26051, 7])


def test_acquisition_table_equals_jax():
    from gps_sdr_tpu.utils.metrics import format_acquisition_table as jfmt
    txt = metrics.format_acquisition_table(_Acq(), 4.58e6)
    assert txt == jfmt(_Acq(), 4.58e6)
    assert "3683" in txt and "26.43" not in txt
    assert len(txt.splitlines()) == 4


def test_ephemeris_csv_equals_jax(tmp_path):
    """Task_3_table.m's CSV, from decoded ephemerides (the LNAV encoder's
    frames of the scenario set, decoded by each package): the same text,
    header + 6 scalar + 21 parameter rows, the file equal to the return."""
    import scenario as sc
    from gps_sdr_tpu.navdecode import decode_channel as jdecode
    from gps_sdr_tpu.utils.metrics import export_ephemeris_table as jexport
    from gps_sdr_tpu_torch.io import lnav
    from gps_sdr_tpu_torch.navdecode import decode_channel
    eph, jeph = {}, {}
    for k, p in enumerate((3, 7, 16)):
        e = dict(sc.BASE_EPH, m0=sc.BASE_EPH["m0"] + 0.1 * k,
                 af0=sc.BASE_EPH["af0"] * (k + 1))
        bits = lnav.encode_frames(e, sc.WEEK, sc.TOW0 + 1.0, 7)
        p_i = np.repeat(1.0 - 2.0 * np.asarray(bits, np.float64), 20) * 1e3
        eph[p] = decode_channel(p_i, start_offset_ms=0).eph
        jeph[p] = jdecode(p_i, start_offset_ms=0).eph
    path = str(tmp_path / "eph.csv")
    text = metrics.export_ephemeris_table(eph, path)
    assert text == jexport(jeph, None) == open(path).read()
    lines = text.strip().splitlines()
    assert lines[0] == "parameter,PRN3,PRN7,PRN16" and len(lines) == 28
    assert metrics.export_ephemeris_table(eph, None, prns=[16, 3]) \
        == jexport(jeph, None, prns=[16, 3])


def _multicorr_corr(rng, T=400):
    taps = [round(0.6 - 0.05 * i, 4) for i in range(25)]
    tri = np.clip(1.0 - np.abs(np.asarray(taps)), 0.0, None)
    corr = np.zeros((T, 2, 25, 2))
    corr[..., 0] = 1000.0 * tri[None, None, :]
    return taps, corr + rng.normal(scale=20.0, size=corr.shape)


def test_acf_evolution_plot(tmp_path):
    taps, corr = _multicorr_corr(np.random.default_rng(2))
    out = str(tmp_path / "acf.png")
    plots.plot_acf_evolution(corr, taps, prns=(3, 16), out_path=out)
    assert os.path.getsize(out) > 10_000


def test_acf_animation_gif(tmp_path):
    """The animated ACF (CalculateFeatures.m:299-319): a GIF of 12 frames
    that accumulate per-ms ACF curves."""
    from PIL import Image
    taps, corr = _multicorr_corr(np.random.default_rng(3), T=60)
    rem = np.zeros((60, 2))
    rem[:, 1] = np.linspace(0, 0.1, 60)
    out = str(tmp_path / "acf.gif")
    plots.save_acf_animation(corr, taps, prn=16, channel=1, rem_chip=rem,
                             out_path=out, n_frames=12, stride_ms=4)
    assert os.path.getsize(out) > 5_000
    with Image.open(out) as im:
        assert im.format == "GIF" and getattr(im, "n_frames", 1) == 12
    with pytest.raises(ValueError, match="no frames"):
        plots.save_acf_animation(corr, taps, prn=16, out_path=out,
                                 start_ms=100)


def test_multicorr_acf_separates_multipath(tmp_path):
    """tests/test_multicorr_e2e.py's experiment through the port: a clean
    channel and one with an in-phase echo 0.3 chips late at 60 % amplitude,
    acquired by the port's Receiver and tracked with the 25-tap CT-POS bank
    (the plain tracking kernel here); the ACF features separate them (the
    echo raises F1 ×1.25 and pushes F2 0.02 chip early, the peak plateau
    widens), and they equal the JAX package's features of the same
    records."""
    from gps_sdr_tpu.analysis.acf import acf_features as jfeat
    from gps_sdr_tpu_torch.config import (FileConfig, ReceiverConfig,
                                          SignalConfig)
    from gps_sdr_tpu_torch.io.ifdata import IFSampleSource, write_if_file
    from gps_sdr_tpu_torch.io.synthetic import (SyntheticSV,
                                                generate_if_samples)
    from gps_sdr_tpu_torch.pipeline import Receiver
    from gps_sdr_tpu_torch.tracking import (TrackParams, init_track_state,
                                            run_tracking)
    cfg = ReceiverConfig(file=FileConfig(name="mcmp", skip_ms=1),
                         signal=SignalConfig(f_if=1.25e6, fs=5e6))
    spc = cfg.signal.fs / cfg.signal.code_freq_basis
    svs = [SyntheticSV(prn=9, amplitude=3.0, doppler_hz=987.0,
                       code_delay_samples=1500.0),
           SyntheticSV(prn=23, amplitude=3.0, doppler_hz=-2100.0,
                       code_delay_samples=100.0),
           SyntheticSV(prn=23, amplitude=1.8, doppler_hz=-2100.0,
                       code_delay_samples=100.0 + 0.3 * spc)]
    iq = generate_if_samples(cfg, svs, duration_ms=900, noise_std=4.0,
                             seed=5, device="cpu")
    path = str(tmp_path / "mcmp.bin")
    write_if_file(path, iq.numpy(), cfg.file)
    src = IFSampleSource(path, cfg.file)
    acq = Receiver(cfg, src, device="cpu").acquisition()
    assert {9, 23} <= set(int(s) for s in acq.sv)
    chans = [acq.channel_index(9), acq.channel_index(23)]
    params = TrackParams.pos_multicorr(cfg)
    st = init_track_state(cfg, acq.code_delay[chans],
                          acq.fine_freq_hz[chans], "cpu")
    rec, _ = run_tracking(src, cfg, [9, 23], st, params, 800)
    feats = acf.acf_features(rec.corr[200:], rec.code_err[200:],
                             params.taps, window_ms=100)
    np.testing.assert_array_equal(
        feats.matrix(), jfeat(rec.corr[200:], rec.code_err[200:],
                              params.taps, window_ms=100).matrix())
    clean, mp = 0, 1
    assert (feats.f1_amp[:, mp].mean()
            > 1.25 * feats.f1_amp[:, clean].mean())
    assert (feats.f2_delay[:, mp].mean()
            > feats.f2_delay[:, clean].mean() + 0.02)
    env = acf.acf_envelope(rec.corr[200:]).mean(axis=0)
    e_clean = env[clean] / env[clean].max()
    e_mp = env[mp] / env[mp].max()
    assert (e_mp >= 0.93).sum() >= (e_clean >= 0.93).sum() + 2
