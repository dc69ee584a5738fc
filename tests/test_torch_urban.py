"""The Urban front end on the port against the JAX package: int16 IQ, zero
IF, a front-end DC offset that the per-block mean removal takes out, and
Dopplers of both signs (the reference's second capture, `urban_config`).

(a) tests/test_urban_fullrate.py at its own shape: 320 ms at 26 MHz, PRNs
    1 / 7 / 18 at +1200 / −365 / −2365 Hz, noise std 160, DC 180 − 120j,
    the search over PRNs 1, 3, 7, 18; then 300 ms of 1 ms E/P/L tracking
    with DC removal.  On the CPU the JAX package takes the circular complex
    grid and the host fine FFT (`_use_pow2("auto")` is False off a TPU,
    gps_sdr_tpu/acquisition.py:367-370), the computation of the port's
    cuFFT grid, so the search results are identical and the SNRs differ by
    float32 FFT round-off only (bound 1e-3 dB).
(b) tests/test_torch_slice.py's scenario (5 SVs, transmit-time geometry,
    32 s at 2.5 MHz) re-shaped to the urban front end: zero IF, int16,
    amplitudes and noise both ×20 (the same C/N0), the DC offset
    230 − 95j of tests/test_urban_frontend.py added to the written values.
    Both Receivers run acquisition → track_for_eph → decode → usable_svs →
    ct_position → vt_position, the port's then export_mat, read back at
    4 bytes a sample.
(c) on the card: the three kernels against their plain versions at
    26 MHz int16 with DC removal, bit for bit.  Skips without a card:
        python -m pytest --noconftest -p no:cacheprovider -m gpu \\
            tests/test_torch_urban.py
    (JAX-package imports sit inside fixtures, so that runs without JAX).

Tracking parity is the rule of tests/test_torch_slice.py: the two float32
loops round float64 NCO words to integers every block, so once a ~1e-6
difference flips one rounding they follow different, equally valid, noise
paths.  Integer block chains are exact up to that first split and within
one sample after it, navigation-bit signs identical; decoded navigation
data identical; WLS fixes within 1 m; VT fixes within the 12 m split of
tests/test_e2e_vt.py (`_assert_chains_agree` of tests/test_torch_slice.py
holds the chains).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from gps_sdr_tpu_torch import convert
from gps_sdr_tpu_torch.acquisition import run_acquisition as t_acquire
from gps_sdr_tpu_torch.io.ifdata import IFSampleSource as TSource
from gps_sdr_tpu_torch.ops import corr_bank as cb
from gps_sdr_tpu_torch.ops import track_chunk as tc
from gps_sdr_tpu_torch.tracking import (TrackParams, chip_tables,
                                        init_track_state, run_tracking)

torch.set_num_threads(2)


# ------------------------------------- (a) 26 MHz int16, zero IF, DC offset

FULL_SVS = (dict(prn=1, amplitude=55.0, doppler_hz=1200.0,
                 code_delay_samples=4021.0),
            dict(prn=7, amplitude=45.0, doppler_hz=-365.0,
                 code_delay_samples=17777.0),
            dict(prn=18, amplitude=45.0, doppler_hz=-2365.0,
                 code_delay_samples=9000.0))
FULL_PRNS = (1, 7, 18)
FULL_MS, FULL_TRACK_MS = 320, 300


@pytest.fixture(scope="module")
def fullrate(tmp_path_factory):
    """The capture of tests/test_urban_fullrate.py written once by the
    port's `write_if_file` (byte-equal to the JAX package's), and both
    packages' acquisition on it."""
    from gps_sdr_tpu.acquisition import run_acquisition as j_acquire
    from gps_sdr_tpu.config import AcqConfig, FileConfig, urban_config
    from gps_sdr_tpu.io.ifdata import IFSampleSource as JSource
    from gps_sdr_tpu.io.ifdata import write_if_file as j_write
    from gps_sdr_tpu.io.synthetic import SyntheticSV, generate_if_samples
    from gps_sdr_tpu_torch.io.ifdata import write_if_file
    cfg = dataclasses.replace(
        urban_config(),
        file=FileConfig(name="urban_26M", skip_ms=2, data_precision=2),
        acq=AcqConfig(prn_list=(1, 3, 7, 18)))
    iq = generate_if_samples(cfg, [SyntheticSV(**sv) for sv in FULL_SVS],
                             duration_ms=FULL_MS, noise_std=160.0, seed=9)
    iq = iq + (180.0 - 120.0j)
    root = tmp_path_factory.mktemp("urban26")
    path, jpath = str(root / "urban_26M.bin"), str(root / "urban_jax.bin")
    tcfg = convert.config_from_jax(cfg)
    write_if_file(path, iq, tcfg.file)
    j_write(jpath, iq, cfg.file)
    with open(path, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    os.remove(jpath)
    ref = j_acquire(JSource(path, cfg.file), cfg)
    src = TSource(path, tcfg.file)
    got = t_acquire(src, tcfg, device="cpu")
    return dict(cfg=cfg, tcfg=tcfg, path=path, src=src, ref=ref, got=got)


def test_fullrate_int16_ingest(fullrate):
    """The int16 memmap and its reads: the raw (n, 2) values are the file's
    int16 pairs, staged and uploaded as int16 (`DeviceStager`,
    `upload_capture`; on the CPU they wrap the values), read_complex removes
    the block's mean by default for int16 (acquisition.m:29-32) and equals
    the JAX package's read."""
    from gps_sdr_tpu.io.ifdata import IFSampleSource as JSource
    from gps_sdr_tpu_torch.io.ifdata import DeviceStager, upload_capture
    src, cfg = fullrate["src"], fullrate["cfg"]
    jsrc = JSource(fullrate["path"], cfg.file)
    assert src.n_samples == FULL_MS * 26000 == jsrc.n_samples
    vals = src.read_iq_values(26000 * 3 + 11, 26000)
    assert vals.dtype == np.int16 and vals.shape == (26000, 2)
    np.testing.assert_array_equal(
        vals.reshape(-1), np.fromfile(fullrate["path"], np.int16)[
            2 * (26000 * 3 + 11):2 * (26000 * 4 + 11)])
    staged = DeviceStager("cpu").stage(vals)
    assert staged.dtype == torch.int16
    assert torch.equal(staged, torch.from_numpy(vals))
    resident = upload_capture(src, "cpu")
    assert resident.dtype == torch.int16 and resident.shape == (
        src.n_samples, 2)
    assert torch.equal(resident[26000 * 3 + 11:26000 * 4 + 11],
                       torch.from_numpy(vals))
    c = src.read_complex(26000 * 3 + 11, 26000)
    np.testing.assert_array_equal(c, jsrc.read_complex(26000 * 3 + 11,
                                                       26000))
    assert abs(c.mean()) < 1e-3
    raw = src.read_complex(26000 * 3 + 11, 26000, remove_dc=False)
    assert abs(raw.mean() - (180.0 - 120.0j)) < 5.0


def test_fullrate_acquisition_equals_jax(fullrate):
    """The circular grid at S = 26 000: PRNs, code delays, coarse and fine
    frequencies equal to the JAX package's, SNRs within 1e-3 dB; all three
    true SVs far above threshold."""
    ref, got = fullrate["ref"], fullrate["got"]
    np.testing.assert_array_equal(got.sv, ref.sv)
    np.testing.assert_array_equal(got.code_delay, ref.code_delay)
    np.testing.assert_array_equal(got.doppler_hz, ref.doppler_hz)
    np.testing.assert_array_equal(got.fine_freq_hz, ref.fine_freq_hz)
    np.testing.assert_allclose(got.snr_db, ref.snr_db, rtol=0, atol=1e-3)
    assert set(FULL_PRNS) <= set(int(p) for p in got.sv)
    snr = {int(p): s for p, s in zip(got.sv, got.snr_db)}
    assert all(snr[p] > 30.0 for p in FULL_PRNS), snr


def test_fullrate_fine_doppler_signs(fullrate):
    """Zero IF: the fine frequency is the Doppler, and the fftshift branch
    of `fine_doppler` gives the negative ones their sign (within 15 Hz, the
    bound of tests/test_urban_fullrate.py); the code delays follow the
    reference's convention within 2 samples."""
    got, cfg = fullrate["got"], fullrate["tcfg"]
    freq = {int(p): f for p, f in zip(got.sv, got.fine_freq_hz)}
    delay = {int(p): d for p, d in zip(got.sv, got.code_delay)}
    S = cfg.signal.samples_per_ms
    for sv in FULL_SVS:
        assert abs(freq[sv["prn"]] - sv["doppler_hz"]) < 15.0, freq
        offset = (sv["code_delay_samples"] - cfg.file.skip_ms * S) % S
        err = (delay[sv["prn"]] - (S - offset) % S + S / 2) % S - S / 2
        assert abs(err) <= 2, (sv["prn"], delay[sv["prn"]])
    assert freq[7] < 0 and freq[18] < 0 < freq[1]


@pytest.fixture(scope="module")
def fullrate_tracks(fullrate):
    """FULL_TRACK_MS of 1 ms E/P/L tracking with DC removal by both
    packages, each from its own acquisition."""
    from gps_sdr_tpu.io.ifdata import IFSampleSource as JSource
    from gps_sdr_tpu.tracking import TrackParams as JParams
    from gps_sdr_tpu.tracking import init_track_state as j_init
    from gps_sdr_tpu.tracking import run_tracking as j_track
    cfg, tcfg = fullrate["cfg"], fullrate["tcfg"]
    ref, got = fullrate["ref"], fullrate["got"]
    chans = [got.channel_index(p) for p in FULL_PRNS]
    params = TrackParams.epl(tcfg)
    assert params.remove_dc
    rec, _ = run_tracking(fullrate["src"], tcfg, list(FULL_PRNS),
                          init_track_state(tcfg, got.code_delay[chans],
                                           got.fine_freq_hz[chans], "cpu"),
                          params, FULL_TRACK_MS)
    jrec, _ = j_track(JSource(fullrate["path"], cfg.file), cfg,
                      list(FULL_PRNS),
                      j_init(cfg, ref.code_delay[chans],
                             ref.fine_freq_hz[chans]),
                      JParams.epl(cfg, replica="nco"), FULL_TRACK_MS)
    return rec, jrec


def test_fullrate_tracking_locks(fullrate_tracks):
    """The prompt holds the energy (|I| > 4·|Q| over the last 100 ms), the
    carrier sits within 3 Hz of each SV's Doppler, blocks are 26 000 ± 30
    samples (tests/test_urban_fullrate.py's gates)."""
    rec, _ = fullrate_tracks
    p = np.abs(rec.p_i[-100:]).mean(axis=0)
    q = np.abs(rec.p_q[-100:]).mean(axis=0)
    assert np.all(p > 4 * q), (p, q)
    for ch, sv in enumerate(FULL_SVS):
        err = np.mean(rec.carr_freq[-100:, ch]) - sv["doppler_hz"]
        assert abs(err) < 3.0, (sv["prn"], err)
    assert np.all(np.abs(rec.num_sample - 26000) < 30)


def test_fullrate_tracking_follows_jax(fullrate_tracks):
    """The block chain against the JAX package's by the slice rule.  At
    26 000 samples a block the two loops split early: measured at row 22,
    on PRN 18's channel, where one sample's code chip lands on the other
    side of a Q32 rounding (a correlator 730 apart in 1.39e6; without DC
    removal the same happens at row 33), after which the carriers are
    > 1e-3 Hz apart for ~12 rows; the block chain itself stayed exact over
    all 300 rows.  Bound on the split: row 10."""
    from test_torch_slice import _assert_chains_agree
    rec, jrec = fullrate_tracks
    assert rec.corr.shape == (FULL_TRACK_MS, len(FULL_PRNS), 3, 2)
    _assert_chains_agree(jrec, rec, 10)


# ------------------- (b) the Receiver end to end on the urban front end

URBAN_FS = 2.5e6
GAIN = 20.0            # amplitudes and noise ×20: int16 range, same C/N0
DC = (230, -95)        # tests/test_urban_frontend.py:31
EPH_MS, DECODE_OFFSET_MS, CT_MS, VT_MS, VT_TAIL = 31800, 200, 4000, 600, 300


@pytest.fixture(scope="module")
def receivers(tmp_path_factory):
    """The scenario written by the JAX `write_file_fast` as int16 at zero
    IF, the DC offset added to every written pair; both Receivers (each its
    own artifact directory; the JAX one single-device) from the truth
    position as start, so CT is tracked once and VT reuses it."""
    import scenario as sc
    from gps_sdr_tpu.config import FileConfig, SignalConfig
    from gps_sdr_tpu.geo.coords import llh2xyz
    from gps_sdr_tpu.io.ifdata import IFSampleSource as JSource
    from gps_sdr_tpu.io.synthetic import GeometrySignal, GeometrySV
    from gps_sdr_tpu.pipeline import Receiver as JReceiver
    from gps_sdr_tpu_torch.pipeline import Receiver as TReceiver
    root = tmp_path_factory.mktemp("torch_urban")
    cfg = sc.CFG.replace(
        file=FileConfig(name="urban_scn", skip_ms=0, data_precision=2),
        signal=SignalConfig(f_if=0.0, fs=URBAN_FS))
    usr = np.asarray(llh2xyz(np.asarray(sc.TRUTH_LLH)))
    ephs = sc.visible_constellation(len(sc.SCN_PRNS))
    gs = GeometrySignal(
        cfg, [GeometrySV(prn=p, eph=e, amplitude=GAIN * a)
              for p, e, a in zip(sc.SCN_PRNS, ephs, sc.AMPLITUDES)],
        usr, sc.TOW0, clk_bias_s=sc.CLK_BIAS_S,
        clk_drift_sps=sc.CLK_DRIFT_SPS, atmosphere=True,
        iono_alpha=cfg.cmn.iono_alpha, iono_beta=cfg.cmn.iono_beta,
        doy=cfg.cmn.day_of_year)
    path = str(root / "capture.bin")
    gs.write_file_fast(path, sc.DURATION_MS, noise_std=GAIN * sc.NOISE_STD,
                       seed=11)
    vals = np.memmap(path, np.int16, "r+").reshape(-1, 2)
    assert np.abs(vals).max() < 32767 - max(abs(d) for d in DC)
    vals += np.asarray(DC, np.int16)
    vals.flush()
    del vals
    tcfg = convert.config_from_jax(cfg)
    out = {"cfg": cfg, "tcfg": tcfg, "usr": usr, "path": path}
    ct_kw = dict(n_ms=CT_MS, init_pos_ecef=usr)
    vt_kw = dict(n_ms=VT_MS, ct_n_ms=CT_MS, init_pos_ecef=usr)
    for tag, rx in (
            ("jax", JReceiver(cfg, JSource(path, cfg.file),
                              artifact_dir=str(root / "jax"), mesh=None)),
            ("torch", TReceiver(tcfg, TSource(path, tcfg.file),
                                artifact_dir=str(root / "torch"),
                                device="cpu"))):
        acq = rx.acquisition()
        rec = rx.track_for_eph(n_ms=EPH_MS)
        eph, sbf = rx.decode(start_offset_ms=DECODE_OFFSET_MS)
        usable = rx.usable_svs()
        ct_rec, nav = rx.ct_position(**ct_kw)
        vt_trk, vt_sol = rx.vt_position(**vt_kw)
        out[tag] = dict(acq=acq, rec=rec, eph=eph, sbf=sbf, usable=usable,
                        ct_rec=ct_rec, nav=nav, vt_trk=vt_trk, vt_sol=vt_sol)
    mat = str(root / "torch_mat")
    rx.export_mat(mat, ct_kw=ct_kw, vt_kw=vt_kw)
    out["torch"]["mat"] = mat
    return out


def test_receiver_acquisition_identical(receivers):
    """The 5 SVs at zero IF, Dopplers of both signs; the JAX package's
    table (SNR within 1e-3 dB)."""
    import scenario as sc
    j, t = receivers["jax"]["acq"], receivers["torch"]["acq"]
    np.testing.assert_array_equal(t.sv, j.sv)
    assert sorted(t.sv.tolist()) == sorted(sc.SCN_PRNS)
    np.testing.assert_array_equal(t.code_delay, j.code_delay)
    np.testing.assert_array_equal(t.doppler_hz, j.doppler_hz)
    np.testing.assert_array_equal(t.fine_freq_hz, j.fine_freq_hz)
    np.testing.assert_allclose(t.snr_db, j.snr_db, rtol=0, atol=1e-3)
    assert t.fine_freq_hz.min() < 0 < t.fine_freq_hz.max()


def test_receiver_eph_chain(receivers):
    """The eph record (1 ms E/P/L with DC removal) by the slice rule."""
    import scenario as sc
    from test_torch_slice import _assert_chains_agree
    j, t = receivers["jax"]["rec"], receivers["torch"]["rec"]
    assert t.corr.shape == (EPH_MS, len(sc.SCN_PRNS), 3, 2)
    _assert_chains_agree(j, t, 200)


def test_receiver_decode_identical(receivers):
    """Subframe anchors, usable SVs and every ephemeris field equal."""
    import scenario as sc
    j, t = receivers["jax"], receivers["torch"]
    assert t["sbf"] == j["sbf"]
    assert t["usable"] == j["usable"] == sorted(sc.SCN_PRNS)
    tn, jn = (convert.ephemeris_to_numpy(t["eph"]),
              convert.ephemeris_to_numpy(j["eph"]))
    assert tn.keys() == jn.keys()
    for prn in tn:
        for k in tn[prn]:
            np.testing.assert_array_equal(tn[prn][k], jn[prn][k],
                                          err_msg=f"PRN {prn} {k}")


def test_receiver_ct_records_and_wls_fixes(receivers):
    """CT records by the slice rule (first split measured at row 138, bound
    row 50); WLS fixes within 1 m of the JAX package's (median 0.25 m),
    both within 35 m of the truth by median."""
    from test_torch_slice import _assert_chains_agree
    j, t = receivers["jax"], receivers["torch"]
    _assert_chains_agree(j["ct_rec"], t["ct_rec"], 50)
    tp, jp = t["nav"].usr_pos, j["nav"].usr_pos
    assert tp.shape == jp.shape and len(tp) > 100
    dist = np.linalg.norm(tp - jp, axis=1)
    assert np.median(dist) < 0.25 and np.max(dist) < 1.0, dist
    err_t = np.linalg.norm(tp - receivers["usr"], axis=1)
    err_j = np.linalg.norm(jp - receivers["usr"], axis=1)
    assert np.median(err_t) < 35.0 and np.max(err_t) < 80.0
    assert abs(np.median(err_t) - np.median(err_j)) < 1.0


def test_receiver_vt_within_split(receivers):
    """Both VDFLLs (DC removal on: the port's fetching bank through its DC
    path) hold the same fix from their own CT hand-off: median distance
    over the settled tail under 12 m (tests/test_torch_vt.py's split),
    medians against the truth within 10 m of each other, the validity
    masks equal.  Against the truth both sit further off than at an IF:
    61.2 m (port) and 60.9 m (JAX) median over the tail here; the same
    scenario gives 22-26 m at IF 0.6 MHz, 63 m at zero IF in int8 without
    DC removal, 24.3 m at zero IF at 5 MHz: zero IF at 2.5 MHz, in both
    packages alike.  The bound is bench.py:470's 120 m, the gate of
    chip_smoke.py."""
    j, t = receivers["jax"]["vt_sol"], receivers["torch"]["vt_sol"]
    assert t.usr_pos.shape == j.usr_pos.shape == (VT_MS, 3)
    for sol in (t, receivers["torch"]["vt_trk"]):
        for name, arr in vars(sol).items():
            assert np.all(np.isfinite(arr)), name
    dist = np.linalg.norm(t.usr_pos - j.usr_pos, axis=1)[VT_TAIL:]
    assert np.median(dist) < 12.0, np.median(dist)
    err_t = np.linalg.norm(t.usr_pos - receivers["usr"], axis=1)[VT_TAIL:]
    err_j = np.linalg.norm(j.usr_pos - receivers["usr"], axis=1)[VT_TAIL:]
    assert abs(np.median(err_t) - np.median(err_j)) < 10.0
    assert np.median(err_t) < 120.0, np.median(err_t)
    np.testing.assert_array_equal(t.valid, j.valid)
    assert np.max(np.abs(receivers["torch"]["vt_trk"].absolute_sample
                         - receivers["jax"]["vt_trk"].absolute_sample)) <= 1


def test_export_mat_at_four_bytes_a_sample(receivers):
    """`export_mat` of the int16 capture: `absoluteSample` is the byte
    offset, the records' sample index × 4, `absoluteSampleCodedelay` that
    less 4·codedelay, `codedelay` = absoluteSample / 4 mod S in [0, S); the
    files read back through io/matref at bytes_per_sample=4 equal the
    records."""
    import scipy.io as sio
    from gps_sdr_tpu_torch.io import matref
    t, tcfg = receivers["torch"], receivers["tcfg"]
    S, bps = tcfg.signal.samples_per_ms, tcfg.file.bytes_per_sample
    assert bps == 4
    prns, mat = t["usable"], t["mat"]
    assert sorted(os.listdir(mat)) == sorted(
        f.format("urban_scn") for f in (
            "eph_{}.mat", "nAcquired_{}_0.mat", "navSolCT_1ms_{}.mat",
            "navSolVT_{}_updated.mat", "sbf_{}.mat", "tckRstCT_1ms_{}.mat",
            "tckRstVT_{}_updated.mat"))
    ct = sio.loadmat(os.path.join(mat, "tckRstCT_1ms_urban_scn.mat"),
                     squeeze_me=True)["TckResultCT_pos"]
    vt = sio.loadmat(os.path.join(mat, "tckRstVT_urban_scn_updated.mat"),
                     squeeze_me=True)["TckResultVT"]
    for ch, p in enumerate(prns):
        for row, rec in ((ct[p - 1], t["ct_rec"]), (vt[p - 1], t["vt_trk"])):
            samples = np.asarray(rec.absolute_sample[:, ch], np.float64)
            np.testing.assert_array_equal(row["absoluteSample"], 4 * samples)
            cd = np.asarray(row["codedelay"], np.float64)
            assert cd.min() >= 0 and cd.max() < S
            np.testing.assert_array_equal(cd, np.mod(samples, S))
        np.testing.assert_array_equal(
            ct[p - 1]["absoluteSampleCodedelay"],
            ct[p - 1]["absoluteSample"] - 4 * ct[p - 1]["codedelay"])
    rec, pdi = matref.load_tck_records(
        os.path.join(mat, "tckRstCT_1ms_urban_scn.mat"), prns,
        bytes_per_sample=bps, samples_per_ms=S)
    assert int(pdi.max()) == 1
    for f, a in convert.records_to_numpy(t["ct_rec"]).items():
        np.testing.assert_array_equal(getattr(rec, f), a, err_msg=f)
    trk, _ = matref.load_vt_records(
        os.path.join(mat, "tckRstVT_urban_scn_updated.mat"), prns,
        bytes_per_sample=bps)
    np.testing.assert_array_equal(trk.absolute_sample,
                                  t["vt_trk"].absolute_sample)
    np.testing.assert_array_equal(trk.num_sample[1:],
                                  t["vt_trk"].num_sample[1:])


# ---------------------------------------------------------- (c) on the card


@pytest.mark.gpu
def test_cuda_kernels_at_26mhz_int16_with_dc():
    """The three kernels against their plain versions on the card at the
    urban shape (26 000 samples a ms, int16, DC removal on), every field
    bit for bit (ROADMAP B's rule): track_chunk over 200 E/P/L blocks and
    60 blocks of the 25-tap grid; the bank over windows at 10 ms, 3 and 25
    taps; the fetching bank at 3 taps, split (the DC kernel runs first)
    and on one CTA per channel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _check_urban_kernels(torch.device("cuda"))


def _check_urban_kernels(dev):
    from gps_sdr_tpu_torch.config import urban_config
    from gps_sdr_tpu_torch.io.synthetic import (SyntheticSV,
                                                generate_if_samples,
                                                quantize_iq)
    cfg = urban_config()
    S = cfg.signal.samples_per_ms
    svs = [SyntheticSV(prn=sv["prn"], amplitude=sv["amplitude"],
                       doppler_hz=sv["doppler_hz"],
                       code_delay_samples=sv["code_delay_samples"])
           for sv in FULL_SVS]
    iq = generate_if_samples(cfg, svs, 400, noise_std=160.0, seed=9,
                             device=dev) + complex(*DC)
    src = TSource.from_array(quantize_iq(iq, np.int16), cfg.file)
    delays, fine = [], []
    for sv in FULL_SVS:
        f_code = 1.023e6 * (1 + sv["doppler_hz"] / cfg.signal.fc)
        epoch = sv["code_delay_samples"] % (1023 / f_code * cfg.signal.fs)
        delays.append(int(round((S - epoch) % S)))
        fine.append(sv["doppler_hz"] + 3.0)
    state = init_track_state(cfg.replace(file=dataclasses.replace(
        cfg.file, skip_ms=0)), delays, fine, dev)
    chips = chip_tables(FULL_PRNS, dev)
    for kind, n_steps in (("epl", 200), ("pos_multicorr", 60)):
        spec = getattr(TrackParams, kind)(cfg).chunk_spec(cfg)
        assert spec.remove_dc
        start = int(state.ptr.min())
        raw = torch.from_numpy(src.read_iq_values(
            start, int(state.ptr.max()) - start
            + spec.chunk_samples(n_steps))).to(dev)
        got, end = tc.track_chunk(raw, start, state, chips, spec, n_steps)
        ref, _ = tc.track_chunk_reference(raw, start, state, chips, spec,
                                          n_steps)
        tc.raise_on_fault(got)
        for f in ref:
            assert torch.equal(got[f], ref[f]), (kind, f)
        if kind == "epl":
            locked = end
    st = locked
    num = torch.ceil((1023.0 * 10 - st.rem_chip)
                     / (st.code_freq / cfg.signal.fs)).to(torch.int64)
    carr_fp = torch.round(st.carr_freq / cfg.signal.fs * 2.0 ** 32).to(
        torch.int64)
    start = int(st.ptr.min()) - S
    raw = torch.from_numpy(src.read_iq_values(start, 14 * S)).to(dev)
    words = (st.rem_chip.contiguous(), st.code_freq.contiguous(),
             st.phase_fp.to(torch.int64), carr_fp, num)
    blk = -(-(10 * S + 256) // 128) * 128
    win = cb.cut_windows(raw, st.ptr - start, blk)
    for taps in (TrackParams.epl(cfg).taps,
                 TrackParams.pos_multicorr(cfg).taps):
        tap_fp = cb.tap_offsets_fp(taps, dev)
        out, fault = cb.correlator_bank_windows(
            win, *words, chips, tap_fp, cfg.signal.fs, True)
        ref, _ = cb.correlator_bank_windows_reference(
            win, *words, chips, tap_fp, cfg.signal.fs, True)
        cb.raise_on_fault(fault)
        assert torch.equal(out, ref), len(taps)
    blk = -(-(S + 256) // 128) * 128
    num1 = torch.ceil((1023.0 - st.rem_chip)
                      / (st.code_freq / cfg.signal.fs)).to(torch.int64)
    tap_fp = cb.tap_offsets_fp((-0.5, 0.0, 0.5), dev)
    args = (raw, st.ptr - start, *words[:4], num1, chips, tap_fp,
            cfg.signal.fs, blk, True)
    ref, _ = cb.correlator_bank_reference(*args)
    for n_split in (None, 1):
        out, fault = cb.correlator_bank(*args, n_split=n_split)
        cb.raise_on_fault(fault)
        assert torch.equal(out, ref), n_split
