"""The port's main path as a whole against the JAX package's, on one
capture: the scenario constellation (5 SVs, transmit-time geometry +
atmosphere) for 32 s at 2.5 MHz — the lowest rate in 2.5-5 MHz at which
the JAX Receiver still decodes all 5 SVs, incommensurate with the chip
rate (2.44 samples/chip) — written by the JAX `write_file_fast` into a
temporary directory (never the shared .cache/).

Both Receivers run acquisition → track_for_eph(31800) → decode(200) →
usable_svs → ct_position(4000) → vt_position(600, ct 4000, from a start
3.7 km off) → vt_position(200, the 29-tap bank) → ct_position(2400 rows
with the per-channel pdi 1 → 10 ms switch at row 2000 + countinx) →
ct_position_kf(4000, the legacy filter, from the 3.7 km start) →
export_mat (twice: with the VT stage's kwargs, and with an n_ms no VT run
used) → report, each with its own artifact and output directories; the JAX one single-device (mesh=None), its
VT on the exact-NCO replica (what "auto" resolves to off the TPU).  The
port tracks on the CPU through the plain version of the tracking kernel (the
10 ms blocks through `track_scan`), the same arithmetic as the JAX "nco"
scan up to float32 summation order (correlators ~3e-6 relative apart).

That is not enough for identical trajectories over 32 s.  The loops round
float64 NCO words to integers every block (carr_fp to one Q32 LSB, the
block length to one sample), and once a ~1e-6 difference flips one such
rounding the two loops follow different — equally valid — noise paths:
the JAX package against itself with the initial carrier moved by 1e-6 Hz
splits the same way within a few hundred blocks.  So the block chains are
exact until the first split and within one sample after it, the decoded
navigation data is identical, and the fixes agree to decimetres; the
positioning code alone, fed the JAX records, agrees to 1e-6 m.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from gps_sdr_tpu.config import SignalConfig
from gps_sdr_tpu.geo.coords import llh2xyz
from gps_sdr_tpu.io.ifdata import IFSampleSource as JSource
from gps_sdr_tpu.io.synthetic import GeometrySignal, GeometrySV
from gps_sdr_tpu.pipeline import Receiver as JReceiver
from gps_sdr_tpu_torch import convert
from gps_sdr_tpu_torch.io.ifdata import IFSampleSource as TSource
from gps_sdr_tpu_torch.pipeline import Receiver as TReceiver
from gps_sdr_tpu_torch.receiver.ct import run_ct_positioning
import scenario as sc

torch.set_num_threads(2)

FS, F_IF = 2.5e6, 0.6e6
EPH_MS, DECODE_OFFSET_MS, CT_MS = 31800, 200, 4000
VT_MS, VT_MC_MS, VT_TAIL = 600, 200, 300
# the switch of tests/test_e2e_ct.py: some 45 WLS epochs (from ~1.1 s in)
# before the first channel switches, 200 after
SW_ROWS, SW_MS = 2400, 2000


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_slice")
    cfg = sc.CFG.replace(signal=SignalConfig(f_if=F_IF, fs=FS))
    usr = np.asarray(llh2xyz(np.asarray(sc.TRUTH_LLH)))
    ephs = sc.visible_constellation(len(sc.SCN_PRNS))
    gs = GeometrySignal(
        cfg, [GeometrySV(prn=p, eph=e, amplitude=a)
              for p, e, a in zip(sc.SCN_PRNS, ephs, sc.AMPLITUDES)],
        usr, sc.TOW0, clk_bias_s=sc.CLK_BIAS_S,
        clk_drift_sps=sc.CLK_DRIFT_SPS, atmosphere=True,
        iono_alpha=cfg.cmn.iono_alpha, iono_beta=cfg.cmn.iono_beta,
        doy=cfg.cmn.day_of_year)
    path = str(root / "capture.bin")
    gs.write_file_fast(path, sc.DURATION_MS, noise_std=sc.NOISE_STD, seed=11)
    tcfg = convert.config_from_jax(cfg)
    out = {"cfg": cfg, "tcfg": tcfg, "usr": usr, "path": path}
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
        ct_rec, nav = rx.ct_position(n_ms=CT_MS)
        init = usr + np.array([3000.0, -2000.0, 1500.0])
        vt_trk, vt_sol = rx.vt_position(n_ms=VT_MS, ct_n_ms=CT_MS,
                                        init_pos_ecef=init)
        mc_trk, mc_sol = rx.vt_position(n_ms=VT_MC_MS, ct_n_ms=CT_MS,
                                        init_pos_ecef=init, multicorr=True)
        sw_rec, sw_nav = rx.ct_position(n_ms=SW_ROWS, pdi_switch_ms=SW_MS)
        kf_rec, kf_nav = rx.ct_position_kf(n_ms=CT_MS, init_pos_ecef=init)
        vt_kw = dict(n_ms=VT_MS, ct_n_ms=CT_MS, init_pos_ecef=init)
        mat, no_vt = str(root / f"{tag}_mat"), str(root / f"{tag}_mat_no_vt")
        rx.export_mat(mat, ct_kw=dict(n_ms=CT_MS), vt_kw=vt_kw)
        rx.export_mat(no_vt, ct_kw=dict(n_ms=CT_MS),
                      vt_kw=dict(vt_kw, n_ms=VT_MS - 1))
        report = str(root / f"{tag}_report")
        rx.report(report, ct_kw=dict(n_ms=CT_MS), vt_kw=vt_kw)
        out[tag] = dict(acq=acq, rec=rec, eph=eph, sbf=sbf, usable=usable,
                        ct_rec=ct_rec, nav=nav, dir=rx.dir, vt_trk=vt_trk,
                        vt_sol=vt_sol, mc_trk=mc_trk, mc_sol=mc_sol,
                        sw_rec=sw_rec, sw_nav=sw_nav, cnt=rx.countinx(),
                        kf_rec=kf_rec, kf_nav=kf_nav, mat=mat, no_vt=no_vt,
                        report=report)
    out["init"] = init
    return out


def test_acquisition_identical(runs):
    j, t = runs["jax"]["acq"], runs["torch"]["acq"]
    np.testing.assert_array_equal(t.sv, j.sv)
    assert sorted(t.sv.tolist()) == sorted(sc.SCN_PRNS)
    np.testing.assert_array_equal(t.code_delay, j.code_delay)
    np.testing.assert_array_equal(t.doppler_hz, j.doppler_hz)
    np.testing.assert_allclose(t.snr_db, j.snr_db, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(t.fine_freq_hz, j.fine_freq_hz)


def _assert_chains_agree(j, t, min_split=200):
    """Integer block chain exact up to the first trajectory split (the
    first row with carrier frequencies > 1e-3 Hz apart, no earlier than
    `min_split`), within one sample after it; prompt signs (the navigation
    bits) identical throughout."""
    dcarr = np.abs(t.carr_freq - j.carr_freq) > 1e-3
    split = int(np.argmax(dcarr.any(axis=1))) if dcarr.any() else len(dcarr)
    assert split >= min_split, split
    np.testing.assert_array_equal(t.num_sample[:split], j.num_sample[:split])
    np.testing.assert_array_equal(t.absolute_sample[:split],
                                  j.absolute_sample[:split])
    assert np.max(np.abs(t.absolute_sample - j.absolute_sample)) <= 1
    assert np.mean(t.num_sample != j.num_sample) < 1e-3
    assert np.mean(np.sign(t.p_i) == np.sign(j.p_i)) > 0.9999


def test_eph_block_chain(runs):
    j, t = runs["jax"]["rec"], runs["torch"]["rec"]
    assert t.corr.shape == (EPH_MS, len(sc.SCN_PRNS), 3, 2)
    _assert_chains_agree(j, t)


def test_decode_identical(runs):
    j, t = runs["jax"], runs["torch"]
    assert t["sbf"] == j["sbf"]
    assert t["usable"] == j["usable"] == sorted(sc.SCN_PRNS)
    tn, jn = (convert.ephemeris_to_numpy(t["eph"]),
              convert.ephemeris_to_numpy(j["eph"]))
    assert tn.keys() == jn.keys()
    for prn in tn:
        for k in tn[prn]:
            np.testing.assert_array_equal(tn[prn][k], jn[prn][k],
                                          err_msg=f"PRN {prn} {k}")


def test_ct_records_and_wls_fixes(runs):
    j, t = runs["jax"], runs["torch"]
    _assert_chains_agree(j["ct_rec"], t["ct_rec"])
    tp, jp = t["nav"].usr_pos, j["nav"].usr_pos
    assert tp.shape == jp.shape and len(tp) > 100
    dist = np.linalg.norm(tp - jp, axis=1)
    assert np.median(dist) < 0.25 and np.max(dist) < 1.0, dist
    err_t = np.linalg.norm(tp - runs["usr"], axis=1)
    err_j = np.linalg.norm(jp - runs["usr"], axis=1)
    assert np.median(err_t) < 35.0 and np.max(err_t) < 80.0
    assert abs(np.median(err_t) - np.median(err_j)) < 1.0


def test_ct_pdi_switch(runs):
    """`ct_position(pdi_switch_ms=2000)`: each channel runs 1 ms blocks for
    2000 + countinx rows and 10 ms blocks after (the port's through
    `track_scan`).  Same `countinx`, so the same rows per regime (read back
    from the block lengths); artifacts under the JAX package's `_sw2000`
    stems; the block chain as in the other stages; the fixes within 1 m of
    the JAX package's across the switch."""
    j, t = runs["jax"], runs["torch"]
    np.testing.assert_array_equal(t["cnt"], j["cnt"])
    S = runs["cfg"].signal.samples_per_ms
    jr, tr = j["sw_rec"], t["sw_rec"]
    assert tr.corr.shape == jr.corr.shape == (SW_ROWS, len(sc.SCN_PRNS), 3, 2)
    pdi_t = np.where(np.abs(tr.num_sample - S) < 50, 1, 10)
    pdi_j = np.where(np.abs(jr.num_sample - S) < 50, 1, 10)
    np.testing.assert_array_equal(pdi_t, pdi_j)
    rows = np.arange(SW_ROWS)[:, None]
    np.testing.assert_array_equal(
        pdi_t, np.where(rows < SW_MS + t["cnt"][None, :], 1, 10))
    assert np.all(np.abs(tr.num_sample - pdi_t * S) < 50)
    for d in (j["dir"], t["dir"]):
        stems = [f for f in os.listdir(d) if f"_{SW_ROWS}_sw{SW_MS}_" in f]
        assert sorted(s.split("_")[0] for s in stems) == ["navct", "tckct"]
    _assert_chains_agree(jr, tr)
    tp, jp = t["sw_nav"].usr_pos, j["sw_nav"].usr_pos
    assert tp.shape == jp.shape and len(tp) > 100
    dist = np.linalg.norm(tp - jp, axis=1)
    print(f"pdi switch: {len(tp)} epochs, fixes median {np.median(dist):.3f}"
          f" m, max {np.max(dist):.3f} m apart")
    assert np.max(dist) < 1.0, dist
    err_t = np.linalg.norm(tp - runs["usr"], axis=1)
    assert np.median(err_t[5:40]) < 40.0 and np.median(err_t[60:]) < 40.0
    np.testing.assert_allclose(np.diff(t["sw_nav"].transmit_time, axis=0),
                               0.02, rtol=0, atol=1e-6)


def test_ct_positioning_from_jax_records(runs):
    """The JAX records and decode, carried across by convert.py, through
    the port's WLS epochs give the JAX fixes."""
    j = runs["jax"]
    eph, sbf = convert.ephemeris_from_jax(j["eph"], j["sbf"])
    nav = run_ct_positioning(convert.records_from_jax(j["ct_rec"]),
                             runs["tcfg"], j["usable"], eph, sbf,
                             runs["usr"])
    ref = convert.nav_to_numpy(convert.nav_from_jax(j["nav"]))
    got = convert.nav_to_numpy(nav)
    assert got.keys() == ref.keys()
    np.testing.assert_allclose(got["usr_pos"], ref["usr_pos"], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got["clk_bias_m"], ref["clk_bias_m"],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["usr_vel"], ref["usr_vel"], rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(got["valid"], ref["valid"])


def test_vt_fixes_agree(runs):
    """Both VDFLLs hold the same fix from the same kind of warm start (each
    from its own CT records, which split onto different noise paths, see
    the module docstring): median distance between the two position series
    over the settled tail under 12 m, the bound of
    tests/test_e2e_vt.py::test_vt_pallas_replica_converges; medians of the
    error against truth within 10 m of each other."""
    j, t = runs["jax"]["vt_sol"], runs["torch"]["vt_sol"]
    assert t.usr_pos.shape == j.usr_pos.shape == (VT_MS, 3)
    for sol in (t, runs["torch"]["vt_trk"]):
        for name, arr in vars(sol).items():
            assert np.all(np.isfinite(arr)), name
    dist = np.linalg.norm(t.usr_pos - j.usr_pos, axis=1)[VT_TAIL:]
    assert np.median(dist) < 12.0, np.median(dist)
    err_t = np.linalg.norm(t.usr_pos - runs["usr"], axis=1)[VT_TAIL:]
    err_j = np.linalg.norm(j.usr_pos - runs["usr"], axis=1)[VT_TAIL:]
    assert abs(np.median(err_t) - np.median(err_j)) < 10.0
    assert np.median(err_t) < 35.0, np.median(err_t)
    assert np.all(t.valid[VT_TAIL:].sum(axis=1) >= 4)
    np.testing.assert_array_equal(t.valid, j.valid)
    print(f"VT parity: median distance {np.median(dist):.3f} m, max "
          f"{np.max(dist):.3f} m; median error torch {np.median(err_t):.2f}"
          f" m, jax {np.median(err_j):.2f} m")


def test_vt_records_have_the_jax_schema(runs):
    j = convert.vt_records_to_numpy(convert.vt_records_from_jax(
        runs["jax"]["vt_trk"]))
    t = convert.vt_records_to_numpy(runs["torch"]["vt_trk"])
    assert t.keys() == j.keys()
    for k in t:
        assert t[k].shape == j[k].shape and t[k].dtype == j[k].dtype, k
    js = convert.vt_solutions_to_numpy(convert.vt_solutions_from_jax(
        runs["jax"]["vt_sol"]))
    ts = convert.vt_solutions_to_numpy(runs["torch"]["vt_sol"])
    assert ts.keys() == js.keys()
    for k in ts:
        assert ts[k].shape == js[k].shape and ts[k].dtype == js[k].dtype, k
    assert np.max(np.abs(runs["torch"]["vt_trk"].absolute_sample
                         - runs["jax"]["vt_trk"].absolute_sample)) <= 1


def test_vt_multicorr_bank(runs):
    """The 29-tap bank through the same path: the full bank is recorded and
    the loop closes on taps 4 / 14 / 24 (±0.5 chip and prompt)."""
    from gps_sdr_tpu_torch.receiver.vt import VTParams
    j, t = runs["jax"], runs["torch"]
    n = len(sc.SCN_PRNS)
    assert t["mc_trk"].corr.shape == j["mc_trk"].corr.shape \
        == (VT_MC_MS, n, 29, 2)
    p = VTParams.multicorr()
    assert (p.i_early, p.i_prompt, p.i_late) == (4, 14, 24)
    corr = t["mc_trk"].corr
    mag = np.hypot(corr[..., 0], corr[..., 1]).mean(axis=(0, 1))   # (29,)
    assert int(np.argmax(mag)) == p.i_prompt
    # the ±0.5-chip taps sit at half the prompt's triangle
    for i in (p.i_early, p.i_late):
        assert 0.35 < mag[i] / mag[p.i_prompt] < 0.65, mag[i] / mag[14]
    # the same loop as the 3-tap bank: both runs track the same samples
    np.testing.assert_array_equal(
        t["mc_trk"].absolute_sample,
        t["vt_trk"].absolute_sample[:VT_MC_MS])
    dist = np.linalg.norm(t["mc_sol"].usr_pos - j["mc_sol"].usr_pos, axis=1)
    assert np.median(dist[100:]) < 12.0, np.median(dist[100:])


def test_position_dispatches_on_mode(runs):
    """`Receiver.position`: mode 2 is the VT stage, mode 0 the CT stage,
    mode 1 the legacy filter (`ct_position_kf`); all served from the
    artifacts here."""
    import dataclasses
    tcfg = runs["tcfg"]
    src = TSource(runs["path"], tcfg.file)
    init = runs["usr"] + np.array([3000.0, -2000.0, 1500.0])
    rx = TReceiver(tcfg, src, artifact_dir=runs["torch"]["dir"],
                   device="cpu")
    assert tcfg.solu.mode == 2 and tcfg.cmn.vt_enable
    trk, sol = rx.position(n_ms=VT_MS, ct_n_ms=CT_MS, init_pos_ecef=init)
    np.testing.assert_array_equal(sol.usr_pos,
                                  runs["torch"]["vt_sol"].usr_pos)
    for mode, kw, want in ((0, {}, runs["torch"]["nav"]),
                           (1, dict(init_pos_ecef=init),
                            runs["torch"]["kf_nav"])):
        cfg_m = dataclasses.replace(
            tcfg, solu=dataclasses.replace(tcfg.solu, mode=mode))
        rx_m = TReceiver(cfg_m, src, artifact_dir=runs["torch"]["dir"],
                         device="cpu")
        _, nav = rx_m.position(n_ms=CT_MS, **kw)
        assert type(nav) is type(want)
        np.testing.assert_array_equal(nav.usr_pos, want.usr_pos)


def test_artifacts_share_the_jax_stems(runs):
    j = set(os.listdir(runs["jax"]["dir"])) - {"jax_cache"}
    t = set(os.listdir(runs["torch"]["dir"]))
    assert t == j, (sorted(t), sorted(j))


# ------------------------------------------------ the legacy filter (mode 1)


def test_kf_converges_and_agrees(runs):
    """tests/test_legacy_components.py::test_legacy_kf_positioning on the
    slice capture: from the 3.7 km start both packages' position-domain
    filters converge (median error under 60 m after epoch 20) with the
    common 75 ms-base offset in the clock state (1e5 < |b| < 3e6 m); their
    fixes are within 1 m of each other, the parity rule of the scalar path;
    the stems are the JAX package's."""
    j, t = runs["jax"], runs["torch"]
    jp, tp = j["kf_nav"].usr_pos, t["kf_nav"].usr_pos
    assert tp.shape == jp.shape and len(tp) >= 50
    for nav in (j["kf_nav"], t["kf_nav"]):
        err = np.linalg.norm(nav.usr_pos[20:] - runs["usr"], axis=1)
        assert np.median(err) < 60.0, np.median(err)
        assert 1e5 < abs(nav.clk_bias_m[-1]) < 3e6
    dist = np.linalg.norm(tp - jp, axis=1)
    print(f"KF: {len(tp)} epochs, fixes median {np.median(dist):.3f} m, "
          f"max {np.max(dist):.3f} m apart")
    assert np.max(dist) < 1.0, dist
    _assert_chains_agree(j["kf_rec"], t["kf_rec"])
    for d in (j["dir"], t["dir"]):
        assert sorted(f for f in os.listdir(d) if "_kf_" in f) == sorted(
            f"{s}_kf_{runs['cfg'].file.name}_{CT_MS}_def_"
            f"{TReceiver._init_token(runs['init'])}.{e}"
            for s, e in (("tckct", "npz"), ("navct", "pkl")))


def test_kf_from_jax_records(runs):
    """The JAX KF records and decode through the port's filter give the JAX
    filter's epochs to 1e-6 m."""
    from gps_sdr_tpu_torch.receiver.ct_legacy import run_ct_positioning_kf
    j = runs["jax"]
    eph, sbf = convert.ephemeris_from_jax(j["eph"], j["sbf"])
    nav = run_ct_positioning_kf(convert.records_from_jax(j["kf_rec"]),
                                runs["tcfg"], j["usable"], eph, sbf,
                                runs["init"])
    for k in ("usr_pos", "usr_vel", "clk_bias_m", "clk_drift_ms", "state",
              "raw_pseudorange"):
        np.testing.assert_allclose(getattr(nav, k), getattr(j["kf_nav"], k),
                                   rtol=0, atol=1e-6, err_msg=k)


# ------------------------------------------------- .mat export and report


MAT_FILES = ["eph_geo_scn.mat", "nAcquired_geo_scn_0.mat",
             "navSolCT_1ms_geo_scn.mat", "navSolVT_geo_scn_updated.mat",
             "sbf_geo_scn.mat", "tckRstCT_1ms_geo_scn.mat",
             "tckRstVT_geo_scn_updated.mat"]


def test_export_mat_reference_schemas(runs):
    """Receiver.export_mat writes the reference's chain under the same file
    names as the JAX package's; vt=None exported the VT chain because the VT
    stage had run for those kwargs and skipped it for an n_ms no run used.
    The port's files reload through its loaders, equal to the records,
    solutions, ephemerides and acquisition in memory."""
    from gps_sdr_tpu_torch.io import matref
    j, t = runs["jax"], runs["torch"]
    for d in (j, t):
        assert sorted(os.listdir(d["mat"])) == MAT_FILES
        assert sorted(os.listdir(d["no_vt"])) == [
            f for f in MAT_FILES if "VT" not in f]
    prns, out = t["usable"], t["mat"]
    bps = runs["tcfg"].file.bytes_per_sample
    rec, pdi = matref.load_tck_records(
        os.path.join(out, "tckRstCT_1ms_geo_scn.mat"), prns,
        bytes_per_sample=bps)
    assert int(pdi.max()) == 1
    for f, a in convert.records_to_numpy(t["ct_rec"]).items():
        np.testing.assert_array_equal(getattr(rec, f), a, err_msg=f)
    nav = matref.load_navsol(os.path.join(out, "navSolCT_1ms_geo_scn.mat"))
    np.testing.assert_array_equal(nav.usr_pos, t["nav"].usr_pos)
    trk, cn0 = matref.load_vt_records(
        os.path.join(out, "tckRstVT_geo_scn_updated.mat"), prns,
        bytes_per_sample=bps)
    np.testing.assert_array_equal(trk.absolute_sample,
                                  t["vt_trk"].absolute_sample)
    np.testing.assert_array_equal(trk.code_freq, t["vt_trk"].code_freq)
    assert cn0.shape == (VT_MS // 20, len(prns))
    g = matref.load_navsol_vt(
        os.path.join(out, "navSolVT_geo_scn_updated.mat"))
    np.testing.assert_array_equal(g["usrPos"], t["vt_sol"].usr_pos)
    assert g["kalman_gain"].shape == (8, 2 * len(prns), VT_MS)
    eph = matref.load_eph(os.path.join(out, "eph_geo_scn.mat"))
    assert sorted(eph) == sorted(t["eph"])
    assert matref.load_sbf(os.path.join(out, "sbf_geo_scn.mat"))["nav1"][
        prns[0]] == t["sbf"]["nav1"][prns[0]]
    na = matref.load_nacquired(os.path.join(out, "nAcquired_geo_scn_0.mat"))
    assert list(na["sv"]) == list(prns)
    np.testing.assert_array_equal(
        na["code_delay"],
        t["acq"].code_delay[[t["acq"].channel_index(p) for p in prns]])


def test_report_writes_all_outputs(runs):
    """Receiver.report writes the reference's eight files (the JAX
    package's names), every PNG over 10 KB, and the ephemeris CSV equal to
    the JAX package's text (identical decodes)."""
    j, t = runs["jax"], runs["torch"]
    files = sorted(os.listdir(t["report"]))
    assert files == sorted(os.listdir(j["report"])) == [
        "channels_dashboard.png", "task1_acquisition.png",
        "task2_tracking.png", "task3_ephemeris.csv", "task3_ephemeris.png",
        "task4_wls.png", "task5_ekf.png", "vt_channels.png"]
    for f in files:
        if f.endswith(".png"):
            assert os.path.getsize(os.path.join(t["report"], f)) > 10_000, f
    texts = [open(os.path.join(d["report"], "task3_ephemeris.csv")).read()
             for d in (j, t)]
    assert texts[0] == texts[1]
    assert texts[1].splitlines()[0] == "parameter," + ",".join(
        f"PRN{p}" for p in t["usable"])


# ------------------- the validity mask (tests/test_validity_mask.py)


@pytest.fixture(scope="module")
def dropout(runs):
    """The port's CT records with channel 0 losing lock at row 2000:
    correlators collapse to noise, the code phase walks off (~2.9 m a ms)."""
    from gps_sdr_tpu_torch.tracking import _REC_FIELDS, TrackRecords
    rec = runs["torch"]["ct_rec"]
    d = {f: np.array(getattr(rec, f)) for f in _REC_FIELDS}
    t0, t_len = 2000, d["corr"].shape[0]
    rng = np.random.default_rng(3)
    d["corr"][t0:, 0] = rng.normal(scale=1.0, size=d["corr"][t0:, 0].shape)
    d["rem_chip"][t0:, 0] += 0.01 * np.arange(t_len - t0)
    return TrackRecords(**d, i_early=rec.i_early, i_prompt=rec.i_prompt,
                        i_late=rec.i_late), t0


def _both_navs(runs, rec, cfg_update=None):
    """The port's and the JAX package's WLS epochs on the same records."""
    from gps_sdr_tpu.receiver.ct import run_ct_positioning as jrun
    cfg, tcfg = runs["cfg"], runs["tcfg"]
    if cfg_update:
        cfg = cfg.replace(solu=dataclasses.replace(cfg.solu, **cfg_update))
        tcfg = tcfg.replace(solu=dataclasses.replace(tcfg.solu,
                                                     **cfg_update))
    t, j = runs["torch"], runs["jax"]
    nav = run_ct_positioning(rec, tcfg, t["usable"], t["eph"], t["sbf"],
                             runs["usr"])
    jnav = jrun(rec, cfg, j["usable"], j["eph"], j["sbf"], runs["usr"])
    np.testing.assert_array_equal(nav.valid, jnav.valid)
    np.testing.assert_allclose(nav.usr_pos, jnav.usr_pos, rtol=0, atol=1e-6)
    return nav


def test_ct_mask_drops_dead_channel_and_survives(runs, dropout):
    """The gate drops the dead channel within ~2 C/N0 windows and keeps
    the others; the fix survives on 4 SVs; the JAX package gates and fixes
    the same records identically (masks equal, fixes within 1e-6 m)."""
    rec, t0 = dropout
    nav = _both_navs(runs, rec)
    err = np.linalg.norm(nav.usr_pos - runs["usr"], axis=1)
    e0 = np.searchsorted(nav.local_time - nav.local_time[0],
                         (t0 - 1080) / 1000.0) + 5
    assert not nav.valid[e0 + 5:, 0].any(), "dead channel still in WLS"
    assert nav.valid[e0 + 5:, 1:].all(), "healthy channels were masked"
    assert np.median(nav.cn0_dbhz[e0 + 5:, 0]) < 35.0
    assert np.median(err[e0 + 5:]) < 60.0, np.median(err[e0 + 5:])
    assert np.median(err[5:e0 - 2]) < 40.0


def test_ct_unmasked_dropout_poisons_solution(runs, dropout):
    """With the gate off (threshold 0, the reference's behaviour) the
    walking pseudorange wrecks the fix, in both packages alike."""
    rec, _ = dropout
    nav = _both_navs(runs, rec, dict(mask_snr_db=0.0))
    err = np.linalg.norm(nav.usr_pos - runs["usr"], axis=1)
    assert np.median(err[-30:]) > 150.0, np.median(err[-30:])


VT_MASK_MS = 1000


def test_vt_mask_survives_corrupted_channel(runs):
    """A channel handed to VT two chips off the peak never correlates: the
    EKF gates it out within a few C/N0 windows, keeps the others and holds
    the fix (median under 60 m, max under 120 m from row 500).  The JAX
    package from the same corrupted start makes the same gate decisions
    (the dead channel's exit up to one C/N0 window apart; measured: 20
    rows), and its median error is within 10 m of the port's."""
    from gps_sdr_tpu.geo.ephemeris import Ephemeris as JEphemeris
    from gps_sdr_tpu.receiver import vt as jvt
    from gps_sdr_tpu_torch.geo.ephemeris import Ephemeris
    from gps_sdr_tpu_torch.receiver import vt as tvt
    cfg, tcfg, usr = runs["cfg"], runs["tcfg"], runs["usr"]
    t = runs["torch"]
    eph, sbf, prns = t["eph"], t["sbf"], t["usable"]
    ct_rec, ct_nav = t["ct_rec"], t["nav"]
    epoch0 = cfg.file.skiptime_vt_ms // cfg.solu.nav_sol_period_ms - 1
    f0 = cfg.signal.code_freq_basis
    start_slot, tt0 = {}, np.empty(len(prns))
    for ch, p in enumerate(prns):
        first_sf_ms = sbf["nav1"][p] + eph[p].sfb[0] * 20
        slot = first_sf_ms + cfg.file.skiptime_vt_ms - 1
        start_slot[ch] = slot
        tt0[ch] = (eph[p].tow[0] + (slot + 1 - first_sf_ms) / 1000.0
                   + ct_rec.rem_chip[slot, ch] / f0)
    args = (list(range(len(prns))), start_slot, tt0, ct_nav.usr_pos[epoch0],
            ct_nav.usr_vel[epoch0], float(ct_nav.clk_bias_m[epoch0]),
            float(ct_nav.clk_drift_ms[epoch0]))
    st = tvt.init_vt_state(tcfg, ct_rec, *args, tvt.VTParams(), "cpu")
    rem, tt = st.rem_chip.clone(), st.transmit_time.clone()
    rem[0] += 2.0
    tt[0] += 2.0 / f0
    trk, sol, _ = tvt.run_vector_tracking(
        TSource(runs["path"], tcfg.file), tcfg, prns,
        Ephemeris.stack([eph[p].latest(0) for p in prns], "cpu"),
        st._replace(rem_chip=rem, transmit_time=tt), tvt.VTParams(),
        VT_MASK_MS, usr)
    err = np.linalg.norm(sol.usr_pos - usr, axis=1)
    assert not sol.valid[200:, 0].any()
    assert sol.valid[200:, 1:].all()
    assert np.median(err[500:]) < 60.0, np.median(err[500:])
    assert np.max(err[500:]) < 120.0
    jparams = jvt.VTParams(replica="nco")
    jst = jvt.init_vt_state(cfg, ct_rec, *args, jparams)
    jst = jst._replace(rem_chip=jst.rem_chip.at[0].add(2.0),
                       transmit_time=jst.transmit_time.at[0].add(2.0 / f0))
    jeph = JEphemeris(**{k: np.asarray([eph[p].latest(0)[k] for p in prns])
                         for k in JEphemeris._fields})
    _, jsol, _ = jvt.run_vector_tracking(
        JSource(runs["path"], cfg.file), cfg, prns, jeph, jst, jparams,
        VT_MASK_MS, usr)
    # the same gate decisions but for when the dead channel leaves: the
    # two runs' noise paths may put that one C/N0 window (20 rows) apart
    diff = sol.valid != jsol.valid
    assert not diff[:, 1:].any() and diff[:, 0].sum() <= 20, \
        np.flatnonzero(diff[:, 0])
    np.testing.assert_array_equal(sol.valid[200:], jsol.valid[200:])
    jerr = np.linalg.norm(jsol.usr_pos - usr, axis=1)
    assert abs(np.median(err[500:]) - np.median(jerr[500:])) < 10.0
