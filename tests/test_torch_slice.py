"""The port's main path as a whole against the JAX package's, on one
capture: the scenario constellation (5 SVs, transmit-time geometry +
atmosphere) for 32 s at 2.5 MHz — the lowest rate in 2.5-5 MHz at which
the JAX Receiver still decodes all 5 SVs, incommensurate with the chip
rate (2.44 samples/chip) — written by the JAX `write_file_fast` into a
temporary directory (never the shared .cache/).

Both Receivers run acquisition → track_for_eph(31800) → decode(200) →
usable_svs → ct_position(4000) → vt_position(600, ct 4000, from a start
3.7 km off) → vt_position(200, the 29-tap bank) → ct_position(2400 rows
with the per-channel pdi 1 → 10 ms switch at row 2000 + countinx), each
with its own artifact directory; the JAX one single-device (mesh=None), its
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
        out[tag] = dict(acq=acq, rec=rec, eph=eph, sbf=sbf, usable=usable,
                        ct_rec=ct_rec, nav=nav, dir=rx.dir, vt_trk=vt_trk,
                        vt_sol=vt_sol, mc_trk=mc_trk, mc_sol=mc_sol,
                        sw_rec=sw_rec, sw_nav=sw_nav, cnt=rx.countinx())
    return out


def test_acquisition_identical(runs):
    j, t = runs["jax"]["acq"], runs["torch"]["acq"]
    np.testing.assert_array_equal(t.sv, j.sv)
    assert sorted(t.sv.tolist()) == sorted(sc.SCN_PRNS)
    np.testing.assert_array_equal(t.code_delay, j.code_delay)
    np.testing.assert_array_equal(t.doppler_hz, j.doppler_hz)
    np.testing.assert_allclose(t.snr_db, j.snr_db, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(t.fine_freq_hz, j.fine_freq_hz)


def _assert_chains_agree(j, t):
    """Integer block chain exact up to the first trajectory split (the
    first row with carrier frequencies > 1e-3 Hz apart), within one sample
    after it; prompt signs (the navigation bits) identical throughout."""
    dcarr = np.abs(t.carr_freq - j.carr_freq) > 1e-3
    split = int(np.argmax(dcarr.any(axis=1))) if dcarr.any() else len(dcarr)
    assert split >= 200, split
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
    """`Receiver.position`: mode 2 is the VT stage, mode 0 the CT stage
    (both served from the artifacts here); mode 1 is not ported."""
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
    for mode, want in ((0, "ct"), (1, None)):
        cfg_m = dataclasses.replace(
            tcfg, solu=dataclasses.replace(tcfg.solu, mode=mode))
        rx_m = TReceiver(cfg_m, src, artifact_dir=runs["torch"]["dir"],
                         device="cpu")
        if want is None:
            with pytest.raises(NotImplementedError):
                rx_m.position(n_ms=CT_MS)
        else:
            _, nav = rx_m.position(n_ms=CT_MS)
            np.testing.assert_array_equal(nav.usr_pos,
                                          runs["torch"]["nav"].usr_pos)


def test_artifacts_share_the_jax_stems(runs):
    j = set(os.listdir(runs["jax"]["dir"])) - {"jax_cache"}
    t = set(os.listdir(runs["torch"]["dir"]))
    assert t == j, (sorted(t), sorted(j))
