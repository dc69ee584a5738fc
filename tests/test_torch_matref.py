"""The port's `.mat` in and out (io/matref) and the replay options of
`run_ct_positioning` against the JAX package, on the CPU: the schema cases
of tests/test_report.py and tests/test_golden_mat.py without the golden
files (not in the repository).

Writers and loaders are host numpy: the records, solutions and
ephemerides are made from a seed here (block sizes at pdi 1 and, past a
per-channel switch row, 10 ms), built as the JAX package's objects and
carried to the port's by convert.py.  Both packages write them; every
variable of each file pair, read back with scipy.io.loadmat, is equal
exactly, and each package's files load through the other's loaders with
equal fields.  The replay options are held on the records of
tests/test_torch_legacy.py's capture (built again here, under pytest's
temporary directory).  Receiver.export_mat is held on the slice capture
(tests/test_torch_slice.py).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from gps_sdr_tpu_torch import convert
from gps_sdr_tpu_torch.io import matref
from gps_sdr_tpu_torch.receiver.ct import run_ct_positioning

torch.set_num_threads(2)

S = 2500                       # samples per ms
PRNS = [3, 7, 16, 22, 27]
T, T_VT = 300, 120
SWITCH = np.array([150, 163, 171, 150, 158])   # rows at pdi = 1 per channel


def _records(switched: bool, seed: int = 1):
    """A JAX TrackRecords from a seed: per-channel pdi 1 → 10 at SWITCH
    (when `switched`), block sizes pdi·S ± 3, absolute samples their sum."""
    from gps_sdr_tpu.tracking import TrackRecords
    rng = np.random.default_rng(seed)
    n = len(PRNS)
    pdi = (np.where(np.arange(T)[:, None] < SWITCH[None, :], 1, 10)
           if switched else np.ones((T, n), np.int64))
    num = pdi * S + rng.integers(-3, 4, (T, n))
    return TrackRecords(
        corr=rng.normal(scale=500.0, size=(T, n, 3, 2)).astype(np.float32),
        code_err=rng.normal(scale=0.05, size=(T, n)),
        carr_err=rng.normal(scale=0.02, size=(T, n)),
        code_freq=1.023e6 + rng.normal(scale=2.0, size=(T, n)),
        carr_freq=6e5 + rng.uniform(-4e3, 4e3, n) + rng.normal(size=(T, n)),
        num_sample=num.astype(np.int64),
        rem_chip=rng.uniform(-0.5, 0.5, (T, n)),
        rem_phase=rng.uniform(-np.pi, np.pi, (T, n)),
        absolute_sample=(np.cumsum(num, axis=0)
                         + rng.integers(0, S, n)).astype(np.int64),
        i_early=0, i_prompt=1, i_late=2), pdi


def _fill(cls, shapes, rng):
    return cls(**{f: (rng.normal(size=shp) if dt is None
                      else rng.integers(0, 2, shp).astype(dt))
                  for f, (shp, dt) in shapes.items()})


@pytest.fixture(scope="module")
def objects():
    """The same seeded objects as the JAX package's and as the port's."""
    from gps_sdr_tpu.navdecode import EphemerisRecord
    from gps_sdr_tpu.receiver.ct import NavSolutions
    from gps_sdr_tpu.receiver.vt import VTSolutions, VTTrackRecords
    rng = np.random.default_rng(7)
    n, E = len(PRNS), 40
    rec1, pdi1 = _records(False)
    rec10, pdi10 = _records(True, seed=2)
    f = None
    nav = _fill(NavSolutions, {
        k: (shp, f) for k, shp in dict(
            usr_pos=(E, 3), usr_vel=(E, 3), usr_pos_enu=(E, 3),
            usr_pos_llh=(E, 3), clk_bias_m=(E,), usr_vel_enu=(E, 3),
            clk_drift_ms=(E,), dop=(E, 4), sat_el_deg=(E, n),
            sat_az_deg=(E, n), transmit_time=(E, n),
            raw_pseudorange=(E, n), code_phase_meas=(E, n),
            local_time=(E,), cn0_dbhz=(E, n)).items()}
        | {"valid": ((E, n), bool)}, rng)
    trk = _fill(VTTrackRecords, dict(
        corr=((T_VT, n, 3, 2), f), carr_err=((T_VT, n), f),
        code_err=((T_VT, n), f), code_freq=((T_VT, n), f),
        carr_freq=((T_VT, n), f), delta_pr=((T_VT, n), f),
        num_sample=((T_VT, n), np.int64), absolute_sample=((T_VT, n), f),
        transmit_time=((T_VT, n), f), sv_vel=((T_VT, n, 3), f),
        rem_chip=((T_VT, n), f), rem_phase=((T_VT, n), f),
        carr_nco=((T_VT, n), f)), rng)
    trk.corr = trk.corr.astype(np.float32)
    trk.absolute_sample = (np.cumsum(np.full((T_VT, n), S), axis=0)
                           + rng.integers(0, S, n)).astype(np.float64)
    trk.num_sample = np.full((T_VT, n), S, np.int64)
    sol = _fill(VTSolutions, dict(
        usr_pos=((T_VT, 3), f), usr_vel=((T_VT, 3), f),
        usr_pos_enu=((T_VT, 3), f), usr_pos_llh=((T_VT, 3), f),
        clk_bias_m=((T_VT,), f), clk_drift_ms=((T_VT,), f),
        local_time=((T_VT,), f), state_cov_diag=((T_VT, 8), f),
        kalman_gain=((T_VT, 8, 2 * n), f), innovation=((T_VT, 2 * n), f),
        r_diag=((T_VT, 2 * n), f), sat_el_deg=((T_VT, n), f),
        sat_az_deg=((T_VT, n), f), cn0_dbhz=((T_VT, n), f),
        valid=((T_VT, n), bool), loop_bw_hz=((T_VT, 2 * n), f),
        usr_vel_enu=((T_VT, 3), f), predicted_z=((T_VT, 2 * n), f),
        sv_pos=((T_VT, n, 3), f)), rng)
    sol.usr_pos = np.array([-2.42e6, 5.38e6, 2.41e6]) + sol.usr_pos
    sol.sv_pos = 2.6e7 * sol.sv_pos / np.linalg.norm(sol.sv_pos, axis=-1,
                                                     keepdims=True)
    sol.clk_bias_m = 1.5e5 + sol.clk_bias_m
    eph = {}
    for k, p in enumerate(PRNS):
        vals = {fd: [float(rng.normal())] for fd in (
            "sqrta", "ecc", "m0", "omega0", "i0", "w", "deltan", "omegadot",
            "idot", "cuc", "cus", "crc", "crs", "cic", "cis", "toe", "toc",
            "af0", "af1", "af2", "tgd", "tow", "tow1")}
        eph[p] = EphemerisRecord(
            **vals, sfb=[k + 1, k + 6], sfb1=[k + 1], weeknum=[2239],
            ura=[0], health=[0], iodc=[23], iode2=[23], iode3=[23],
            updateflag=1, updatetime_ms=[1000.0 * k],
            updatetime_tow=[388800.0 + k])
    sbf = {"nav1": {p: 11 + k for k, p in enumerate(PRNS)},
           "sfb1": {p: k + 1 for k, p in enumerate(PRNS)}}
    acq = dict(sv=np.asarray(PRNS), snr_db=rng.uniform(30, 45, n),
               doppler_hz=rng.uniform(-4e3, 4e3, n),
               code_delay=rng.integers(1, S, n),
               fine_freq_hz=6e5 + rng.uniform(-4e3, 4e3, n))
    cn0 = rng.uniform(35, 50, (T // 20, n))
    teph, tsbf = convert.ephemeris_from_jax(eph, sbf)
    return dict(
        jax=dict(rec1=rec1, rec10=rec10, nav=nav, trk=trk, sol=sol, eph=eph,
                 sbf=sbf),
        torch=dict(rec1=convert.records_from_jax(rec1),
                   rec10=convert.records_from_jax(rec10),
                   nav=convert.nav_from_jax(nav),
                   trk=convert.vt_records_from_jax(trk),
                   sol=convert.vt_solutions_from_jax(sol), eph=teph,
                   sbf=tsbf),
        pdi1=pdi1, pdi10=pdi10, acq=acq, cn0=cn0)


def _write_all(mod, o, out, acq, cn0):
    """Every writer of one package into `out`."""
    os.makedirs(out, exist_ok=True)
    mod.save_nacquired_mat(os.path.join(out, "nAcquired.mat"), **acq)
    mod.save_eph_mat(os.path.join(out, "eph.mat"), o["eph"], sbf=o["sbf"],
                     sbf_path=os.path.join(out, "sbf.mat"))
    for tag in ("rec1", "rec10"):
        mod.save_tck_records_mat(
            os.path.join(out, f"tckRstCT_{tag}.mat"), o[tag], PRNS,
            bytes_per_sample=2, cn0_ct=cn0, samples_per_ms=S)
    mod.save_navsol_mat(os.path.join(out, "navSolCT.mat"), o["nav"])
    mod.save_vt_records_mat(os.path.join(out, "tckRstVT.mat"), o["trk"],
                            PRNS, bytes_per_sample=2, samples_per_ms=S,
                            cn0_vt=cn0)
    mod.save_navsol_vt_mat(os.path.join(out, "navSolVT.mat"), o["sol"],
                           r_update_ms=40, eph=o["eph"], trk=o["trk"])


@pytest.fixture(scope="module")
def written(objects, tmp_path_factory):
    from gps_sdr_tpu.io import matref as jmatref
    root = tmp_path_factory.mktemp("torch_matref")
    dirs = {"jax": str(root / "jax"), "torch": str(root / "torch")}
    _write_all(jmatref, objects["jax"], dirs["jax"], objects["acq"],
               objects["cn0"])
    _write_all(matref, objects["torch"], dirs["torch"], objects["acq"],
               objects["cn0"])
    return dirs


def _assert_equal(a, b, where):
    """Two loadmat values equal exactly, struct arrays field by field."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype.names == b.dtype.names, where
    assert a.shape == b.shape, where
    if a.dtype.names:
        for name in a.dtype.names:
            for i in np.ndindex(a.shape):
                _assert_equal(a[i][name], b[i][name], f"{where}.{name}{i}")
    elif a.dtype == object:
        for i in np.ndindex(a.shape):
            _assert_equal(a[i], b[i], f"{where}{i}")
    else:
        assert a.dtype == b.dtype, where
        _leaf_equal(a, b, where)


def _leaf_equal(a, b, where):
    if ".satePos" in where:
        # the one variable that goes through sin/cos (the Sagnac rotation
        # of the last channel's SV position): torch's and XLA's float64
        # trig differ in the last bit (measured: 1 ulp)
        np.testing.assert_allclose(a, b, rtol=4.5e-16, atol=0, err_msg=where)
    else:
        np.testing.assert_array_equal(a, b, err_msg=where)


FILES = ["nAcquired.mat", "eph.mat", "sbf.mat", "tckRstCT_rec1.mat",
         "tckRstCT_rec10.mat", "navSolCT.mat", "tckRstVT.mat",
         "navSolVT.mat"]


@pytest.mark.parametrize("name", FILES)
def test_writers_equal_jax(written, name):
    """Every variable of the port's file equals the JAX package's (read
    with scipy.io.loadmat), exactly; navSolVT's satePos to 2 ulp (see
    `_assert_equal`)."""
    import scipy.io as sio
    a = sio.loadmat(os.path.join(written["torch"], name))
    b = sio.loadmat(os.path.join(written["jax"], name))
    keys = sorted(k for k in a if not k.startswith("__"))
    assert keys == sorted(k for k in b if not k.startswith("__")) and keys
    for k in keys:
        _assert_equal(a[k], b[k], f"{name}:{k}")


def _as_dict(obj):
    if isinstance(obj, dict):
        return obj
    return {f: getattr(obj, f) for f in (
        [x.name for x in dataclasses.fields(obj)]
        if dataclasses.is_dataclass(obj) else [])}


def _assert_same_load(a, b, where):
    if isinstance(a, tuple):
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_load(x, y, f"{where}[{i}]")
        return
    da, db = _as_dict(a), _as_dict(b)
    if not da and not isinstance(a, dict):
        np.testing.assert_array_equal(a, b, err_msg=where)
        return
    assert sorted(map(str, da)) == sorted(map(str, db)), where
    for k in da:
        x, y = da[k], db[k]
        if isinstance(x, (dict, tuple)) or dataclasses.is_dataclass(x):
            _assert_same_load(x, y, f"{where}.{k}")
        elif x is None or y is None:
            assert x is None and y is None, f"{where}.{k}"
        else:
            _leaf_equal(np.asarray(x), np.asarray(y), f"{where}.{k}")


LOADERS = [
    ("load_nacquired", "nAcquired.mat", {}),
    ("load_eph", "eph.mat", {}),
    ("load_sbf", "sbf.mat", {}),
    ("load_tck_records", "tckRstCT_rec1.mat",
     dict(prns=PRNS, samples_per_ms=S)),
    ("load_tck_records", "tckRstCT_rec10.mat",
     dict(prns=PRNS, samples_per_ms=S)),
    ("load_navsol", "navSolCT.mat", {}),
    ("load_vt_records", "tckRstVT.mat", dict(prns=PRNS)),
    ("load_navsol_vt", "navSolVT.mat", {}),
]


@pytest.mark.parametrize("loader,name,kw", LOADERS,
                         ids=[f"{l}-{n}" for l, n, _ in LOADERS])
def test_files_cross_load(written, loader, name, kw):
    """A file written by either package loads through either package's
    loader, and the four loads have equal fields (satePos to 2 ulp, as the
    files hold it)."""
    from gps_sdr_tpu.io import matref as jmatref
    loads = {(w, m.__name__.split(".")[0]): getattr(m, loader)(
        os.path.join(written[w], name), **kw)
        for w in ("jax", "torch") for m in (jmatref, matref)}
    first = loads[("jax", "gps_sdr_tpu")]
    for key, got in loads.items():
        _assert_same_load(got, first, f"{loader} {key}")


def test_loaded_records_are_what_was_written(objects, written):
    """The port's loaders give back what was written: the records' fields
    (absolute samples from byte offsets), the pdi rows of the switched
    record, the ephemerides and sbf."""
    o = objects["torch"]
    for tag, pdi in (("rec1", objects["pdi1"]), ("rec10", objects["pdi10"])):
        rec, got_pdi = matref.load_tck_records(
            os.path.join(written["torch"], f"tckRstCT_{tag}.mat"), PRNS,
            samples_per_ms=S)
        np.testing.assert_array_equal(got_pdi, pdi)
        for f, a in convert.records_to_numpy(o[tag]).items():
            np.testing.assert_array_equal(getattr(rec, f), a, err_msg=f)
    eph = matref.load_eph(os.path.join(written["torch"], "eph.mat"))
    assert convert.ephemeris_to_numpy(eph).keys() == o["eph"].keys()
    for p, fields in convert.ephemeris_to_numpy(eph).items():
        want = convert.ephemeris_to_numpy(o["eph"])[p]
        for k in fields:
            np.testing.assert_array_equal(fields[k], want[k], err_msg=k)
    assert matref.load_sbf(os.path.join(written["torch"], "sbf.mat")) \
        == {k: {p: v for p, v in d.items()} | {
            q: 0 for q in range(1, 33) if q not in d}
            for k, d in o["sbf"].items()}


@pytest.mark.parametrize("switched", [False, True])
def test_pdi_and_meas_start_equal_jax(objects, switched):
    """pdi_from_block_sizes (with and without the exact S) and
    reconstruct_meas_start give the JAX package's numbers exactly, on the
    records with the per-channel pdi 1 → 10 ms switch too."""
    from gps_sdr_tpu.io import matref as jmatref
    tag = "rec10" if switched else "rec1"
    rec = objects["torch"][tag]
    for s in (S, None):
        got, gs = matref.pdi_from_block_sizes(rec.num_sample, s)
        want, ws = jmatref.pdi_from_block_sizes(rec.num_sample, s)
        np.testing.assert_array_equal(got, want)
        assert gs == ws
    pdi = objects["pdi10" if switched else "pdi1"]
    np.testing.assert_array_equal(
        matref.pdi_from_block_sizes(rec.num_sample, S)[0], pdi)
    # an epoch-0 navigation solution whose transmit times fall inside the
    # record: each channel's signal ms at row 120 plus a code phase
    rng = np.random.default_rng(3)
    n = len(PRNS)
    tow1 = 388800.0 + rng.uniform(0, 1, n)
    nav1, sfb1 = np.arange(11, 11 + n), np.arange(1, 1 + n)
    ms = np.cumsum(pdi, axis=0)[120]
    cpm = rng.uniform(0, 1023, n)
    tt = tow1 + (ms - (nav1 + sfb1 * 20)) / 1000.0 + cpm / 1023e3
    ref_nav = matref.RefNavSolutions(**{
        f.name: np.zeros((1, n)) for f in
        dataclasses.fields(matref.RefNavSolutions)})
    ref_nav.code_phase_meas, ref_nav.transmit_time = cpm[None], tt[None]
    got = matref.reconstruct_meas_start(rec, pdi, ref_nav, tow1, nav1, sfb1,
                                        2.5e6)
    want = jmatref.reconstruct_meas_start(
        objects["jax"][tag], pdi, ref_nav, tow1, nav1, sfb1, 2.5e6)
    np.testing.assert_array_equal(got, want)
    assert np.all(np.isfinite(got))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from test_torch_legacy import build_scene
    return build_scene(tmp_path_factory.mktemp("torch_matref_scene"))


def test_replay_options_match_jax(scene):
    """The replay of shipped records: `run_ct_positioning` with the first
    measurement sample given (reconstructed from the plain run's epoch 0,
    then 0.6 ms later), the byte-scaled local-clock advance and the
    Doppler of the common fire row agrees with the JAX package to 1e-6 m
    on the same records (and reconstruct_meas_start inverts the plain run's
    epoch 0 to within 1e-3 samples)."""
    from gps_sdr_tpu.receiver.ct import run_ct_positioning as jrun
    from gps_sdr_tpu.io import matref as jmatref
    cfg, tcfg, prns = scene["cfg"], scene["tcfg"], scene["prns"]
    plain = run_ct_positioning(scene["trec"], tcfg, prns, scene["t_eph"],
                               scene["t_sbf"], scene["usr"])
    tow1 = np.array([scene["t_eph"][p].tow[0] for p in prns])
    nav1 = np.array([scene["t_sbf"]["nav1"][p] for p in prns])
    sfb1 = np.array([scene["t_eph"][p].sfb[0] for p in prns])
    ones = np.ones_like(scene["trec"].num_sample)
    start = matref.reconstruct_meas_start(scene["trec"], ones, plain, tow1,
                                          nav1, sfb1, cfg.signal.fs)
    first = max(float(scene["trec"].absolute_sample[
        nav1[ch] + sfb1[ch] * 20 - 1, ch]) for ch in range(len(prns))) + 1
    assert np.max(np.abs(start - first)) < 1e-3, start - first
    jstart = jmatref.reconstruct_meas_start(scene["rec"], ones, plain, tow1,
                                            nav1, sfb1, cfg.signal.fs)
    np.testing.assert_array_equal(start, jstart)
    step = int(cfg.signal.fs * cfg.solu.nav_sol_period_ms / 1000)
    kw = dict(meas_start_sample=float(np.median(start)) + 1500.0,
              local_time_advance_s=2 * step / cfg.signal.fs,
              doppler_at_fire_row=True)
    ref = convert.nav_to_numpy(convert.nav_from_jax(jrun(
        scene["rec"], cfg, prns, scene["eph"], scene["sbf"], scene["usr"],
        **kw)))
    got = convert.nav_to_numpy(run_ct_positioning(
        scene["trec"], tcfg, prns, scene["t_eph"], scene["t_sbf"],
        scene["usr"], **kw))
    assert got.keys() == ref.keys() and len(got["usr_pos"]) > 50
    for k in ("usr_pos", "usr_vel", "clk_bias_m", "clk_drift_ms",
              "raw_pseudorange", "usr_pos_enu"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    for k in ("transmit_time", "local_time"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-12,
                                   err_msg=k)
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    # the options did act: the first epoch 0.6 ms later; the clock state
    # carries the doubled advance's overshoot, one epoch (20 ms) of light
    # time, which the feedback removes again each epoch
    assert abs(got["transmit_time"][0, 0] - plain.transmit_time[0, 0]
               - 6e-4) < 1e-5
    over = np.median(got["clk_bias_m"][1:]) - np.median(
        plain.clk_bias_m[1:])
    print(f"clock-state overshoot {over:.3f} m")
    assert abs(over - step / cfg.signal.fs * 299792458.0) < 100.0, over
