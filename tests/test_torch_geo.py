"""Geodesy and WLS of the port (torch float64) against the JAX package
(x64): ephemeris, atmosphere, coordinates, the position and velocity LS.
Same float64 formulas in both, so the bounds are round-off: 1e-9 relative,
1e-6 m on positions."""

import numpy as np
import pytest
import torch

from gps_sdr_tpu.geo import atmosphere as jatm
from gps_sdr_tpu.geo import coords as jco
from gps_sdr_tpu.geo import earth as jearth
from gps_sdr_tpu.geo.ephemeris import Ephemeris as JEph
from gps_sdr_tpu.geo.ephemeris import sv_pos_vel_clock as j_svpvc
from gps_sdr_tpu.positioning import wls as jwls
from gps_sdr_tpu_torch.geo import atmosphere as tatm
from gps_sdr_tpu_torch.geo import coords as tco
from gps_sdr_tpu_torch.geo import earth as tearth
from gps_sdr_tpu_torch.geo.ephemeris import Ephemeris as TEph
from gps_sdr_tpu_torch.geo.ephemeris import sv_pos_vel_clock as t_svpvc
from gps_sdr_tpu_torch.positioning import wls as twls
from scenario import BASE_EPH, TOW0, TRUTH_LLH

torch.set_num_threads(2)

ALPHA = (9.3132e-09, 1.4901e-08, -5.9605e-08, -1.1921e-07)
BETA = (8.8064e+04, 4.9152e+04, -1.3107e+05, -3.2768e+05)


def _close(got, ref, rtol=1e-9, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def sky():
    """6 SVs (omega0/m0 variations of the scenario ephemeris) at TOW0 ± 30 s."""
    rng = np.random.default_rng(3)
    ephs = [dict(BASE_EPH, omega0=float(o), m0=float(m),
                 af0=float(rng.uniform(-2e-4, 2e-4)))
            for o, m in zip(rng.uniform(0, 2 * np.pi, 6),
                            rng.uniform(0, 2 * np.pi, 6))]
    t = TOW0 + rng.uniform(-30.0, 30.0, 6)
    j = JEph(**{k: np.asarray([e[k] for e in ephs], np.float64)
                for k in JEph._fields})
    return ephs, t, j, TEph.stack(ephs, "cpu")


def test_sv_pos_vel_clock(sky):
    _, t, jeph, teph = sky
    ref = j_svpvc(jeph, t)
    got = t_svpvc(teph, t)
    for k in ("pos", "vel", "clk_m", "clk_rate_ms", "tgd_s"):
        _close(got[k], ref[k], atol=1e-6 if k == "pos" else 1e-12)
    _close(got["pos"], ref["pos"], rtol=0, atol=1e-6)


def test_coords_round_trip_and_enu():
    usr = np.asarray(jco.llh2xyz(np.asarray(TRUTH_LLH)))
    _close(tco.llh2xyz(np.asarray(TRUTH_LLH)), usr, rtol=0, atol=1e-6)
    pts = usr + np.random.default_rng(0).normal(0, 2e7, (5, 3))
    _close(tco.xyz2llh(pts), jco.xyz2llh(pts), atol=1e-9)
    _close(tco.xyz2enu(pts, usr), jco.xyz2enu(pts, usr), rtol=0, atol=1e-6)
    el_t, az_t = tco.elevation_azimuth(pts, usr)
    el_j, az_j = jco.elevation_azimuth(pts, usr)
    _close(el_t, el_j, atol=1e-12)
    _close(az_t, az_j, atol=1e-12)
    _close(tearth.earth_rotation_correction(pts, np.full(5, 2.2e7)),
           jearth.earth_rotation_correction(pts, np.full(5, 2.2e7)),
           rtol=0, atol=1e-6)


def test_klobuchar_and_unb3(sky):
    _, t, jeph, teph = sky
    pos = np.asarray(j_svpvc(jeph, t)["pos"])
    usr = np.asarray(jco.llh2xyz(np.asarray(TRUTH_LLH)))
    _close(tatm.klobuchar_delay(t, pos, usr, ALPHA, BETA),
           jatm.klobuchar_delay(t, pos, usr, ALPHA, BETA), atol=1e-12)
    el = np.array([5.0, 15.0, 30.0, 45.0, 60.0, 89.0])
    for lat in (-80.0, -22.3, 0.0, 10.0, 22.3, 37.5, 52.0, 80.0):
        _close(tatm.tropo_unb3_delay(171, lat, 4.0, el),
               jatm.tropo_unb3_delay(171, lat, 4.0, el), atol=1e-12)


def test_iterated_ls_and_velocity(sky):
    _, t, jeph, teph = sky
    sv = j_svpvc(jeph, t)
    pos, vel = np.asarray(sv["pos"]), np.asarray(sv["vel"])
    usr = np.asarray(jco.llh2xyz(np.asarray(TRUTH_LLH)))
    rng = np.random.default_rng(9)
    pr = np.linalg.norm(pos - usr, axis=1) + 1500.0 + rng.normal(0, 5, 6)
    init = np.concatenate([usr + 3e3, [0.0]])
    st_j, dop_j = jwls.iterated_ls_position(pr, pos, init)
    st_t, dop_t = twls.iterated_ls_position(pr, pos, init)
    _close(st_t[:3], st_j[:3], rtol=0, atol=1e-6)
    _close(st_t[3], st_j[3], rtol=0, atol=1e-6)
    _close(dop_t, dop_j)
    dopp = rng.normal(0, 3000, 6)
    clk_rate = rng.normal(0, 1, 6)
    v_j, d_j, r_j = jwls.doppler_velocity_ls(np.asarray(st_j[:3]), pos, vel,
                                             dopp, 0.1903, clk_rate)
    v_t, d_t, r_t = twls.doppler_velocity_ls(np.asarray(st_j[:3]), pos, vel,
                                             dopp, 0.1903, clk_rate)
    _close(v_t, v_j, rtol=0, atol=1e-6)
    _close(d_t, d_j, rtol=0, atol=1e-6)
    _close(r_t, r_j, rtol=0, atol=1e-6)
