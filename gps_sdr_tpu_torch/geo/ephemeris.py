"""IS-GPS-200 broadcast-ephemeris satellite position / velocity / clock,
torch float64 (equivalent of the reference's `geo/svPosVel.m`).

All channels are evaluated at once as (N,) tensors; the Kepler iteration
is a fixed 12 trips (converges to <1e-13; svPosVel.m:94-100 allows 10) and
week rollover is a closed-form mod (svPosVel.m:49-59).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gps_sdr_tpu_torch.geo.coords import f64
from gps_sdr_tpu_torch.utils.device import resolve_device

GPS_PI = 3.1415926535898
MU_EARTH = 3.986005e14
OMEGA_E_DOT = 7.2921151467e-5
F_REL = -4.442807633e-10
C_LIGHT = 299_792_458.0
WEEK_SECONDS = 604800.0


class Ephemeris(NamedTuple):
    """One broadcast ephemeris per channel — every field is shape (N,)
    float64 (IS-GPS-200 names; the reference's ini_eph.m:19-55)."""
    sqrta: torch.Tensor
    ecc: torch.Tensor
    m0: torch.Tensor
    omega0: torch.Tensor
    i0: torch.Tensor
    w: torch.Tensor
    deltan: torch.Tensor
    omegadot: torch.Tensor
    idot: torch.Tensor
    cuc: torch.Tensor
    cus: torch.Tensor
    crc: torch.Tensor
    crs: torch.Tensor
    cic: torch.Tensor
    cis: torch.Tensor
    toe: torch.Tensor
    toc: torch.Tensor
    af0: torch.Tensor
    af1: torch.Tensor
    af2: torch.Tensor
    tgd: torch.Tensor

    @staticmethod
    def stack(eph_list, device=None) -> "Ephemeris":
        """From a list of objects or dicts carrying the fields, on
        `device` (the card when None)."""
        device = resolve_device(device)
        def get(e, f):
            return e[f] if isinstance(e, dict) else getattr(e, f)
        return Ephemeris(*[f64([float(get(e, f)) for e in eph_list], device)
                           for f in Ephemeris._fields])


def _wrap_week(t: torch.Tensor) -> torch.Tensor:
    """Normalize a time difference into [-302400, 302400] (svPosVel.m:49-59)."""
    return torch.remainder(t + WEEK_SECONDS / 2, WEEK_SECONDS) - WEEK_SECONDS / 2


def sv_pos_vel_clock(eph: Ephemeris, t):
    """SV ECEF position, velocity and clock at transmit time `t` (s of week).

    Returns a dict: pos (…,3) m, vel (…,3) m/s, clk_m (clock correction in
    metres incl. the relativistic term), clk_rate_ms (m/s), tgd_s.
    The orbit is evaluated at tk = (t − clkcorr) − toe (svPosVel.m:61-72).
    """
    t = f64(t, eph.toe.device)
    tkc = _wrap_week(t - eph.toc)
    clkcorr = (eph.af0 + eph.af1 * tkc + eph.af2 * tkc * tkc) - eph.tgd
    tk = _wrap_week((t - clkcorr) - eph.toe)

    a = eph.sqrta * eph.sqrta
    n0 = torch.sqrt(MU_EARTH / (a * a * a))
    n = n0 + eph.deltan
    mk = torch.remainder(eph.m0 + n * tk + 2 * GPS_PI, 2 * GPS_PI)

    ek = mk
    for _ in range(12):
        ek = mk + eph.ecc * torch.sin(ek)
    ek = torch.remainder(ek + 2 * GPS_PI, 2 * GPS_PI)
    cek, sek = torch.cos(ek), torch.sin(ek)
    c1 = 1.0 - eph.ecc * cek
    ek_dot = n / c1
    c2 = torch.sqrt(1.0 - eph.ecc * eph.ecc)
    vk = torch.atan2(c2 * sek / c1, (cek - eph.ecc) / c1)
    vk_dot = ek_dot * c2 / c1

    phik = torch.remainder(vk + eph.w, 2 * GPS_PI)
    c2p, s2p = torch.cos(2 * phik), torch.sin(2 * phik)

    uk = phik + eph.cus * s2p + eph.cuc * c2p
    uk_dot = vk_dot * (1.0 + 2.0 * (eph.cus * c2p - eph.cuc * s2p))
    rk = a * c1 + eph.crs * s2p + eph.crc * c2p
    rk_dot = (a * eph.ecc * ek_dot * sek
              + 2.0 * vk_dot * (eph.crs * c2p - eph.crc * s2p))
    ik = eph.i0 + eph.cis * s2p + eph.cic * c2p + eph.idot * tk
    ik_dot = eph.idot + vk_dot * 2.0 * (eph.cis * c2p - eph.cic * s2p)

    cuk, suk = torch.cos(uk), torch.sin(uk)
    xxk = rk * cuk
    yyk = rk * suk
    xxk_dot = rk_dot * cuk - uk_dot * rk * suk
    yyk_dot = rk_dot * suk + uk_dot * rk * cuk

    omgk = torch.remainder(eph.omega0 + (eph.omegadot - OMEGA_E_DOT) * tk
                           - OMEGA_E_DOT * eph.toe + 2 * GPS_PI, 2 * GPS_PI)
    odot = eph.omegadot - OMEGA_E_DOT
    co, so = torch.cos(omgk), torch.sin(omgk)
    ci, si = torch.cos(ik), torch.sin(ik)

    pos = torch.stack([
        xxk * co - yyk * ci * so,
        xxk * so + yyk * ci * co,
        yyk * si,
    ], dim=-1)
    vel = torch.stack([
        xxk_dot * co - odot * xxk * so - yyk_dot * ci * so
        + ik_dot * yyk * si * so - odot * yyk * ci * co,
        xxk_dot * so + odot * xxk * co + yyk_dot * ci * co
        - ik_dot * yyk * si * co - odot * yyk * ci * so,
        yyk_dot * si + ik_dot * yyk * ci,
    ], dim=-1)

    c3 = F_REL * eph.ecc * eph.sqrta
    clk_m = C_LIGHT * (eph.af0 + eph.af1 * tkc + eph.af2 * tkc * tkc
                       + c3 * sek)
    clk_rate_ms = C_LIGHT * (eph.af1 + 2.0 * eph.af2 * tkc
                             + c3 * cek * ek_dot)
    return {"pos": pos, "vel": vel, "clk_m": clk_m,
            "clk_rate_ms": clk_rate_ms,
            "tgd_s": eph.tgd.expand_as(clk_m)}
