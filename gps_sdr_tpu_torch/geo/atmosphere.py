"""Atmospheric delay models, torch float64: Klobuchar ionosphere + UNB3
troposphere.

Equivalents of the reference's `geo/ionocorr.m` (GPSoft 8-coefficient
broadcast Klobuchar) and `geo/trop_UNB3.m` + `Get_UNB3_Model.m` +
`Trop_Saastamoinen_UNB3_Components.m` + `Trop_Black_Eisner_Map.m`
(Saastamoinen zenith delays from the UNB3 5-latitude table with annual
cycle, Black & Eisner mapping).
"""

from __future__ import annotations

import functools
import math

import torch

from gps_sdr_tpu_torch.geo.coords import f64, xyz2enu, xyz2llh

C_LIGHT = 299_792_458.0


def klobuchar_delay(gps_tow_s, sv_xyz, usr_xyz, alpha, beta) -> torch.Tensor:
    """Klobuchar ionospheric group delay [m].

    Faithful to geo/ionocorr.m including its use of the *satellite* LLH
    for the "user" latitude/longitude terms (ionocorr.m:24,34,40).
    """
    sv_xyz = f64(sv_xyz)
    dev = sv_xyz.device
    alpha = f64(alpha, dev)
    beta = f64(beta, dev)
    sv_llh = xyz2llh(sv_xyz)
    enu = xyz2enu(sv_xyz, usr_xyz)
    el = torch.atan2(enu[..., 2], torch.linalg.norm(enu[..., :2], dim=-1))
    az = torch.atan2(enu[..., 0], enu[..., 1])
    E = el / math.pi    # semicircles
    F = 1.0 + 16.0 * (0.53 - E) ** 3
    psi = 0.00137 / (E + 0.11) - 0.022

    phiu = sv_llh[..., 0] / math.pi
    phii = torch.clamp(phiu + psi * torch.cos(az), -0.416, 0.416)
    lambdau = sv_llh[..., 1] / math.pi
    lambdai = lambdau + psi * torch.sin(az) / torch.cos(phii * math.pi)
    phim = phii + 0.064 * torch.cos((lambdai - 1.616) * math.pi)

    t = torch.remainder(4.32e4 * lambdai + f64(gps_tow_s, dev), 86400.0)
    per = beta[0] + beta[1] * phim + beta[2] * phim ** 2 + beta[3] * phim ** 3
    per = torch.clamp(per, min=72000.0)
    x = 2.0 * math.pi * (t - 50400.0) / per
    amp = (alpha[0] + alpha[1] * phim + alpha[2] * phim ** 2
           + alpha[3] * phim ** 3)
    amp = torch.clamp(amp, min=0.0)
    t_iono = torch.where(torch.abs(x) < 1.57,
                         F * (5e-9 + amp * (1.0 - x * x / 2.0 + x ** 4 / 24.0)),
                         F * 5e-9)
    return t_iono * C_LIGHT


# UNB3 look-up tables: lat [deg], P0 [mbar], T0 [K], WVP [mbar], beta, lambda
_UNB3_AVG = (
    (15.0, 1013.25, 299.65, 26.31, 0.00630, 2.77),
    (30.0, 1017.25, 294.15, 21.79, 0.00605, 3.15),
    (45.0, 1015.75, 283.15, 11.66, 0.00558, 2.57),
    (60.0, 1011.75, 272.15, 6.78, 0.00539, 1.81),
    (75.0, 1013.00, 263.65, 4.11, 0.00453, 1.55),
)
_UNB3_AMP = (
    (15.0, 0.00, 0.00, 0.00, 0.00000, 0.00),
    (30.0, -3.75, 7.00, 8.85, 0.00025, 0.33),
    (45.0, -2.25, 11.00, 7.24, 0.00032, 0.46),
    (60.0, -1.75, 15.00, 5.36, 0.00081, 0.74),
    (75.0, -0.50, 14.50, 3.39, 0.00062, 0.30),
)

_UNB3_GM = 9.80665
_UNB3_RD = 287.054
_UNB3_K1 = 0.000077604
_UNB3_K2 = 0.382


@functools.lru_cache(maxsize=None)
def _unb3_tables(device: torch.device):
    """The two look-up tables on `device`, copied there once: a step that
    is captured into a CUDA graph may not copy from the host."""
    return f64(_UNB3_AVG, device), f64(_UNB3_AMP, device)


def _unb3_surface(doy: torch.Tensor, lat_deg: torch.Tensor,
                  alt_m: torch.Tensor):
    """Interpolated UNB3 met values at altitude (Get_UNB3_Model.m)."""
    avg_t, amp_t = _unb3_tables(lat_deg.device)
    doy = torch.where(lat_deg < 0.0, doy - 211.0, doy - 28.0)
    cosphs = torch.cos(doy * 2.0 * math.pi / 365.25)
    lat = torch.abs(lat_deg)
    p1 = torch.clamp(torch.floor((lat - 15.0) / 15.0).to(torch.int64), 0, 4)
    p2 = torch.clamp(p1 + 1, 0, 4)
    same = (lat >= 75.0) | (lat <= 15.0)
    p1 = torch.where(lat <= 15.0, torch.zeros_like(p1),
                     torch.where(lat >= 75.0, torch.full_like(p1, 4), p1))
    p2 = torch.where(same, p1, p2)
    denom = torch.where(same, torch.ones_like(lat),
                        avg_t[p2, 0] - avg_t[p1, 0])
    m = torch.where(same, torch.zeros_like(lat),
                    (lat - avg_t[p1, 0]) / denom)

    avg = avg_t[p1, 1:] + m[..., None] * (avg_t[p2, 1:] - avg_t[p1, 1:])
    amp = amp_t[p1, 1:] + m[..., None] * (amp_t[p2, 1:] - amp_t[p1, 1:])
    surf = avg - amp * cosphs[..., None]
    p0, t0, wvp0, beta, lam = (surf[..., 0], surf[..., 1], surf[..., 2],
                               surf[..., 3], surf[..., 4])
    ep = _UNB3_GM / _UNB3_RD
    t = t0 - beta * alt_m
    p = p0 * (t / t0) ** (ep / beta)
    wvp = wvp0 * (t / t0) ** (ep * (lam + 1.0) / beta - 1.0)
    return t, t0, p, wvp, beta, lam


def tropo_unb3_delay(doy, lat_deg, alt_m, el_deg) -> torch.Tensor:
    """UNB3 tropospheric delay [m]: Saastamoinen zenith × Black & Eisner
    map (trop_UNB3.m: the dry map reused for wet)."""
    el_deg = f64(el_deg)
    dev = el_deg.device
    doy, lat_deg, alt_m = (f64(doy, dev), f64(lat_deg, dev), f64(alt_m, dev))
    doy, lat_deg, alt_m, el_deg = torch.broadcast_tensors(
        doy, lat_deg, alt_m, el_deg)
    t, t0, p, wvp, beta, lam = _unb3_surface(doy, lat_deg, alt_m)
    k_dry = p * _UNB3_K1 * _UNB3_RD / _UNB3_GM
    k_wet = wvp * _UNB3_K2 * _UNB3_RD / (
        (_UNB3_GM * (lam + 1.0) - beta * _UNB3_RD) * t0)
    cos_el = torch.cos(torch.deg2rad(el_deg))
    m_dry = 1.0 / torch.sqrt(1.0 - cos_el * cos_el / 1.002001)
    return k_dry * m_dry + k_wet * m_dry
