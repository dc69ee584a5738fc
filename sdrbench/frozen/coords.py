"""WGS-84 coordinate transforms (ECEF ↔ LLH ↔ local ENU), torch float64.

Equivalents of the reference's `geo/xyz2llh.m` (Kaplan's closed form),
`geo/llh2xyz.m` and `geo/xyz2enu.m`.  Inputs may be tensors or array-likes;
they batch over leading axes and stay on the input's device.
"""

from __future__ import annotations

import numpy as np
import torch

WGS84_A = 6378137.0
WGS84_B = 6356752.3142
WGS84_F = 1.0 / 298.257223563


def f64(x, device=None) -> torch.Tensor:
    """`x` as a float64 tensor (on `device`, else where it already is)."""
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = x.copy()
    return torch.as_tensor(x, dtype=torch.float64, device=device)


def xyz2llh(xyz) -> torch.Tensor:
    """ECEF (…,3) [m] → (lat rad, lon rad, height m) (…,3), Kaplan's
    closed-form solution (geo/xyz2llh.m)."""
    xyz = f64(xyz)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    a, b = WGS84_A, WGS84_B
    e2 = 1.0 - (b / a) ** 2
    ep = (e2 ** 0.5) * (a / b)
    b2 = b * b
    z2 = z * z
    r = torch.sqrt(x * x + y * y)
    r2 = r * r
    E2 = a * a - b * b
    F = 54.0 * b2 * z2
    G = r2 + (1.0 - e2) * z2 - e2 * E2
    c = (e2 * e2) * 54.0 * b2 * (z2 / G) * (r2 / G) / G
    s = (1.0 + c + torch.sqrt(c * c + 2.0 * c)) ** (1.0 / 3.0)
    P = F / (3.0 * (s + 1.0 / s + 1.0) ** 2 * G * G)
    Q = torch.sqrt(1.0 + 2.0 * e2 * e2 * P)
    ro = -(P * e2 * r) / (1.0 + Q) + torch.sqrt(torch.clamp(
        (a * a / 2.0) * (1.0 + 1.0 / Q)
        - (P * (1.0 - e2) * z2) / (Q * (1.0 + Q)) - P * r2 / 2.0, min=0.0))
    tmp = (r - e2 * ro) ** 2
    U = torch.sqrt(tmp + z2)
    V = torch.sqrt(tmp + (1.0 - e2) * z2)
    zo = (b2 * z) / (a * V)
    height = U * (1.0 - b2 / (a * V))
    lat = torch.atan((z + ep * ep * zo) / r)
    lon = torch.atan2(y, x)
    return torch.stack([lat, lon, height], dim=-1)


def llh2xyz(llh) -> torch.Tensor:
    """(lat rad, lon rad, height m) (…,3) → ECEF (…,3) [m] (geo/llh2xyz.m)."""
    llh = f64(llh)
    lat, lon, ht = llh[..., 0], llh[..., 1], llh[..., 2]
    e2 = (2.0 - WGS84_F) * WGS84_F
    slat, clat = torch.sin(lat), torch.cos(lat)
    r_n = WGS84_A / torch.sqrt(1.0 - e2 * slat * slat)
    x = (r_n + ht) * clat * torch.cos(lon)
    y = (r_n + ht) * clat * torch.sin(lon)
    z = (r_n * (1.0 - e2) + ht) * slat
    return torch.stack([x, y, z], dim=-1)


def enu_rotation(org_llh: torch.Tensor) -> torch.Tensor:
    """(…,3,3) rotation ECEF→ENU at the origin's latitude/longitude."""
    lat, lon = org_llh[..., 0], org_llh[..., 1]
    sp, cp = torch.sin(lat), torch.cos(lat)
    sl, cl = torch.sin(lon), torch.cos(lon)
    return torch.stack([
        torch.stack([-sl, cl, torch.zeros_like(sl)], dim=-1),
        torch.stack([-sp * cl, -sp * sl, cp], dim=-1),
        torch.stack([cp * cl, cp * sl, sp], dim=-1),
    ], dim=-2)


def xyz2enu(xyz, org_xyz) -> torch.Tensor:
    """ECEF point → ENU relative to an ECEF origin (geo/xyz2enu.m)."""
    xyz = f64(xyz)
    org = f64(org_xyz, xyz.device)
    R = enu_rotation(xyz2llh(org))
    return torch.einsum("...ij,...j->...i", R, xyz - org)


def elevation_azimuth(sv_xyz, usr_xyz):
    """(elevation rad, azimuth rad) of an SV seen from the user:
    el = atan2(U, ‖EN‖), az = atan2(E, N) (trackingCT_POS_updated.m:492-494)."""
    enu = xyz2enu(sv_xyz, usr_xyz)
    el = torch.atan2(enu[..., 2], torch.linalg.norm(enu[..., :2], dim=-1))
    az = torch.atan2(enu[..., 0], enu[..., 1])
    return el, az
