"""Earth-rotation (Sagnac) correction — equivalent of geo/erotcorr.m."""

from __future__ import annotations

import torch

from sdrbench.frozen.coords import f64

OMEGA_E = 7.2921151467e-5
C_LIGHT = 299_792_458.0


def earth_rotation_correction(sv_xyz, pseudorange_m) -> torch.Tensor:
    """Rotate SV ECEF position by ωe·pr/c about z (erotcorr.m:28-35).
    Batched: sv_xyz (…,3), pseudorange_m (…)."""
    sv_xyz = f64(sv_xyz)
    theta = OMEGA_E * f64(pseudorange_m, sv_xyz.device) / C_LIGHT
    c, s = torch.cos(theta), torch.sin(theta)
    x, y, z = sv_xyz[..., 0], sv_xyz[..., 1], sv_xyz[..., 2]
    return torch.stack([c * x + s * y, -s * x + c * y, z], dim=-1)
