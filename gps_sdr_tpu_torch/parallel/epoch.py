"""Channel-sharded measurement-epoch solvers.

At a WLS epoch every channel contributes one geometry row and one residual
(trackingCT_POS_updated.m:512-514).  With the channels sharded over ranks,
the normal equations HᵀWH (4×4) and HᵀWy (4,) are formed on each rank from
its rows and reduced with `Mesh.reduce_sum` (added in rank order, so every
rank holds the same bits); every rank then solves the same 4×4 system.  The
counterpart of the JAX package's `gps_sdr_tpu/parallel/epoch.py`, in
float64 on the rank's device.

`sharded_wls_epoch` reproduces the whole epoch of `positioning/wls.py`
(gps_sdr_tpu/parallel/epoch.py:59-133): 10 Gauss-Newton steps, the DOP from
(HᵀWH)⁻¹, the Doppler velocity LS, with a weight per channel; padding and
gated-out rows have weight 0 and change nothing.  `receiver/ct.py` swaps it
in for the host solver when given a mesh.  Normal equations are not the
host solver's SVD least squares: the two agree to float64 round-off (1e-6
m in position, tests/test_mesh_pipeline.py's tolerances), not bit for bit.
With `mesh=None` the same equations are formed on one device, unreduced.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gps_sdr_tpu_torch.parallel.mesh import Mesh


def _reduce(mesh: Optional[Mesh]):
    return mesh.reduce_sum if mesh is not None else (lambda t: t)


def _geometry(state: torch.Tensor, sv_pos: torch.Tensor):
    """(N, 4) rows [unit(usr − sv), 1] and the (N, 1) ranges."""
    diff = state[None, :3] - sv_pos
    rng = torch.linalg.norm(diff, dim=-1, keepdim=True)
    return torch.cat([diff / rng, torch.ones_like(rng)], dim=-1), rng


def sharded_wls_normal_equations(mesh: Optional[Mesh]):
    """One Gauss-Newton step with the normal equations reduced over the
    ranks: fn(sv_pos, resid, usr) → the (4,) step, each rank passing its
    rows of sv_pos (n, 3) and resid (n,)."""
    reduce = _reduce(mesh)

    def fn(sv_pos, resid, usr):
        h, _ = _geometry(usr, sv_pos)
        ne = reduce(torch.cat([h.T @ h, (h.T @ resid)[:, None]], dim=1))
        return torch.linalg.solve(ne[:, :4], ne[:, 4])

    return fn


def sharded_wls_epoch(mesh: Optional[Mesh], n_iter: int = 10):
    """The whole WLS epoch with the channels sharded over the ranks.

    Returns fn(pr, sv_pos, sv_vel, doppler_mps, sv_clk_rate, weight,
    init_state) → (state (4,), dop (4,), vel (3,), clk_drift ()), each rank
    passing its rows (float64 tensors on its device): `pr` corrected
    pseudoranges, `sv_pos` rotated SV positions, `weight` 1.0 for channels
    in the solution and 0.0 for gated-out or padding rows.  Position from
    `n_iter` Gauss-Newton steps (olspos.m:40-53), one reduction a step; DOP
    from (HᵀWH)⁻¹ of the last geometry (olspos.m:56-61); velocity and clock
    drift from one weighted LS on `doppler_mps` = λ·(carrFreq − IF)
    (LS_SA_code_Vel.m:58-97), reduced with HᵀWH in one more reduction."""
    reduce = _reduce(mesh)

    def fn(pr, sv_pos, sv_vel, doppler_mps, sv_clk_rate, weight, init_state):
        w = weight[:, None]
        state = init_state
        for _ in range(n_iter):
            h, rng = _geometry(state, sv_pos)
            y = pr - rng[:, 0] - state[3]
            ne = reduce(torch.cat([(w * h).T @ h, ((w * h).T @ y)[:, None]],
                                  dim=1))
            state = state + torch.linalg.solve(ne[:, :4], ne[:, 4])
        h, _ = _geometry(state, sv_pos)
        y0 = doppler_mps - ((h[:, :3] * sv_vel).sum(dim=-1) - sv_clk_rate)
        ne = reduce(torch.cat([(w * h).T @ h, ((w * h).T @ y0)[:, None]],
                              dim=1))
        ata = ne[:, :4]
        q = torch.linalg.inv(ata)
        d = torch.diagonal(q)
        dop = torch.stack([torch.sqrt(torch.trace(q)),
                           torch.sqrt(d[0] + d[1] + d[2]),
                           torch.sqrt(d[0] + d[1]), torch.sqrt(d[2])])
        x = torch.linalg.solve(ata, ne[:, 4])
        return state, dop, x[:3], x[3]

    return fn


def make_epoch_solver(mesh: Optional[Mesh], wavelength_m: float,
                      device=None):
    """The host solver's calling convention for `receiver/ct.py`:
    solver(prvec, sv_pos_rot, sv_vel, doppler_hz, sv_clk_rate, valid,
    init_state) → (state, dop, vel, clk_drift) as float64 CPU tensors (the
    drift a float), from every channel's rows (the same on every rank).
    The rows are padded with zero-weight rows to a multiple of the world's
    size, each rank solves on its slice on its device (`mesh.device`, or
    `device` without a mesh)."""
    fn = sharded_wls_epoch(mesh)
    size = 1 if mesh is None else mesh.size
    dev = torch.device(device) if mesh is None else mesh.device

    def solver(prvec, sv_pos_rot, sv_vel, doppler_hz, sv_clk_rate, valid,
               init_state):
        rows = [torch.as_tensor(np.asarray(a), dtype=torch.float64)
                for a in (prvec, sv_pos_rot, sv_vel,
                          np.asarray(doppler_hz) * wavelength_m, sv_clk_rate,
                          np.asarray(valid, np.float64))]
        n = rows[0].shape[0]
        pad = (-n) % size
        if pad:
            # zero-weight rows; a repeated SV position keeps the padding
            # rows' geometry finite
            rows = [torch.cat([a, (a[:1].expand(pad, *a.shape[1:])
                                   if i == 1 else
                                   a.new_zeros((pad, *a.shape[1:])))])
                    for i, a in enumerate(rows)]
        if mesh is not None:
            rows = [a[mesh.rows(n + pad)] for a in rows]
        state, dop, vel, drift = fn(
            *(a.to(dev) for a in rows),
            torch.as_tensor(np.asarray(init_state), dtype=torch.float64,
                            device=dev))
        return state.cpu(), dop.cpu(), vel.cpu(), float(drift)

    return solver
