"""Legacy conventional-tracking positioning: a per-epoch 8-state position
EKF over *relative* pseudoranges, the reference's `trackingCT_POS.m` (the
generation `SDR_main.m` no longer calls; `solu.mode == 1`).

Where the production stage (`receiver/ct.py`) resolves an absolute
receiver clock and runs WLS per epoch, the legacy stage:

- forms pseudoranges relative to the earliest-arriving channel with a
  nominal 75 ms base travel time (`pr_est_interp.m`, here
  `positioning/relpr.py`); the huge common range offset is absorbed by the
  filter's clock-bias state,
- fuses them in a position-domain 8-state Kalman filter
  [δx δy δz vx vy vz δb ḃ] (trackingCT_POS.m:50-74,344-371): the
  position/clock components are error states re-zeroed each epoch, the
  velocity/drift components are total states carried in the filter,
- measures range rate from the carrier frequency alone,
  d_p = c·(f_carr − f_IF)/f_L1 − a·v_sv (trackingCT_POS.m:265-268).

The records come from the same tracking run as the production stage's
(on the device); the epochs are formed afterwards on the host: the
geodesy through `geo/` on CPU float64 tensors, the 8×8 filter algebra in
numpy float64.

Intentional deviations from the cited trackingCT_POS.m, kept aligned with
the production (updated) stage so the two generations compare directly:

- transmit time omits the reference's +(1/c)·sv_clk term
  (trackingCT_POS.m:291); the SV clock correction is applied to the
  pseudorange instead, as the updated stage does;
- the −tgd·c group-delay correction is applied
  (trackingCT_POS_updated.m:487), where the legacy file comments it out
  (trackingCT_POS.m:297);
- the filter epoch defaults to the config nav period (20 ms) rather than
  the reference's 1 ms, with the process noise scaled by dt/1 ms so the
  random-walk strength per unit time matches the reference tuning
  (trackingCT_POS.m:58,72-74); pass epoch_ms=1 for the exact legacy
  cadence.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np
import torch

from gps_sdr_tpu_torch.config import C_LIGHT, ReceiverConfig
from gps_sdr_tpu_torch.geo.atmosphere import klobuchar_delay, tropo_unb3_delay
from gps_sdr_tpu_torch.geo.coords import elevation_azimuth, xyz2enu, xyz2llh
from gps_sdr_tpu_torch.geo.earth import earth_rotation_correction
from gps_sdr_tpu_torch.geo.ephemeris import Ephemeris, sv_pos_vel_clock
from gps_sdr_tpu_torch.navdecode import EphemerisRecord
from gps_sdr_tpu_torch.positioning.relpr import (
    relative_pseudorange_from_transmit_time)
from gps_sdr_tpu_torch.receiver.ct import first_subframe_sample
from gps_sdr_tpu_torch.tracking import TrackRecords


@dataclasses.dataclass
class NavSolutionsKF:
    """Legacy `navSolutionsKF` record (trackingCT_POS.m:376-391)."""

    usr_pos: np.ndarray      # (E,3) ECEF
    usr_vel: np.ndarray      # (E,3) ECEF (filter total state)
    usr_pos_enu: np.ndarray  # (E,3)
    usr_pos_llh: np.ndarray  # (E,3) deg/deg/m
    clk_bias_m: np.ndarray   # (E,)
    clk_drift_ms: np.ndarray
    state: np.ndarray        # (E,8) post-update filter state
    raw_pseudorange: np.ndarray   # (E,N) relative pseudoranges
    transmit_time: np.ndarray     # (E,N)


def run_ct_positioning_kf(records: TrackRecords, cfg: ReceiverConfig,
                          prns: Sequence[int],
                          eph: Dict[int, EphemerisRecord],
                          sbf: Dict[str, Dict[int, int]],
                          init_pos_ecef: np.ndarray,
                          epoch_ms: int | None = None,
                          max_epochs: int | None = None) -> NavSolutionsKF:
    """Run the legacy position-domain EKF over a tracked segment.

    `epoch_ms` is the filter epoch period (default the config nav period;
    the reference updates every tracked ms, epoch_ms=1).  Records must be
    pdi = 1 ms rows: the legacy stage predates the 10 ms switch.
    """
    sig, cmn = cfg.signal, cfg.cmn
    fs = sig.fs
    n_ch = len(prns)
    T = records.absolute_sample.shape[0]
    if epoch_ms is None:
        epoch_ms = cfg.solu.nav_sol_period_ms

    eph_struct = Ephemeris.stack([eph[p].latest(0) for p in prns], "cpu")
    tow1 = np.array([eph[p].tow[0] for p in prns])
    nav1 = np.array([sbf["nav1"][p] for p in prns])
    sfb1 = np.array([eph[p].sfb[0] for p in prns])

    meas_start = max(first_subframe_sample(records, ch, int(nav1[ch]),
                                           int(sfb1[ch]))
                     for ch in range(n_ch)) + 1
    sample_end = records.absolute_sample[-1].min() - 1
    meas_step = int(fs * epoch_ms / 1000)
    abs_s = records.absolute_sample

    # filter constants (trackingCT_POS.m:50-74)
    dt = epoch_ms * 1e-3
    F = np.eye(8)
    F[0, 3] = F[1, 4] = F[2, 5] = F[6, 7] = dt
    P = np.diag([1e-1] * 6 + [1e0, 1e0])
    # the reference's Q is tuned for its 1 ms update (trackingCT_POS.m:
    # 72-74); random-walk noise grows linearly with the epoch interval, so
    # scale by dt/1 ms to keep the per-second strength at other cadences
    Qn = (dt / 1e-3) * 10.0 * np.diag(
        [0.1, 0.1, 0.1, 0.01, 0.01, 0.01, 10.0, 1.0])
    R = np.diag([1e-1] * n_ch + [1e-2] * n_ch)

    init_pos = np.asarray(init_pos_ecef, np.float64)
    est = init_pos.copy()
    clk_bias = 0.0
    vel = np.zeros(3)
    clk_drift = 0.0

    out = {k: [] for k in ("pos", "vel", "enu", "llh", "b", "d",
                           "state", "pr", "tt")}
    epoch = 0
    chan = np.arange(n_ch)
    while max_epochs is None or epoch < max_epochs:
        cur = meas_start + meas_step * epoch
        if cur > sample_end:
            break
        idx = np.array([np.searchsorted(abs_s[:, ch], cur, side="right") - 1
                        for ch in range(n_ch)])
        if np.any(idx < 0) or np.any(idx >= T - 1):
            break
        step_chips = records.code_freq[idx, chan] / fs
        code_phase = (records.rem_chip[idx, chan]
                      + step_chips * (cur - abs_s[idx, chan]))
        transmit_time = (code_phase / sig.code_length / 1000.0
                         + (idx + 1 - (nav1 + sfb1 * 20)) / 1000.0
                         + tow1)

        pr, _ = relative_pseudorange_from_transmit_time(transmit_time)

        sv = sv_pos_vel_clock(eph_struct, transmit_time)
        prvec = pr + (sv["clk_m"] - sv["tgd_s"] * C_LIGHT).numpy()
        # the relative pseudorange carries the filter's (huge, 75 ms-base)
        # clock offset; the Sagnac rotation needs the actual travel time,
        # so the previous epoch's clock-bias estimate comes off first
        # (trackingCT_POS.m:298 rotates by prvec − usr_clk)
        sv_pos_rot = earth_rotation_correction(sv["pos"], prvec - clk_bias)
        est_t = torch.from_numpy(est)
        llh = xyz2llh(est_t)
        iono = klobuchar_delay(transmit_time, sv_pos_rot, est_t,
                               cmn.iono_alpha, cmn.iono_beta)
        el, _ = elevation_azimuth(sv_pos_rot, est_t)
        tropo = torch.abs(tropo_unb3_delay(
            cmn.day_of_year, torch.rad2deg(llh[0]), llh[2],
            torch.rad2deg(el)))
        prvec = prvec - (iono + tropo).numpy()
        sv_pos_rot = sv_pos_rot.numpy()

        # measurement model (trackingCT_POS.m:344-356)
        dvec = sv_pos_rot - est
        r = np.linalg.norm(dvec, axis=1)
        a = dvec / r[:, None]
        H = np.zeros((2 * n_ch, 8))
        H[:n_ch, 0:3] = -a
        H[:n_ch, 6] = 1.0
        H[n_ch:, 3:6] = -a
        H[n_ch:, 7] = 1.0
        doppler_mps = C_LIGHT * (
            (records.carr_freq[idx, chan] - sig.f_if) / sig.fc)
        d_p = doppler_mps - np.einsum("ij,ij->i", sv["vel"].numpy(), a)
        pr_delta = prvec - r - clk_bias
        Z = np.concatenate([pr_delta, d_p])

        # propagate with zeroed error states (trackingCT_POS.m:357-371)
        state = np.concatenate([[0.0, 0.0, 0.0], vel, [0.0], [clk_drift]])
        state = F @ state
        P = F @ P @ F.T + Qn
        S = H @ P @ H.T + R
        K = P @ H.T @ np.linalg.inv(S)
        state = state + K @ (Z - H @ state)
        P = (np.eye(8) - K @ H) @ P

        est = est + state[:3]
        clk_bias = clk_bias + state[6]
        vel = state[3:6].copy()
        clk_drift = state[7]

        llh_out = xyz2llh(est).numpy()
        out["pos"].append(est.copy())
        out["vel"].append(vel.copy())
        out["enu"].append(xyz2enu(est, init_pos).numpy())
        out["llh"].append(np.array([np.rad2deg(llh_out[0]),
                                    np.rad2deg(llh_out[1]), llh_out[2]]))
        out["b"].append(clk_bias)
        out["d"].append(clk_drift)
        out["state"].append(state.copy())
        out["pr"].append(pr)
        out["tt"].append(transmit_time)
        epoch += 1

    return NavSolutionsKF(
        usr_pos=np.asarray(out["pos"]), usr_vel=np.asarray(out["vel"]),
        usr_pos_enu=np.asarray(out["enu"]),
        usr_pos_llh=np.asarray(out["llh"]),
        clk_bias_m=np.asarray(out["b"]),
        clk_drift_ms=np.asarray(out["d"]),
        state=np.asarray(out["state"]),
        raw_pseudorange=np.asarray(out["pr"]),
        transmit_time=np.asarray(out["tt"]))
