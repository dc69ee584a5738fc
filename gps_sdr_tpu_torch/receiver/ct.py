"""Conventional-tracking positioning: measurement epochs + WLS PVT.

The reference fuses tracking and WLS in one MATLAB loop
(`trackingCT_POS_updated.m`), but the coupling is one-directional: the
WLS result never feeds back into the DLL/PLL.  So the tracking segment
runs on the device first and the measurement epochs are formed from the
recorded per-block state afterwards, on the host in float64 (torch CPU
tensors for the geometry and the solves):

- measurement epoch grid anchored at the first common subframe sample
  (trackingCT_POS_updated.m:151-164),
- per-channel code-phase interpolation to the common measurement sample
  → transmit times (…:437-458),
- pseudoranges from a local clock initialized at max(transmitTime)+75 ms,
  corrected by the estimated bias each epoch (…:462-466,550-554),
- SV positions/clocks at transmit time, Sagnac, Klobuchar, UNB3 (…:472-505),
- iterated LS position + DOP, Doppler velocity LS (…:512-514).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from gps_sdr_tpu_torch.config import C_LIGHT, L1_WAVELENGTH, ReceiverConfig
from gps_sdr_tpu_torch.geo.atmosphere import klobuchar_delay, tropo_unb3_delay
from gps_sdr_tpu_torch.geo.coords import elevation_azimuth, xyz2enu, xyz2llh
from gps_sdr_tpu_torch.geo.earth import earth_rotation_correction
from gps_sdr_tpu_torch.geo.ephemeris import Ephemeris, sv_pos_vel_clock
from gps_sdr_tpu_torch.navdecode import EphemerisRecord
from gps_sdr_tpu_torch.positioning.wls import (doppler_velocity_ls,
                                               iterated_ls_position)
from gps_sdr_tpu_torch.tracking import TrackRecords
from gps_sdr_tpu_torch.utils.metrics import cn0_series, gate_mask


@dataclasses.dataclass
class NavSolutions:
    """WLS navigation solutions, one row per epoch — the reference's
    `navSolutionsWLS` record (trackingCT_POS_updated.m:509-554)."""

    usr_pos: np.ndarray        # (E,3) ECEF
    usr_vel: np.ndarray        # (E,3) ECEF
    usr_pos_enu: np.ndarray    # (E,3) vs initial/truth position
    usr_pos_llh: np.ndarray    # (E,3) lat/lon deg, height m
    clk_bias_m: np.ndarray     # (E,)
    usr_vel_enu: np.ndarray
    clk_drift_ms: np.ndarray
    dop: np.ndarray            # (E,4)
    sat_el_deg: np.ndarray     # (E,N)
    sat_az_deg: np.ndarray
    transmit_time: np.ndarray  # (E,N)
    raw_pseudorange: np.ndarray
    code_phase_meas: np.ndarray
    local_time: np.ndarray     # (E,)
    cn0_dbhz: np.ndarray = None       # (E,N) moment-method C/N0
    valid: np.ndarray = None          # (E,N) channels in the solution


def first_subframe_sample(records: TrackRecords, ch: int, nav1_ms: int,
                          sfb1: int) -> float:
    """Absolute sample of the first decoded subframe start
    (trackingCT_POS_updated.m:156): abs_sample[nav1 + sfb·20] (1-based)."""
    return float(records.absolute_sample[nav1_ms + sfb1 * 20 - 1, ch])


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def run_ct_positioning(records: TrackRecords, cfg: ReceiverConfig,
                       prns: Sequence[int],
                       eph: Dict[int, EphemerisRecord],
                       sbf: Dict[str, Dict[int, int]],
                       init_pos_ecef, pdi_ms_per_block=1,
                       max_epochs: int | None = None,
                       meas_start_sample: float | None = None,
                       local_time_advance_s: float | None = None,
                       doppler_at_fire_row: bool = False,
                       mesh=None) -> NavSolutions:
    """Form WLS solutions from a tracked segment whose state started at the
    eph-decoding run's origin (skip·S + S − codedelay + 1).

    `pdi_ms_per_block` is the coherent length of each record row: a
    scalar, a (T,) vector or a (T, N) matrix; transmit times use each
    channel's own elapsed-ms cumsum (…:458).

    The three options replay records the reference wrote itself:
    `meas_start_sample` gives the first measurement sample (the reference
    anchors it in its eph record, which predates its POS record's rows,
    …:151-164); `local_time_advance_s` the per-epoch local-clock advance
    (the reference's measSampleStep counts bytes, …:164,554, so its
    localTime steps twice the epoch on IQ data; only clkBias and localTime
    show it); `doppler_at_fire_row=True` feeds the velocity LS the carrier
    frequency of the first row at which every channel has passed the
    measurement sample, one common row as the reference's live loop
    variable is (…:513-514), instead of each channel's own row.

    `mesh` (a `parallel.mesh.Mesh`) solves every epoch with the channel
    axis sharded over its ranks: the normal equations of the iterated LS,
    the DOP and the velocity LS reduced over the ranks, with the validity
    weights (`parallel/epoch.make_epoch_solver`); the fixes agree with the
    host solver's to float64 round-off.
    """
    sig, cmn, solu = cfg.signal, cfg.cmn, cfg.solu
    fs = sig.fs
    n_ch = len(prns)
    T = records.absolute_sample.shape[0]
    pdi = (np.full((T, n_ch), pdi_ms_per_block)
           if np.isscalar(pdi_ms_per_block)
           else np.asarray(pdi_ms_per_block))
    if pdi.ndim == 1:
        pdi = np.broadcast_to(pdi[:, None], (T, n_ch))
    ms_elapsed = np.cumsum(pdi, axis=0)              # (T, N): ms at block end

    eph_struct = Ephemeris.stack([eph[p].latest(0) for p in prns], "cpu")
    tow1 = np.array([eph[p].tow[0] for p in prns])
    nav1 = np.array([sbf["nav1"][p] for p in prns])
    sfb1 = np.array([eph[p].sfb[0] for p in prns])

    if meas_start_sample is None:
        anchor_rows = nav1 + sfb1 * 20 - 1
        if anchor_rows.max() >= T:
            raise ValueError(
                f"CT record ({T} rows) does not reach the first-subframe "
                f"anchor at row {int(anchor_rows.max())} (decoded nav1 + "
                "sfb1·20) — track more ms or decode with a smaller "
                "start_offset_ms")
        meas_start = max(first_subframe_sample(records, ch, int(nav1[ch]),
                                               int(sfb1[ch]))
                         for ch in range(n_ch)) + 1
    else:
        meas_start = float(meas_start_sample)
    sample_end = records.absolute_sample[-1].min() - 1
    meas_step = int(fs * solu.nav_sol_period_ms / 1000)
    lt_advance = (meas_step / fs if local_time_advance_s is None
                  else float(local_time_advance_s))

    abs_s = records.absolute_sample            # (T, N)
    chan = np.arange(n_ch)
    out: Dict[str, List] = {k: [] for k in (
        "usr_pos", "usr_vel", "enu", "llh", "clk_bias", "vel_enu",
        "clk_drift", "dop", "el", "az", "tt", "pr", "cpm", "lt",
        "cn0", "valid")}

    # measurement-validity gate: per-row post-correlation SNR
    cn0_rows, gate_rows = cn0_series(records.p_i, records.p_q,
                                     t_coh_s=pdi * 1e-3, window=20,
                                     gated=True)
    mask_thresh = float(getattr(solu, "mask_snr_db", 0.0))
    valid_rows = (gate_mask(gate_rows, mask_thresh) if mask_thresh > 0
                  else np.ones_like(gate_rows, bool))

    epoch_solver = None
    if mesh is not None and mesh.size > 1:
        from gps_sdr_tpu_torch.parallel.epoch import make_epoch_solver
        epoch_solver = make_epoch_solver(mesh, L1_WAVELENGTH)

    init_pos = np.asarray(init_pos_ecef, np.float64)
    est = torch.as_tensor(np.concatenate([init_pos, [0.0]]),
                          dtype=torch.float64)
    local_time = np.inf
    epoch = 0
    while max_epochs is None or epoch < max_epochs:
        cur = meas_start + meas_step * epoch
        if cur > sample_end:
            break
        # last block whose end sample ≤ current measurement sample
        idx = np.array([np.searchsorted(abs_s[:, ch], cur, side="right") - 1
                        for ch in range(n_ch)])
        if np.any(idx < 0) or np.any(idx >= T - 1):
            break
        step_chips = records.code_freq[idx, chan] / fs
        code_phase = (records.rem_chip[idx, chan]
                      + step_chips * (cur - abs_s[idx, chan]))
        transmit_time = (code_phase / sig.code_length / 1000.0
                         + (ms_elapsed[idx, chan] - (nav1 + sfb1 * 20))
                         / 1000.0 + tow1)

        if np.isinf(local_time):
            local_time = transmit_time.max() + 75e-3  # assumed travel time
        pseudorange = (local_time - transmit_time) * C_LIGHT

        sv = sv_pos_vel_clock(eph_struct, transmit_time)
        prvec = (torch.as_tensor(pseudorange) + sv["clk_m"]
                 - sv["tgd_s"] * C_LIGHT)
        sv_pos_rot = earth_rotation_correction(sv["pos"], prvec)

        el, az = elevation_azimuth(sv_pos_rot, est[:3])
        llh = xyz2llh(est[:3])
        iono = klobuchar_delay(transmit_time, sv_pos_rot, est[:3],
                               cmn.iono_alpha, cmn.iono_beta)
        tropo = torch.abs(tropo_unb3_delay(
            cmn.day_of_year, torch.rad2deg(llh[0]), llh[2],
            torch.rad2deg(el)))
        prvec = prvec - iono - tropo

        m = valid_rows[idx, chan]
        if m.sum() < 4:
            # not enough healthy channels to gate — keep the fix ungated
            m = np.ones(n_ch, bool)
        mt = torch.as_tensor(m)
        # Doppler observable (carrFreq − IF), as the reference passes it
        # (trackingCT_POS_updated.m:514)
        dop_rows = (np.full(n_ch, min(int(idx.max()) + 1, T - 1))
                    if doppler_at_fire_row else idx)
        doppler = torch.as_tensor(records.carr_freq[dop_rows, chan]
                                  - sig.f_if)
        if epoch_solver is not None:
            est, dop, vel, clk_drift = epoch_solver(
                prvec, sv_pos_rot, sv["vel"], doppler, sv["clk_rate_ms"], m,
                est)
        else:
            est, dop = iterated_ls_position(prvec[mt], sv_pos_rot[mt], est)
            vel, clk_drift, _ = doppler_velocity_ls(
                est[:3], sv_pos_rot[mt], sv["vel"][mt], doppler[mt],
                L1_WAVELENGTH, sv["clk_rate_ms"][mt])

        enu = xyz2enu(est[:3], init_pos)
        vel_enu = xyz2enu(est[:3] + vel, est[:3])
        llh_out = xyz2llh(est[:3])

        out["usr_pos"].append(_np(est[:3]))
        out["usr_vel"].append(_np(vel))
        out["enu"].append(_np(enu))
        out["llh"].append(np.array([np.rad2deg(float(llh_out[0])),
                                    np.rad2deg(float(llh_out[1])),
                                    float(llh_out[2])]))
        out["clk_bias"].append(float(est[3]))
        out["vel_enu"].append(_np(vel_enu))
        out["clk_drift"].append(float(clk_drift))
        out["dop"].append(_np(dop))
        out["el"].append(np.rad2deg(_np(el)))
        out["az"].append(np.rad2deg(_np(az)))
        out["tt"].append(transmit_time)
        out["pr"].append(pseudorange)
        out["cpm"].append(code_phase)
        out["cn0"].append(cn0_rows[idx, chan])
        out["valid"].append(m)
        # local clock feedback (trackingCT_POS_updated.m:550-554)
        local_time = local_time - float(est[3]) / C_LIGHT
        out["lt"].append(local_time)
        local_time = local_time + lt_advance
        epoch += 1

    return NavSolutions(
        usr_pos=np.asarray(out["usr_pos"]), usr_vel=np.asarray(out["usr_vel"]),
        usr_pos_enu=np.asarray(out["enu"]), usr_pos_llh=np.asarray(out["llh"]),
        clk_bias_m=np.asarray(out["clk_bias"]),
        usr_vel_enu=np.asarray(out["vel_enu"]),
        clk_drift_ms=np.asarray(out["clk_drift"]), dop=np.asarray(out["dop"]),
        sat_el_deg=np.asarray(out["el"]), sat_az_deg=np.asarray(out["az"]),
        transmit_time=np.asarray(out["tt"]),
        raw_pseudorange=np.asarray(out["pr"]),
        code_phase_meas=np.asarray(out["cpm"]),
        local_time=np.asarray(out["lt"]),
        cn0_dbhz=np.asarray(out["cn0"]),
        valid=np.asarray(out["valid"]))
