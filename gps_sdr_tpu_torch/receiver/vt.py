"""Vector tracking + 8-state EKF positioning (VDFLL), on one device.

The port of the JAX package's `receiver/vt.py` (the reference's
`trackingVT_POS_updated.m`): per-channel correlators, code NCOs driven by
the navigation solution, scalar PLLs, SV ephemeris evaluation, atmospheric
corrections and the error-state EKF that couples all channels.  Per ms:

1. block length from the previous code frequency (ceil, …:164), clipped to
   the block window
2. transmitTime += numSample/fs (…:181)
3. SV pos/vel/clock: full Kepler once per `kepler_update_ms` group head,
   velocity + central-gravity extrapolation between
4. predicted pseudorange (…:208-215): float64 chain at the group head,
   linearised float32 delta terms per step; iono/tropo every 100 ms
5. vector loop closure: codeFreq = f0·(1 − ΔPr/(c·Δt)) (…:218-223)
6. the correlator bank (`ops/corr_bank.BankPlan`, a prepared
   `correlator_bank`: the CUDA kernel on the card, its plain version on the
   CPU), one call per ms
7. scalar Costas PLL per channel (…:307-313)
8. code discriminator → pseudorange-error measurement, carrier →
   pseudorange-rate measurement (…:316-321, 379-382)
9. EKF predict/update on [δp(3) δv(3) δb δḃ] in float32, total state in
   float64 (…:388-442)
10. adaptive measurement noise every `r_update_ms` (…:445-467)

PyTorch's idiom: the step is a chain of small tensor operations on the
state's device that computes new values from the carry and then commits
them into the carry's fixed tensors; the records are preallocated and
written at a row index that lives on the device.  The step counter and its
three cadences (atmosphere, C/N0 window, adaptive R) are known on the
host, so they are plain Python branches that select which step runs;
nothing inside the loop reads a tensor back.  On a CUDA device each such
step is captured into a CUDA graph and replayed, the counterpart of the
JAX package's `lax.scan` over one compiled step (`vt_scan`).  Faults (a
window that leaves the chunk, a code NCO that is not finite) raise a flag
on the device that the host reads once per chunk, with the records.  The JAX
package lets a NaN block length through its clip into the int cast
(`vt.py:325`); here that raises.

With a mesh (`parallel/mesh.py`) the channel axis is sharded over a world
of ranks (`parallel/vt.py`, `run_vector_tracking(mesh=…)`): each rank runs
the per-channel work of its channels, and the EKF runs replicated on every
rank from the world's measurement rows: the line-of-sight rows gathered
once per Kepler group, z_pr, z_prr and the validity gate packed into one
tensor and gathered every ms, the transmit times and block lengths that
the record's local time needs gathered once per chunk with the records.  A
gloo collective cannot be captured in a CUDA graph, so on the card the
sharded step is replayed as two graphs, the step's two halves (`measure`,
`update`), with the gather between them on the host; the refresh, which
gathers, runs eagerly.  The unsharded step is one graph, as before.

Sign note: prr_meas = +(carrFreq − IF)·c/fc, matching prr_pred = a·(Vest −
Vs) and the H rows [0 −a 0 1] for any IF, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from gps_sdr_tpu_torch.config import C_LIGHT, ReceiverConfig
from gps_sdr_tpu_torch.geo.atmosphere import klobuchar_delay, tropo_unb3_delay
from gps_sdr_tpu_torch.geo.coords import f64, xyz2enu, xyz2llh
from gps_sdr_tpu_torch.geo.earth import earth_rotation_correction
from gps_sdr_tpu_torch.geo.ephemeris import (MU_EARTH, Ephemeris,
                                             sv_pos_vel_clock)
from gps_sdr_tpu_torch.io.ifdata import (ChunkPrefetcher, DeviceStager,
                                         IFSampleSource)
from gps_sdr_tpu_torch.ops.corr_bank import (BankPlan, correlator_bank,
                                             new_fault, raise_on_fault,
                                             tap_offsets_fp)
from gps_sdr_tpu_torch.ops.loops import (cn0_moment_estimator,
                                         loop_coefficients,
                                         pll_discriminator)
from gps_sdr_tpu_torch.ops.track_chunk import _wrap32
from gps_sdr_tpu_torch.tracking import Q32, TrackRecords, chip_tables
from gps_sdr_tpu_torch.utils.device import resolve_device


class VTState(NamedTuple):
    """Vector-tracking carry; tensors on one device."""

    # per-channel signal state, shape (N,)
    ptr: torch.Tensor              # int64
    rem_chip: torch.Tensor         # float64 unless noted
    code_freq: torch.Tensor
    carr_freq: torch.Tensor
    carr_freq_basis: torch.Tensor
    phase_fp: torch.Tensor         # int32 Q32 carrier phase
    pll_nco: torch.Tensor
    pll_last: torch.Tensor
    transmit_time: torch.Tensor    # SV transmit time [s of week]
    predicted_pr_last: torch.Tensor
    iono_m: torch.Tensor           # cached corrections
    tropo_m: torch.Tensor
    el_rad: torch.Tensor
    az_rad: torch.Tensor
    # EKF state
    total_state: torch.Tensor      # (8,) [pos, vel, clk_bias_m, clk_drift_ms]
    state_cov: torch.Tensor        # (8, 8)
    r_diag: torch.Tensor           # (2N,) measurement noise diagonal
    innov_sq_sum: torch.Tensor     # (2N,) running Z² for adaptive R
    step_count: torch.Tensor       # int32 scalar
    # measurement-validity gate: moment-method window over the prompt
    # powers; a channel whose post-correlation SNR, averaged over the last
    # 5 windows, falls below params.mask_snr_db has its rows deweighted
    zk: torch.Tensor               # (N, K) prompt-power window
    snr_hist: torch.Tensor         # (N, 5) last window SNRs [dB]
    cn0: torch.Tensor              # (N,) latest C/N0 estimate [dB-Hz]
    valid: torch.Tensor            # (N,) bool gate


# record keys of the EKF layer: the same on every rank when the channel
# axis is sharded; every other key is per channel, channel on axis 1
_VT_REC_GLOBAL = frozenset((
    "total_state", "state_cov_diag", "kalman_gain", "innovation",
    "r_diag", "loop_bw_hz", "predicted_z", "local_time"))
# VTState fields of the EKF layer: replicated across ranks, never padded or
# sliced on the channel axis
_VT_STATE_REPLICATED = frozenset((
    "total_state", "state_cov", "r_diag", "innov_sq_sum", "step_count"))

_VT_STATE_DTYPES = {"ptr": torch.int64, "phase_fp": torch.int32,
                    "step_count": torch.int32, "valid": torch.bool}


@dataclasses.dataclass(frozen=True)
class VTParams:
    pdi_ms: int = 1
    taps: Tuple[float, ...] = (0.5, 0.0, -0.5)  # VT E/P/L (…:230-232)
    i_early: int = 0
    i_prompt: int = 1
    i_late: int = 2
    pll_bw_hz: float = 15.0
    pll_damping: float = 0.707
    pll_gain: float = 0.25
    corr_update_ms: int = 100       # iono/tropo cadence (…:84-86)
    r_update_ms: int = 200          # adaptive-R cadence (…:63)
    q_pos: float = 1.0              # process noise (…:51-54)
    q_vel: float = 0.1
    q_clk: float = 0.1
    q_clkd: float = 0.01
    r_pr0: float = 0.3              # initial R (…:55-56)
    r_prr0: float = 0.1
    r_pr_max: float = 12000.0       # clamps (…:451-463)
    r_prr_max: float = 400.0
    r_min: float = 0.01
    remove_dc: bool = False
    mask_snr_db: float = 1.0        # post-correlation SNR gate (mean of the
                                    # last 5 windows); 0 disables
    cn0_window: int = 20            # K of the Zk window (trackingCT.m:120)
    r_masked: float = 1e8           # R of gated-out channels: an effective
                                    # no-op deweighting that keeps the
                                    # float32 innovation-covariance solve
                                    # conditioned (cond(S) ≲ 1e10)
    kepler_update_ms: int = 50      # full Kepler cadence; between group
                                    # heads SV motion is extrapolated
                                    # (≤1e-7 m over 50 ms).  1 = exact
                                    # per-ms solve
    replica: str = "auto"           # kept for the JAX package's artifact
                                    # stems; the port has one correlator
                                    # engine (ops/corr_bank)

    @staticmethod
    def legacy(**kw) -> "VTParams":
        """The legacy total-state VT (trackingVT_POS.m): fixed measurement
        noise (R_pr=1e-1, R_prr=1e-2, trackingVT_POS.m:75-76; adaptive R
        off) and the 1e1-scaled process noise (:74)."""
        defaults = dict(r_pr0=1e-1, r_prr0=1e-2,
                        r_update_ms=1 << 30,       # adaptive R off
                        q_pos=1.0, q_vel=0.1, q_clk=100.0, q_clkd=10.0)
        defaults.update(kw)
        return VTParams(**defaults)

    @staticmethod
    def multicorr(**kw) -> "VTParams":
        """29-tap grid 0.7:-0.05:-0.7 with the loop on the ±0.5/P taps
        (trackingVT_POS_updated.m:29,230-232; the multicorrelator variant
        records the full bank)."""
        grid = tuple(round(0.7 - 0.05 * i, 4) for i in range(29))
        defaults = dict(taps=grid, i_early=4, i_prompt=14, i_late=24)
        defaults.update(kw)
        return VTParams(**defaults)


# Group-head geometry the steps of one Kepler group linearise around:
# tt0 (N,) f64 transmit time at the head; clk_rate (N,) f64 SV clock rate
# [m/s]; pred_pr_head (N,) f64; a32 (N, 3) f32 unit line of sight; est_pos_h
# (3,) f64; clk_bias_h () f64; H (2N, 8) f32 measurement matrix; vel0_32,
# acc0_32 (N, 3) f32; clk_rate_32 (N,) f32; pos0 (N, 3) f64.
_GROUP_FIELDS = ("tt0", "clk_rate", "pred_pr_head", "a32", "est_pos_h",
                 "clk_bias_h", "H", "vel0_32", "acc0_32", "clk_rate_32",
                 "pos0")
# with a mesh, also the world's a32 (n_real, 3)
_WORLD_GROUP_FIELDS = _GROUP_FIELDS + ("a32_world",)
# what a refresh may renew in the carry
_ATMOSPHERE_FIELDS = ("iono_m", "tropo_m", "el_rad", "az_rad")


class _VTChunk:
    """One chunk of vector tracking: the constants, the carry `st`, the
    group cache `g` and the record row `row`, and the two functions that
    compute from them without changing them.

    `refresh_values(atmosphere)` gives the new group cache (and, with
    `atmosphere`, the renewed corrections); `step_values(first, window,
    r_update)` gives the carry's new values and the record row of one ms.
    The three flags are what the host knows from the step count.  With
    `mesh`, the carry's per-channel fields are this rank's slice and the
    EKF's are the world's, of `n_real` channels: both functions gather what
    the EKF needs from the other ranks.  Neither function writes into a
    tensor it was given and neither reads a tensor back (but for those
    gathers), so on a CUDA device both can be captured into a CUDA graph
    once the caller commits their values into fixed tensors (`vt_scan`).
    """

    def __init__(self, raw, chunk_start, state, chips, eph, iono_alpha,
                 iono_beta, params, fs, blk, f_if, fc, code_freq_basis, doy,
                 mesh=None, n_real=None):
        dev = raw.device
        f32, f64_, i64 = torch.float32, torch.float64, torch.int64
        self.params, self.eph, self.dev = params, eph, dev
        self.n = state.ptr.shape[0]
        # the EKF's channels: the world's real ones with a mesh
        self.mesh = mesh
        self.n_real = self.n if mesh is None else n_real
        if mesh is not None:
            self.mine = mesh.rows(self.n * mesh.size)   # this rank's slice
        self.chunk_start, self.blk = chunk_start, blk
        self.f_if, self.fc, self.code_freq_basis = f_if, fc, code_freq_basis
        tau1, tau2 = loop_coefficients(params.pll_bw_hz, params.pll_damping,
                                       params.pll_gain)
        self.tau1, self.tau2 = tau1, tau2
        self.dt = dt = params.pdi_ms * 1e-3
        self.n_chips = 1023 * params.pdi_ms

        F = torch.eye(8, dtype=f64_, device=dev)
        F[0, 3] = F[1, 4] = F[2, 5] = F[6, 7] = dt
        self.F, self.F32 = F, F.to(f32)
        self.Qm = torch.diag(torch.tensor(
            [params.q_pos] * 3 + [params.q_vel] * 3
            + [params.q_clk, params.q_clkd], dtype=f32, device=dev))
        self.eye8 = torch.eye(8, dtype=f32, device=dev)
        # divisors as device tensors: a true division on every device (CUDA
        # turns division by a host scalar into a reciprocal multiply)
        self.fs_t = torch.tensor(fs, dtype=f64_, device=dev)
        self.c_light32 = torch.tensor(C_LIGHT, dtype=f32, device=dev)
        self.bw_div = torch.tensor(4.0 * 293.0 * 1e-3, dtype=f32, device=dev)
        self.two_pi32 = torch.tensor(2.0 * math.pi, dtype=f32, device=dev)
        self.r_masked = torch.tensor(params.r_masked, dtype=f32, device=dev)
        self.zero32 = torch.zeros((), dtype=f32, device=dev)
        self.alpha, self.beta = f64(iono_alpha, dev), f64(iono_beta, dev)
        self.doy = f64(float(doy), dev)
        self.tgd_m = eph.tgd * C_LIGHT
        self.fault = new_fault(dev)
        self.bank = BankPlan(raw, chips, tap_offsets_fp(params.taps, dev), fs,
                             blk, params.remove_dc, self.fault)

        # the carry, in tensors of its own (the caller's state is not
        # written): float32 covariance loop, int64 phase word
        cast = dict(state_cov=f32, r_diag=f32, innov_sq_sum=f32,
                    phase_fp=i64)
        self.st = {k: v.to(cast.get(k, v.dtype), copy=True)
                   for k, v in state._asdict().items()}
        self.count0 = int(state.step_count)
        self.g: Dict[str, torch.Tensor] = {}
        # the record row of the next step, and with it the step count
        self.row = torch.zeros(1, dtype=i64, device=dev)

    def refresh_values(self, atmosphere: bool) -> Dict[str, torch.Tensor]:
        """Full-precision geometry once per group head: Kepler solve,
        Sagnac-rotated range, unit line of sight, measurement matrix and,
        with `atmosphere`, the corrections.  The steps extrapolate SV
        motion along velocity + central-gravity acceleration and linearise
        the predicted pseudorange around this head (second-order range
        error over a 50 ms group ≈ 4e-4 m)."""
        st, dev = self.st, self.dev
        f32 = torch.float32
        est_pos_h = st["total_state"][:3]
        clk_bias_h = st["total_state"][6]
        sv = sv_pos_vel_clock(self.eph, st["transmit_time"])
        pos0, vel0 = sv["pos"], sv["vel"]
        r3 = (pos0 * pos0).sum(dim=-1, keepdim=True) ** 1.5
        acc0 = -MU_EARTH * pos0 / r3

        new = {k: st[k] for k in _ATMOSPHERE_FIELDS}
        if atmosphere:
            enu_r = xyz2enu(pos0, est_pos_h)
            el = torch.atan2(enu_r[..., 2],
                             torch.linalg.norm(enu_r[..., :2], dim=-1))
            az = torch.atan2(enu_r[..., 0], enu_r[..., 1])
            llh = xyz2llh(est_pos_h)
            new["iono_m"] = klobuchar_delay(st["transmit_time"], pos0,
                                            est_pos_h, self.alpha, self.beta)
            new["tropo_m"] = torch.abs(tropo_unb3_delay(
                self.doy, torch.rad2deg(llh[0]), llh[2], torch.rad2deg(el)))
            new["el_rad"], new["az_rad"] = el, az

        # head pseudorange chain (…:208-215), float64, once per group
        r0 = torch.linalg.norm(pos0 - est_pos_h[None, :], dim=-1)
        corr_m = (clk_bias_h + sv["clk_m"] - self.tgd_m - new["tropo_m"]
                  - new["iono_m"])
        svp_rot = earth_rotation_correction(pos0, r0 + corr_m)
        diff = svp_rot - est_pos_h[None, :]
        r1 = torch.linalg.norm(diff, dim=-1)
        a32 = (diff / r1[:, None]).to(f32)               # unit LOS (N, 3)
        # measurement matrix (…:374-376): the LOS turns by < 1e-5 rad
        # across a group, so H is constant per group.  H is the world's:
        # with a mesh the LOS rows are gathered here, once per group
        a32_g = (a32 if self.mesh is None
                 else self.mesh.all_gather_rows(a32, self.n_real))
        nr = self.n_real
        H = torch.zeros((2 * nr, 8), dtype=f32, device=dev)
        H[:nr, 0:3] = -a32_g
        H[:nr, 6] = 1.0
        H[nr:, 3:6] = -a32_g
        H[nr:, 7] = 1.0
        if self.mesh is not None:
            new["a32_world"] = a32_g
        new.update(
            tt0=st["transmit_time"], clk_rate=sv["clk_rate_ms"],
            pred_pr_head=r1 + corr_m, a32=a32, est_pos_h=est_pos_h,
            clk_bias_h=clk_bias_h, H=H, vel0_32=vel0.to(f32),
            acc0_32=acc0.to(f32), clk_rate_32=sv["clk_rate_ms"].to(f32),
            pos0=pos0)
        return new

    def step_values(self, first: bool, window: bool, r_update: bool
                    ) -> Tuple[Dict[str, torch.Tensor],
                               Dict[str, torch.Tensor]]:
        """One ms: (the carry's new values by field, the record row).
        `first`: the step count is 0; `window`: this step closes a C/N0
        window; `r_update`: it closes an adaptive-R interval.  With a mesh
        the measurement rows are gathered between the two halves."""
        m = self.measure(first, window)
        rows = (None if self.mesh is None
                else self.mesh.all_gather_rows(m["rows"], self.n_real))
        return self.update(m, rows, r_update)

    def measure(self, first: bool, window: bool) -> Dict[str, torch.Tensor]:
        """The first half of a ms, up to this rank's measurement rows: the
        block, the prediction, the correlation, the PLL, the gate and the
        two measurements; what `update` needs, by name (with a mesh, also
        `rows`: z_pr, z_prr and the gate packed as (N, 3) float32)."""
        st, g, params, nr = self.st, self.g, self.params, self.n_real
        f32, f64_, i64 = torch.float32, torch.float64, torch.int64
        fs_t, dt, n_chips = self.fs_t, self.dt, self.n_chips
        ie, ip, il = params.i_early, params.i_prompt, params.i_late
        total0 = st["total_state"]
        est_pos = total0[:3]
        est_vel32 = total0[3:6].to(f32)
        clk_bias, clk_drift = total0[6], total0[7]
        rem, phase = st["rem_chip"], st["phase_fp"]

        # --- block length & transmit-time advance.  The clip keeps a
        # diverged code NCO inside the block window so the C/N0 gate can
        # drop the channel; a NaN passes the clip and the bank refuses it
        num = torch.clamp(
            torch.ceil((n_chips - rem) / (st["code_freq"] / fs_t)),
            1.0, float(self.blk)).to(i64)
        tt = st["transmit_time"] + num.to(f64_) / fs_t

        # --- predicted pseudorange: head value + float32 delta terms ---
        dt_e = tt - g["tt0"]                              # f64 (N,)
        dte32 = dt_e.to(f32)[:, None]
        sv_delta32 = g["vel0_32"] * dte32 \
            + (0.5 * dte32 * dte32) * g["acc0_32"]
        sv_vel32 = g["vel0_32"] + g["acc0_32"] * dte32    # (N, 3) f32
        dpos32 = (est_pos - g["est_pos_h"]).to(f32)
        if self.mesh is None:
            los_dpos = g["a32"] @ dpos32
        else:
            # the product over the world's rows, then this rank's (padding
            # rows repeat channel 0): a product over fewer rows can round
            # differently
            los_w = g["a32_world"] @ dpos32
            los_dpos = torch.cat([los_w, los_w[:1].expand(
                self.n * self.mesh.size - nr)])[self.mine]
        d_range32 = (g["a32"] * sv_delta32).sum(dim=-1) - los_dpos
        pred_pr = (g["pred_pr_head"] + (clk_bias - g["clk_bias_h"])
                   + g["clk_rate"] * dt_e + d_range32.to(f64_))
        delta_pr = (pred_pr - st["predicted_pr_last"]) / dt
        # vector loop closure; the first step keeps its start value
        code_freq = (st["code_freq"] if first else
                     self.code_freq_basis * (1.0 - delta_pr / C_LIGHT))

        # --- correlate: `num` was sized with the previous code frequency,
        # the replica steps at the new one (…:164,227-232) ---
        carr_fp = _wrap32(torch.round(st["carr_freq"] / fs_t * Q32).to(i64))
        corr = self.bank(st["ptr"] - self.chunk_start, rem, code_freq, phase,
                         carr_fp, num)
        rem_new = num.to(f64_) * (code_freq / fs_t) + rem - n_chips
        phase_new = _wrap32(phase + num * carr_fp)
        e_i, e_q = corr[:, ie, 0], corr[:, ie, 1]
        p_i, p_q = corr[:, ip, 0], corr[:, ip, 1]
        l_i, l_q = corr[:, il, 0], corr[:, il, 1]

        # --- scalar Costas PLL (…:307-313): atan(Q/I), never atan2 ---
        carr_err = pll_discriminator(p_i, p_q, self.two_pi32)
        pll = st["pll_nco"] \
            + (self.tau2 / self.tau1) * (carr_err - st["pll_last"]) \
            + carr_err * (dt / self.tau1)
        carr_freq = st["carr_freq_basis"] + pll

        # --- measurement-validity gate: moment-method window over the
        # prompt powers, refreshed every K blocks; the gate is the
        # post-correlation SNR averaged over the last 5 windows, with a
        # 3 dB hysteresis so a dead channel does not flicker back in ---
        col = torch.remainder(self.row + self.count0, params.cn0_window)
        zk = st["zk"].index_copy(
            1, col, (p_i.to(f64_) ** 2 + p_q.to(f64_) ** 2)[:, None])
        snr_hist, cn0, valid = st["snr_hist"], st["cn0"], st["valid"]
        if window:
            snr = cn0_moment_estimator(zk, 1.0, signed=True)
            cn0 = snr - 10.0 * math.log10(dt)
            snr_hist = torch.cat([snr_hist[:, 1:], snr[:, None]], dim=1)
            if params.mask_snr_db > 0:
                m5 = snr_hist.mean(dim=1)
                valid = torch.where(valid, m5 >= params.mask_snr_db,
                                    m5 >= params.mask_snr_db + 3.0)
            else:
                valid = torch.ones_like(valid)

        # --- DLL discriminator → pseudorange-error measurement (…:316-321)
        e = torch.sqrt(e_i * e_i + e_q * e_q)
        l = torch.sqrt(l_i * l_i + l_q * l_q)
        code_err = -0.5 * (e - l) / torch.clamp(e + l, min=1e-30)   # f32
        z_pr = code_err * (self.c_light32 / code_freq.to(f32))
        # carrier → pseudorange-rate measurement (see the sign note)
        prr_meas = ((carr_freq - self.f_if) * (C_LIGHT / self.fc)).to(f32)
        prr_pred = ((est_vel32[None, :] - sv_vel32) * g["a32"]).sum(dim=-1)
        z_prr = prr_pred - prr_meas - clk_drift.to(f32) + g["clk_rate_32"]
        out = dict(total0=total0, num=num, tt=tt, sv_delta32=sv_delta32,
                   sv_vel32=sv_vel32, pred_pr=pred_pr, delta_pr=delta_pr,
                   code_freq=code_freq, corr=corr, rem_new=rem_new,
                   phase_new=phase_new, carr_err=carr_err, pll=pll,
                   carr_freq=carr_freq, zk=zk, snr_hist=snr_hist, cn0=cn0,
                   valid=valid, code_err=code_err, z_pr=z_pr, z_prr=z_prr)
        if self.mesh is not None:
            out["rows"] = torch.stack([z_pr, z_prr, valid.to(f32)], dim=1)
        return out

    def update(self, m: Dict[str, torch.Tensor],
               rows: Optional[torch.Tensor], r_update: bool
               ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """The second half of a ms from `measure`'s values and, with a
        mesh, the world's measurement rows `rows` (n_real, 3): the EKF
        update, the adaptive R, then (the carry's new values, the record
        row)."""
        st, g, params, nr = self.st, self.g, self.params, self.n_real
        f64_ = torch.float64
        fs_t = self.fs_t
        total0, num, tt, valid = m["total0"], m["num"], m["tt"], m["valid"]
        if rows is None:
            z, valid_g = torch.cat([m["z_pr"], m["z_prr"]]), valid  # (2N,)
        else:
            z, valid_g = torch.cat([rows[:, 0], rows[:, 1]]), rows[:, 2] > 0

        # --- EKF predict + update (…:388-404) in float32; gated-out
        # channels have both rows deweighted by r_masked ---
        H, F32 = g["H"], self.F32
        valid2 = torch.cat([valid_g, valid_g])
        r_used = torch.where(valid2, st["r_diag"], self.r_masked)
        P = F32 @ st["state_cov"] @ F32.T + self.Qm
        PHt = P @ H.T
        S = H @ PHt + torch.diag(r_used)
        # Jacobi-scaled LU gain solve: the symmetric diagonal scaling
        # equalises the ~1e5 m² pseudorange rows against the ~1e-1 (m/s)²
        # rate rows, keeping the float32 factorisation accurate
        dsc = torch.rsqrt(torch.diagonal(S))
        S_t = S * dsc[:, None] * dsc[None, :]
        sol, _ = torch.linalg.solve_ex(S_t, (PHt * dsc[None, :]).T,
                                       check_errors=False)
        K = sol.T * dsc[None, :]
        err = K @ z
        # Joseph form stays positive semi-definite under float32 round-off
        ikh = self.eye8 - K @ H
        P = ikh @ P @ ikh.T + (K * r_used[None, :]) @ K.T
        P = 0.5 * (P + P.T)
        total = total0 + err.to(f64_)
        total_next = self.F @ total           # propagate (…:440-442)

        # --- adaptive R (…:445-467); gated-out innovations are excluded
        sq = st["innov_sq_sum"] + torch.where(valid2, z * z, self.zero32)
        r_diag = st["r_diag"]
        if r_update:
            mean_sq = sq / float(params.r_update_ms)
            r_diag = torch.cat([
                torch.clamp(mean_sq[:nr] * 10.0, params.r_min,
                            params.r_pr_max),
                torch.clamp(mean_sq[nr:], params.r_min, params.r_prr_max)])
            sq = torch.zeros_like(sq)

        abs_sample = st["ptr"] + num
        new = dict(
            ptr=abs_sample, rem_chip=m["rem_new"], code_freq=m["code_freq"],
            carr_freq=m["carr_freq"], phase_fp=m["phase_new"],
            pll_nco=m["pll"], pll_last=m["carr_err"], transmit_time=tt,
            predicted_pr_last=m["pred_pr"], total_state=total_next,
            state_cov=P, r_diag=r_diag, innov_sq_sum=sq, zk=m["zk"],
            snr_hist=m["snr_hist"], cn0=m["cn0"], valid=valid)

        rec = dict(
            corr=m["corr"], carr_err=m["carr_err"], code_err=m["code_err"],
            code_freq=m["code_freq"], carr_freq=m["carr_freq"],
            delta_pr=m["delta_pr"], num_sample=num, absolute_sample=abs_sample,
            rem_chip=m["rem_new"],
            rem_phase=torch.remainder(
                m["phase_new"].to(f64_) * (2.0 * math.pi / Q32),
                2.0 * math.pi),
            carr_nco=m["pll"],
            # extrapolated SV position (navSolutionsVT.svxyz_pos, …:431)
            # and the post-fit predicted measurement H·δx (…:433-435)
            sv_pos=g["pos0"] + m["sv_delta32"].to(f64_), predicted_z=H @ err,
            total_state=total, state_cov_diag=torch.diagonal(P),
            kalman_gain=K, innovation=z, r_diag=r_diag,
            # per-measurement equivalent loop bandwidth [Hz]:
            # diag(H·K)/4/293/0.001 (trackingVT_POS_updated_by_20210621.m:384)
            loop_bw_hz=(H * K.T).sum(dim=1) / self.bw_div,
            el=st["el_rad"], az=st["az_rad"], sv_vel=m["sv_vel32"],
            transmit_time=tt, cn0=m["cn0"], valid=valid)
        if self.mesh is None:
            # common-epoch time of the record: the earliest channel's block
            # start, tt − (num − min(num) + 1)/fs (with a mesh: `vt_scan`,
            # once a chunk, `_local_time`)
            rec["local_time"] = (tt - (num - (num.min() - 1)).to(f64_)
                                 / fs_t).min()
        return new, rec

    def atmosphere_due(self, count: int, group_len: int) -> bool:
        """The atmosphere refreshes at the group head whose steps contain a
        multiple of corr_update_ms: the cadence holds for any group length
        and chunking."""
        corr = self.params.corr_update_ms
        return ((corr - count % corr) % corr) < group_len

    def end_state(self, count: int) -> VTState:
        st = dict(self.st)
        st["phase_fp"] = st["phase_fp"].to(torch.int32)
        st["step_count"] = torch.tensor(count, dtype=torch.int32,
                                        device=self.dev)
        return VTState(**st)


def _local_time(tt: torch.Tensor, num: torch.Tensor, fs_t: torch.Tensor
                ) -> torch.Tensor:
    """`local_time` of a (T, N) record, row by row: the arithmetic of
    `_VTChunk.step_values` over the channels of each row."""
    first = num.min(dim=-1, keepdim=True).values - 1
    return (tt - (num - first).to(torch.float64) / fs_t).min(dim=-1).values


def _commit(dst: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor]
            ) -> None:
    """Write `new` into the fixed tensors `dst` (made on the first call)."""
    for k, v in new.items():
        if k not in dst:
            dst[k] = v.clone()
        elif v is not dst[k]:
            dst[k].copy_(v)


def _capture(fn, bank: BankPlan) -> Tuple[torch.cuda.CUDAGraph, int]:
    """`fn()` captured into a CUDA graph on a side stream (nothing runs),
    with the launches of `bank` it holds.  The capture draws its
    temporaries from a pool of its own; a failure raises."""
    dev = bank.device
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(dev)
    before = bank.captured
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            fn()
        finally:
            graph.capture_end()
    torch.cuda.current_stream(dev).wait_stream(side)
    return graph, bank.captured - before


def vt_scan(raw: torch.Tensor, chunk_start: int, state: VTState,
            chips: torch.Tensor, eph: Ephemeris, iono_alpha, iono_beta,
            params: VTParams, n_steps: int, fs: float, blk: int, f_if: float,
            fc: float, code_freq_basis: float, doy: int,
            graph: Optional[bool] = None, mesh=None,
            n_real: Optional[int] = None
            ) -> Tuple[VTState, Dict[str, torch.Tensor]]:
    """Run `n_steps` ms of vector tracking inside one raw chunk.

    raw (L, 2) int8/int16 IQ on the state's device, `chunk_start` the
    absolute sample of raw[0]; chips (N, 1023) float32.  Returns
    (new state, records): records are (T, …) tensors on the device plus
    `fault`, the (1,) int32 flag of `ops/corr_bank` that the caller reads
    back (`raise_on_fault`) with the records.  Reads `state.step_count`
    once on entry; nothing else crosses to the host.

    The counterpart of the JAX package's `lax.scan` over its step: the
    carry, the group cache and the records live in fixed tensors that a
    step updates in place (the records at a row index that is itself a
    device tensor), so a step is the same work every ms.  With `graph` (the
    default on a CUDA device, not available on the CPU) the refresh and the
    step are captured into CUDA graphs, one per cadence signature (refresh
    with or without the atmosphere; step that closes a C/N0 window or an
    adaptive-R interval or neither), each at first need, and replayed from
    then on; the first refresh and the first step of a call run eagerly
    (the step count may be 0 there, and the libraries set themselves up on
    their first call).  The graphs hold the chunk's address and live as
    long as the call.  Both ways give the same bits; a capture that fails
    raises.  A replayed step adds the bank launches it holds to
    `correlator_bank.launches`.

    `mesh` (a `parallel.mesh.Mesh`; see `parallel/vt.sharded_vt_scan`): the
    per-channel fields of `state`, `chips` and `eph` are this rank's slice
    of the world's channels, padded to a multiple of its size; the first
    `n_real` are real.  The EKF runs on every rank from the gathered rows,
    and the records returned are the world's: the per-channel ones gathered
    in rank order and cut to `n_real`, with `local_time` from the gathered
    transmit times and block lengths and `fault` the world's flag.  The
    state stays this rank's.  A collective cannot be captured: with `graph`
    the step is replayed as two graphs, its first half (`measure`) and its
    second (`update`), with the gather of the measurement rows between them
    on the host; the refresh, which gathers the line-of-sight rows, runs
    eagerly.
    """
    dev = raw.device
    if graph is None:
        graph = dev.type == "cuda"
    if graph and dev.type != "cuda":
        raise ValueError(f"vt_scan: CUDA graphs need a CUDA device, not {dev}")
    run = _VTChunk(raw, chunk_start, state, chips, eph, iono_alpha, iono_beta,
                   params, fs, blk, f_if, fc, code_freq_basis, doy, mesh,
                   n_real)
    recs: Dict[str, torch.Tensor] = {}
    graphs: Dict[tuple, tuple] = {}
    world_rows: Dict[str, torch.Tensor] = {}   # the gather's fixed tensor

    def refresh(atmosphere: bool) -> None:
        new = run.refresh_values(atmosphere)
        _commit(run.g, {k: new[k] for k in (
            _GROUP_FIELDS if mesh is None else _WORLD_GROUP_FIELDS)})
        _commit(run.st, {k: new[k] for k in _ATMOSPHERE_FIELDS})

    def record(new: Dict[str, torch.Tensor], rec: Dict[str, torch.Tensor]
               ) -> None:
        if not recs:
            recs.update({k: torch.empty((n_steps, *v.shape), dtype=v.dtype,
                                        device=dev) for k, v in rec.items()})
        for k, v in rec.items():
            recs[k].index_copy_(0, run.row, v.unsqueeze(0))
        _commit(run.st, new)
        run.row += 1

    def step(first: bool, window: bool, r_update: bool) -> None:
        record(*run.step_values(first, window, r_update))

    def replay(key: tuple, fn):
        """`fn()` captured under `key` at first need, then replayed; what
        the captured `fn` returned (tensors every replay rewrites)."""
        if key not in graphs:
            out = []
            graphs[key] = (*_capture(lambda: out.append(fn()), run.bank), out)
        held, launches, out = graphs[key]
        held.replay()
        correlator_bank.launches += launches
        return out[0]

    def do(fn, *flags, eager: bool) -> None:
        if eager or not graph:
            fn(*flags)
        else:
            replay((fn, *flags), lambda: fn(*flags))

    def do_split(first: bool, window: bool, r_update: bool, eager: bool
                 ) -> None:
        """The sharded step: `measure` and `update` replayed with the
        measurement rows gathered between them."""
        if eager or not graph:
            step(first, window, r_update)
            return
        flags = (first, window, r_update)
        m = replay(("measure", *flags), lambda: run.measure(first, window))
        rows = mesh.all_gather_rows(m["rows"], n_real)
        if "rows" in world_rows:
            world_rows["rows"].copy_(rows)
        else:
            world_rows["rows"] = rows
        replay(("update", *flags), lambda: record(
            *run.update(m, world_rows["rows"], r_update)))

    count = run.count0
    group = max(1, int(params.kepler_update_ms))
    done = 0
    while done < n_steps:
        n_group = min(group, n_steps - done)
        do(refresh, run.atmosphere_due(count, n_group),
           eager=done == 0 or mesh is not None)
        for i in range(n_group):
            flags = (count == 0, (count + 1) % params.cn0_window == 0,
                     (count + 1) % params.r_update_ms == 0)
            if mesh is None:
                do(step, *flags, eager=done + i == 0)
            else:
                do_split(*flags, eager=done + i == 0)
            count += 1
        done += n_group

    fault = run.fault
    if mesh is not None:
        recs = {k: (v if k in _VT_REC_GLOBAL
                    else mesh.all_gather_rows(v, n_real, dim=1))
                for k, v in recs.items()}
        if recs:
            recs["local_time"] = _local_time(recs["transmit_time"],
                                             recs["num_sample"], run.fs_t)
        fault = mesh.gather_fault(fault, run.n)
    recs["fault"] = fault
    return run.end_state(count), recs


@dataclasses.dataclass
class VTSolutions:
    """navSolutionsVT equivalent (…:418-437), one row per ms."""

    usr_pos: np.ndarray
    usr_vel: np.ndarray
    usr_pos_enu: np.ndarray
    usr_pos_llh: np.ndarray
    clk_bias_m: np.ndarray
    clk_drift_ms: np.ndarray
    local_time: np.ndarray
    state_cov_diag: np.ndarray
    kalman_gain: np.ndarray        # (T, 8, 2N)
    innovation: np.ndarray         # (T, 2N)
    r_diag: np.ndarray
    sat_el_deg: np.ndarray
    sat_az_deg: np.ndarray
    cn0_dbhz: np.ndarray = None    # (T, N)
    valid: np.ndarray = None       # (T, N) channels in the EKF update
    loop_bw_hz: np.ndarray = None  # (T, 2N) equivalent loop bandwidth
    usr_vel_enu: np.ndarray = None  # (T, 3) ENU velocity at the anchor
                                    # (up-positive)
    predicted_z: np.ndarray = None  # (T, 2N) H·δx post-update (…:435)
    sv_pos: np.ndarray = None       # (T, N, 3) svxyz_pos (…:431)


@dataclasses.dataclass
class VTTrackRecords:
    """TckResultVT equivalent (…:324-352)."""

    corr: np.ndarray
    carr_err: np.ndarray
    code_err: np.ndarray
    code_freq: np.ndarray
    carr_freq: np.ndarray
    delta_pr: np.ndarray
    num_sample: np.ndarray
    absolute_sample: np.ndarray
    transmit_time: np.ndarray
    sv_vel: np.ndarray
    rem_chip: np.ndarray = None     # (T, N) remChip (…:339)
    rem_phase: np.ndarray = None    # (T, N) remCarrPhase [rad] (…:340)
    carr_nco: np.ndarray = None     # (T, N) carrNco (…:343)


def init_vt_state(cfg: ReceiverConfig, ct_records: TrackRecords,
                  prn_channels: Sequence[int], start_slot_ms: Dict[int, int],
                  transmit_time0: np.ndarray, est_pos: np.ndarray,
                  est_vel: np.ndarray, clk_bias_m: float,
                  clk_drift_ms: float, params: VTParams,
                  device=None) -> VTState:
    """Warm start from conventional tracking (…:66-70,109-132), tensors on
    `device` (the card when None).

    `prn_channels` are channel indices into `ct_records`; `start_slot_ms`
    maps channel → 0-based record row to hand off from; `transmit_time0`
    is the transmit time at each channel's handoff sample.
    """
    device = resolve_device(device)
    chans = list(prn_channels)
    n = len(chans)
    rows = np.array([start_slot_ms[c] for c in chans])
    sel = (rows, np.array(chans))
    carr = ct_records.carr_freq[sel]
    phase_fp = (np.round(ct_records.rem_phase[sel] / (2 * np.pi) * Q32)
                .astype(np.int64).astype(np.int32))

    def t(a, dtype=torch.float64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float64, device=device)

    return VTState(
        ptr=t(ct_records.absolute_sample[sel], torch.int64),
        rem_chip=t(ct_records.rem_chip[sel]),
        code_freq=t(ct_records.code_freq[sel]),
        carr_freq=t(carr), carr_freq_basis=t(carr),
        phase_fp=t(phase_fp, torch.int32),
        pll_nco=full((n,), 0.0), pll_last=t(ct_records.carr_err[sel]),
        transmit_time=t(transmit_time0), predicted_pr_last=full((n,), 0.0),
        iono_m=full((n,), 0.0), tropo_m=full((n,), 0.0),
        el_rad=full((n,), np.pi / 4), az_rad=full((n,), 0.0),
        total_state=t(np.concatenate(
            [est_pos, est_vel, [clk_bias_m, clk_drift_ms]])),
        state_cov=t(1e5 * np.diag([0.1] * 6 + [1.0, 1.0])),
        r_diag=t(np.concatenate([np.full(n, params.r_pr0),
                                 np.full(n, params.r_prr0)])),
        innov_sq_sum=full((2 * n,), 0.0),
        step_count=torch.tensor(0, dtype=torch.int32, device=device),
        zk=full((n, params.cn0_window), 0.0), snr_hist=full((n, 5), 99.0),
        cn0=full((n,), 99.0),
        valid=torch.ones(n, dtype=torch.bool, device=device))


def run_vector_tracking(source: IFSampleSource, cfg: ReceiverConfig,
                        prns: Sequence[int], eph_struct: Ephemeris,
                        state: VTState, params: VTParams, n_ms: int,
                        init_pos_ecef: np.ndarray, chunk_ms: int = 1000,
                        mesh=None
                        ) -> Tuple[VTTrackRecords, VTSolutions, VTState]:
    """Host loop of the VT scan: chunk the capture, collect the records.

    Runs on the device of `state`; `eph_struct` must be there too.  The
    next chunk's host read overlaps the device's work on the current one.

    `mesh` (a `parallel.mesh.Mesh`) shards the channel axis over its ranks
    (`parallel/vt.py`; the JAX package's gps_sdr_tpu/receiver/vt.py:740-805):
    padded with duplicates of channel 0 to a multiple of its size, each
    rank running its slice from its own reads, the EKF replicated from the
    gathered measurement rows.  Every rank returns the records, solutions
    and end state of all channels; the records bit for bit the unsharded
    run's.
    """
    if len(prns) == 0:
        raise ValueError("no channels to track (empty PRN list)")
    device = state.ptr.device
    S = cfg.signal.samples_per_ms
    fs = float(cfg.signal.fs)
    blk = -(-(S * params.pdi_ms + 256) // 128) * 128
    chips = chip_tables(prns, device)
    n_real = len(prns)
    scan = vt_scan
    use_mesh = mesh is not None and mesh.size > 1
    if use_mesh:
        from gps_sdr_tpu_torch.parallel import vt as pvt
        state, chips, eph_struct, _ = pvt.pad_vt_state(state, chips,
                                                       eph_struct, mesh.size)
        state, chips, eph_struct = pvt.shard_vt_state(mesh, state, chips,
                                                      eph_struct)
        scan = pvt.sharded_vt_scan(mesh, n_real)
    prefetcher = ChunkPrefetcher(source.read_iq_values)
    stager = DeviceStager(device)
    recs: Dict[str, list] = {}
    done = 0
    try:
        while done < n_ms:
            nb = min(chunk_ms, n_ms - done)
            ptrs = state.ptr.cpu()
            ptr_min, ptr_max = int(ptrs.min()), int(ptrs.max())
            length = (ptr_max - ptr_min) + nb * params.pdi_ms * S + blk + 64
            raw = stager.stage(prefetcher.fetch(ptr_min, length))
            state, rec = scan(
                raw, ptr_min, state, chips, eph_struct, cfg.cmn.iono_alpha,
                cfg.cmn.iono_beta, params, nb, fs, blk,
                float(cfg.signal.f_if), float(cfg.signal.fc),
                float(cfg.signal.code_freq_basis), int(cfg.cmn.day_of_year))
            nb_next = min(chunk_ms, n_ms - done - nb)
            if nb_next > 0:
                prefetcher.prefetch(
                    ptr_min + nb * params.pdi_ms * S - 2 * S,
                    (ptr_max - ptr_min) + nb_next * params.pdi_ms * S
                    + blk + 64 + 4 * S)
            raise_on_fault(rec.pop("fault"))
            for k, v in rec.items():
                recs.setdefault(k, []).append(v.cpu().numpy())
            done += nb
    finally:
        prefetcher.close()
    if use_mesh:
        state = pvt.gather_vt_state(mesh, state, n_real)
    cat = {k: np.concatenate(v) for k, v in recs.items()}

    pos = cat["total_state"][:, :3]
    vel = cat["total_state"][:, 3:6]
    anchor = np.asarray(init_pos_ecef, np.float64)
    # coordinate transforms of the whole series on the host, in float64
    enu = xyz2enu(pos, anchor).numpy()
    # ENU velocity by rotation at the anchor (the reference rotates at
    # cnslxyz, trackingVT_POS_updated.m:408-415; up-positive here)
    vel_enu = xyz2enu(anchor[None, :] + vel, anchor).numpy()
    llh = xyz2llh(pos).numpy()
    llh = np.stack([np.rad2deg(llh[:, 0]), np.rad2deg(llh[:, 1]),
                    llh[:, 2]], axis=-1)
    sol = VTSolutions(
        usr_pos=pos, usr_vel=vel, usr_pos_enu=enu, usr_pos_llh=llh,
        clk_bias_m=cat["total_state"][:, 6],
        clk_drift_ms=cat["total_state"][:, 7],
        local_time=cat["local_time"], state_cov_diag=cat["state_cov_diag"],
        kalman_gain=cat["kalman_gain"], innovation=cat["innovation"],
        r_diag=cat["r_diag"], sat_el_deg=np.rad2deg(cat["el"]),
        sat_az_deg=np.rad2deg(cat["az"]), cn0_dbhz=cat["cn0"],
        valid=cat["valid"], loop_bw_hz=cat["loop_bw_hz"],
        usr_vel_enu=vel_enu, predicted_z=cat["predicted_z"],
        sv_pos=cat["sv_pos"])
    trk = VTTrackRecords(
        corr=cat["corr"], carr_err=cat["carr_err"], code_err=cat["code_err"],
        code_freq=cat["code_freq"], carr_freq=cat["carr_freq"],
        delta_pr=cat["delta_pr"], num_sample=cat["num_sample"],
        absolute_sample=cat["absolute_sample"],
        transmit_time=cat["transmit_time"], sv_vel=cat["sv_vel"],
        rem_chip=cat["rem_chip"], rem_phase=cat["rem_phase"],
        carr_nco=cat["carr_nco"])
    return trk, sol, state
