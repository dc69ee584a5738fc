"""Result visualization — equivalents of the reference's Plot_task_1..5.m
and TrackingPlot*.m dashboards, writing PNG files.

Each function takes the receiver's result objects and an output path;
matplotlib (and PIL for the GIF) is imported inside the functions, with the
Agg backend, so the package imports without them and headless machines
plot; where matplotlib is missing the call raises its ImportError.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_acquisition(acq, out_path: str) -> None:
    """Task 1 (Plot_task_1.m): SNR / Doppler / code delay per acquired SV."""
    plt = _plt()
    fig, axes = plt.subplots(3, 1, figsize=(10, 9), sharex=True)
    sv = acq.sv
    axes[0].bar(sv, acq.snr_db)
    axes[0].set_ylabel("acquisition SNR [dB]")
    axes[0].axhline(12.0, color="r", ls="--", label="threshold")
    axes[0].legend()
    axes[1].stem(sv, acq.fine_freq_hz - acq.fine_freq_hz.mean())
    axes[1].set_ylabel("fine freq − mean [Hz]")
    axes[2].stem(sv, acq.code_delay)
    axes[2].set_ylabel("code delay [samples]")
    axes[2].set_xlabel("PRN")
    fig.suptitle("Acquisition results")
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def plot_tracking(records, prns: Sequence[int], out_path: str,
                  max_ms: Optional[int] = None) -> None:
    """Task 2 / TrackingPlot.m: prompt I/Q series, IQ constellation,
    carrier frequency, discriminators per channel."""
    plt = _plt()
    n = len(prns)
    fig, axes = plt.subplots(n, 4, figsize=(18, 2.6 * n), squeeze=False)
    t_end = max_ms or records.p_i.shape[0]
    for ch, prn in enumerate(prns):
        pi = records.p_i[:t_end, ch]
        pq = records.p_q[:t_end, ch]
        axes[ch][0].plot(pi, lw=0.4)
        axes[ch][0].set_ylabel(f"PRN {prn}\nP_i")
        axes[ch][1].plot(pi, pq, ".", ms=1)
        axes[ch][1].set_xlabel("I")
        axes[ch][1].set_ylabel("Q")
        axes[ch][2].plot(records.carr_freq[:t_end, ch], lw=0.6)
        axes[ch][2].set_ylabel("carrier [Hz]")
        axes[ch][3].plot(records.code_err[:t_end, ch], lw=0.4)
        axes[ch][3].set_ylabel("DLL disc")
    fig.suptitle("Tracking channels")
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def plot_ephemeris(eph, prns: Sequence[int], out_path: str) -> None:
    """Task 3 (Plot_task_3.m): decoded orbital elements per SV."""
    plt = _plt()
    fields = ["sqrta", "ecc", "i0", "omega0", "w", "m0"]
    fig, axes = plt.subplots(2, 3, figsize=(15, 7))
    for ax, f in zip(axes.ravel(), fields):
        vals = [getattr(eph[p], f)[0] if getattr(eph[p], f) else np.nan
                for p in prns]
        ax.bar([str(p) for p in prns], vals)
        ax.set_title(f)
    fig.suptitle("Decoded ephemeris parameters")
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def plot_wls_solution(nav, truth_ecef: np.ndarray, out_path: str) -> None:
    """Task 4 (Plot_task_4.m): WLS ENU trajectory, velocity, error series
    and histogram, clock bias."""
    from gps_sdr_tpu_torch.geo.coords import xyz2enu

    plt = _plt()
    enu = xyz2enu(nav.usr_pos, truth_ecef).numpy()
    err = np.linalg.norm(enu, axis=1)
    fig, axes = plt.subplots(2, 3, figsize=(16, 8))
    axes[0][0].plot(enu[:, 0], enu[:, 1], ".-", ms=2)
    axes[0][0].plot([0], [0], "r*", ms=12, label="truth")
    axes[0][0].set_xlabel("E [m]"); axes[0][0].set_ylabel("N [m]")
    axes[0][0].legend(); axes[0][0].set_title("WLS horizontal trajectory")
    axes[0][1].plot(nav.usr_vel_enu)
    axes[0][1].set_title("velocity ENU [m/s]")
    axes[0][2].plot(err)
    axes[0][2].set_title("3D position error [m]")
    axes[1][0].hist(err, bins=30)
    axes[1][0].set_title("position error histogram")
    axes[1][1].plot(nav.clk_bias_m)
    axes[1][1].set_title("clock bias [m]")
    axes[1][2].plot(nav.clk_drift_ms)
    axes[1][2].set_title("clock drift [m/s]")
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def plot_vt_solution(sol, truth_ecef: np.ndarray, out_path: str) -> None:
    """Task 5 (Plot_task_5.m): EKF trajectory, velocity, error histogram,
    clock states, Kalman gain and innovation diagnostics."""
    from gps_sdr_tpu_torch.geo.coords import xyz2enu

    plt = _plt()
    enu = xyz2enu(sol.usr_pos, truth_ecef).numpy()
    err = np.linalg.norm(enu, axis=1)
    fig, axes = plt.subplots(3, 3, figsize=(16, 11))
    axes[0][0].plot(enu[:, 0], enu[:, 1], lw=0.5)
    axes[0][0].plot([0], [0], "r*", ms=12)
    axes[0][0].set_title("EKF horizontal trajectory [m]")
    axes[0][1].plot(sol.usr_vel)
    axes[0][1].set_title("velocity ECEF [m/s]")
    axes[0][2].plot(err, lw=0.5)
    axes[0][2].set_title("position error [m]")
    axes[1][0].hist(err, bins=30)
    axes[1][0].set_title("error histogram")
    axes[1][1].plot(sol.clk_bias_m)
    axes[1][1].set_title("clock bias [m]")
    axes[1][2].plot(sol.clk_drift_ms)
    axes[1][2].set_title("clock drift [m/s]")
    n2 = sol.innovation.shape[1]
    axes[2][0].plot(sol.innovation[:, :n2 // 2], lw=0.3)
    axes[2][0].set_title("pr innovation [m]")
    axes[2][1].plot(sol.innovation[:, n2 // 2:], lw=0.3)
    axes[2][1].set_title("prr innovation [m/s]")
    axes[2][2].plot(np.abs(sol.kalman_gain).mean(axis=(1, 2)), lw=0.5)
    axes[2][2].set_title("mean |Kalman gain|")
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def plot_channel_dashboard(records, prns: Sequence[int], out_path: str,
                           code_freq_basis: float = 1.023e6,
                           max_ms: Optional[int] = None) -> None:
    """Per-SV tracking dashboard — the TrackingPlot3.m (171-line) panel
    set: IQ constellation, prompt I/Q series, raw + filtered DLL
    discriminator, raw + filtered PLL discriminator, code frequency and
    code delay.  One figure row of 8 panels per SV.

    The reference plots the NCO inputs/outputs it kept in TckResult
    (TrackingPlot3.m:20-160); the equivalents here are code_err /
    carr_err (raw discriminators), code_freq − basis and
    carr_freq − carr_freq[0] (filtered loop outputs), and the per-block
    sample residue num_sample − round(mean) (the delayValue series,
    trackingCT_POS_updated.m:191)."""
    plt = _plt()
    n = len(prns)
    fig, axes = plt.subplots(n, 8, figsize=(30, 2.8 * n), squeeze=False)
    t_end = max_ms or records.p_i.shape[0]
    for ch, prn in enumerate(prns):
        pi = records.p_i[:t_end, ch]
        pq = records.p_q[:t_end, ch]
        ax = axes[ch]
        ax[0].plot(pi, pq, ".", ms=1)
        ax[0].set_ylabel(f"PRN {prn}")
        ax[0].set_title("IQ constellation" if ch == 0 else "")
        ax[1].plot(pi, lw=0.4)
        ax[1].plot(pq, lw=0.4, alpha=0.6)
        ax[1].set_title("prompt I (blue) / Q" if ch == 0 else "")
        ax[2].plot(records.code_err[:t_end, ch], lw=0.4)
        ax[2].set_title("raw DLL disc [chip]" if ch == 0 else "")
        ax[3].plot(records.code_freq[:t_end, ch] - code_freq_basis, lw=0.6)
        ax[3].set_title("filtered DLL (codeFreq−f0) [Hz]"
                        if ch == 0 else "")
        ax[4].plot(records.carr_err[:t_end, ch], lw=0.4)
        ax[4].set_title("raw PLL disc [cyc]" if ch == 0 else "")
        ax[5].plot(records.carr_freq[:t_end, ch]
                   - records.carr_freq[0, ch], lw=0.6)
        ax[5].set_title("filtered PLL (carrFreq−f̂0) [Hz]"
                        if ch == 0 else "")
        ax[6].plot(records.code_freq[:t_end, ch], lw=0.6)
        ax[6].set_title("code frequency [Hz]" if ch == 0 else "")
        ns = records.num_sample[:t_end, ch]
        ax[7].plot(ns - np.round(ns.mean()), lw=0.6)
        ax[7].set_title("block-length residue [smp]" if ch == 0 else "")
    fig.suptitle("Per-SV tracking dashboards (TrackingPlot3 panel set)")
    fig.tight_layout()
    fig.savefig(out_path, dpi=100)
    plt.close(fig)


def plot_vt_channels(trk, sol, prns: Sequence[int], truth_ecef: np.ndarray,
                     out_path: str) -> None:
    """TrackingPlot_vt.m equivalent: per-channel vector-tracking panels
    (prompt IQ, code-discriminator → EKF measurement, nav-driven code
    frequency, ΔPr rate) combined with the navigation-solution panels
    (ENU trajectory + components, clock bias/drift) the reference stacks
    below them (TrackingPlot_vt.m:1-234)."""
    from gps_sdr_tpu_torch.geo.coords import xyz2enu

    plt = _plt()
    n = len(prns)
    fig, axes = plt.subplots(n + 2, 4, figsize=(18, 2.6 * (n + 2)),
                             squeeze=False)
    t = trk.code_err.shape[0]
    pi = trk.corr[:, :, trk.corr.shape[2] // 2, 0]
    pq = trk.corr[:, :, trk.corr.shape[2] // 2, 1]
    for ch, prn in enumerate(prns):
        ax = axes[ch]
        ax[0].plot(pi[:, ch], pq[:, ch], ".", ms=1)
        ax[0].set_ylabel(f"PRN {prn}")
        ax[0].set_title("IQ" if ch == 0 else "")
        ax[1].plot(trk.code_err[:, ch], lw=0.4)
        ax[1].set_title("code disc → Z_pr [chip]" if ch == 0 else "")
        ax[2].plot(trk.code_freq[:, ch], lw=0.5)
        ax[2].set_title("nav-driven codeFreq [Hz]" if ch == 0 else "")
        ax[3].plot(trk.delta_pr[:, ch], lw=0.5)
        ax[3].set_title("ΔPr rate [m/s]" if ch == 0 else "")
    enu = xyz2enu(sol.usr_pos, truth_ecef).numpy()
    axn = axes[n]
    axn[0].plot(enu[:, 0], enu[:, 1], lw=0.5)
    axn[0].plot([0], [0], "r*", ms=10)
    axn[0].set_title("EKF horizontal ENU [m]")
    for i, lab in enumerate("ENU"):
        axn[1].plot(enu[:, i], lw=0.5, label=lab)
    axn[1].legend(); axn[1].set_title("ENU components [m]")
    axn[2].plot(sol.clk_bias_m, lw=0.6); axn[2].set_title("clock bias [m]")
    axn[3].plot(sol.clk_drift_ms, lw=0.6)
    axn[3].set_title("clock drift [m/s]")
    axv = axes[n + 1]
    axv[0].plot(sol.usr_vel, lw=0.5); axv[0].set_title("velocity ECEF [m/s]")
    axv[1].plot(np.linalg.norm(enu, axis=1), lw=0.5)
    axv[1].set_title("3D error [m]")
    axv[2].plot(sol.cn0_dbhz, lw=0.5); axv[2].set_title("C/N0 [dB-Hz]")
    axv[3].plot(sol.r_diag, lw=0.4); axv[3].set_title("adaptive R diag")
    fig.suptitle("Vector tracking channels + navigation solution "
                 "(TrackingPlot_vt panel set)")
    fig.tight_layout()
    fig.savefig(out_path, dpi=100)
    plt.close(fig)


def plot_acf_evolution(corr: np.ndarray, taps: Sequence[float],
                       prns: Sequence[int], out_path: str,
                       n_snapshots: int = 6,
                       window_ms: int = 100) -> None:
    """Correlation-function evolution from multicorrelator records — the
    static equivalent of CalculateFeatures.m's animated ACF GIF
    (:299-319): per SV, a time × tap envelope waterfall plus `n_snapshots`
    window-averaged ACF curves (LOS keeps the sharp symmetric triangle;
    multipath skews/widens it)."""
    from gps_sdr_tpu_torch.analysis.acf import acf_envelope

    plt = _plt()
    env = acf_envelope(corr)                       # (T, N, ntaps)
    taps = np.asarray(taps, np.float64)
    order = np.argsort(taps)
    T, n = env.shape[:2]
    fig, axes = plt.subplots(n, 2, figsize=(13, 2.8 * n), squeeze=False)
    snap_rows = np.linspace(0, max(T - window_ms, 1), n_snapshots,
                            dtype=int)
    for ch, prn in enumerate(prns):
        e = env[:, ch][:, order]
        axes[ch][0].imshow(e.T, aspect="auto", origin="lower",
                           extent=[0, T, taps[order][0], taps[order][-1]],
                           cmap="viridis")
        axes[ch][0].set_ylabel(f"PRN {prn}\ntap [chip]")
        axes[ch][0].set_title("ACF envelope waterfall" if ch == 0 else "")
        for r in snap_rows:
            seg = e[r:r + window_ms].mean(axis=0)
            axes[ch][1].plot(taps[order], seg, lw=0.8,
                             label=f"{r}–{r + window_ms} ms")
        axes[ch][1].set_title("window-averaged ACF snapshots"
                              if ch == 0 else "")
        if ch == 0:
            axes[ch][1].legend(fontsize=6)
    axes[-1][0].set_xlabel("time [ms]")
    axes[-1][1].set_xlabel("tap offset [chip]")
    fig.suptitle("Multicorrelator ACF evolution")
    fig.tight_layout()
    fig.savefig(out_path, dpi=100)
    plt.close(fig)


def save_acf_animation(corr: np.ndarray, taps: Sequence[float],
                       prn: int, out_path: str, channel: int = 0,
                       rem_chip: Optional[np.ndarray] = None,
                       start_ms: int = 0, n_frames: int = 20,
                       stride_ms: int = 1,
                       frame_duration_ms: int = 1000) -> None:
    """Animated multicorrelator ACF GIF — the reference's
    `correlation_outputs.gif` (CalculateFeatures.m:299-319): each frame
    overlays one more per-ms ACF curve on the accumulating axes
    (MATLAB `hold on` + `imwrite(...,'WriteMode','append')`), with the
    tap axis shifted by that ms's remChip exactly as the reference
    plots `spacing + remChip(ind)`.

    corr      (T, N, ntaps, 2) I/Q multicorrelator records
    rem_chip  (T, N) remChip series for the x-shift; 0 when omitted
    """
    from PIL import Image

    plt = _plt()
    taps = np.asarray(taps, np.float64)
    order = np.argsort(taps)
    env = np.sqrt(corr[:, channel, :, 0] ** 2
                  + corr[:, channel, :, 1] ** 2)       # (T, ntaps)
    rows = start_ms + stride_ms * np.arange(n_frames)
    rows = rows[rows < env.shape[0]]
    shift = (np.asarray(rem_chip[:, channel], np.float64)
             if rem_chip is not None else np.zeros(env.shape[0]))
    fig, ax = plt.subplots(figsize=(6.4, 4.8))
    ax.grid(True)
    ax.set_title(f"PRN #{prn}", fontsize=14)
    ax.set_xlabel("Time delay (Chip)", fontsize=14)
    ax.set_ylabel("Correlation value", fontsize=14)
    frames = []
    for r in rows:
        ax.plot(taps[order] + shift[r], env[r][order], lw=1)
        fig.canvas.draw()
        frames.append(Image.fromarray(
            np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()))
    plt.close(fig)
    if not frames:
        raise ValueError("no frames: start_ms beyond the record")
    frames[0].save(out_path, save_all=True, append_images=frames[1:],
                   duration=frame_duration_ms, loop=0)


def save_all(acq=None, records=None, prns=None, eph=None, nav=None,
             vt_sol=None, truth_ecef=None, out_dir: str = "results",
             vt_trk=None) -> None:
    os.makedirs(out_dir, exist_ok=True)
    if acq is not None:
        plot_acquisition(acq, os.path.join(out_dir, "task1_acquisition.png"))
    if records is not None and prns is not None:
        plot_tracking(records, prns, os.path.join(out_dir, "task2_tracking.png"))
    if eph is not None and prns is not None:
        plot_ephemeris(eph, prns, os.path.join(out_dir, "task3_ephemeris.png"))
    if nav is not None and truth_ecef is not None:
        plot_wls_solution(nav, truth_ecef, os.path.join(out_dir, "task4_wls.png"))
    if vt_sol is not None and truth_ecef is not None:
        plot_vt_solution(vt_sol, truth_ecef, os.path.join(out_dir, "task5_ekf.png"))
    if records is not None and prns is not None:
        plot_channel_dashboard(
            records, prns, os.path.join(out_dir, "channels_dashboard.png"))
    if (vt_trk is not None and vt_sol is not None and prns is not None
            and truth_ecef is not None):
        plot_vt_channels(vt_trk, vt_sol, prns, truth_ecef,
                         os.path.join(out_dir, "vt_channels.png"))
