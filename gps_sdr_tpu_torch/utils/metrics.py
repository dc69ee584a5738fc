"""Receiver metrics and report formatting.

- Moment-method C/N0 series and the validity gate, host-side float64 over
  the recorded prompt correlators (trackingCT.m:120-134 embeds the same
  estimator in every tracking loop).
- The acquisition table (showAcqResult.m) and the ephemeris CSV
  (Task_3_table.m).
"""

from __future__ import annotations

import numpy as np
import torch

from gps_sdr_tpu_torch.ops.loops import cn0_moment_estimator


def cn0_series(p_i: np.ndarray, p_q: np.ndarray, t_coh_s=1e-3,
               window: int = 20, gated: bool = False):
    """C/N0 from (T, N) prompt records over disjoint K=`window` blocks.

    `t_coh_s` is a scalar or a (T, N) per-row coherent time; the powers
    are normalized by t_coh² before windowing so a window that straddles
    a pdi switch is not spuriously gated.

    gated=False → (W, N) per-window C/N0 (the reference's |·| quirk).
    gated=True  → per-row (cn0_dbhz (T,N), gate_snr_db (T,N)): window w's
    estimate applies from window w+1's rows on; the gate series is the
    post-correlation SNR averaged over the last 5 completed windows.
    """
    pp = p_i.astype(np.float64) ** 2 + p_q.astype(np.float64) ** 2
    t_len, n_ch = pp.shape
    k = window
    n_win = t_len // k
    tc = np.broadcast_to(np.asarray(t_coh_s, np.float64), pp.shape)
    pp = pp / (tc * tc)
    zk = pp[:n_win * k].reshape(n_win, k, n_ch)
    snr = cn0_moment_estimator(
        torch.from_numpy(np.ascontiguousarray(np.moveaxis(zk, 1, 2))), 1.0,
        signed=True).numpy()                                   # (n_win, N)
    est = snr - 10.0 * np.log10(tc[k - 1::k][:n_win])
    if not gated:
        return np.abs(est)
    cn0 = np.full((t_len, n_ch), np.inf)
    gate = np.full((t_len, n_ch), np.inf)
    if n_win == 0:
        return cn0, gate
    cs = np.cumsum(snr, axis=0)
    m5 = np.empty_like(snr)
    for w in range(n_win):
        lo = max(0, w - 4)
        m5[w] = (cs[w] - (cs[lo - 1] if lo else 0.0)) / (w - lo + 1)
    cn0[:k] = est[0]
    gate[:k] = m5[0]
    for w in range(n_win):
        lo, hi = (w + 1) * k, min((w + 2) * k, t_len)
        if lo >= t_len:
            break
        cn0[lo:hi] = est[w]
        gate[lo:hi] = m5[w]
    return cn0, gate


def gate_mask(gate: np.ndarray, thresh_db: float,
              reenter_margin_db: float = 3.0) -> np.ndarray:
    """(T, N) validity mask from a gate series with hysteresis: a channel
    drops below `thresh_db` and re-enters only above
    `thresh_db + reenter_margin_db` (Schmitt trigger)."""
    t_len, n_ch = gate.shape
    valid = np.empty((t_len, n_ch), bool)
    cur = np.ones(n_ch, bool)
    enter = thresh_db + reenter_margin_db
    # the trigger is a fixed point under a constant input: one update per
    # constant-gate segment equals the per-row recurrence
    change = np.ones(t_len, bool)
    change[1:] = np.any(gate[1:] != gate[:-1], axis=1)
    starts = np.flatnonzero(change)
    for i, s0 in enumerate(starts):
        g = gate[s0]
        cur = np.where(cur, g >= thresh_db, g >= enter)
        end = starts[i + 1] if i + 1 < len(starts) else t_len
        valid[s0:end] = cur
    return valid


def export_ephemeris_table(eph: dict, path: str, prns=None) -> str:
    """CSV of decoded ephemerides, one column per PRN and one row per
    parameter (the working equivalent of the reference's partly broken
    Task_3_table.m).  Returns the text; writes it to `path` when given."""
    prns = list(prns) if prns is not None else sorted(
        p for p, r in eph.items() if getattr(r, "updateflag", 0) == 1)
    scalar_rows = ["weeknum", "iodc", "iode2", "iode3", "health", "ura"]
    param_rows = ["toe", "toc", "sqrta", "ecc", "m0", "omega0", "i0", "w",
                  "deltan", "omegadot", "idot", "cuc", "cus", "crc", "crs",
                  "cic", "cis", "af0", "af1", "af2", "tgd"]
    lines = ["parameter," + ",".join(f"PRN{p}" for p in prns)]
    for name in scalar_rows + param_rows:
        vals = []
        for p in prns:
            seq = getattr(eph[p], name, [])
            vals.append(repr(seq[0]) if len(seq) else "")
        lines.append(f"{name}," + ",".join(vals))
    text = "\n".join(lines) + "\n"
    if path:
        with open(path, "w") as f:
            f.write(text)
    return text


def format_acquisition_table(acq, f_if: float) -> str:
    """Console table of acquisition results (showAcqResult.m:14-20)."""
    lines = ["PRN   SNR[dB]  Doppler[Hz]  FineDoppler[Hz]  CodeDelay[smp]"]
    for i, sv in enumerate(acq.sv):
        lines.append(
            f"{int(sv):3d} {acq.snr_db[i]:9.2f} {acq.doppler_hz[i]:12.1f} "
            f"{acq.fine_freq_hz[i] - f_if:16.1f} {int(acq.code_delay[i]):15d}")
    return "\n".join(lines)
