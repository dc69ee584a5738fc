"""Output kind "vt": the (`VTTrackRecords`, `VTSolutions`) of
`vt_position`, judged step by step (`reference.judge_vt`).

The mix's `tracker` object names the correlator bank the stage ran:
`taps` [chips] and `epl`, the columns its loops close on (early, prompt,
late); where it leaves them out, the E/P/L bank of
trackingVT_POS_updated.m, (0.5, 0, −0.5) and (0, 1, 2).

A pass counts its 1 ms steps and launches B2 (the fetching bank) once a
step, all channels.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from sdrbench import judge as J
from sdrbench import reference as ref
from sdrbench import roofline

TRK_FIELDS = ("corr", "carr_err", "code_err", "code_freq", "carr_freq",
              "delta_pr", "num_sample", "absolute_sample", "transmit_time",
              "rem_chip", "rem_phase")
SOL_FIELDS = ("usr_pos", "usr_vel", "clk_bias_m", "clk_drift_ms",
              "kalman_gain", "innovation", "state_cov_diag", "r_diag",
              "valid")


def tracker(case: J.Case) -> dict:
    return J.tracker(case, dict(taps=[0.5, 0.0, -0.5], epl=[0, 1, 2]))


def keep(out) -> Dict[str, np.ndarray]:
    """The host arrays of a pass's result that the judge and the readers
    read (the result itself is the program's and is let go)."""
    trk, sol = out
    d = {f: np.asarray(getattr(trk, f)) for f in TRK_FIELDS}
    d.update({"sol_" + f: np.asarray(getattr(sol, f)) for f in SOL_FIELDS})
    return d


def covered_samples(rec: Dict[str, np.ndarray], acq_ptr: np.ndarray) -> int:
    return 0


def steps(rec: Dict[str, np.ndarray]) -> int:
    """The 1 ms steps of a pass."""
    return int(rec["num_sample"].shape[0])


def judge(case: J.Case, recs: List[Dict[str, np.ndarray]],
          rng: np.random.Generator, n_sample: int,
          dtype=np.float64) -> List[ref.Gaps]:
    """The reference's gaps for each pass: every step, and the
    correlators of `n_sample` steps a pass drawn by `rng`."""
    samples = [np.unique(rng.integers(0, r["num_sample"].shape[0] - 1,
                                      n_sample)) for r in recs]
    return ref.judge_vt(recs, constants(case), case.eph, case.capture,
                        case.codes, case.dc, samples, case.device, dtype)


def constants(case: J.Case) -> dict:
    """The VT stage's constants (trackingVT_POS_updated.m): the tracker's
    taps and E/P/L columns, the scalar PLL of the configuration, ceil
    block lengths clipped to the block window, f0 the code rate; the
    EKF's process noise, P₀ and R₀ (…:51-56), R's clamps and cadence
    (…:445-467), the gate (the configuration's mask over the mean SNR of
    5 windows of 20 ms), the atmosphere's cadence (…:84-86) and the
    geometry's: a group of 50 ms from one Kepler head."""
    r = case.cfg["receiver"]
    t = r["track"]
    trk = tracker(case)
    t1, t2 = ref.loop_coefficients(t["pll_bw_hz"], t["pll_damping"],
                                   t["pll_gain"])
    blk = -(-(case.S + 256) // 128) * 128
    return dict(fs=case.fs, blk=blk, code_basis=case.code_basis,
                c=299_792_458.0, pll_p=t2 / t1, pll_i=1e-3 / t1,
                taps=tuple(float(x) for x in trk["taps"]),
                epl=tuple(int(i) for i in trk["epl"]),
                f_if=r["signal"]["f_if"],
                fc=r["signal"]["fc"], iono_alpha=r["cmn"]["iono_alpha"],
                iono_beta=r["cmn"]["iono_beta"], doy=r["cmn"]["day_of_year"],
                group=50, atmos=100, window=20,
                mask_db=r["solu"]["mask_snr_db"], r_update=200,
                q_pos=1.0, q_vel=0.1, q_clk=0.1, q_clkd=0.01,
                p0=[1e4] * 6 + [1e5] * 2, r_pr0=0.3, r_prr0=0.1,
                r_pr_max=12000.0, r_prr_max=400.0, r_min=0.01,
                r_masked=1e8)


def launches(ctx, rec: Dict[str, np.ndarray]) -> dict:
    """`roofline.bank_bound` of each step's fetching-bank launch: the
    union of the channels' windows at each step's pointers."""
    num = rec["num_sample"]
    ptr = np.concatenate([rec["absolute_sample"][:1] - num[:1],
                          rec["absolute_sample"][:-1]])
    ntaps = len(tracker(ctx.case)["taps"])
    return {"b2": [roofline.bank_bound(ptr[t], num[t], ntaps, ctx.case.dc,
                                       ctx.sample_bytes, windows=False)
                   for t in range(num.shape[0])]}
