"""What a pass returns, as the harness keeps it, and how the reference
judges it: the glue between a traffic mix's `output` kind and
`reference.py`.

Output kinds:

- "track": the `TrackRecords` of an eph stage (`track_for_eph`,
  `track_for_eph_reference`), judged row by row; covers the capture from
  the acquisition pointer to the last sample its last row reads.
- "vt": the (`VTTrackRecords`, `VTSolutions`) of `vt_position`, judged
  step by step; counts its steps.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from sdrbench import reference as ref

TRACK_FIELDS = ("corr", "code_err", "carr_err", "code_freq", "carr_freq",
                "num_sample", "rem_chip", "rem_phase", "absolute_sample")
VT_TRK_FIELDS = ("corr", "carr_err", "code_err", "code_freq", "carr_freq",
                 "delta_pr", "num_sample", "absolute_sample", "transmit_time",
                 "rem_chip", "rem_phase")
VT_SOL_FIELDS = ("usr_pos", "usr_vel", "clk_bias_m", "clk_drift_ms",
                 "kalman_gain", "innovation", "state_cov_diag", "r_diag",
                 "valid")


def keep(kind: str, out) -> Dict[str, np.ndarray]:
    """The host arrays of a pass's result that the judge and the readers
    read (the result itself is the program's and is let go)."""
    if kind == "track":
        return {f: np.asarray(getattr(out, f)) for f in TRACK_FIELDS}
    if kind == "vt":
        trk, sol = out
        d = {f: np.asarray(getattr(trk, f)) for f in VT_TRK_FIELDS}
        d.update({"sol_" + f: np.asarray(getattr(sol, f))
                  for f in VT_SOL_FIELDS})
        return d
    raise ValueError(f"unknown output kind {kind!r}")


def covered_samples(kind: str, rec: Dict[str, np.ndarray],
                    acq_ptr: np.ndarray) -> int:
    """Capture samples a pass covered: from the acquisition pointer to the
    last sample its last row read."""
    if kind != "track":
        return 0
    return int(rec["absolute_sample"][-1].max() - np.min(acq_ptr))


def steps(kind: str, rec: Dict[str, np.ndarray]) -> int:
    """The 1 ms steps of a VT pass."""
    return int(rec["num_sample"].shape[0]) if kind == "vt" else 0


class Case:
    """What the judge needs besides a pass's arrays: the configuration,
    the mix, the capture as (L, 2) int IQ, the codes of the channels, the
    acquisition result, the synthesizer's chip counts."""

    def __init__(self, cfg: dict, mix: dict, capture: np.ndarray,
                 codes: np.ndarray, acq: dict, truth_chips, device,
                 ephs=None):
        self.cfg, self.mix, self.capture = cfg, mix, capture
        self.codes, self.acq, self.device = codes, acq, device
        # the channels' broadcast ephemerides as the synthesizer made the
        # signal from them, by field, (N,) each
        self.eph = (None if ephs is None else
                    {f: np.array([e[f] for e in ephs], np.float64)
                     for f in ephs[0]})
        self.truth_chips = truth_chips
        r = cfg["receiver"]
        self.fs = r["signal"]["fs"]
        self.S = int(np.ceil(self.fs * 1e-3))
        self.skip = r["file"]["skip_ms"]
        self.dc = r["file"]["data_precision"] == 2
        self.code_basis = r["signal"]["code_freq_basis"]
        self.init = ref.init_state(acq["code_delay"], acq["fine_freq_hz"],
                                   self.skip, self.S, self.code_basis)


def judge_start(case: Case, prns) -> ref.Gaps:
    g = ref.Gaps()
    ref.judge_acquisition(g, case.acq, prns, case.truth_chips, case.skip,
                          case.S)
    return g


def judge_passes(case: Case, recs: List[Dict[str, np.ndarray]],
                 rng: np.random.Generator, n_sample: int,
                 dtype=np.float64) -> List[ref.Gaps]:
    """The reference's gaps for each pass: every row, and `n_sample` rows'
    correlators a pass drawn by `rng` (for a track pass the first rows
    of each phase always)."""
    kind = case.mix["output"]
    if kind == "track":
        return [judge_track_pass(case, r, rng, n_sample, dtype) for r in recs]
    if kind == "vt":
        samples = [np.unique(rng.integers(0, r["num_sample"].shape[0] - 1,
                                          n_sample)) for r in recs]
        return ref.judge_vt(recs, vt_constants(case), case.eph, case.capture,
                            case.codes, case.dc, samples, case.device, dtype)
    raise ValueError(f"unknown output kind {kind!r}")


def judge_track_pass(case: Case, rec: Dict[str, np.ndarray],
                     rng: np.random.Generator, n_sample: int,
                     dtype=np.float64) -> ref.Gaps:
    g = ref.Gaps()
    track = case.cfg["receiver"]["track"]
    plan = ref.block_plan(rec, case.init, track, case.fs, case.S, g,
                          n1=track["ms_eph_1ms"])
    total = ref.plan_blocks(plan)
    firsts, at = [], 0
    for item in plan:
        firsts.append(at)
        at += item[1].shape[0]
    sample = np.unique(np.concatenate([
        firsts, rng.integers(0, total, n_sample)]))
    ref.judge_track(rec, plan, case.capture, case.codes, case.dc,
                    sample, case.device, g, dtype)
    return g


def vt_constants(case: Case) -> dict:
    """The VT stage's constants (trackingVT_POS_updated.m): E/P/L taps
    ±0.5 chip, the scalar PLL of the configuration, ceil block lengths
    clipped to the block window, f0 the code rate; the EKF's process
    noise, P₀ and R₀ (…:51-56), R's clamps and cadence (…:445-467), the
    gate (the configuration's mask over the mean SNR of 5 windows of 20
    ms), the atmosphere's cadence (…:84-86) and the geometry's: a group
    of 50 ms from one Kepler head."""
    r = case.cfg["receiver"]
    t = r["track"]
    t1, t2 = ref.loop_coefficients(t["pll_bw_hz"], t["pll_damping"],
                                   t["pll_gain"])
    blk = -(-(case.S + 256) // 128) * 128
    return dict(fs=case.fs, blk=blk, code_basis=case.code_basis,
                c=299_792_458.0, pll_p=t2 / t1, pll_i=1e-3 / t1,
                taps=(0.5, 0.0, -0.5), f_if=r["signal"]["f_if"],
                fc=r["signal"]["fc"], iono_alpha=r["cmn"]["iono_alpha"],
                iono_beta=r["cmn"]["iono_beta"], doy=r["cmn"]["day_of_year"],
                group=50, atmos=100, window=20,
                mask_db=r["solu"]["mask_snr_db"], r_update=200,
                q_pos=1.0, q_vel=0.1, q_clk=0.1, q_clkd=0.01,
                p0=[1e4] * 6 + [1e5] * 2, r_pr0=0.3, r_prr0=0.1,
                r_pr_max=12000.0, r_prr_max=400.0, r_min=0.01,
                r_masked=1e8)


def verdict(gaps: List[Dict[str, float]], limits: Dict[str, float]) -> dict:
    """{name: [widest value over `gaps`, limit]} for every limit, and
    whether each of `gaps` (dicts of the reference's gaps by name) stays
    within all of them."""
    worst = {n: max([g.get(n, 0.0) for g in gaps] + [0.0]) for n in limits}
    ok = [all(g.get(n, 0.0) <= lim for n, lim in limits.items())
          for g in gaps]
    return dict(numbers={n: [worst[n], limits[n]] for n in limits}, ok=ok)
