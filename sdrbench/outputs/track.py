"""Output kind "track": the `TrackRecords` of a scalar tracking stage
(`track_for_eph_reference`, `track_for_eph`), judged row by row.

The mix's `tracker` object says what the stage ran; each key it leaves
out takes the eph stages' E/P/L tracker of trackingCT.m on its 3-phase
schedule:

- `taps` [chips] and `epl`, the early, prompt and late columns: (−d, 0,
  +d) of the configuration's correlator spacing d, and (0, 1, 2);
- `rounding` of the block length, "round" or "ceil": "round";
- `dll_sign` (codeFreq = basis + dll_sign·nco): −1;
- `schedule`: "eph_ref", trackingCT.m's three phases (1 ms, the re-track
  to countinx, 10 ms blocks repeated ×10 in the record, whose sums the
  10 ms phase negates), or "serial", every row at 1 ms from the
  acquisition state with no switch.

A pass covers the capture from the acquisition pointer to the last
sample its last row reads, and launches B1 (`track_chunk`, one launch a
chunk of each 1 ms `run_tracking` call: the pass's `chunk_ms` rows,
1000 where the mix leaves it out) and, on the 3-phase
schedule, B3 (`track_scan`, one windows-bank launch a 10 ms block).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from sdrbench import judge as J
from sdrbench import launches as L
from sdrbench import reference as ref
from sdrbench import roofline

FIELDS = ("corr", "code_err", "carr_err", "code_freq", "carr_freq",
          "num_sample", "rem_chip", "rem_phase", "absolute_sample")
SCHEDULES = ("eph_ref", "serial")


def tracker(case: J.Case) -> dict:
    d = case.cfg["receiver"]["track"]["correlator_spacing"]
    t = J.tracker(case, dict(taps=[-d, 0.0, d], epl=[0, 1, 2],
                             rounding="round", dll_sign=-1.0,
                             schedule="eph_ref"))
    if t["schedule"] not in SCHEDULES or t["rounding"] not in ("round",
                                                               "ceil"):
        raise ValueError(f"tracker: schedule {t['schedule']!r} not in "
                         f"{SCHEDULES} or rounding {t['rounding']!r} not "
                         "'round' or 'ceil'")
    return t


def keep(out) -> Dict[str, np.ndarray]:
    """The host arrays of a pass's result that the judge and the readers
    read (the result itself is the program's and is let go)."""
    return {f: np.asarray(getattr(out, f)) for f in FIELDS}


def covered_samples(rec: Dict[str, np.ndarray], acq_ptr: np.ndarray) -> int:
    """Capture samples a pass covered: from the acquisition pointer to the
    last sample its last row read."""
    return int(rec["absolute_sample"][-1].max() - np.min(acq_ptr))


def steps(rec: Dict[str, np.ndarray]) -> int:
    return 0


def judge(case: J.Case, recs: List[Dict[str, np.ndarray]],
          rng: np.random.Generator, n_sample: int,
          dtype=np.float64) -> List[ref.Gaps]:
    """The reference's gaps for each pass: every row, and the correlators
    of `n_sample` rows a pass drawn by `rng` and of the first rows of
    each phase."""
    return [judge_pass(case, r, rng, n_sample, dtype) for r in recs]


def judge_pass(case: J.Case, rec: Dict[str, np.ndarray],
               rng: np.random.Generator, n_sample: int,
               dtype=np.float64) -> ref.Gaps:
    g = ref.Gaps()
    track = case.cfg["receiver"]["track"]
    plan = ref.block_plan(rec, case.init, track, case.fs, case.S, g,
                          tracker(case), n1=track["ms_eph_1ms"])
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


def switch_rows(rec: Dict[str, np.ndarray], S: int) -> np.ndarray:
    """Each channel's first 10 ms row (the record's length where none)."""
    big = rec["num_sample"] > 5 * S
    T = rec["num_sample"].shape[0]
    return np.where(big.any(axis=0), np.argmax(big, axis=0), T)


def launches(ctx, rec: Dict[str, np.ndarray]) -> dict:
    """The bound of each launch, by kernel.  Serial: one `run_tracking`
    call over the record's rows.  3-phase: phases (a) and (b), whose 1 ms
    rows the merged record keeps up to each channel's switch row (phase
    (a)'s rows are (b)'s: both start from the same state), then one B3
    launch a 10 ms block, all channels."""
    case, S = ctx.case, ctx.case.S
    t = tracker(case)
    ntaps = len(t["taps"])
    chunk = max(1, int(case.mix["pass"][1].get("chunk_ms", 1000)))
    T, n_ch = rec["num_sample"].shape
    if t["schedule"] == "serial":
        return {"b1": L.chunk_launches(case, rec, [T], np.full(n_ch, T),
                                       ntaps, chunk, ctx.sample_bytes)}
    sw = switch_rows(rec, S)
    n1 = ctx.cfg["receiver"]["track"]["ms_eph_1ms"]
    b1 = L.chunk_launches(case, rec, [n1, int(sw.max())], sw, ntaps, chunk,
                          ctx.sample_bytes)
    n_blocks = (T - int(sw.max())) // 10
    rows = sw[None, :] + 10 * np.arange(n_blocks)[:, None]
    num = np.take_along_axis(rec["num_sample"], rows, axis=0)
    b3 = [roofline.bank_bound(np.zeros(n_ch), num[j], ntaps, case.dc,
                              ctx.sample_bytes, windows=True)
          for j in range(n_blocks)]
    return {"b1": b1, "b3": b3}
