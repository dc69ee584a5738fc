"""Relative (clock-free) pseudorange estimation.

Capability parity with the reference's legacy pseudorange estimators
`pr_est.m:21-46` and `pr_est_interp.m:21-50` (GPSSDR_vt / SoftXXXGPS
lineage), which the legacy positioning stage `trackingCT_POS.m:268`
consumes.  The idea: without a resolved receiver clock, pseudoranges can
still be formed *relative to the earliest-arriving channel* by assuming
a nominal travel time for it —

    pr_i = c · (base_sec + Δt_i),   base_sec = 75 ms
    Δt_i = arrival(subframe-1 epoch, channel i) − min_j arrival(…, j)

The reference measures the arrival offsets in samples:
`dat = 20·fs·ms·sfb1 + fs·ms·nav1 + (codedelay − 1)` (pr_est_interp.m:38)
— the sample index of the first subframe-1 code start within the
capture.  `relative_pseudorange_samples` is that form;
`relative_pseudorange_from_transmit_time` is the receiver's own form
(transmit times at a common received sample already encode the same
arrival offsets, with sub-sample code-phase resolution).

The production stages (`receiver/ct.py`, `receiver/vt.py`) use absolute
transmit-time pseudoranging instead; these estimators serve the legacy
`trackingCT_POS.m` position filter (`receiver/ct_legacy.py`).  Host
float64 numpy: a handful of values per epoch.
"""

from __future__ import annotations

import numpy as np

from gps_sdr_tpu_torch.config import C_LIGHT

BASE_TRAVEL_S = 75e-3   # pr_est.m:24 — SV range is 67..86 ms of light time


def relative_pseudorange_samples(sfb1, nav1, code_delay, fs,
                                 base_sec: float = BASE_TRAVEL_S):
    """Sample-offset form (pr_est.m:29-46, pr_est_interp.m:29-50).

    sfb1: (N,) first subframe-1 index per channel [20 ms units, 1-based]
    nav1: (N,) first nav-bit ms per channel [ms, 1-based] — pass zeros
          for pr_est.m's convention (it zeroes nav1, pr_est.m:33)
    code_delay: (N,) tracked code start within the ms [samples, 1-based]
    Returns (pseudorange_m, relative_time_s).
    """
    sfb1 = np.asarray(sfb1, np.float64)
    nav1 = np.asarray(nav1, np.float64)
    code_delay = np.asarray(code_delay, np.float64)
    ms = fs * 1e-3
    dat = 20.0 * ms * sfb1 + ms * nav1 + (code_delay - 1.0)
    rel = (dat - dat.min()) / fs
    return C_LIGHT * (base_sec + rel), rel


def relative_pseudorange_from_transmit_time(
        transmit_time, base_sec: float = BASE_TRAVEL_S):
    """Transmit-time form: at a common received sample, a channel whose
    signal left the SV *later* (larger transmit time) is nearer; the
    earliest-arriving (max-transmit-time) channel gets the nominal
    base_sec travel time and every other channel its measured excess.

    transmit_time: (N,) transmit times at one common received sample [s].
    Returns (pseudorange_m, relative_time_s).
    """
    tt = np.asarray(transmit_time, np.float64)
    rel = tt.max() - tt
    return C_LIGHT * (base_sec + rel), rel
