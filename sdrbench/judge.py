"""What every output kind's judge shares: the case a run's passes are
judged in, the stage's start, the tracker a mix names, and the verdict
over the limits.

Each kind of a pass's result is a module of its own, `outputs/<kind>.py`
(`harness.load_output`), which keeps, judges and counts a pass of that
kind through `reference.py` and `roofline.py`:

- "track": the `TrackRecords` of a scalar tracking stage, judged row by
  row;
- "vt": the (`VTTrackRecords`, `VTSolutions`) of `vt_position`, judged
  step by step.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from sdrbench import reference as ref


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


def tracker(case: Case, defaults: dict) -> dict:
    """The mix's `tracker` object over an output kind's `defaults`, key by
    key; a key the kind does not know is refused."""
    given = case.mix.get("tracker", {})
    unknown = sorted(set(given) - set(defaults))
    if unknown:
        raise ValueError(f"tracker keys {unknown} not known to output kind "
                         f"{case.mix['output']!r}; known: {sorted(defaults)}")
    return dict(defaults, **given)


def verdict(gaps: List[Dict[str, float]], limits: Dict[str, float]) -> dict:
    """{name: [widest value over `gaps`, limit]} for every limit, and
    whether each of `gaps` (dicts of the reference's gaps by name) stays
    within all of them."""
    worst = {n: max([g.get(n, 0.0) for g in gaps] + [0.0]) for n in limits}
    ok = [all(g.get(n, 0.0) <= lim for n, lim in limits.items())
          for g in gaps]
    return dict(numbers={n: [worst[n], limits[n]] for n in limits}, ok=ok)
