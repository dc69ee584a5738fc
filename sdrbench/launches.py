"""The kernel launches of a traced pass, worked out from the pass's own
records, and what the per-layer readers make of them.

The records say which blocks each channel ran; how the stage groups them
into launches is the program's public schedule: `run_tracking` gives
`track_chunk` one launch per chunk of 1000 blocks at pdi 1 ms, and
`track_scan` one windows-bank launch per 10 ms block for all channels;
`vt_position` one fetching-bank launch per 1 ms step.  With DC removal
each bank launch is preceded by the bank's DC kernel, whose time is the
bank's too (an eph cell runs no fetching bank, a VT cell no windows
bank).  A reader counts
the launches it works out against the kernels the profiler saw and reads
nothing when they differ.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Tuple

import numpy as np

from sdrbench import roofline

B1 = r"\btrack_chunk_kernel\b"
B3 = r"\bcorr_bank_(windows|dc)_kernel\b"
B2 = r"\bcorr_bank(_dc)?_kernel\b"
CHUNK_BLOCKS = 1000


def idle_pct(ctx, kind: str) -> Optional[float]:
    """The share of an untraced pass's wall time in which the card ran
    nothing: the traced pass's device time (kernels and copies, merged)
    over the wall time of the untraced pass run just before it.  The
    profiler slows the host, not the card, so the traced pass's own wall
    time would count the profiler's cost as idle."""
    if ctx.trace is None or ctx.mix["output"] != kind or not ctx.untraced_s:
        return None
    busy = ctx.trace.busy_s()
    if busy >= ctx.untraced_s:
        print(f"sdrbench: device time {busy} s is not under the untraced "
              f"pass's {ctx.untraced_s} s; idle share not read",
              file=sys.stderr)
        return None
    return 100.0 * (1.0 - busy / ctx.untraced_s)


def _switch_rows(rec, S: int) -> np.ndarray:
    """Each channel's first 10 ms row (the record's length where none)."""
    big = rec["num_sample"] > 5 * S
    T = rec["num_sample"].shape[0]
    return np.where(big.any(axis=0), np.argmax(big, axis=0), T)


def b1_launches(ctx, rec) -> List[Tuple[float, str]]:
    """`roofline.chunk_bound` of each track_chunk launch of a track pass:
    the reference schedule's phases (a) and (b), whose 1 ms rows the
    merged record keeps up to each channel's switch row (phase (a)'s rows
    are (b)'s: both start from the same state; rows a channel does not
    keep count at the nominal S)."""
    case, S = ctx.case, ctx.case.S
    sw = _switch_rows(rec, S)
    n_ch = sw.shape[0]
    n1 = ctx.cfg["receiver"]["track"]["ms_eph_1ms"]
    phases = [n1, int(sw.max())]
    ntaps = 3
    out = []
    for length in phases:
        for r0 in range(0, length, CHUNK_BLOCKS):
            r1 = min(length, r0 + CHUNK_BLOCKS)
            start, stop, n = [], [], 0.0
            for ch in range(n_ch):
                have = int(min(r1, sw[ch]))
                missing = r1 - have
                n += float(rec["num_sample"][r0:have, ch].sum()) + S * missing
                start.append(int(case.init["ptr"][ch]) if r0 == 0 else
                             int(rec["absolute_sample"][min(r0, have) - 1, ch]))
                stop.append(int(rec["absolute_sample"][have - 1, ch])
                            + S * missing)
            out.append(roofline.chunk_bound(
                start, stop, n, r1 - r0, n_ch, ntaps, case.dc,
                ctx.sample_bytes))
    return out


def b3_launches(ctx, rec) -> List[Tuple[float, str]]:
    """`roofline.bank_bound` over windows of each 10 ms block of the
    reference schedule's phase (c): one launch a block, all channels."""
    S = ctx.case.S
    sw = _switch_rows(rec, S)
    T, n_ch = rec["num_sample"].shape
    n_blocks = (T - int(sw.max())) // 10
    rows = sw[None, :] + 10 * np.arange(n_blocks)[:, None]
    num = np.take_along_axis(rec["num_sample"], rows, axis=0)
    return [roofline.bank_bound(np.zeros(n_ch), num[j], 3, ctx.case.dc,
                                ctx.sample_bytes, windows=True)
            for j in range(n_blocks)]


def b2_launches(ctx, rec) -> List[Tuple[float, str]]:
    """`roofline.bank_bound` of each VT step's fetching-bank launch: the
    union of the channels' windows at each step's pointers."""
    num = rec["num_sample"]
    ptr = np.concatenate([rec["absolute_sample"][:1] - num[:1],
                          rec["absolute_sample"][:-1]])
    return [roofline.bank_bound(ptr[t], num[t], 3, ctx.case.dc,
                                ctx.sample_bytes, windows=False)
            for t in range(num.shape[0])]


_WHICH = {"b1": ("track", B1, b1_launches),
          "b3": ("track", B3, b3_launches),
          "b2": ("vt", B2, b2_launches)}


def roofline_pct(ctx, which: str) -> Optional[float]:
    kind, pattern, work = _WHICH[which]
    if ctx.trace is None or ctx.mix["output"] != kind:
        return None
    measured_s, n = ctx.trace.kernel_s(pattern)
    if not n:
        return None
    bounds = work(ctx, ctx.passes[0])
    if which in ("b2", "b3") and ctx.case.dc:
        n //= 2                         # the DC kernel, then the bank
    if n != len(bounds):
        print(f"sdrbench: {which}: the profiler saw {n} launches, the "
              f"records say {len(bounds)}; not read", file=sys.stderr)
        return None
    return 100.0 * sum(b for b, _ in bounds) / measured_s


def bound_by(ctx, which: str) -> Optional[str]:
    """What bounds most of the launches: "bytes", "fp32" or "fp64"."""
    kind, _, work = _WHICH[which]
    if ctx.mix["output"] != kind:
        return None
    by = [b for _, b in work(ctx, ctx.passes[0])]
    return max(set(by), key=by.count) if by else None
