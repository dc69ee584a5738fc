"""The kernel launches of a traced pass, worked out from the pass's own
records, and what the per-layer readers make of them.

The records say which blocks each channel ran; how the stage groups them
into launches is the program's public schedule, which the output kind's
module (`outputs/<kind>.py`, `launches(ctx, rec)`) applies, listing only
the kernels its stage launches: `run_tracking` gives `track_chunk` (B1)
one launch per chunk of the pass's `chunk_ms` blocks at pdi 1 ms
(`chunk_launches`), and
`track_scan` one windows-bank (B3) launch per 10 ms block for all
channels; `vt_position` one fetching-bank (B2) launch per 1 ms step.
With DC removal each bank launch is preceded by the bank's DC kernel,
whose time is the bank's too (an eph stage runs no fetching bank, a VT
stage no windows bank).  A reader counts the launches it works out
against the kernels the profiler saw and reads nothing when they
differ.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Tuple

from sdrbench import roofline

B1 = r"\btrack_chunk_kernel\b"
B3 = r"\bcorr_bank_(windows|dc)_kernel\b"
B2 = r"\bcorr_bank(_dc)?_kernel\b"
PATTERNS = {"b1": B1, "b2": B2, "b3": B3}


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


def chunk_launches(case, rec, lengths, kept, ntaps: int, chunk: int,
                   sample_bytes: int) -> List[Tuple[float, str]]:
    """`roofline.chunk_bound` of each track_chunk launch of `run_tracking`
    calls over `lengths` rows each (one launch per `chunk` rows at pdi
    1 ms, every call from the acquisition state): a record keeps rows
    [0, kept[ch]) of channel ch, and the rows it does not keep count at
    the nominal S."""
    S = case.S
    out = []
    for length in lengths:
        for r0 in range(0, length, chunk):
            r1 = min(length, r0 + chunk)
            start, stop, n = [], [], 0.0
            for ch in range(len(kept)):
                have = int(min(r1, kept[ch]))
                missing = r1 - have
                n += float(rec["num_sample"][r0:have, ch].sum()) + S * missing
                start.append(int(case.init["ptr"][ch]) if r0 == 0 else
                             int(rec["absolute_sample"][min(r0, have) - 1, ch]))
                stop.append(int(rec["absolute_sample"][have - 1, ch])
                            + S * missing)
            out.append(roofline.chunk_bound(
                start, stop, n, r1 - r0, len(kept), ntaps, case.dc,
                sample_bytes))
    return out


def bounds(ctx, which: str) -> Optional[List[Tuple[float, str]]]:
    """The bound of each launch of kernel `which` in the first pass, as
    the output kind worked them out once for the traced line
    (`ctx.launches`); None where its stage launches none."""
    return ctx.launches.get(which)


def roofline_pct(ctx, which: str) -> Optional[float]:
    if ctx.trace is None:
        return None
    work = bounds(ctx, which)
    if work is None:
        return None
    measured_s, n = ctx.trace.kernel_s(PATTERNS[which])
    if not n:
        return None
    if which in ("b2", "b3") and ctx.case.dc:
        n //= 2                         # the DC kernel, then the bank
    if n != len(work):
        print(f"sdrbench: {which}: the profiler saw {n} launches, the "
              f"records say {len(work)}; not read", file=sys.stderr)
        return None
    return 100.0 * sum(b for b, _ in work) / measured_s


def bound_by(ctx, which: str) -> Optional[str]:
    """What bounds most of the launches: "bytes", "fp32" or "fp64"."""
    by = [b for _, b in bounds(ctx, which) or []]
    return max(set(by), key=by.count) if by else None
