"""The program's spans in a traced pass, and what the per-layer readers
make of them.

The program records spans (`gps_sdr_tpu_torch.utils.spans`) while a
profiler session is active, stamped with `time.time_ns()`, the clock on
which the trace opens and closes its window and kineto stamps the
device's events.  A program that records none (one older than its spans)
gives every reader here nothing to read, and none of them raises.

The main thread is the thread of the outermost `stage.*` span; a root is
a main-thread span with no parent (the pass's entry).  Each idle
nanosecond of the device inside the window goes to the innermost
main-thread span open at that instant (an exact overlap of the idle
intervals with the spans), or to none; spans of other threads (the
prefetch thread's `io.read`) are not counted there.
"""

from __future__ import annotations

import sys
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

_CACHE = "_sdrbench_spans"


class PassSpans:
    """The main thread's spans of one traced pass."""

    def __init__(self, spans: list, t0_ns: int, t1_ns: int):
        self.t0_ns, self.t1_ns = t0_ns, t1_ns
        stages = [s for s in spans if s.name.startswith("stage.")]
        first = min(stages, key=lambda s: s.start_ns)
        self.main = [s for s in spans if s.thread == first.thread]
        self.roots = [s for s in self.main if s.parent is None]
        self._children: Dict[int, list] = defaultdict(list)
        for s in self.main:
            if s.parent is not None:
                self._children[s.parent].append(s)

    def named(self, name: str) -> list:
        return [s for s in self.main if s.name == name]

    def total(self, name: str) -> Tuple[float, int]:
        """(seconds, summed n) of the main thread's spans called `name`."""
        hits = self.named(name)
        return (sum(s.end_ns - s.start_ns for s in hits) * 1e-9,
                sum(s.n for s in hits))

    def self_s(self, name: str) -> float:
        """The spans' durations less their children's (a thread's spans
        nest, so the children never overlap)."""
        return sum((s.end_ns - s.start_ns)
                   - sum(c.end_ns - c.start_ns for c in self._children[s.id])
                   for s in self.named(name)) * 1e-9

    def roots_outside(self, name: str) -> float:
        """Seconds of the roots not covered by spans called `name`."""
        inside = [s for s in self.named(name)
                  if any(r.start_ns <= s.start_ns and s.end_ns <= r.end_ns
                         for r in self.roots)]
        return (sum(r.end_ns - r.start_ns for r in self.roots)
                - sum(s.end_ns - s.start_ns for s in inside)) * 1e-9

    def innermost(self) -> List[tuple]:
        """[(a, b, span or None)]: the window cut where the main thread's
        innermost open span changes."""
        out, stack, cur = [], [], self.t0_ns

        def until(t):
            nonlocal cur
            while stack and stack[-1].end_ns <= t:
                s = stack.pop()
                if s.end_ns > cur:
                    out.append((cur, s.end_ns, s))
                    cur = s.end_ns
            if t > cur:
                out.append((cur, t, stack[-1] if stack else None))
                cur = t

        for s in sorted(self.main, key=lambda s: (s.start_ns, -s.end_ns)):
            until(min(max(s.start_ns, self.t0_ns), self.t1_ns))
            stack.append(s)
        until(self.t1_ns)
        return out

    def idle_by_span(self, intervals: np.ndarray) -> Dict[object, int]:
        """Idle ns of the window by the innermost main-thread span open
        then (None: none open), from the device's merged busy
        `intervals`."""
        edges = np.concatenate([[self.t0_ns], np.asarray(intervals).ravel(),
                                [self.t1_ns]])
        gaps = [(int(a), int(b)) for a, b in edges.reshape(-1, 2) if b > a]
        segs = self.innermost()
        tot: Dict[object, int] = defaultdict(int)
        i = j = 0
        while i < len(gaps) and j < len(segs):
            a = max(gaps[i][0], segs[j][0])
            b = min(gaps[i][1], segs[j][1])
            if b > a:
                tot[segs[j][2]] += b - a
            if gaps[i][1] < segs[j][1]:
                i += 1
            else:
                j += 1
        return tot

    def unspanned_pct(self, intervals: np.ndarray) -> Optional[float]:
        """Share of the idle time in which the innermost open span was a
        root or none, in percent; the eight names with the most idle
        time printed to stderr."""
        tot = self.idle_by_span(intervals)
        idle = sum(tot.values())
        if not idle:
            return None
        roots = {s.id for s in self.roots}
        bare = sum(ns for s, ns in tot.items()
                   if s is None or s.id in roots)
        by_name: Dict[str, int] = defaultdict(int)
        for s, ns in tot.items():
            by_name["none" if s is None else s.name] += ns
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        print("sdrbench: idle by span: " + ", ".join(
            f"{n} {ns * 1e-9}" for n, ns in top), file=sys.stderr)
        return 100.0 * bare / idle


def load(ctx, kind: str) -> Optional[PassSpans]:
    """The traced pass's spans when the cell's output is `kind` and the
    program recorded a stage there; else None."""
    if ctx.trace is None or ctx.mix["output"] != kind:
        return None
    if not hasattr(ctx, _CACHE):
        setattr(ctx, _CACHE, _read(ctx))
    return getattr(ctx, _CACHE)


def _read(ctx) -> Optional[PassSpans]:
    try:
        from gps_sdr_tpu_torch.utils.spans import recorded
    except ImportError:
        return None
    t0, t1 = ctx.trace.t0_ns, ctx.trace.t1_ns
    spans = recorded(t0, t1)
    if not any(s.name.startswith("stage.") for s in spans):
        return None
    return PassSpans(spans, t0, t1)


def per_capture_s(ctx, name: str) -> Optional[float]:
    """ms of the main thread's `name` spans per second of capture the
    traced tracking pass covered."""
    sp = load(ctx, "track")
    if sp is None or not ctx.covered_s or not sp.named(name):
        return None
    return sp.total(name)[0] * 1e3 / ctx.covered_s


def per_step_us(ctx, seconds: float) -> Optional[float]:
    """`seconds` of the traced VT pass in µs a step."""
    return seconds * 1e6 / ctx.steps if ctx.steps else None
