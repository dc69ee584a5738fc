"""One traced pass: `torch.profiler` over CPU and CUDA activity, reduced in
memory to what the per-layer readers need (nothing is written to disk).

`Trace` holds the device's kernels and copies (name, start, end in ns on
the host's realtime clock), the host's events (operators and runtime
calls), and the traced window's length.
"""

from __future__ import annotations

import re
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

_TEMPLATE = re.compile(r"<.*")


class Trace:
    def __init__(self, events, window_s: float, t0_ns: int, t1_ns: int):
        self.window_s = window_s
        self.kernels: List[Tuple[str, int, int]] = []
        self.copies: List[Tuple[str, int, int]] = []
        self.host: List[Tuple[str, int, int]] = []
        for ev in events:
            start = ev.start_ns()
            end = start + ev.duration_ns()
            name = ev.name()
            if "CUDA" in str(ev.device_type()):
                if end < t0_ns or start > t1_ns:
                    continue
                if name.startswith(("Memcpy", "Memset")):
                    self.copies.append((name, start, end))
                else:
                    self.kernels.append((name, start, end))
            elif t0_ns <= start <= t1_ns:
                self.host.append((name, start, end))
        self.t0_ns, self.t1_ns = t0_ns, t1_ns

    # ---------------- device intervals
    def intervals(self) -> np.ndarray:
        """Merged (start, end) intervals in which the device ran a kernel
        or a copy, clipped to the window."""
        iv = sorted((max(a, self.t0_ns), min(b, self.t1_ns))
                    for _, a, b in self.kernels + self.copies)
        out = []
        for a, b in iv:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return np.asarray(out, np.int64).reshape(-1, 2)

    def busy_s(self) -> float:
        iv = self.intervals()
        return float((iv[:, 1] - iv[:, 0]).sum()) * 1e-9

    def kernel_s(self, pattern: str) -> Tuple[float, int]:
        """(seconds, launches) of the kernels whose name matches."""
        rx = re.compile(pattern)
        hits = [(b - a) for n, a, b in self.kernels if rx.search(n)]
        return sum(hits) * 1e-9, len(hits)

    def copy_s(self, pattern: str) -> Tuple[float, int]:
        rx = re.compile(pattern)
        hits = [(b - a) for n, a, b in self.copies if rx.search(n)]
        return sum(hits) * 1e-9, len(hits)

    # ---------------- breakdown
    def device_ops(self, top: int = 10) -> list:
        tot: Dict[str, int] = defaultdict(int)
        for n, a, b in self.kernels + self.copies:
            tot[_short(n)] += b - a
        return [[n, t * 1e-9] for n, t in sorted(
            tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """The window's idle time by what the host was doing: each gap
        between device intervals is named by the host operator that was
        running at its middle (the innermost one), or by the operator the
        host started next when none was."""
        iv = self.intervals()
        edges = np.concatenate([[self.t0_ns], iv.ravel(), [self.t1_ns]])
        gaps = edges.reshape(-1, 2)
        host = sorted(self.host, key=lambda h: h[1])
        starts = np.asarray([h[1] for h in host], np.int64)
        tot: Dict[str, int] = defaultdict(int)
        for a, b in gaps:
            if b <= a:
                continue
            mid = (a + b) // 2
            i = int(np.searchsorted(starts, mid, side="right"))
            name = None
            for j in range(i - 1, max(i - 200, -1), -1):
                if host[j][1] <= mid < host[j][2]:
                    name = host[j][0]
                    break
            if name is None:
                name = ("host, before " + host[i][0] if i < len(host)
                        else "host, after the last operator")
            tot[name] += b - a
        return [[n, t * 1e-9] for n, t in sorted(
            tot.items(), key=lambda kv: -kv[1])[:top]]


def _short(name: str) -> str:
    """A kernel's name without its template arguments and parameters."""
    name = name.strip().replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return _TEMPLATE.sub("", name.split("(")[0])[:120] or name[:120]


def traced(fn: Callable[[], object], device) -> Tuple[object, Trace]:
    """Run `fn()` under the profiler; its result and its `Trace`."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, record_shapes=False,
                 with_stack=False) as prof:
        torch.cuda.synchronize(device) if device.type == "cuda" else None
        t0_ns = time.time_ns()
        t0 = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
        t1_ns = time.time_ns()
    # kineto stamps its events with the host's realtime clock in ns
    return out, Trace(prof.profiler.kineto_results.events(), window_s,
                      t0_ns, t1_ns)
