"""The least time an NVIDIA H100 SXM could take for the kernels' work.

A frozen copy of `chip_smoke.py`'s `bound_ms` / `chunk_bound` /
`bank_bound` / `union_samples`, with one repair: the kernels sum the tap
products in float64 (`csrc/nco_common.cuh`), so those adds are counted
against the float64 peak and the rest against the float32 one, and the
bound is the largest of the three times (the float32 and float64 pipes
are separate units, so neither waits for the other).

Per sample and channel: the Q32 phasor product 6 float32 operations, the
mix 6, per tap 2 float32 products and 2 float64 adds, DC removal 4
float32.  Bytes: each input sample read once (the union of the windows
where they overlap), the code tables, the NCO words, the outputs written
once.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np

# NVIDIA H100 SXM5 data sheet, dense, outside the tensor cores; at the
# card's full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
FP64_FLOP_PER_S = 34e12
PEAKS_SOURCE = "NVIDIA H100 SXM5 data sheet (700 W)"

F32_PER_SAMPLE, F32_PER_TAP, F64_PER_TAP, F32_DC = 12, 2, 2, 4
CODE_TABLE_BYTES = 1023 * 4


def bound_s(n_bytes: float, ops_f32: float, ops_f64: float
            ) -> Tuple[float, str]:
    """(seconds, what bounds it: "bytes", "fp32" or "fp64")."""
    t = {"bytes": n_bytes / HBM_BYTES_PER_S,
         "fp32": ops_f32 / FP32_FLOP_PER_S,
         "fp64": ops_f64 / FP64_FLOP_PER_S}
    by = max(t, key=t.get)
    return t[by], by


def ops(n_samples: float, ntaps: int, dc: bool) -> Tuple[float, float]:
    """(float32, float64) operations of correlating `n_samples`."""
    return (n_samples * (F32_PER_SAMPLE + F32_PER_TAP * ntaps + F32_DC * dc),
            n_samples * F64_PER_TAP * ntaps)


def union_samples(start: Iterable[int], stop: Iterable[int]) -> int:
    """Samples covered by the union of the windows [start, stop)."""
    total, reach = 0, None
    for a, b in sorted(zip(np.asarray(start).tolist(),
                           np.asarray(stop).tolist())):
        if reach is None or a > reach:
            total, reach = total + (b - a), b
        elif b > reach:
            total, reach = total + (b - reach), b
    return total


def chunk_bound(start, stop, n_samples: float, n_steps: int, n_ch: int,
                ntaps: int, dc: bool, sample_bytes: int
                ) -> Tuple[float, str]:
    """One `track_chunk` launch: channels tracked from `start` to `stop`
    over `n_steps` blocks that correlate `n_samples` in all; its records
    (taps as float32 pairs, 8 fields of 8 bytes) and end state (10 words)
    written once."""
    n_bytes = (union_samples(start, stop) * 2 * sample_bytes
               + n_ch * CODE_TABLE_BYTES
               + n_steps * n_ch * (ntaps * 2 * 4 + 8 * 8) + n_ch * 10 * 8)
    return bound_s(n_bytes, *ops(n_samples, ntaps, dc))


def bank_bound(ptr, num, ntaps: int, dc: bool, sample_bytes: int,
               windows: bool) -> Tuple[float, str]:
    """One bank launch over blocks of `num` samples at `ptr`: each window
    read once for the windows bank (B3, the windows are cut for it), the
    union of the windows for the fetching one (B2)."""
    ptr, num = np.asarray(ptr, np.int64), np.asarray(num, np.int64)
    n = len(ptr)
    read = int(num.sum()) if windows else union_samples(ptr, ptr + num)
    n_bytes = (read * 2 * sample_bytes + n * CODE_TABLE_BYTES
               + n * (5 if windows else 6) * 8 + ntaps * 8
               + n * ntaps * 2 * 4)
    return bound_s(n_bytes, *ops(float(num.sum()), ntaps, dc))
