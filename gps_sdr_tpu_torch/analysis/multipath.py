"""Multipath ACF distortion study.

Equivalent of the reference's `acqtckpos/MultipathSimulator.m`: synthesize
a LOS C/A signal plus one delayed, attenuated, phase-shifted reflection,
correlate against a clean replica over a dense tap grid, and return the
distorted autocorrelation functions for a sweep of multipath delays.
Useful both as an analysis tool and to generate multipath-stressed test
signals (the Urban-scenario analog).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from gps_sdr_tpu_torch.ops.cacode import CODE_LENGTH, ca_code


@dataclasses.dataclass
class MultipathACF:
    delays_chips: np.ndarray     # (D,) multipath delays
    taps_chips: np.ndarray       # (K,) correlator offsets
    acf: np.ndarray              # (D, K) correlation envelope
    acf_los: np.ndarray          # (K,) clean-LOS reference ACF


def _sampled_code(prn: int, fs: float, code_freq: float, n: int,
                  delay_chips: float) -> np.ndarray:
    k = np.arange(n, dtype=np.float64)
    chip = np.floor(k * code_freq / fs - delay_chips).astype(np.int64)
    return ca_code(prn)[chip % CODE_LENGTH]


def multipath_acf(prn: int = 3, fs: float = 40.92e6,
                  code_freq: float = 1.023e6,
                  delays_chips: Sequence[float] = tuple(np.linspace(0, 1.5, 26)),
                  alpha: float = 0.5, phase_rad: float = 0.0,
                  taps_chips: Sequence[float] = tuple(np.arange(-1.5, 1.55, 0.05)),
                  n_ms: int = 1) -> MultipathACF:
    """ACF of LOS + one reflection (amplitude `alpha`, carrier phase
    `phase_rad`) for each multipath delay (MultipathSimulator.m:6-64)."""
    n = int(round(fs * 1e-3 * n_ms))
    los = _sampled_code(prn, fs, code_freq, n, 0.0)
    taps = np.asarray(taps_chips, np.float64)
    replicas = np.stack([_sampled_code(prn, fs, code_freq, n, -t)
                         for t in taps])                       # (K, n)
    acf_los = np.abs(replicas @ los) / n
    out = np.empty((len(delays_chips), len(taps)))
    for i, d in enumerate(delays_chips):
        mp = alpha * np.exp(1j * phase_rad) * _sampled_code(
            prn, fs, code_freq, n, float(d))
        sig = los + mp
        out[i] = np.abs(replicas @ sig) / n
    return MultipathACF(delays_chips=np.asarray(delays_chips),
                        taps_chips=taps, acf=out, acf_los=acf_los)


def pseudorange_bias_chips(result: MultipathACF,
                           spacing: float = 0.5) -> np.ndarray:
    """DLL zero-crossing bias vs multipath delay: the tracking error a
    non-coherent E-L discriminator with the given spacing would settle at."""
    taps = result.taps_chips
    biases = np.empty(len(result.delays_chips))
    shifts = np.linspace(-0.6, 0.6, 241)
    for i, acf in enumerate(result.acf):
        disc = []
        for s in shifts:
            e = np.interp(s - spacing, taps, acf)
            l = np.interp(s + spacing, taps, acf)
            disc.append(e - l)
        disc = np.asarray(disc)
        j = np.argmin(np.abs(disc))
        biases[i] = shifts[j]
    return biases
