"""Multi-correlator ACF feature extraction for NLOS/multipath analysis.

Equivalent of the reference's `ACF/CalculateFeatures.m`: from the 25-tap
correlator records of a multicorrelator tracking run, compute per-window
statistics that discriminate LOS from multipath/NLOS signal conditions:

  F1  mean max correlation amplitude over the window, optionally
      normalized by an elevation-expected amplitude polynomial
      (CalculateFeatures.m:186-188 uses a receiver-calibrated cubic)
  F2  mean tap-delay of the correlation maximum
  F3  variance of the max-tap delay
  F4  mean of the code discriminator
  F5  variance of the code discriminator

The reference computes these per 100 ms window per SV and assembles a
labeled matrix for classification; `acf_features` mirrors that layout.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass
class ACFFeatures:
    f1_amp: np.ndarray          # (W, N) mean max correlation (normalized)
    f2_delay: np.ndarray        # (W, N) mean delay of max tap [chips]
    f3_delay_var: np.ndarray    # (W, N)
    f4_disc_mean: np.ndarray    # (W, N)
    f5_disc_var: np.ndarray     # (W, N)

    def matrix(self) -> np.ndarray:
        """(W·N, 5) feature matrix, channel-major."""
        cols = [self.f1_amp, self.f2_delay, self.f3_delay_var,
                self.f4_disc_mean, self.f5_disc_var]
        return np.stack([c.reshape(-1) for c in cols], axis=-1)


def acf_envelope(corr: np.ndarray) -> np.ndarray:
    """(T, N, ntaps) correlation envelope √(I²+Q²) from (T,N,ntaps,2)."""
    return np.sqrt(corr[..., 0] ** 2 + corr[..., 1] ** 2)


def acf_features(corr: np.ndarray, code_err: np.ndarray,
                 taps: Sequence[float], window_ms: int = 100,
                 elevation_deg: Optional[np.ndarray] = None,
                 amp_poly: Optional[Sequence[float]] = None) -> ACFFeatures:
    """Compute ACF features over consecutive windows.

    corr       (T, N, ntaps, 2) multicorrelator I/Q records
    code_err   (T, N) DLL discriminator
    taps       tap offsets [chips]
    elevation_deg, amp_poly: optional elevation-expected amplitude
      normalization for F1 — amp_expected = polyval(amp_poly, el).
    """
    env = acf_envelope(corr)
    taps = np.asarray(taps, np.float64)
    T, N = env.shape[:2]
    W = T // window_ms
    env = env[:W * window_ms].reshape(W, window_ms, N, -1)
    ce = code_err[:W * window_ms].reshape(W, window_ms, N)
    max_amp = env.max(axis=-1)                    # (W, w, N)
    max_tap = taps[env.argmax(axis=-1)]           # (W, w, N) chips
    f1 = max_amp.mean(axis=1)
    if elevation_deg is not None and amp_poly is not None:
        el = np.broadcast_to(elevation_deg, f1.shape)
        expected = np.polyval(np.asarray(amp_poly), el)
        f1 = f1 / np.maximum(expected, 1e-9)
    return ACFFeatures(
        f1_amp=f1,
        f2_delay=max_tap.mean(axis=1),
        f3_delay_var=max_tap.var(axis=1),
        f4_disc_mean=ce.mean(axis=1),
        f5_disc_var=ce.var(axis=1),
    )
