"""Tracking-loop filters and discriminators.

Second-order loop filter in the SoftGNSS form used by the reference
(`calcLoopCoef.m:41-45`, update recurrences in `trackingCT.m:137-150` and
`trackingCT_POS_updated.m:252-270`).  The discriminators take batched
tensors (channels on the leading axes); the CUDA tracking kernel carries
the same arithmetic per channel.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def loop_coefficients(bw_hz: float, zeta: float, gain: float
                      ) -> Tuple[float, float]:
    """(tau1, tau2) for a 2nd-order loop (calcLoopCoef.m:41-45)."""
    wn = bw_hz * 8.0 * zeta / (4.0 * zeta * zeta + 1.0)
    tau1 = gain / (wn * wn)
    tau2 = 2.0 * zeta / wn
    return tau1, tau2


def loop_filter_step(nco: torch.Tensor, last_error: torch.Tensor,
                     error: torch.Tensor, gain_p: float, gain_i: float
                     ) -> torch.Tensor:
    """One proportional+integral update, the new NCO command:
    nco' = nco + (tau2/tau1)·(e − e_prev) + e·(dt/tau1), with
    gain_p = tau2/tau1 and gain_i = dt/tau1
    (trackingCT.m:140, trackingCT_POS_updated.m:257-258)."""
    return nco + gain_p * (error - last_error) + error * gain_i


def dll_discriminator(e_i: torch.Tensor, e_q: torch.Tensor,
                      l_i: torch.Tensor, l_q: torch.Tensor) -> torch.Tensor:
    """Normalized non-coherent early-minus-late envelope, float64:
    0.5·(E−L)/(E+L) (trackingCT.m:137-139).  The envelopes are formed in
    the correlators' dtype (float32), the ratio in float64, as in the
    JAX scan (tracking.py:415-417).  Safe at E+L→0."""
    e = torch.sqrt(e_i * e_i + e_q * e_q).to(torch.float64)
    l = torch.sqrt(l_i * l_i + l_q * l_q).to(torch.float64)
    return 0.5 * (e - l) / torch.clamp(e + l, min=1e-30)


def pll_discriminator(p_i: torch.Tensor, p_q: torch.Tensor,
                      two_pi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Costas discriminator in cycles, atan(Q/I)/2π (trackingCT.m:146).

    `atan` of the ratio, not `atan2`: the Costas loop must not see the
    data-bit sign.  Evaluated in the correlators' dtype, returned as
    float64 (tracking.py:424-426).  2π is a device tensor so the division
    is a true one on every device (CUDA turns division by a host scalar
    into a reciprocal multiply); a caller whose step is captured into a
    CUDA graph makes it once and passes it (a capture may not copy from the
    host)."""
    safe_i = torch.where(p_i == 0, torch.full_like(p_i, 1e-30), p_i)
    if two_pi is None:
        two_pi = torch.tensor(2.0 * math.pi, dtype=p_i.dtype,
                              device=p_i.device)
    return (torch.atan(p_q / safe_i) / two_pi).to(torch.float64)


def cn0_moment_estimator(zk: torch.Tensor, t_coh_s, signed: bool = False
                         ) -> torch.Tensor:
    """Moment-method C/N0 from a window of prompt powers Zk = P_i²+P_q².

    CN0 = |10·log10( (1/T)·NA²/(2·varIQ) )| with NA² = sqrt(E[Z]²−Var[Z]),
    varIQ = (E[Z]−NA²)/2, over a K=20 window (trackingCT.m:120-134).
    `zk` has the window on the last axis.  `signed=True` skips the
    reference's abs() quirk (the validity gate needs the signed value).
    """
    mean_zk = zk.mean(dim=-1)
    var_zk = zk.var(dim=-1, correction=1)
    na2 = torch.sqrt(torch.clamp(mean_zk * mean_zk - var_zk, min=1e-30))
    var_iq = 0.5 * (mean_zk - na2)
    ratio = na2 / torch.clamp(2.0 * var_iq, min=1e-30)
    cn0 = 10.0 * torch.log10(torch.clamp(ratio / t_coh_s, min=1e-30))
    return cn0 if signed else torch.abs(cn0)
