"""Synthetic GPS L1 C/A IF-signal generation, on the device.

Every stage is verified against signals with known truth (the reference's
captures are not distributed).  Two fidelity levels:

- `generate_if_samples`: constant Doppler/delay per SV with nav bits —
  unit tests of acquisition/tracking/decode.
- `GeometrySignal`: full transmit-time geometry from broadcast ephemeris
  (SV orbits and clocks, receiver clock bias/drift, optional atmosphere),
  so recovered WLS positions can be checked against the antenna's truth.

Sample convention (acquisition.m:36): interleaved values v[2k]+1j·v[2k+1];
a signal at carrier phase θ contributes A·code·bit·(sin θ + i·cos θ), so
the receiver's I = imag(raw·e^{iθ̂}) (trackingCT.m:113-114) carries the
data bit at lock.  Noise comes from an explicit, seeded `torch.Generator`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from gps_sdr_tpu_torch.config import C_LIGHT, ReceiverConfig
from gps_sdr_tpu_torch.geo.atmosphere import klobuchar_delay, tropo_unb3_delay
from gps_sdr_tpu_torch.geo.coords import elevation_azimuth, f64, xyz2llh
from gps_sdr_tpu_torch.geo.earth import earth_rotation_correction
from gps_sdr_tpu_torch.geo.ephemeris import Ephemeris, sv_pos_vel_clock
from gps_sdr_tpu_torch.io import lnav
from gps_sdr_tpu_torch.ops.cacode import CODE_LENGTH, ca_code
from gps_sdr_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class SyntheticSV:
    """One emitter in simple (constant-dynamics) mode."""

    prn: int
    amplitude: float = 20.0
    doppler_hz: float = 0.0            # carrier Doppler excluding IF
    code_delay_samples: float = 0.0    # delay of the code epoch, in samples
    nav_bits: Optional[np.ndarray] = None  # {0,1} at 50 bps
    phase0_rad: float = 0.0


def _noise(n: int, std: float, gen: torch.Generator, device) -> torch.Tensor:
    """Complex Gaussian noise, std per component, float64."""
    z = torch.randn((2, n), generator=gen, dtype=torch.float64, device=device)
    return torch.complex(z[0], z[1]) * std


def generate_if_samples(cfg: ReceiverConfig, svs: Sequence[SyntheticSV],
                        duration_ms: int, noise_std: float = 0.0,
                        seed: int = 0, device=None) -> torch.Tensor:
    """Constant-dynamics IF stream, complex128 (n_samples,) on `device`
    (the card when None)."""
    device = resolve_device(device)
    sig = cfg.signal
    n = int(round(sig.fs * duration_ms * 1e-3))
    t = torch.arange(n, dtype=torch.float64, device=device) / sig.fs
    out = torch.zeros(n, dtype=torch.complex128, device=device)
    for sv in svs:
        f_carr = sig.f_if + sv.doppler_hz
        f_code = sig.code_freq_basis * (1.0 + sv.doppler_hz / sig.fc)
        chips = f64(ca_code(sv.prn), device)
        chip_phase = (t - sv.code_delay_samples / sig.fs) * f_code
        code = chips[torch.remainder(torch.floor(chip_phase).to(torch.int64),
                                     CODE_LENGTH)]
        amp = sv.amplitude * code
        if sv.nav_bits is not None:
            bits = f64(np.asarray(sv.nav_bits, np.float64), device)
            bit_idx = torch.clamp(torch.floor(chip_phase / (CODE_LENGTH * 20)
                                              ).to(torch.int64),
                                  0, len(bits) - 1)
            amp = amp * (1.0 - 2.0 * bits[bit_idx])
        theta = 2.0 * math.pi * f_carr * t + sv.phase0_rad
        out += amp * torch.complex(torch.sin(theta), torch.cos(theta))
    if noise_std > 0:
        gen = torch.Generator(device=out.device).manual_seed(seed)
        out += _noise(n, noise_std, gen, out.device)
    return out


def quantize_iq(iq: torch.Tensor, dtype=np.int8) -> np.ndarray:
    """Complex samples → interleaved int values (round half to even, clip),
    as a host array ready for `IFSampleSource.from_array`."""
    info = np.iinfo(dtype)
    tdt = torch.int8 if dtype == np.int8 else torch.int16
    v = torch.stack([iq.real, iq.imag], dim=-1).reshape(-1)
    return torch.clamp(torch.round(v), info.min, info.max).to(tdt).cpu(
        ).numpy()


@dataclasses.dataclass
class GeometrySV:
    """One emitter in geometry mode."""

    prn: int
    eph: Dict[str, float]        # SI-unit ephemeris fields (lnav schema)
    amplitude: float = 20.0


class GeometrySignal:
    """Transmit-time-consistent IF signal for a static receiver.

    For receiver-clock sample time t each SV contributes code and carrier
    at SV-clock transmit time T_sv(t) = t − δt_rx(t) − τ_geo + δt_sv, τ_geo
    solving the light-time equation against the broadcast orbit.  T_sv is
    solved exactly (float64) at ms boundaries and is linear within a ms,
    so each (SV, ms) is a carrier cycle count c0 + k·dc and a chip count
    p0 + k·dp in the sample index k: the formulation of the JAX package's
    `write_file_fast`.  Phases are wrapped in float64 and evaluated with
    float32 sin/cos (≤6e-8 cycle error, far under int8 quantization).
    Nav bits come from the LNAV encoder with edges on SV-clock 20 ms
    boundaries.
    """

    def __init__(self, cfg: ReceiverConfig, svs: Sequence[GeometrySV],
                 usr_pos_ecef, tow0: float, clk_bias_s: float = 0.0,
                 clk_drift_sps: float = 0.0,
                 n_subframes: int = 14, weeknum: int = 2239,
                 atmosphere: bool = False, iono_alpha=None, iono_beta=None,
                 doy: int = 171, device=None):
        self.cfg = cfg
        self.svs = list(svs)
        self.device = resolve_device(device)
        self.usr = f64(np.asarray(usr_pos_ecef, np.float64), self.device)
        self.tow0 = float(tow0)
        self.clk_bias_s = float(clk_bias_s)
        self.clk_drift_sps = float(clk_drift_sps)
        self.atmosphere = atmosphere
        self.iono_alpha, self.iono_beta, self.doy = iono_alpha, iono_beta, doy
        # the broadcast message starts at the earliest frame boundary at
        # least ~80 ms of travel time before tow0
        self.msg_tow0 = math.floor((tow0 - 1.0) / 30.0) * 30.0
        self.bits: Dict[int, np.ndarray] = {
            sv.prn: lnav.encode_frames(sv.eph, weeknum, self.msg_tow0,
                                       n_subframes) for sv in self.svs}
        self._eph = {sv.prn: Ephemeris.stack([sv.eph], self.device)
                     for sv in self.svs}

    def _atmos_delay_s(self, sv_pos: torch.Tensor, tow: torch.Tensor
                       ) -> torch.Tensor:
        """Klobuchar + UNB3 group delay [s] for (T,3)/(T,) inputs."""
        iono = klobuchar_delay(tow, sv_pos, self.usr, self.iono_alpha,
                               self.iono_beta)
        llh = xyz2llh(self.usr)
        el, _ = elevation_azimuth(sv_pos, self.usr)
        tropo = torch.abs(tropo_unb3_delay(
            self.doy, torch.rad2deg(llh[0]), llh[2], torch.rad2deg(el)))
        return (iono + tropo) / C_LIGHT

    def sv_clock_delta(self, prn: int, tau_rel) -> torch.Tensor:
        """delta = T_sv − t_rx_clock at capture offsets `tau_rel` [s]
        (light-time solve with Sagnac, 3 iterations).  delta stays
        O(0.1 s), so fc·delta keeps full float64 phase precision."""
        tau_rel = f64(tau_rel, self.device)
        eph = self._eph[prn]
        dt_rx = self.clk_bias_s + self.clk_drift_sps * tau_rel
        t_rx_gps = self.tow0 + tau_rel - dt_rx
        tau = torch.full_like(tau_rel, 0.075)
        for _ in range(3):
            out = sv_pos_vel_clock(eph, t_rx_gps - tau)
            # the range uses the transmit position expressed in the
            # reception-epoch frame (the effect erotcorr.m undoes)
            pos_rot = earth_rotation_correction(out["pos"], tau * C_LIGHT)
            r = torch.linalg.norm(pos_rot - self.usr, dim=-1)
            tau = r / C_LIGHT
            if self.atmosphere:
                tau = tau + self._atmos_delay_s(pos_rot, t_rx_gps)
        clk = out["clk_m"] / C_LIGHT - out["tgd_s"]
        return -dt_rx - tau + clk

    def _boundaries(self, ms0: int, n_ms: int):
        """(n_sv, n_ms+1) float64 carrier cycles and chip counts at the ms
        boundaries ms0 … ms0+n_ms (receiver clock)."""
        sig = self.cfg.signal
        spm = sig.samples_per_ms
        tau_b = (torch.arange(ms0, ms0 + n_ms + 1, dtype=torch.float64,
                              device=self.device) * (spm / sig.fs))
        rebase = self.tow0 - self.msg_tow0
        cyc, chp = [], []
        for sv in self.svs:
            delta_b = self.sv_clock_delta(sv.prn, tau_b)
            cyc.append(sig.fc * delta_b + sig.f_if * tau_b)
            chp.append((rebase + tau_b + delta_b) * sig.code_freq_basis)
        return torch.stack(cyc), torch.stack(chp)

    def _synth(self, cyc: torch.Tensor, chp: torch.Tensor) -> torch.Tensor:
        """Noise-free (n_ms·spm,) complex64 samples from boundary values."""
        spm = self.cfg.signal.samples_per_ms
        k = torch.arange(spm, dtype=torch.float64, device=self.device)
        n_ms = cyc.shape[1] - 1
        re = torch.zeros((n_ms, spm), dtype=torch.float32, device=self.device)
        im = torch.zeros_like(re)
        for i, sv in enumerate(self.svs):
            c0, p0 = cyc[i, :-1, None], chp[i, :-1, None]
            dc = (cyc[i, 1:, None] - cyc[i, :-1, None]) / spm
            dp = (chp[i, 1:, None] - chp[i, :-1, None]) / spm
            th = (2.0 * math.pi * torch.remainder(c0 + k * dc, 1.0)
                  ).to(torch.float32)
            chip = torch.floor(p0 + k * dp)
            table = torch.as_tensor(ca_code(sv.prn), dtype=torch.float32,
                                    device=self.device)
            code = table[torch.remainder(chip, CODE_LENGTH).to(torch.int64)]
            bits = torch.as_tensor(1.0 - 2.0 * self.bits[sv.prn]
                                   .astype(np.float32), device=self.device)
            bit = bits[torch.clamp(chip / (CODE_LENGTH * 20), 0,
                                   len(bits) - 1).to(torch.int64)]
            cb = sv.amplitude * code * bit
            re += cb * torch.sin(th)
            im += cb * torch.cos(th)
        return torch.complex(re, im).reshape(-1)

    def generate_ms(self, ms_start: int, n_ms: int, noise_std: float = 0.0,
                    seed: int = 0) -> torch.Tensor:
        """Complex64 IF samples for ms block [ms_start, ms_start+n_ms), on
        the signal's device."""
        out = self._synth(*self._boundaries(ms_start, n_ms))
        if noise_std > 0:
            gen = torch.Generator(device=self.device).manual_seed(
                seed + ms_start)
            out = out + _noise(out.numel(), noise_std, gen,
                               self.device).to(torch.complex64)
        return out

    def synthesize(self, duration_ms: int, noise_std: float = 0.0,
                   seed: int = 0, chunk_ms: int = 100,
                   out: Optional[np.ndarray] = None) -> np.ndarray:
        """The whole capture as interleaved int8/int16 values (a host
        array, or `out` — e.g. an np.memmap of a capture file), synthesized
        on the device `chunk_ms` at a time."""
        spm = self.cfg.signal.samples_per_ms
        dtype = np.int8 if self.cfg.file.data_precision == 1 else np.int16
        n_vals = 2 * duration_ms * spm
        if out is None:
            out = np.empty(n_vals, dtype=dtype)
        elif out.size != n_vals or out.dtype != dtype:
            raise ValueError(f"out must hold {n_vals} {np.dtype(dtype)}")
        cyc, chp = self._boundaries(0, duration_ms)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for ms in range(0, duration_ms, chunk_ms):
            nm = min(chunk_ms, duration_ms - ms)
            iq = self._synth(cyc[:, ms:ms + nm + 1], chp[:, ms:ms + nm + 1])
            if noise_std > 0:
                iq = iq + _noise(iq.numel(), noise_std, gen,
                                 self.device).to(torch.complex64)
            out[2 * ms * spm: 2 * (ms + nm) * spm] = quantize_iq(iq, dtype)
        return out
