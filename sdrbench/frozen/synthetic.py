"""The benchmark's capture synthesizer: a frozen copy of the port's
`io/synthetic.GeometrySignal` (and the geodesy it uses, beside it in this
folder), so that what the benchmark feeds the receiver does not move when
the program does.

Sample convention (acquisition.m:36): interleaved values v[2k]+1j·v[2k+1];
a signal at carrier phase θ contributes A·code·bit·(sin θ + i·cos θ), so
the receiver's I = imag(raw·e^{iθ̂}) (trackingCT.m:113-114) carries the
data bit at lock.  Noise comes from an explicit, seeded `torch.Generator`.

Two additions to the copy, neither of which changes a sample it makes
without them: `synthesize(dc=...)` adds a front end's DC offset before
quantizing (the Urban front end), and the quantized chunks are written
into the host array from the device without a numpy round trip.
`front_end` describes the capture with the few fields the synthesizer
reads, so it needs no configuration class of the program.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from sdrbench.frozen.atmosphere import klobuchar_delay, tropo_unb3_delay
from sdrbench.frozen.coords import elevation_azimuth, f64, xyz2llh
from sdrbench.frozen.earth import earth_rotation_correction
from sdrbench.frozen.ephemeris import Ephemeris, sv_pos_vel_clock
from sdrbench.frozen import lnav
from sdrbench.frozen.cacode import CODE_LENGTH, ca_code

C_LIGHT = 299_792_458.0


def front_end(fs: float, f_if: float, data_precision: int,
              fc: float = 1_575.42e6, code_freq_basis: float = 1.023e6):
    """What `GeometrySignal` reads of a receiver configuration:
    `.signal.{fs, f_if, fc, code_freq_basis, samples_per_ms}` and
    `.file.data_precision` (1: int8, 2: int16 IQ)."""
    from types import SimpleNamespace
    return SimpleNamespace(
        signal=SimpleNamespace(fs=fs, f_if=f_if, fc=fc,
                               code_freq_basis=code_freq_basis,
                               samples_per_ms=int(math.ceil(fs * 1e-3))),
        file=SimpleNamespace(data_precision=data_precision))


def _noise(n: int, std: float, gen: torch.Generator, device) -> torch.Tensor:
    """Complex Gaussian noise, std per component, float64."""
    z = torch.randn((2, n), generator=gen, dtype=torch.float64, device=device)
    return torch.complex(z[0], z[1]) * std


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

    def __init__(self, cfg, svs: Sequence[GeometrySV],
                 usr_pos_ecef, tow0: float, clk_bias_s: float = 0.0,
                 clk_drift_sps: float = 0.0,
                 n_subframes: int = 14, weeknum: int = 2239,
                 atmosphere: bool = False, iono_alpha=None, iono_beta=None,
                 doy: int = 171, device=None):
        self.cfg = cfg
        self.svs = list(svs)
        self.device = torch.device(device)
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

    def synthesize(self, duration_ms: int, noise_std: float = 0.0,
                   seed: int = 0, chunk_ms: int = 100,
                   out: Optional[np.ndarray] = None, dc=None) -> np.ndarray:
        """The whole capture as interleaved int8/int16 values (a host
        array, or `out`), synthesized on the device `chunk_ms` at a time.
        `dc` (I, Q) is added to every sample before it is quantized."""
        spm = self.cfg.signal.samples_per_ms
        dtype = np.int8 if self.cfg.file.data_precision == 1 else np.int16
        tdt = torch.int8 if dtype == np.int8 else torch.int16
        info = np.iinfo(dtype)
        n_vals = 2 * duration_ms * spm
        if out is None:
            out = np.empty(n_vals, dtype=dtype)
        elif out.size != n_vals or out.dtype != dtype:
            raise ValueError(f"out must hold {n_vals} {np.dtype(dtype)}")
        host = torch.from_numpy(out)
        cyc, chp = self._boundaries(0, duration_ms)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for ms in range(0, duration_ms, chunk_ms):
            nm = min(chunk_ms, duration_ms - ms)
            iq = self._synth(cyc[:, ms:ms + nm + 1], chp[:, ms:ms + nm + 1])
            if noise_std > 0:
                iq = iq + _noise(iq.numel(), noise_std, gen,
                                 self.device).to(torch.complex64)
            if dc is not None:
                iq = iq + complex(*dc)
            v = torch.stack([iq.real, iq.imag], dim=-1).reshape(-1)
            host[2 * ms * spm: 2 * (ms + nm) * spm].copy_(
                torch.clamp(torch.round(v), info.min, info.max).to(tdt))
        return out
