"""FFT parallel code-phase acquisition on torch.fft.

The reference's triple loop (32 PRN × 20 blocks × 41 Doppler bins,
acquisition.m:47-61) as batched FFTs:

  X[b,f]   = FFT(block_b · carrier_f)                 (batched over F)
  P[p,f,:] += |IFFT(C[p] · conj(X[b,f]))|²            (batched over p,f)

— the reference-exact circular correlation in complex64, at the capture's
own (non power-of-two) FFT length.  The (P,F,S) power grid stays on the
device; only per-PRN peak statistics come back.  Fine Doppler uses the
reference's long-FFT method (acquisition.m:102-121): strip the code over
`L` ms at the acquired delay, zero-pad ×20, take the spectrum peak.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.io.ifdata import IFSampleSource
from gps_sdr_tpu_torch.ops.cacode import CODE_LENGTH, ca_code_table
from gps_sdr_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class AcquisitionResult:
    """Equivalent of the reference's `Acquired` struct (host arrays)."""

    sv: np.ndarray                 # acquired PRNs (1-based)
    snr_db: np.ndarray
    doppler_hz: np.ndarray         # coarse Doppler (grid bin)
    code_delay: np.ndarray         # 0-based sample delay (acquisition.m:74)
    fine_freq_hz: np.ndarray       # absolute fine carrier freq (IF-relative
                                   # Doppler = fine_freq − IF)

    def channel_index(self, prn: int) -> int:
        return int(np.nonzero(self.sv == prn)[0][0])


def doppler_carriers(cfg: ReceiverConfig, n_samples: Optional[int] = None
                     ) -> np.ndarray:
    """(F, n) complex64 carrier grid exp(+i·2π(IF+fd)·k/fs), k=1..n
    (acquisition.m:41-44).  Phase accumulated in f64, wrapped, then cast."""
    sig, acq = cfg.signal, cfg.acq
    n = n_samples or sig.samples_per_ms
    k = np.arange(1, n + 1, dtype=np.float64)
    f = np.asarray(acq.doppler_bins_hz, dtype=np.float64) + sig.f_if
    cycles = np.mod(f[:, None] * k[None, :] / sig.fs, 1.0)
    return np.exp(2j * np.pi * cycles).astype(np.complex64)


def sampled_codes(cfg: ReceiverConfig, prns: Sequence[int]) -> np.ndarray:
    """(P, S) float32 code replicas: scode[k] = code[ceil((k+1)·fchip/fs)]
    (acquisition.m:49-51)."""
    sig = cfg.signal
    k = np.arange(1, sig.samples_per_ms + 1, dtype=np.float64)
    chip = (np.ceil(k * sig.code_freq_basis / sig.fs).astype(np.int64) - 1
            ) % CODE_LENGTH
    table = ca_code_table()
    return np.stack([table[p - 1][chip] for p in prns])


def acquisition_power_grid(blocks: torch.Tensor, carriers: torch.Tensor,
                           code_fft: torch.Tensor, prn_chunk: int = 8
                           ) -> torch.Tensor:
    """Non-coherent power over the full search grid, circular correlation
    (exactly acquisition.m:53-61).

    blocks   (B, S) complex64 — B 1-ms sample blocks
    carriers (F, S) complex64 — Doppler carrier grid
    code_fft (P, S) complex64 — FFT of the sampled code replicas
    returns  (P, F, S) float32 power
    """
    P, S = code_fft.shape
    F = carriers.shape[0]
    acc = torch.zeros((P, F, S), dtype=torch.float32, device=blocks.device)
    for b in range(blocks.shape[0]):
        xc = torch.conj(torch.fft.fft(blocks[b][None, :] * carriers, dim=-1))
        for p0 in range(0, P, prn_chunk):
            cf = code_fft[p0:p0 + prn_chunk]
            y = torch.fft.ifft(cf[:, None, :] * xc[None, :, :], dim=-1)
            acc[p0:p0 + prn_chunk] += y.abs() ** 2
    return acc


def peak_statistics(power: torch.Tensor, cfg: ReceiverConfig):
    """Per-PRN (snr_db, best_freq_idx, code_delay) from the power grid.

    SNR per acquisition.m:62-68: peak² over the mean squared off-peak power
    of the best frequency row, excluding ±1 chip around the peak.
    """
    chip_w = int(np.ceil(cfg.signal.fs / cfg.signal.code_freq_basis))
    P, F, S = power.shape
    flat = power.reshape(P, F * S)
    arg = torch.argmax(flat, dim=1)
    fbin = arg // S
    delay = arg % S
    peak = torch.gather(flat, 1, arg[:, None])[:, 0]
    row = power[torch.arange(P, device=power.device), fbin]       # (P, S)
    idx = torch.arange(S, device=power.device)[None, :]
    keep = (idx <= delay[:, None] - chip_w) | (idx >= delay[:, None] + chip_w)
    mean_off = (torch.where(keep, row, 0.0) ** 2).sum(dim=1) \
        / keep.sum(dim=1).to(torch.float32)
    snr = 10.0 * torch.log10(peak ** 2 / mean_off)
    return snr.cpu().numpy(), fbin.cpu().numpy(), delay.cpu().numpy()


def _fine_segment(long_signal: np.ndarray, prn: int, code_delay: int,
                  cfg: ReceiverConfig) -> np.ndarray:
    """Code-stripped fine-Doppler segment (acquisition.m:104-106), from the
    first code epoch after the first ms (0-based sample S − codedelay)."""
    sig, acq = cfg.signal, cfg.acq
    S = sig.samples_per_ms
    n = acq.fine_fft_ms * S
    k = np.arange(1, n + 1, dtype=np.float64)
    chip = (np.ceil(k * sig.code_freq_basis / sig.fs).astype(np.int64) - 1
            ) % CODE_LENGTH
    code = ca_code_table()[prn - 1][chip]
    start = S - int(code_delay)
    return np.asarray(long_signal[start:start + n],
                      dtype=np.complex64) * code


def fine_doppler(long_signal: np.ndarray, prn: int, code_delay: int,
                 cfg: ReceiverConfig, device=None) -> float:
    """Fine carrier frequency via the ×20 zero-padded long FFT
    (acquisition.m:102-121), at the exact non power-of-two length, in
    complex128, on `device`.  Resolution fs/(L·S·20) ≈ 5 Hz at 58 MHz."""
    device = resolve_device(device)
    sig, acq = cfg.signal, cfg.acq
    seg = _fine_segment(long_signal, prn, code_delay, cfg)
    fftlen = seg.shape[0] * acq.n_noncoherent_ms
    x = torch.as_tensor(seg, device=device).to(torch.complex128)
    spec = torch.fft.fft(x, n=fftlen).abs()
    if cfg.file.data_type == 2:
        spec = torch.fft.fftshift(spec)
        idx = int(torch.argmax(spec)) + 1
        return float(-idx * (sig.fs / fftlen) + sig.fs / 2.0)
    idx = int(torch.argmax(spec)) + 1
    return float(idx * (sig.fs / fftlen))


def run_acquisition(source: IFSampleSource, cfg: ReceiverConfig,
                    prns: Optional[Sequence[int]] = None,
                    device=None, power_fn=None) -> AcquisitionResult:
    """Full acquisition stage on one capture (acquisition.m end to end),
    on `device` (the card when None).

    `power_fn(blocks, carriers, code_fft)` overrides the grid computation
    (`acquisition_power_grid`'s arguments and result; e.g. the PRN-sharded
    grid of `parallel.acquisition.sharded_acquisition_power`)."""
    device = resolve_device(device)
    prns = list(prns if prns is not None else cfg.acq.prn_list)
    sig, acq = cfg.signal, cfg.acq
    S = sig.samples_per_ms
    start = cfg.file.skip_ms * S

    raw = source.read_complex(start, acq.n_noncoherent_ms * S)
    blocks = torch.as_tensor(raw.reshape(acq.n_noncoherent_ms, S),
                             device=device)
    carriers = torch.as_tensor(doppler_carriers(cfg), device=device)
    code_fft = torch.as_tensor(
        np.fft.fft(sampled_codes(cfg, prns)).astype(np.complex64),
        device=device)
    power = (power_fn or acquisition_power_grid)(blocks, carriers, code_fft)
    snr, fbin, delay = peak_statistics(power, cfg)
    del power

    keep = snr >= acq.snr_threshold_db
    sv = np.asarray(prns)[keep]
    doppler = acq.freq_min + acq.freq_step * fbin[keep]
    code_delay = delay[keep]

    long_raw = source.read_complex(start, (acq.fine_fft_ms + 1) * S)
    fine = np.array([fine_doppler(long_raw, int(p), int(d), cfg, device)
                     for p, d in zip(sv, code_delay)])
    return AcquisitionResult(sv=sv, snr_db=snr[keep], doppler_hz=doppler,
                             code_delay=code_delay, fine_freq_hz=fine)
