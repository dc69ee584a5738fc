"""The synthetic-geometry scenario of the repo's results record: a static
receiver at the reference's surveyed ground-truth location observing 5 GPS
SVs whose signals are generated from broadcast ephemerides with full
transmit-time geometry, atmosphere and a receiver clock bias and drift.

The port's own copy of the scenario the JAX package's end-to-end tests and
`make_results.py` use (`tests/scenario.py`): the same constants and the
same constellation picker, on the port's geodesy.  The capture is written
by the port's synthesizer (`GeometrySignal.synthesize`) on the chosen
device; its noise comes from a seeded `torch.Generator`, so its bytes
differ from the JAX package's file of the same scenario.
"""

from __future__ import annotations

import numpy as np

from gps_sdr_tpu_torch.config import (CommonConfig, FileConfig,
                                      ReceiverConfig, SignalConfig,
                                      SolutionConfig)
from gps_sdr_tpu_torch.geo.coords import llh2xyz
from gps_sdr_tpu_torch.geo.ephemeris import Ephemeris, sv_pos_vel_clock
from gps_sdr_tpu_torch.io.ifdata import IFSampleSource
from gps_sdr_tpu_torch.io.synthetic import GeometrySignal, GeometrySV

TOW0 = 388799.0  # 1 s before a frame (subframe-1) boundary so IDs 1..5
# all complete within ~31 s of capture
WEEK = 2239

TRUTH_LLH = (np.deg2rad(22.328444770087565),
             np.deg2rad(114.1713630049711), 4.0)

CFG = ReceiverConfig(
    file=FileConfig(name="geo_scn", skip_ms=0),
    signal=SignalConfig(f_if=1.25e6, fs=5e6),  # incommensurate
    # fs/fchip (4.89 samples/chip): commensurate sampling locks every chip
    # to the same fractional alignment and biases the E-L discriminator
    solu=SolutionConfig(truth_llh=TRUTH_LLH),
    # 3-tap E/P/L banks for the fast path; the multicorrelator run of the
    # record asks for its 25 taps itself
    cmn=CommonConfig(multicorr_ct=False, multicorr_vt=False),
)

BASE_EPH = dict(
    sqrta=5153.6413, ecc=0.00122963, m0=2.14587329, omega0=1.25789432,
    i0=0.96679784, w=-0.89245321, deltan=4.3267e-09, omegadot=-7.2345e-09,
    idot=-4.2e-10, cuc=1.5272e-07, cus=2.3842e-07, crc=287.46875,
    crs=-2.59375, cic=-7.45058e-09, cis=1.3039e-08, toe=388800.0,
    toc=388800.0, af0=1.8364e-04, af1=2.0464e-12, af2=0.0,
    tgd=-7.4506e-09, iodc=23, iode=23, health=0, ura=0)

# Stable PRN assignment for the scenario
SCN_PRNS = (3, 7, 16, 22, 27)
CLK_BIAS_S = 5e-4
CLK_DRIFT_SPS = 2e-9  # ~0.6 m/s clock drift
NOISE_STD = 8.0
AMPLITUDES = (3.0, 2.6, 2.8, 2.4, 2.7)
DURATION_MS = 32000


def visible_constellation(n_sv: int = 5, min_el_deg: float = 20.0,
                          truth_llh=TRUTH_LLH) -> list:
    """(omega0, m0) variations of BASE_EPH visible from `truth_llh` at
    TOW0 with azimuths at least 0.5 rad apart: the candidates shuffled and
    each one's af0 drawn by a numpy generator of seed 7, as
    `tests/scenario.py` picks them."""
    usr = llh2xyz(np.asarray(truth_llh)).numpy()
    picked, az_used = [], []
    rng = np.random.default_rng(7)
    candidates = [(o, m) for o in np.linspace(0, 2 * np.pi, 24, endpoint=False)
                  for m in np.linspace(0, 2 * np.pi, 12, endpoint=False)]
    rng.shuffle(candidates)
    for om, m0 in candidates:
        eph = dict(BASE_EPH, omega0=float(om), m0=float(m0),
                   af0=float(rng.uniform(-2e-4, 2e-4)))
        pos = sv_pos_vel_clock(Ephemeris.stack([eph], "cpu"), [TOW0])["pos"][0]
        los = pos.numpy() - usr
        up = usr / np.linalg.norm(usr)
        el = np.rad2deg(np.arcsin(np.dot(los, up) / np.linalg.norm(los)))
        if el < min_el_deg:
            continue
        east = np.cross([0.0, 0.0, 1.0], up)
        east /= np.linalg.norm(east)
        north = np.cross(up, east)
        az = np.arctan2(np.dot(los, east), np.dot(los, north))
        if any(abs((az - a + np.pi) % (2 * np.pi) - np.pi) < 0.5
               for a in az_used):
            continue
        az_used.append(az)
        picked.append(eph)
        if len(picked) == n_sv:
            return picked
    raise RuntimeError("not enough visible candidates")


def geometry_signal(tow0: float = TOW0, cfg: ReceiverConfig = CFG,
                    device=None) -> GeometrySignal:
    """The scenario's signal from GPS time `tow0` on `device` (the card
    when None): the 5 SVs at their amplitudes, seen from the truth
    position, with the receiver clock and the atmosphere."""
    return GeometrySignal(
        cfg, [GeometrySV(prn=p, eph=e, amplitude=a) for p, e, a in zip(
            SCN_PRNS, visible_constellation(len(SCN_PRNS)), AMPLITUDES)],
        llh2xyz(np.asarray(TRUTH_LLH)).numpy(), tow0, clk_bias_s=CLK_BIAS_S,
        clk_drift_sps=CLK_DRIFT_SPS, atmosphere=True,
        iono_alpha=cfg.cmn.iono_alpha, iono_beta=cfg.cmn.iono_beta,
        doy=cfg.cmn.day_of_year, device=device)


def write_capture(path: str, gs: GeometrySignal,
                  duration_ms: int = DURATION_MS,
                  seed: int = 11) -> IFSampleSource:
    """`gs`'s int8 IQ capture of `duration_ms` (noise NOISE_STD, drawn from
    `seed`), synthesized on its device straight into the file at `path`;
    returns the file's sample source."""
    out = np.memmap(path, dtype=np.int8, mode="w+",
                    shape=(2 * duration_ms * gs.cfg.signal.samples_per_ms,))
    gs.synthesize(duration_ms, noise_std=NOISE_STD, seed=seed, out=out)
    out.flush()
    del out
    return IFSampleSource(path, gs.cfg.file)
