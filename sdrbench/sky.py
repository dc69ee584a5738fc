"""The sky the benchmark's captures hold: broadcast ephemerides visible
from a receiver, made into a `GeometrySignal` (the frozen synthesizer).

A frozen copy of the constellation picker of the repository's scenario
(`tests/scenario.py`, which `gps_sdr_tpu_torch/io/scenario.py` copies):
(omega0, m0) variations of one broadcast ephemeris, each visible above
20° from the receiver at TOW0 with azimuths at least 0.5 rad apart, drawn
by a numpy generator of seed 7.  What a configuration file's `sky` group
sets: the PRNs and amplitudes, the noise, the receiver clock, the GPS
time of the capture's first sample and the front end's DC offset.
"""

from __future__ import annotations

import numpy as np

from sdrbench.frozen.coords import llh2xyz
from sdrbench.frozen.ephemeris import Ephemeris, sv_pos_vel_clock
from sdrbench.frozen.synthetic import GeometrySignal, GeometrySV, front_end

BASE_EPH = dict(
    sqrta=5153.6413, ecc=0.00122963, m0=2.14587329, omega0=1.25789432,
    i0=0.96679784, w=-0.89245321, deltan=4.3267e-09, omegadot=-7.2345e-09,
    idot=-4.2e-10, cuc=1.5272e-07, cus=2.3842e-07, crc=287.46875,
    crs=-2.59375, cic=-7.45058e-09, cis=1.3039e-08, toe=388800.0,
    toc=388800.0, af0=1.8364e-04, af1=2.0464e-12, af2=0.0,
    tgd=-7.4506e-09, iodc=23, iode=23, health=0, ura=0)
TOW0 = 388799.0


def visible_constellation(n_sv: int, truth_llh, min_el_deg: float = 20.0
                          ) -> list:
    """`n_sv` ephemerides visible from `truth_llh` (rad, rad, m) at TOW0."""
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


def geometry_signal(cfg: dict, device) -> GeometrySignal:
    """The configuration's sky as a `GeometrySignal` on `device`: the
    configuration file's `signal`, `file` and `cmn` groups give the front
    end and the atmosphere's coefficients, its `sky` group the rest."""
    sky, sig, cmn = cfg["sky"], cfg["receiver"]["signal"], cfg["receiver"]["cmn"]
    ephs = visible_constellation(len(sky["prns"]), sky["constellation_llh"])
    scale = sky["amp_scale"]
    svs = [GeometrySV(prn=p, eph=e, amplitude=scale * a)
           for p, e, a in zip(sky["prns"], ephs, sky["amplitudes"])]
    fe = front_end(sig["fs"], sig["f_if"],
                   cfg["receiver"]["file"]["data_precision"], fc=sig["fc"],
                   code_freq_basis=sig["code_freq_basis"])
    return GeometrySignal(
        fe, svs, llh2xyz(np.asarray(sky["receiver_llh"])).numpy(),
        sky["tow0"],
        clk_bias_s=sky["clk_bias_s"], clk_drift_sps=sky["clk_drift_sps"],
        atmosphere=sky["atmosphere"], iono_alpha=cmn["iono_alpha"],
        iono_beta=cmn["iono_beta"], doy=cmn["day_of_year"], device=device)


def make_capture(cfg: dict, seed: int, device, chunk_ms: int = 200
                 ) -> tuple:
    """(interleaved int8/int16 host array, the GeometrySignal): the
    configuration's `capture_ms` synthesized on `device`, its noise drawn
    from `seed`."""
    gs = geometry_signal(cfg, device)
    sky = cfg["sky"]
    values = gs.synthesize(cfg["capture_ms"], noise_std=sky["noise_std"],
                           seed=seed, chunk_ms=chunk_ms, dc=sky.get("dc"))
    return values, gs


def truth_chips(gs: GeometrySignal, capture_ms: int):
    """`f(prn, samples)`: the signal's chip count at capture samples,
    from the synthesizer's own ms boundaries (linear within a ms)."""
    spm = gs.cfg.signal.samples_per_ms
    _, chp = gs._boundaries(0, capture_ms)
    chp = chp.cpu().numpy()
    index = {sv.prn: i for i, sv in enumerate(gs.svs)}

    def f(prn: int, samples: np.ndarray) -> np.ndarray:
        row = chp[index[prn]]
        ms, k = np.divmod(np.asarray(samples, np.int64), spm)
        return row[ms] + k * (row[ms + 1] - row[ms]) / spm
    return f
