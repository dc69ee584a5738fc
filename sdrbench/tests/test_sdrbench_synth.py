"""The frozen synthesizer and sky against the port's at a tiny size on
the CPU: the same values, bit for bit."""

import numpy as np
import torch

from sdrbench import sky
from sdrbench.frozen.synthetic import GeometrySignal, GeometrySV, front_end


def test_frozen_synthesizer_equals_the_port():
    from gps_sdr_tpu_torch.config import (FileConfig, ReceiverConfig,
                                          SignalConfig)
    from gps_sdr_tpu_torch.io import scenario
    from gps_sdr_tpu_torch.io.synthetic import GeometrySignal as PortSignal
    from gps_sdr_tpu_torch.io.synthetic import GeometrySV as PortSV

    llh = (0.3897057693107332, 1.9926489077944098, 4.0)
    ephs = sky.visible_constellation(3, llh)
    assert ephs == scenario.visible_constellation(3, truth_llh=llh)
    usr = np.asarray(scenario.llh2xyz(np.asarray(llh)))
    kw = dict(clk_bias_s=5e-4, clk_drift_sps=2e-9, atmosphere=True,
              iono_alpha=(9.3132e-09, 1.4901e-08, -5.9605e-08, -1.1921e-07),
              iono_beta=(8.8064e+04, 4.9152e+04, -1.3107e+05, -3.2768e+05),
              doy=171, device="cpu")
    for prec, fs, f_if in ((1, 1.3e6, 0.3e6), (2, 1.1e6, 0.0)):
        cfg = ReceiverConfig(file=FileConfig(data_precision=prec),
                             signal=SignalConfig(fs=fs, f_if=f_if))
        amps = (3.0, 2.6, 2.8) if prec == 1 else (300.0, 260.0, 280.0)
        port = PortSignal(cfg, [PortSV(p, e, a) for p, e, a in zip(
            (3, 7, 16), ephs, amps)], usr, 388797.0, **kw)
        mine = GeometrySignal(front_end(fs, f_if, prec), [
            GeometrySV(p, e, a) for p, e, a in zip((3, 7, 16), ephs, amps)],
            usr, 388797.0, **kw)
        a = port.synthesize(250, noise_std=8.0, seed=2 ** 31 + 9,
                            chunk_ms=100)
        b = mine.synthesize(250, noise_std=8.0, seed=2 ** 31 + 9,
                            chunk_ms=100)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        # the DC offset is added before quantizing, nothing else changes
        # (a sample may round the other way by one: float32 sums, ties)
        c = mine.synthesize(250, noise_std=8.0, seed=2 ** 31 + 9,
                            chunk_ms=100, dc=(230, -95))
        d = (c.astype(np.int64) - b.astype(np.int64)).reshape(-1, 2)
        info = np.iinfo(b.dtype)
        inside = (np.abs(b.reshape(-1, 2).astype(np.int64)) < info.max - 300
                  ).all(axis=1)
        assert inside.any() or prec == 1
        assert (abs(d[inside] - [230, -95]) <= 1).all()


def test_truth_chips_follow_the_boundaries():
    cfg = {"sky": {"prns": [3], "amplitudes": [1.0], "amp_scale": 1.0,
                   "noise_std": 0.0,
                   "constellation_llh": [0.3897057693107332,
                                         1.9926489077944098, 4.0],
                   "receiver_llh": [0.3897057693107332, 1.9926489077944098,
                                    4.0],
                   "tow0": 388797.0, "clk_bias_s": 0.0, "clk_drift_sps": 0.0,
                   "atmosphere": False, "dc": None},
           "receiver": {"signal": {"fs": 1.0e6, "f_if": 0.0, "fc": 1575.42e6,
                                   "code_freq_basis": 1.023e6},
                        "file": {"data_precision": 1},
                        "cmn": {"iono_alpha": [0, 0, 0, 0],
                                "iono_beta": [0, 0, 0, 0],
                                "day_of_year": 171}}}
    gs = sky.geometry_signal(cfg, torch.device("cpu"))
    f = sky.truth_chips(gs, 10)
    _, chp = gs._boundaries(0, 10)
    assert np.allclose(f(3, np.array([0, 1000, 5500])),
                       [chp[0, 0], chp[0, 1],
                        0.5 * (chp[0, 5] + chp[0, 6])])
