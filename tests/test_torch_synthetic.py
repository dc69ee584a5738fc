"""The port's synthetic IF generator against the JAX package's.

GeometrySignal: the port evaluates each ms as linear carrier-cycle and
chip counts from float64 boundary values (the JAX `write_file_fast`
formulation) with float32 sin/cos, the JAX `generate_ms` per sample in
float64 — so noise-free samples agree within 1e-4·amplitude (float32
sin/cos against float64), and the light-time solve to float64 round-off.
"""

import numpy as np
import pytest
import torch

from gps_sdr_tpu.config import (CommonConfig, FileConfig, ReceiverConfig,
                                SignalConfig)
from gps_sdr_tpu.geo.coords import llh2xyz
from gps_sdr_tpu.io import synthetic as jsyn
from gps_sdr_tpu_torch import convert
from gps_sdr_tpu_torch.io import synthetic as tsyn
from scenario import CLK_BIAS_S, CLK_DRIFT_SPS, TOW0, TRUTH_LLH, \
    visible_constellation

torch.set_num_threads(2)

CFG = ReceiverConfig(file=FileConfig(name="syn", skip_ms=0),
                     signal=SignalConfig(f_if=1.25e6, fs=4.1e6),
                     cmn=CommonConfig())
AMPS = (3.0, 2.6)
PRNS = (3, 7)


@pytest.fixture(scope="module")
def signals():
    ephs = visible_constellation(len(PRNS))
    usr = np.asarray(llh2xyz(np.asarray(TRUTH_LLH)))
    kw = dict(clk_bias_s=CLK_BIAS_S, clk_drift_sps=CLK_DRIFT_SPS,
              atmosphere=True, iono_alpha=CFG.cmn.iono_alpha,
              iono_beta=CFG.cmn.iono_beta, doy=CFG.cmn.day_of_year)
    j = jsyn.GeometrySignal(CFG, [jsyn.GeometrySV(prn=p, eph=e, amplitude=a)
                                  for p, e, a in zip(PRNS, ephs, AMPS)],
                            usr, TOW0, **kw)
    t = tsyn.GeometrySignal(convert.config_from_jax(CFG),
                            [tsyn.GeometrySV(prn=p, eph=e, amplitude=a)
                             for p, e, a in zip(PRNS, ephs, AMPS)],
                            usr, TOW0, device="cpu", **kw)
    return j, t


def test_nav_bits_identical(signals):
    j, t = signals
    for p in PRNS:
        np.testing.assert_array_equal(t.bits[p], j.bits[p])
    assert t.msg_tow0 == j.msg_tow0


def test_light_time_solve(signals):
    j, t = signals
    tau = np.linspace(0.0, 32.0, 33)
    for p in PRNS:
        np.testing.assert_allclose(t.sv_clock_delta(p, tau).numpy(),
                                   j.sv_clock_delta(p, tau), rtol=0,
                                   atol=1e-15)


@pytest.mark.parametrize("ms_start", [0, 1234])
def test_generate_ms_noise_free(signals, ms_start):
    j, t = signals
    ref = j.generate_ms(ms_start, 20)
    got = t.generate_ms(ms_start, 20).numpy()
    assert got.dtype == np.complex64 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * max(AMPS))


def test_synthesize_is_quantized_generate(signals):
    """The capture writer is generate_ms, quantized to int8 (noise free)."""
    _, t = signals
    vals = t.synthesize(30, chunk_ms=7)
    q = tsyn.quantize_iq(t.generate_ms(0, 30))
    np.testing.assert_array_equal(vals, q)
    noisy = t.synthesize(30, noise_std=8.0, seed=3)
    assert noisy.dtype == np.int8 and 7.0 < noisy.astype(float).std() < 9.5


def test_generate_if_samples_noise_free():
    bits = np.random.default_rng(0).integers(0, 2, 10)
    svs_j = [jsyn.SyntheticSV(prn=7, amplitude=3.0, doppler_hz=1234.5,
                              code_delay_samples=800.0, nav_bits=bits),
             jsyn.SyntheticSV(prn=21, amplitude=2.5, doppler_hz=-2500.25,
                              code_delay_samples=2345.0, phase0_rad=0.3)]
    svs_t = [tsyn.SyntheticSV(**vars(s)) for s in svs_j]
    ref = jsyn.generate_if_samples(CFG, svs_j, 25)
    got = tsyn.generate_if_samples(convert.config_from_jax(CFG), svs_t, 25,
                                   device="cpu")
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-9)
