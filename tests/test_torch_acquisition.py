"""The port's acquisition (torch.fft, circular complex64 grid + long-FFT
fine Doppler) against the JAX package's on the same int8 capture.  On the
CPU the JAX package takes the same circular grid and the host fine FFT
(acquisition.py:367-370), so the search results are identical and the SNR
differs only by float32 FFT round-off."""

import numpy as np
import pytest
import torch

from gps_sdr_tpu.acquisition import run_acquisition as j_run
from gps_sdr_tpu.config import (AcqConfig, FileConfig, ReceiverConfig,
                                SignalConfig)
from gps_sdr_tpu.io.ifdata import IFSampleSource as JSource
from gps_sdr_tpu.io.synthetic import SyntheticSV, generate_if_samples
from gps_sdr_tpu_torch import convert
from gps_sdr_tpu_torch.acquisition import run_acquisition as t_run
from gps_sdr_tpu_torch.io.ifdata import IFSampleSource as TSource

torch.set_num_threads(2)

CFG = ReceiverConfig(
    file=FileConfig(name="acq", skip_ms=0),
    signal=SignalConfig(f_if=1.25e6, fs=4.1e6),
    acq=AcqConfig(prn_list=(1, 3, 5, 7, 11, 16, 22, 27)))
SVS = [SyntheticSV(prn=3, amplitude=2.0, doppler_hz=1750.0,
                   code_delay_samples=1234.5),
       SyntheticSV(prn=16, amplitude=1.6, doppler_hz=-3260.0,
                   code_delay_samples=77.25),
       SyntheticSV(prn=27, amplitude=1.2, doppler_hz=4420.0,
                   code_delay_samples=3900.0)]


@pytest.fixture(scope="module")
def results():
    iq = generate_if_samples(CFG, SVS, 40, noise_std=8.0, seed=3)
    vals = np.empty(2 * iq.size)
    vals[0::2] = iq.real
    vals[1::2] = iq.imag
    vals = np.clip(np.round(vals), -127, 127).astype(np.int8)
    tcfg = convert.config_from_jax(CFG)
    ref = j_run(JSource.from_array(vals, CFG.file), CFG)
    got = t_run(TSource.from_array(vals, tcfg.file), tcfg, device="cpu")
    return ref, got


def test_same_svs_delays_and_bins(results):
    ref, got = results
    np.testing.assert_array_equal(got.sv, ref.sv)
    assert sorted(got.sv.tolist()) == [3, 16, 27]
    np.testing.assert_array_equal(got.code_delay, ref.code_delay)
    np.testing.assert_array_equal(got.doppler_hz, ref.doppler_hz)


def test_snr_and_fine_frequency(results):
    ref, got = results
    np.testing.assert_allclose(got.snr_db, ref.snr_db, rtol=0, atol=1e-3)
    # same spectrum bin: identical frequencies
    np.testing.assert_array_equal(got.fine_freq_hz, ref.fine_freq_hz)
    conv = convert.acquisition_from_jax(ref)
    for k, v in convert.acquisition_to_numpy(conv).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(ref, k)))
