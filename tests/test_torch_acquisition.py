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


# ---- the int16 front end end to end (tests/test_urban_frontend.py) ----

URBAN = ReceiverConfig(
    file=FileConfig(name="urban_syn", skip_ms=1, data_precision=2),
    signal=SignalConfig(f_if=0.0, fs=5e6))
URBAN_SVS = [SyntheticSV(prn=1, amplitude=60.0, doppler_hz=1200.0,
                         code_delay_samples=777.0),
             SyntheticSV(prn=11, amplitude=50.0, doppler_hz=-365.0,
                         code_delay_samples=3001.0)]


@pytest.fixture(scope="module")
def urban(tmp_path_factory):
    """An int16 capture at zero IF with a DC offset (230 − 95j), written by
    the port's `write_if_file` (the same bytes as the JAX package's), and
    both packages' acquisition on it."""
    from gps_sdr_tpu.io.ifdata import write_if_file as j_write
    from gps_sdr_tpu_torch.io.ifdata import write_if_file
    iq = generate_if_samples(URBAN, URBAN_SVS, duration_ms=600,
                             noise_std=180.0, seed=5) + (230.0 - 95.0j)
    root = tmp_path_factory.mktemp("urban")
    path, jpath = str(root / "urban.bin"), str(root / "urban_jax.bin")
    tcfg = convert.config_from_jax(URBAN)
    write_if_file(path, iq, tcfg.file)
    j_write(jpath, iq, URBAN.file)
    with open(path, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    ref = j_run(JSource(path, URBAN.file), URBAN)
    src = TSource(path, tcfg.file)
    got = t_run(src, tcfg, device="cpu")
    return dict(tcfg=tcfg, path=path, src=src, ref=ref, got=got)


def test_int16_acquisition_with_dc_offset(urban):
    """Both true SVs, strongly, at their Doppler; the search results equal
    the JAX package's (SNR within float32 FFT round-off)."""
    ref, got = urban["ref"], urban["got"]
    np.testing.assert_array_equal(got.sv, ref.sv)
    np.testing.assert_array_equal(got.code_delay, ref.code_delay)
    np.testing.assert_array_equal(got.fine_freq_hz, ref.fine_freq_hz)
    np.testing.assert_allclose(got.snr_db, ref.snr_db, rtol=0, atol=1e-3)
    assert {1, 11} <= set(int(s) for s in got.sv)
    snr = {int(p): s for p, s in zip(got.sv, got.snr_db)}
    freq = {int(p): f for p, f in zip(got.sv, got.fine_freq_hz)}
    assert snr[1] > 30 and snr[11] > 30
    assert abs(freq[1] - 1200.0) < 25.0 and abs(freq[11] + 365.0) < 25.0


def test_int16_tracking_locks_with_dc_removal(urban):
    """400 ms of 1 ms E/P/L tracking with the per-block DC removal the
    int16 front end engages: the prompt holds the energy (|I| > 4·|Q|),
    the carrier sits within 3 Hz of the truth, and the block chain and
    carrier follow the JAX package's (the rule of tests/test_torch_slice.py:
    chains exact up to the first split of the two float32 loops, within a
    sample after it, navigation-bit signs identical)."""
    from gps_sdr_tpu.tracking import (TrackParams as JParams,
                                      init_track_state as j_init,
                                      run_tracking as j_track)
    from gps_sdr_tpu_torch.tracking import (TrackParams, init_track_state,
                                            run_tracking)
    tcfg, got, ref = urban["tcfg"], urban["got"], urban["ref"]
    chans = [got.channel_index(p) for p in (1, 11)]
    params = TrackParams.epl(tcfg)
    assert params.remove_dc
    rec, _ = run_tracking(urban["src"], tcfg, [1, 11], init_track_state(
        tcfg, got.code_delay[chans], got.fine_freq_hz[chans], "cpu"),
        params, 400)
    p = np.abs(rec.p_i[-100:]).mean(axis=0)
    q = np.abs(rec.p_q[-100:]).mean(axis=0)
    assert np.all(p > 4 * q)
    for ch, sv in enumerate(URBAN_SVS):
        err = np.mean(rec.carr_freq[-100:, ch]) - sv.doppler_hz
        assert abs(err) < 3.0, (sv.prn, err)
    jrec, _ = j_track(JSource(urban["path"], URBAN.file), URBAN, [1, 11],
                      j_init(URBAN, ref.code_delay[chans],
                             ref.fine_freq_hz[chans]),
                      JParams.epl(URBAN, replica="nco"), 400)
    dcarr = np.abs(rec.carr_freq - jrec.carr_freq) > 1e-3
    split = int(np.argmax(dcarr.any(axis=1))) if dcarr.any() else 400
    assert split >= 100, split          # measured: row 213
    np.testing.assert_array_equal(rec.num_sample[:split],
                                  jrec.num_sample[:split])
    assert np.max(np.abs(rec.absolute_sample - jrec.absolute_sample)) <= 1
    assert np.mean(rec.num_sample != jrec.num_sample) < 1e-3
    assert np.mean(np.sign(rec.p_i) == np.sign(jrec.p_i)) > 0.9999
