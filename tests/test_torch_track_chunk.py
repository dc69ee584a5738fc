"""The port's tracking kernel module (gps_sdr_tpu_torch/ops/track_chunk.py)
against the JAX package, on tests/test_pallas_fused.py's capture
(4.092 MHz, PRNs 7/21, 300 ms).

(a) The plain PyTorch version against the JAX "nco" scan — the same
    arithmetic: integer block chain exact; the rest differs only by float32
    summation order in the correlators and by the ±1-LSB rounding of
    carr_fp from float64 frequencies that differ by ~1e-7 Hz.
(b) Against the JAX whole-chunk Pallas kernel ("fused", interpret mode), a
    different replica model, at the bounds of tests/test_tracking.py over
    the settled tail of an 800 ms run (the 2 Hz DLL's 100 ms means still
    swing ±1.5 Hz at 300 ms on this capture, for both replicas).
(c) Chunk chaining is exact on the plain path.
(d) The CUDA kernel against the plain version (needs a card).

JAX-package imports sit inside the fixtures, so that on a machine without
JAX the card test alone runs:
    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_track_chunk.py
"""

import numpy as np
import pytest
import torch

from gps_sdr_tpu_torch import convert
from gps_sdr_tpu_torch.io.ifdata import IFSampleSource as TIFSampleSource
from gps_sdr_tpu_torch.io.synthetic import SyntheticSV as TSyntheticSV
from gps_sdr_tpu_torch.io.synthetic import generate_if_samples, quantize_iq
from gps_sdr_tpu_torch.ops import track_chunk as tc
from gps_sdr_tpu_torch.tracking import TrackParams as TTrackParams
from gps_sdr_tpu_torch.tracking import chip_tables
from gps_sdr_tpu_torch.tracking import init_track_state as t_init
from gps_sdr_tpu_torch.tracking import run_tracking as t_run

torch.set_num_threads(2)

FS, F_IF = 4.092e6, 1.023e6
SVS = [dict(prn=7, amplitude=3.0, doppler_hz=1234.5, code_delay_samples=800.0),
       dict(prn=21, amplitude=2.5, doppler_hz=-2500.25,
            code_delay_samples=2345.0)]
N_MS = 300
N_MS_LONG = 800


def _jax_cfg():
    from gps_sdr_tpu.config import FileConfig, ReceiverConfig, SignalConfig
    return ReceiverConfig(file=FileConfig(name="synthetic", skip_ms=0),
                          signal=SignalConfig(f_if=F_IF, fs=FS))


def _init(cfg):
    S = cfg.signal.samples_per_ms
    delays, fine = [], []
    for sv in SVS:
        f_code = cfg.signal.code_freq_basis * (1 + sv["doppler_hz"]
                                               / cfg.signal.fc)
        next_epoch = sv["code_delay_samples"] % (1023 / f_code * FS)
        delays.append(int(round((S - next_epoch) % S)))
        fine.append(F_IF + sv["doppler_hz"] + 3.0)
    return np.array(delays), np.array(fine)


@pytest.fixture(scope="module")
def capture():
    """int8 values of the test_pallas_fused capture, and the JAX config."""
    from gps_sdr_tpu.io.synthetic import SyntheticSV, generate_if_samples
    cfg = _jax_cfg()
    iq = generate_if_samples(cfg, [SyntheticSV(**sv) for sv in SVS],
                             N_MS_LONG + 5, noise_std=4.0, seed=5)
    vals = np.empty(2 * iq.size)
    vals[0::2] = iq.real
    vals[1::2] = iq.imag
    return np.clip(np.round(vals), -127, 127).astype(np.int8), cfg


def _run_both(capture, kind, n_ms, chunk_ms=1000, replica="nco"):
    from gps_sdr_tpu.io.ifdata import IFSampleSource
    from gps_sdr_tpu.tracking import TrackParams, init_track_state, \
        run_tracking
    vals, cfg = capture
    tcfg = convert.config_from_jax(cfg)
    delays, fine = _init(cfg)
    prns = [sv["prn"] for sv in SVS]
    jstate = init_track_state(cfg, delays, fine)
    jrec, jend = run_tracking(IFSampleSource.from_array(vals, cfg.file), cfg,
                              prns, jstate,
                              getattr(TrackParams, kind)(cfg, replica=replica),
                              n_ms)
    # the port starts from the JAX package's own initial state
    trec, tstate = t_run(TIFSampleSource.from_array(vals, tcfg.file), tcfg,
                         prns, convert.track_state_from_jax(jstate, "cpu"),
                         getattr(TTrackParams, kind)(tcfg), n_ms,
                         chunk_ms=chunk_ms)
    if replica == "nco":
        tn, jn = (convert.track_state_to_numpy(tstate),
                  convert.track_state_to_numpy(jend))
        for f in ("ptr", "phase_fp"):
            assert tn[f].dtype == jn[f].dtype
        np.testing.assert_array_equal(tn["ptr"], jn["ptr"])
        np.testing.assert_allclose(tn["code_freq"], jn["code_freq"], atol=1e-3)
    return jrec, trec, tstate


@pytest.fixture(scope="module")
def epl_pair(capture):
    return _run_both(capture, "epl", N_MS)


def _assert_matches_nco(jrec, trec):
    jrec = convert.records_from_jax(jrec)
    assert convert.records_to_numpy(trec).keys() == \
        convert.records_to_numpy(jrec).keys()
    np.testing.assert_array_equal(trec.num_sample, jrec.num_sample)
    np.testing.assert_array_equal(trec.absolute_sample, jrec.absolute_sample)
    np.testing.assert_allclose(trec.rem_chip, jrec.rem_chip, rtol=0,
                               atol=1e-6)
    scale = np.mean(np.abs(jrec.corr))
    np.testing.assert_allclose(trec.corr, jrec.corr, rtol=0,
                               atol=1e-4 * scale)
    np.testing.assert_allclose(trec.code_freq, jrec.code_freq, rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(trec.carr_freq, jrec.carr_freq, rtol=0,
                               atol=1e-3)
    dphi = np.angle(np.exp(1j * (trec.rem_phase - jrec.rem_phase)))
    assert np.max(np.abs(dphi)) < 1e-3, np.max(np.abs(dphi))


def test_plain_matches_jax_nco_epl(epl_pair):
    jrec, trec, _ = epl_pair
    _assert_matches_nco(jrec, trec)


@pytest.mark.parametrize("kind,n_ms", [("pos_epl", 120),
                                       ("pos_multicorr", 120)])
def test_plain_matches_jax_nco_pos(capture, kind, n_ms):
    """The CT-POS variants: ceil block length, +nco sign, the +0.05-chip
    prompt quirk, and the 25-tap bank."""
    jrec, trec, _ = _run_both(capture, kind, n_ms)
    assert trec.corr.shape[2] == (25 if kind == "pos_multicorr" else 3)
    _assert_matches_nco(jrec, trec)


def test_plain_against_jax_fused_kernel(capture):
    """The JAX Pallas kernel (interpret mode) is a different replica model
    (nominal-rate shift tables, compensated float32 NCO), so both are held
    to truth and to each other at tests/test_tracking.py's bounds."""
    cfg = capture[1]
    fused, trec, _ = _run_both(capture, "epl", N_MS_LONG, replica="fused")
    for rec in (fused, trec):
        for ch, sv in enumerate(SVS):
            carr_truth = F_IF + sv["doppler_hz"]
            code_truth = cfg.signal.code_freq_basis * (
                1 + sv["doppler_hz"] / cfg.signal.fc)
            assert abs(np.mean(rec.carr_freq[-200:, ch]) - carr_truth) < 2.0
            assert abs(np.mean(rec.code_freq[-200:, ch]) - code_truth) < 1.5
    a, b = trec.p_i[-400:], fused.p_i[-400:]
    rel = np.abs(a - b) / np.maximum(np.abs(b), 1.0)
    assert np.median(rel) < 0.04, np.median(rel)
    assert np.mean(np.sign(a) == np.sign(b)) > 0.999


def test_plain_chunk_chaining_exact(capture, epl_pair):
    """chunk_ms=77 equals one chunk bit for bit: each block reads its own
    window, so nothing depends on where a chunk starts."""
    _, trec, tstate = epl_pair
    vals, cfg = capture
    tcfg = convert.config_from_jax(cfg)
    delays, fine = _init(cfg)
    rec77, st77 = t_run(TIFSampleSource.from_array(vals, tcfg.file), tcfg,
                        [sv["prn"] for sv in SVS],
                        t_init(tcfg, delays, fine, "cpu"),
                        TTrackParams.epl(tcfg), N_MS, chunk_ms=77)
    for f in ("corr", "code_freq", "carr_freq", "num_sample", "rem_chip",
              "rem_phase", "absolute_sample"):
        np.testing.assert_array_equal(getattr(rec77, f), getattr(trec, f))
    for a, b in zip(st77, tstate):
        assert torch.equal(a, b)


def test_state_from_records_matches_jax_and_resumes(capture, epl_pair):
    """The carry rebuilt from record rows equals the JAX package's, and
    tracking resumed from it continues the uninterrupted run."""
    from gps_sdr_tpu.tracking import state_from_records as j_state
    from gps_sdr_tpu_torch.tracking import state_from_records as t_state
    jrec, trec, _ = epl_pair
    vals, cfg = capture
    tcfg = convert.config_from_jax(cfg)
    _, fine = _init(cfg)
    rows = np.array([149, 149])
    jn = convert.track_state_to_numpy(j_state(jrec, rows, fine))
    tst = t_state(convert.records_from_jax(jrec), rows, fine,
                  device="cpu")
    tn = convert.track_state_to_numpy(tst)
    assert tn.keys() == jn.keys()
    for f in tn:
        assert tn[f].dtype == jn[f].dtype, f
        np.testing.assert_array_equal(tn[f], jn[f], err_msg=f)
    rest, _ = t_run(TIFSampleSource.from_array(vals, tcfg.file), tcfg,
                    [sv["prn"] for sv in SVS],
                    t_state(trec, rows, fine, device="cpu"),
                    TTrackParams.epl(tcfg), 150)
    np.testing.assert_array_equal(rest.num_sample, trec.num_sample[150:])
    np.testing.assert_array_equal(rest.absolute_sample,
                                  trec.absolute_sample[150:])
    scale = np.mean(np.abs(trec.corr))
    np.testing.assert_allclose(rest.corr, trec.corr[150:], rtol=0,
                               atol=1e-4 * scale)
    np.testing.assert_allclose(rest.carr_freq, trec.carr_freq[150:], rtol=0,
                               atol=1e-6)


def test_wrapper_routes_cpu_to_plain_and_validates(capture):
    """On a CPU tensor the wrapper runs the plain version and launches no
    kernel; it rejects a chunk too short for the blocks asked."""
    vals, cfg = capture
    tcfg = convert.config_from_jax(cfg)
    delays, fine = _init(cfg)
    state = t_init(tcfg, delays, fine, "cpu")
    spec = TTrackParams.epl(tcfg).chunk_spec(tcfg)
    chips = chip_tables([sv["prn"] for sv in SVS], "cpu")
    start = int(state.ptr.min())
    n = int(state.ptr.max()) - start + spec.chunk_samples(10)
    raw = torch.from_numpy(vals.reshape(-1, 2)[start:start + n].copy())
    before = tc.track_chunk.launches
    rec, _ = tc.track_chunk(raw, start, state, chips, spec, 10)
    assert tc.track_chunk.launches == before
    assert int(rec["fault"][0]) == 0 and rec["corr"].shape == (10, 2, 3, 2)
    with pytest.raises(ValueError, match="does not cover"):
        tc.track_chunk(raw[:-1], start, state, chips, spec, 10)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain():
    """The CUDA kernel against the plain version on the card, at
    tests/test_pallas_fused.py's bounds: the plain version runs on the CPU
    here, whose sin/cos differ from the card's in the last float32 bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gps_sdr_tpu_torch.config import (FileConfig, ReceiverConfig,
                                          SignalConfig)
    dev = torch.device("cuda")
    tcfg = ReceiverConfig(file=FileConfig(name="synthetic", skip_ms=0),
                          signal=SignalConfig(f_if=F_IF, fs=FS))
    iq = generate_if_samples(tcfg, [TSyntheticSV(**sv) for sv in SVS],
                             N_MS + 5, noise_std=4.0, seed=5, device=dev)
    src = TIFSampleSource.from_array(quantize_iq(iq), tcfg.file)
    delays, fine = _init(tcfg)
    prns = [sv["prn"] for sv in SVS]
    for kind, n_ms in (("epl", N_MS), ("pos_multicorr", 120)):
        params = getattr(TTrackParams, kind)(tcfg)
        ref, _ = t_run(src, tcfg, prns, t_init(tcfg, delays, fine, "cpu"),
                       params, n_ms)
        before = tc.track_chunk.launches
        out, _ = t_run(src, tcfg, prns, t_init(tcfg, delays, fine, dev),
                       params, n_ms)
        assert tc.track_chunk.launches == before + 1
        np.testing.assert_array_equal(out.num_sample, ref.num_sample)
        np.testing.assert_array_equal(out.absolute_sample,
                                      ref.absolute_sample)
        np.testing.assert_allclose(out.rem_chip, ref.rem_chip, atol=2e-4)
        scale = np.mean(np.abs(ref.corr))
        np.testing.assert_allclose(out.corr, ref.corr, atol=2e-3 * scale)
        np.testing.assert_allclose(out.code_freq, ref.code_freq, atol=0.05)
        np.testing.assert_allclose(out.carr_freq, ref.carr_freq, atol=0.05)
        dphi = np.angle(np.exp(1j * (out.rem_phase - ref.rem_phase)))
        assert np.max(np.abs(dphi)) < 0.02


@pytest.mark.gpu
def test_cuda_cluster_sizes_agree():
    """One CTA per channel against the cluster size the wrapper chooses, on
    the card: every record and the state after it equal bit for bit, with DC
    removal on and off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gps_sdr_tpu_torch.config import (FileConfig, ReceiverConfig,
                                          SignalConfig)
    dev = torch.device("cuda")
    tcfg = ReceiverConfig(file=FileConfig(name="synthetic", skip_ms=0),
                          signal=SignalConfig(f_if=F_IF, fs=FS))
    iq = generate_if_samples(tcfg, [TSyntheticSV(**sv) for sv in SVS],
                             N_MS + 5, noise_std=4.0, seed=5, device=dev)
    src = TIFSampleSource.from_array(quantize_iq(iq), tcfg.file)
    delays, fine = _init(tcfg)
    state = t_init(tcfg, delays, fine, dev)
    chips = chip_tables([sv["prn"] for sv in SVS], dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert tc.cluster_size(len(SVS), sms) > 1
    for kind, n_steps in (("epl", N_MS), ("pos_multicorr", 120)):
        for remove_dc in (False, True):
            spec = getattr(TTrackParams, kind)(tcfg).chunk_spec(tcfg)
            spec = spec._replace(remove_dc=remove_dc)
            start = int(state.ptr.min())
            n = int(state.ptr.max()) - start + spec.chunk_samples(n_steps)
            raw = torch.as_tensor(src.read_iq_values(start, n)).to(dev)
            got, end = tc.track_chunk(raw, start, state, chips, spec, n_steps)
            one, end1 = tc._track_chunk_cuda(raw, start, state, chips, spec,
                                             n_steps, cluster=1)
            tc.raise_on_fault(got)
            for f in got:
                assert torch.equal(got[f], one[f]), (kind, remove_dc, f)
            for a, b in zip(end, end1):
                assert torch.equal(a, b), (kind, remove_dc)
