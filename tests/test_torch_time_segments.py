"""The port's time-segmented tracking (`parallel/time_segments`) against the
JAX package's, on the CPU, and the port's `Receiver.track_for_eph(
n_segments=…)`.

The capture is tests/test_time_segments.py's, made here from the same seed
(4.092 MHz, PRNs 5 and 29, 1600 + 500 ms, int8, in memory): D = 4 segments
with a 250 ms halo.  The port runs its plain tracker here over the capture
held as one CPU tensor (`io.ifdata.upload_capture`); on the card the same
route launches the CUDA kernel, which `chip_smoke.py` holds against the
plain version on the 58 MHz capture.  Artifacts go under pytest's tmp
directory, never `.cache/`.

Tolerances, against the JAX package (the rule of tests/test_torch_slice.py:
the two float32 loops follow the same path until a ~1e-6 difference flips
one per-block rounding, then equally valid noise paths):
- the initial state and the stitch: exact, bit for bit;
- the segmented run: `num_sample` and `absolute_sample` exact up to each
  channel's first split (the first row whose carrier differs by > 1e-3
  Hz), `absolute_sample` within one sample everywhere, prompt signs equal
  on > 0.999 of the rows past the first segment's pull-in, carrier within
  0.5 Hz at the median.
Against the port's own serial run: the five gates of
tests/test_time_segments.py.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from gps_sdr_tpu_torch import convert
from gps_sdr_tpu_torch import tracking as ttrack
from gps_sdr_tpu_torch.io.ifdata import IFSampleSource as TSource
from gps_sdr_tpu_torch.io.ifdata import upload_capture
from gps_sdr_tpu_torch.parallel import time_segments as tts
from gps_sdr_tpu_torch.pipeline import Receiver as TReceiver
from gps_sdr_tpu_torch.tracking import TrackParams as TParams

torch.set_num_threads(2)

FS, F_IF = 4.092e6, 1.023e6
N_MS, EXTRA_MS, D, HALO = 1600, 500, 4, 250
EPH = dict(
    sqrta=5153.6413, ecc=0.00122963, m0=2.14587329, omega0=1.25789432,
    i0=0.96679784, w=-0.89245321, deltan=4.3267e-09, omegadot=-7.2345e-09,
    idot=-4.2e-10, cuc=1.5272e-07, cus=2.3842e-07, crc=287.46875,
    crs=-2.59375, cic=-7.45058e-09, cis=1.3039e-08, toe=388800.0,
    toc=388800.0, af0=1.8364e-04, af1=2.0464e-12, af2=0.0,
    tgd=-7.4506e-09, iodc=23, iode=23, health=0, ura=0)
SVS = [dict(prn=5, amplitude=3.0, doppler_hz=1711.0,
            code_delay_samples=900.0),
       dict(prn=29, amplitude=2.6, doppler_hz=-3100.0,
            code_delay_samples=2600.0)]
PRNS = [sv["prn"] for sv in SVS]


@pytest.fixture(scope="module")
def setup():
    """Both packages' configs and sources over one int8 capture, and the
    acquisition-like start of each channel (tests/test_time_segments.py)."""
    from gps_sdr_tpu.config import FileConfig, ReceiverConfig, SignalConfig
    from gps_sdr_tpu.io import lnav
    from gps_sdr_tpu.io.ifdata import IFSampleSource as JSource
    from gps_sdr_tpu.io.synthetic import SyntheticSV, generate_if_samples
    cfg = ReceiverConfig(file=FileConfig(name="seg", skip_ms=0),
                         signal=SignalConfig(f_if=F_IF, fs=FS))
    bits = lnav.encode_frames(EPH, 2239, 388800.0, 4)
    svs = [SyntheticSV(**sv, nav_bits=bits) for sv in SVS]
    iq = generate_if_samples(cfg, svs, N_MS + EXTRA_MS, noise_std=6.0,
                             seed=4)
    vals = np.empty(2 * iq.size)
    vals[0::2] = iq.real
    vals[1::2] = iq.imag
    vals = np.clip(np.round(vals), -127, 127).astype(np.int8)
    tcfg = convert.config_from_jax(cfg)
    S = cfg.signal.samples_per_ms
    delays, fine = [], []
    for sv in svs:
        f_code = cfg.signal.code_freq_basis * (1 + sv.doppler_hz
                                               / cfg.signal.fc)
        nxt = sv.code_delay_samples % (1023 / f_code * FS)
        delays.append(int(round((S - nxt) % S)))
        fine.append(F_IF + sv.doppler_hz + 2.0)
    return dict(cfg=cfg, tcfg=tcfg, jsrc=JSource.from_array(vals, cfg.file),
                tsrc=TSource.from_array(vals, tcfg.file),
                delays=np.array(delays), fine=np.array(fine))


@pytest.fixture(scope="module")
def jax_segmented(setup):
    from gps_sdr_tpu.parallel.time_segments import run_tracking_segmented
    from gps_sdr_tpu.tracking import TrackParams
    return run_tracking_segmented(
        setup["jsrc"], setup["cfg"], PRNS, setup["delays"], setup["fine"],
        TrackParams.epl(setup["cfg"], replica="nco"), N_MS, n_segments=D,
        halo_ms=HALO)


@pytest.fixture(scope="module")
def segmented(setup):
    return tts.run_tracking_segmented(
        setup["tsrc"], setup["tcfg"], PRNS, setup["delays"], setup["fine"],
        TParams.epl(setup["tcfg"]), N_MS, n_segments=D, halo_ms=HALO,
        device="cpu")


@pytest.fixture(scope="module")
def serial(setup):
    tcfg = setup["tcfg"]
    rec, _ = ttrack.run_tracking(
        setup["tsrc"], tcfg, PRNS, ttrack.init_track_state(
            tcfg, setup["delays"], setup["fine"], "cpu"),
        TParams.epl(tcfg), N_MS)
    return rec


# ---- (a) the initial state ----

@pytest.mark.parametrize("n_seg,seg_ms,halo", [(D, N_MS // D, HALO),
                                               (8, 4975, 400)])
def test_initial_state_equals_jax(setup, n_seg, seg_ms, halo):
    """Field for field: the pointers (int64) and the float64 words exact,
    at this file's D = 4 and at the card's D = 8 over 39 800 ms."""
    from gps_sdr_tpu.parallel.time_segments import segmented_initial_state
    want = convert.track_state_to_numpy(segmented_initial_state(
        setup["cfg"], setup["delays"], setup["fine"], n_seg, seg_ms, halo))
    got = convert.track_state_to_numpy(tts.segmented_initial_state(
        setup["tcfg"], setup["delays"], setup["fine"], n_seg, seg_ms, halo,
        "cpu"))
    assert got.keys() == want.keys()
    for f in want:
        assert got[f].shape == (2 * n_seg,), f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert got["ptr"].dtype == np.int64
    # segment s starts s·seg − halo code periods in (0 for s = 0)
    S = setup["cfg"].signal.samples_per_ms
    lead = (got["ptr"].reshape(n_seg, 2) - got["ptr"][:2]) / S
    np.testing.assert_allclose(
        lead[1:, 0], [s * seg_ms - halo for s in range(1, n_seg)], rtol=1e-5)


# ---- (b) the stitch ----

def _seeded_records(flips, rng, seg_ms=60, halo=20, n=3):
    """A (seg+halo, n·D) segmented record whose prompt I carries one ±1
    bit stream per channel over absolute code periods, segment s of
    channel c multiplied by flips[s][c], plus noise; other fields random."""
    n_seg = len(flips)
    rows = seg_ms + halo
    bits = rng.choice([-1.0, 1.0], size=(n_seg * seg_ms // 20 + 2, n))
    corr = rng.normal(0, 0.3, (rows, n * n_seg, 3, 2)).astype(np.float32)
    for s in range(n_seg):
        period = np.arange(rows) + (s * seg_ms - halo if s else 0)
        for c in range(n):
            corr[:, s * n + c, 1, 0] += (5.0 * flips[s][c]
                                         * bits[period // 20, c])
    f64 = lambda: rng.normal(size=(rows, n * n_seg))
    i64 = lambda: rng.integers(0, 2 ** 40, size=(rows, n * n_seg))
    return dict(corr=corr, code_err=f64(), carr_err=f64(), code_freq=f64(),
                carr_freq=f64(), num_sample=i64(), rem_chip=f64(),
                rem_phase=f64(), absolute_sample=i64())


@pytest.mark.parametrize("flips", [
    [(1, 1, 1)] * 4,
    [(1, 1, 1), (-1, 1, 1), (1, 1, 1), (1, 1, 1)],
    [(1, -1, 1), (-1, -1, 1), (1, 1, -1), (-1, 1, -1)],
    [(-1, -1, -1), (1, 1, 1), (-1, -1, -1), (1, 1, 1), (-1, 1, -1)]],
    ids=["none", "one", "mixed", "alternate"])
def test_stitch_equals_jax_with_flips(flips, setup):
    """Bit for bit against the JAX stitch, and every segment comes out with
    segment 0's polarity: its prompt rows are the input's times the flip
    that undoes it."""
    from gps_sdr_tpu.parallel.time_segments import stitch_segments
    from gps_sdr_tpu.tracking import TrackParams, TrackRecords
    seg_ms, halo, n = 60, 20, 3
    fields = _seeded_records(flips, np.random.default_rng(len(flips)))
    n_ms = len(flips) * seg_ms - 7
    want = stitch_segments(TrackRecords(**fields), n, len(flips), seg_ms,
                           halo, n_ms, TrackParams.epl(setup["cfg"]))
    got = tts.stitch_segments(ttrack.TrackRecords(**fields), n, len(flips),
                              seg_ms, halo, n_ms, TParams.epl(setup["tcfg"]))
    for f in ttrack._REC_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    assert got.corr.shape == (n_ms, n, 3, 2)
    for s, fl in enumerate(flips):
        lo = 0 if s == 0 else halo
        src = fields["corr"][lo:lo + seg_ms, s * n:(s + 1) * n, 1, 0]
        out = got.p_i[s * seg_ms:(s + 1) * seg_ms]
        undo = np.asarray(flips[0], np.float32) * np.asarray(fl, np.float32)
        np.testing.assert_array_equal(out, (src * undo)[:len(out)])


# ---- (c) the segmented run against the JAX package ----

def test_segmented_run_follows_jax(segmented, jax_segmented):
    """Same shape and dtypes; the integer chain exact up to each channel's
    first split and within one sample after it; prompt signs and carrier
    as the module docstring states."""
    got = segmented
    want = convert.records_to_numpy(jax_segmented)
    assert got.corr.shape == want["corr"].shape == (N_MS, 2, 3, 2)
    for ch in range(2):
        dcarr = np.abs(got.carr_freq[:, ch] - want["carr_freq"][:, ch]) > 1e-3
        split = int(np.argmax(dcarr)) if dcarr.any() else N_MS
        assert split >= 50, (ch, split)
        for f in ("num_sample", "absolute_sample"):
            np.testing.assert_array_equal(getattr(got, f)[:split, ch],
                                          want[f][:split, ch], err_msg=f)
    assert np.max(np.abs(got.absolute_sample
                         - want["absolute_sample"])) <= 1
    agree = np.mean(np.sign(got.p_i[300:]) == np.sign(
        want["corr"][300:, :, 1, 0]))
    assert agree > 0.999, agree
    assert np.median(np.abs(got.carr_freq - want["carr_freq"])) < 0.5


def test_segmented_route_reads_the_resident_capture(setup, monkeypatch):
    """The segmented run reads the capture once, whole, and gives every
    chunk all of it from chunk_start 0: no read per chunk."""
    src = setup["tsrc"]
    seen, reads = [], []
    real_chunk, real_read = ttrack.track_chunk, src.read_iq_values
    monkeypatch.setattr(ttrack, "track_chunk", lambda raw, start, *a: (
        seen.append((raw.shape[0], start)) or real_chunk(raw, start, *a)))
    monkeypatch.setattr(src, "read_iq_values", lambda *a: (
        reads.append(a) or real_read(*a)))
    tts.run_tracking_segmented(
        src, setup["tcfg"], PRNS, setup["delays"], setup["fine"],
        TParams.epl(setup["tcfg"]), 400, n_segments=2, halo_ms=100,
        chunk_ms=100, device="cpu")
    assert reads == [(0, src.n_samples)]
    assert seen == [(src.n_samples, 0)] * 3


# ---- (d) the port's segmented run against its serial run ----

def test_shapes_match_serial(serial, segmented):
    assert segmented.p_i.shape == serial.p_i.shape == (N_MS, 2)


def test_bits_identical_after_pull_in(serial, segmented):
    agree = np.mean(np.sign(serial.p_i[300:]) == np.sign(segmented.p_i[300:]))
    assert agree > 0.999, agree


def test_carrier_freq_matches_serial(serial, segmented):
    d = np.abs(segmented.carr_freq[300:] - serial.carr_freq[300:])
    assert np.median(d) < 1.0
    assert np.percentile(d, 99) < 10.0


def test_absolute_sample_alignment(serial, segmented):
    d = np.abs(segmented.absolute_sample[300:]
               - serial.absolute_sample[300:])
    assert np.max(d) < 30, np.max(d)


@pytest.mark.parametrize("q", range(D))
def test_prompt_power_in_every_segment(segmented, q):
    seg = slice(q * 400 + 300 if q == 0 else q * 400, (q + 1) * 400)
    p = np.abs(segmented.p_i[seg]).mean()
    qq = np.abs(segmented.p_q[seg]).mean()
    assert p > 3 * qq, (q, p, qq)


# ---- (e) the Receiver ----

def _receiver(setup, d, name="seg"):
    """A port Receiver on `d` whose acquisition is served from an
    artifact holding the channels' start."""
    tcfg = dataclasses.replace(setup["tcfg"], file=dataclasses.replace(
        setup["tcfg"].file, name=name))
    stem = os.path.join(d, f"acquired_{name}_0.npz")
    if not os.path.exists(stem):
        os.makedirs(d, exist_ok=True)
        np.savez(stem, sv=np.array(PRNS), snr_db=np.array([20.0, 20.0]),
                 doppler_hz=np.array([1500.0, -3000.0]),
                 code_delay=setup["delays"], fine_freq_hz=setup["fine"])
    return TReceiver(tcfg, setup["tsrc"], artifact_dir=d, device="cpu")


@pytest.fixture(scope="module")
def receiver_dir(setup, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_seg_rx"))
    rec = _receiver(setup, d).track_for_eph(n_ms=N_MS, n_segments=2)
    return d, rec


def test_receiver_writes_its_own_stem(setup, receiver_dir):
    """The segmented record is under tckeph_seg{D}_{halo}_{name}.npz, not
    the serial stem, and equals run_tracking_segmented's."""
    d, rec = receiver_dir
    files = sorted(f for f in os.listdir(d) if f.startswith("tckeph"))
    assert files == ["tckeph_seg2_400_seg.npz"]
    want = tts.run_tracking_segmented(
        setup["tsrc"], setup["tcfg"], PRNS, setup["delays"], setup["fine"],
        TParams.epl(setup["tcfg"]), N_MS, n_segments=2, halo_ms=400,
        device="cpu")
    again = _receiver(setup, d).track_for_eph(n_ms=N_MS, n_segments=2)
    for f in ttrack._REC_FIELDS:
        np.testing.assert_array_equal(getattr(rec, f), getattr(want, f))
        np.testing.assert_array_equal(getattr(again, f), getattr(want, f))


def test_decode_reads_the_segmented_record(setup, receiver_dir, tmp_path,
                                           monkeypatch):
    """A second Receiver on a directory holding only the segmented record
    decodes it and tracks nothing; with the serial record beside it,
    neither built by the Receiver, decode raises naming both files."""
    import shutil

    from gps_sdr_tpu_torch import navdecode, pipeline
    d, rec = receiver_dir
    for f in ("acquired_seg_0.npz", "tckeph_seg2_400_seg.npz"):
        shutil.copy(os.path.join(d, f), tmp_path)
    calls = []
    monkeypatch.setattr(pipeline, "run_tracking",
                        lambda *a, **k: calls.append(1))
    monkeypatch.setattr(pipeline, "run_tracking_segmented",
                        lambda *a, **k: calls.append(1))
    rx = _receiver(setup, str(tmp_path))
    eph, sbf = rx.decode(start_offset_ms=0)
    cnt = rx.countinx(min_transition_index=300)
    assert calls == []
    want_eph, want_sbf = navdecode.decode_all(
        {p: rec.p_i[:, ch] for ch, p in enumerate(PRNS)}, 0)
    assert sbf == want_sbf and sorted(eph) == sorted(want_eph)
    np.testing.assert_array_equal(cnt, [pipeline.detect_bit_transition(
        rec.p_i[:, ch], min_index=300) for ch in range(2)])
    rx._save_records("tckeph_seg.npz", rec)
    for f in ("eph_seg.pkl", "countinx_seg.npz"):
        os.remove(tmp_path / f)
    with pytest.raises(RuntimeError, match="tckeph_seg.npz") as err:
        _receiver(setup, str(tmp_path)).decode(start_offset_ms=0)
    assert "tckeph_seg2_400_seg.npz" in str(err.value)
    assert calls == []


def test_segmented_stem_is_not_another_receivers(setup, receiver_dir,
                                                 tmp_path):
    """A Receiver of another capture name on the same directory sees none
    of this one's records; one whose name only ends like it neither."""
    import shutil
    d, _ = receiver_dir
    shutil.copy(os.path.join(d, "tckeph_seg2_400_seg.npz"), tmp_path)
    for name in ("other", "400_seg"):
        rx = _receiver(setup, str(tmp_path), name=name)
        stems = [f for f in os.listdir(tmp_path) if f.startswith("tckeph")]
        assert stems == ["tckeph_seg2_400_seg.npz"]
        rx.track_for_eph = lambda: "tracked"
        assert rx._decode_records() == "tracked"


def test_pdi_other_than_1_raises(setup):
    with pytest.raises(ValueError, match="pdi=1"):
        tts.run_tracking_segmented(
            setup["tsrc"], setup["tcfg"], PRNS, setup["delays"],
            setup["fine"], TParams.epl(setup["tcfg"], pdi_ms=10), N_MS,
            n_segments=2, device="cpu")


def test_halo_not_shorter_than_segment_raises(setup, tmp_path):
    """1600 ms in 4 segments is 400 ms each: the Receiver's 400 ms halo
    does not fit; nothing is written."""
    rx = _receiver(setup, str(tmp_path))
    with pytest.raises(ValueError, match="halo"):
        rx.track_for_eph(n_ms=N_MS, n_segments=4)
    assert not [f for f in os.listdir(tmp_path) if f.startswith("tckeph")]


@pytest.mark.parametrize("data_type", [1, 2])
@pytest.mark.parametrize("start,n", [(-3, 10), (0, 5), (45, 10), (47, 10),
                                     (-20, 200), (120, 5), (0, 0)])
def test_read_iq_into_pads_outside_the_capture(data_type, start, n):
    """The upload's host read: (n, 2) pairs of samples [start, start+n),
    zeros outside the capture, for IQ and real-only captures alike."""
    from gps_sdr_tpu_torch.config import FileConfig
    vals = np.arange(-50, 50, dtype=np.int8)
    src = TSource.from_array(vals, FileConfig(data_type=data_type))
    out = np.full((n, 2), 99, np.int8)
    src.read_iq_into(start, out)
    k = np.arange(start, start + n)
    inside = (k >= 0) & (k < src.n_samples)
    kk = np.where(inside, k, 0)
    if data_type == 2:
        want = np.stack([vals[2 * kk], vals[2 * kk + 1]], axis=-1)
    else:
        want = np.stack([vals[kk], np.zeros_like(vals[kk])], axis=-1)
    want[~inside] = 0
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(src.read_iq_values(start, n), want)


def test_resident_capture_must_be_the_capture(setup):
    tcfg = setup["tcfg"]
    state = ttrack.init_track_state(tcfg, setup["delays"], setup["fine"],
                                    "cpu")
    short = upload_capture(setup["tsrc"], "cpu")[:-1]
    with pytest.raises(ValueError, match="resident capture"):
        ttrack.run_tracking(setup["tsrc"], tcfg, PRNS, state,
                            TParams.epl(tcfg), 10, resident=short)


@pytest.mark.gpu
def test_cuda_segmented_chunk_matches_plain():
    """B1 at the segmented shape on the card: 64 channels (the two PRNs in
    32 segments over the capture held on the card) in clusters of
    `cluster_size(64, SMs)` CTAs, one launch from chunk_start 0, every
    record field and the end state equal bit for bit to the plain version
    on the same device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gps_sdr_tpu_torch.config import (FileConfig, ReceiverConfig,
                                          SignalConfig)
    from gps_sdr_tpu_torch.io import lnav as tlnav
    from gps_sdr_tpu_torch.io.synthetic import (SyntheticSV,
                                                generate_if_samples,
                                                quantize_iq)
    from gps_sdr_tpu_torch.ops import track_chunk as tc
    dev = torch.device("cuda")
    tcfg = ReceiverConfig(file=FileConfig(name="seg", skip_ms=0),
                          signal=SignalConfig(f_if=F_IF, fs=FS))
    bits = tlnav.encode_frames(EPH, 2239, 388800.0, 4)
    iq = generate_if_samples(tcfg, [SyntheticSV(**sv, nav_bits=bits)
                                    for sv in SVS], N_MS + EXTRA_MS,
                             noise_std=6.0, seed=4, device=dev)
    src = TSource.from_array(quantize_iq(iq), tcfg.file)
    S = tcfg.signal.samples_per_ms
    delays, fine = [], []
    for sv in SVS:
        f_code = tcfg.signal.code_freq_basis * (1 + sv["doppler_hz"]
                                                / tcfg.signal.fc)
        nxt = sv["code_delay_samples"] % (1023 / f_code * FS)
        delays.append(int(round((S - nxt) % S)))
        fine.append(F_IF + sv["doppler_hz"] + 2.0)
    state = tts.segmented_initial_state(tcfg, delays, fine, 32, 60, 20, dev)
    resident = upload_capture(src, dev)
    assert resident.shape == (src.n_samples, 2) and resident.is_cuda
    chips = ttrack.chip_tables(PRNS * 32, dev)
    spec = TParams.epl(tcfg).chunk_spec(tcfg)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert tc.cluster_size(64, sms) == (2 if sms >= 128 else 1)
    before = tc.track_chunk.launches
    got, end = tc.track_chunk(resident, 0, state, chips, spec, 100)
    assert tc.track_chunk.launches == before + 1
    ref, end_ref = tc.track_chunk_reference(resident, 0, state, chips, spec,
                                            100)
    tc.raise_on_fault(got)
    for f in ttrack._REC_FIELDS:
        assert torch.equal(got[f], ref[f]), f
    for f in end._fields:
        assert torch.equal(getattr(end, f), getattr(end_ref, f)), f
