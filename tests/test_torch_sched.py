"""The port's 10 ms coherent schedules against the JAX package, on the CPU:
the bank over windows (`ops/corr_bank.correlator_bank_windows`), the
per-block tracker (`tracking.track_scan`), the routing of `run_tracking`,
and `Receiver.track_for_eph_reference`; and `run_tracking`'s graph route
(`tracking.ScanGraph`, one CUDA graph a chunk on the card) against
`track_scan` chunk by chunk, on port-only captures (the port's generator).

One small capture serves the bank and tracker tests (4.092 MHz, PRNs
7 / 21 / 13, 560 ms, int8, made by the JAX generator from a seed); the
schedule test uses the capture of tests/test_reference_schedule.py (5 MHz,
PRNs 9 / 23, 700 + 800 ms).  Captures go under pytest's tmp directory.
The port runs its plain versions here (`device="cpu"`); the CUDA kernel is
held against the plain version by the `gpu`-marked test at the end:
    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_sched.py
JAX-package imports sit inside fixtures and tests, so that command runs on
a machine without JAX.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gps_sdr_tpu_torch import convert
from gps_sdr_tpu_torch import tracking as ttrack
from gps_sdr_tpu_torch.io.ifdata import ChunkFeed
from gps_sdr_tpu_torch.io.ifdata import IFSampleSource as TSource
from gps_sdr_tpu_torch.ops import corr_bank as cb
from gps_sdr_tpu_torch.ops import track_chunk as tc
from gps_sdr_tpu_torch.pipeline import Receiver as TReceiver
from gps_sdr_tpu_torch.tracking import TrackParams as TTrackParams
from gps_sdr_tpu_torch.tracking import chip_tables
from gps_sdr_tpu_torch.utils import spans

torch.set_num_threads(2)

FS, F_IF = 4.092e6, 1.023e6
SVS = [dict(prn=7, amplitude=3.0, doppler_hz=1234.5, code_delay_samples=800.0),
       dict(prn=21, amplitude=2.5, doppler_hz=-2500.25,
            code_delay_samples=2345.0),
       dict(prn=13, amplitude=2.8, doppler_hz=310.0,
            code_delay_samples=3100.5)]
PRNS = [sv["prn"] for sv in SVS]
LOCK_MS, N_MS = 100, 560
Q32 = 2.0 ** 32


@pytest.fixture(scope="module")
def scene():
    """int8 capture, both configs, and the NCO state after LOCK_MS ms of
    1 ms E/P/L tracking by the port (the loops are locked by then)."""
    from gps_sdr_tpu.config import FileConfig, ReceiverConfig, SignalConfig
    from gps_sdr_tpu.io.synthetic import SyntheticSV, generate_if_samples
    cfg = ReceiverConfig(file=FileConfig(name="sched", skip_ms=0),
                         signal=SignalConfig(f_if=F_IF, fs=FS))
    iq = generate_if_samples(cfg, [SyntheticSV(**sv) for sv in SVS], N_MS,
                             noise_std=4.0, seed=5)
    vals = np.empty(2 * iq.size)
    vals[0::2] = iq.real
    vals[1::2] = iq.imag
    vals = np.clip(np.round(vals), -127, 127).astype(np.int8)
    tcfg = convert.config_from_jax(cfg)
    S = cfg.signal.samples_per_ms
    delays, fine = [], []
    for sv in SVS:
        f_code = cfg.signal.code_freq_basis * (1 + sv["doppler_hz"]
                                               / cfg.signal.fc)
        next_epoch = sv["code_delay_samples"] % (1023 / f_code * FS)
        delays.append(int(round((S - next_epoch) % S)))
        fine.append(F_IF + sv["doppler_hz"] + 3.0)
    src = TSource.from_array(vals, tcfg.file)
    _, locked = ttrack.run_tracking(
        src, tcfg, PRNS, ttrack.init_track_state(tcfg, delays, fine, "cpu"),
        TTrackParams.epl(tcfg), LOCK_MS)
    return dict(cfg=cfg, tcfg=tcfg, vals=vals, src=src, locked=locked,
                chips=chip_tables(PRNS, "cpu"))


def _chunk(scene, spec, n_steps):
    """(raw int8 tensor, chunk_start) covering n_steps blocks from the
    locked state."""
    st = scene["locked"]
    start = int(st.ptr.min())
    n = int(st.ptr.max()) - start + spec.window.need(n_steps)
    vals = scene["vals"].reshape(-1, 2)
    assert start + n <= len(vals)
    return torch.from_numpy(vals[start:start + n].copy()), start


def _params(tcfg, kind, **kw):
    return getattr(TTrackParams, kind)(tcfg, **kw)


# ------------------------------------------------- (1) the bank over windows


def _window_inputs(scene, params, int16=False):
    """Windows of one block of `params` cut at the locked state, and the
    NCO words of that block (numpy, as both packages take them)."""
    tcfg, st = scene["tcfg"], scene["locked"]
    spec = params.chunk_spec(tcfg)
    raw, start = _chunk(scene, spec, 1)
    if int16:       # an int16 front end: wider values with a DC offset
        raw = raw.to(torch.int16) * 50 + torch.tensor([700, -400],
                                                      dtype=torch.int16)
    rem, code_freq = st.rem_chip.numpy(), st.code_freq.numpy()
    n_exact = (spec.n_chips - rem) / (code_freq / FS)
    num = (np.ceil(n_exact) if spec.ceil_rounding
           else np.round(n_exact)).astype(np.int64)
    win = cb.cut_windows(raw, st.ptr - start, spec.window.blk)
    return dict(win=win, raw=raw, off=st.ptr - start, rem=rem,
                code_freq=code_freq, carr_freq=st.carr_freq.numpy(),
                phase_fp=st.phase_fp.numpy(), num=num, blk=spec.window.blk,
                taps=np.asarray(params.taps, np.float64),
                n_chips=spec.n_chips)


def _port_windows(scene, b, remove_dc):
    t64 = lambda a: torch.as_tensor(np.array(a), dtype=torch.int64)
    carr_fp = np.round(b["carr_freq"] / FS * Q32).astype(np.int64)
    corr, fault = cb.correlator_bank_windows(
        b["win"], torch.from_numpy(b["rem"].copy()),
        torch.from_numpy(b["code_freq"].copy()), t64(b["phase_fp"]),
        t64(carr_fp), t64(b["num"]), scene["chips"],
        cb.tap_offsets_fp(b["taps"], "cpu"), FS, remove_dc)
    assert int(fault[0]) == 0
    return corr


def test_cut_windows_equals_slices(scene):
    """The cut is a copy of raw[off : off + blk] per channel, int8 and
    int16, contiguous; offsets past the chunk are clamped into it."""
    tcfg = scene["tcfg"]
    for int16 in (False, True):
        b = _window_inputs(scene, TTrackParams.epl(tcfg, pdi_ms=10), int16)
        win, raw, blk = b["win"], b["raw"], b["blk"]
        assert win.shape == (3, blk, 2) and win.is_contiguous()
        assert win.dtype == raw.dtype
        for ch, o in enumerate(b["off"].tolist()):
            assert torch.equal(win[ch], raw[o:o + blk])
    L = raw.shape[0]
    far = cb.cut_windows(raw, torch.tensor([-5, L]), blk)
    assert torch.equal(far[0], raw[:blk]) and torch.equal(far[1], raw[-blk:])


@pytest.mark.parametrize("remove_dc", [False, True])
@pytest.mark.parametrize("pdi_ms", [1, 10])
@pytest.mark.parametrize("kind", ["epl", "pos_multicorr"])
def test_windows_bank_matches_jax_nco(scene, kind, pdi_ms, remove_dc):
    """The same windows, NCO words, `num` and taps through
    jax.vmap(correlate_block) with the "nco" replica (each window given as
    that channel's own chunk) and through the port's plain bank: within
    1e-5 of the mean prompt magnitude (float32 summation order: the JAX dot
    sums in float32, the port in float64).  DC removal runs on an int16
    version of the capture with an offset, as an int16 front end has."""
    import jax
    import jax.numpy as jnp
    from gps_sdr_tpu.ops.cacode import ca_code_table
    from gps_sdr_tpu.tracking import correlate_block

    params = _params(scene["tcfg"], kind, pdi_ms=pdi_ms)
    b = _window_inputs(scene, params, int16=remove_dc)
    chips = jnp.asarray(np.stack([ca_code_table()[p - 1] for p in PRNS]),
                        jnp.float32)
    taps = jnp.asarray(params.taps, jnp.float64)

    def chan(win, rem, cfq, cfr, pfp, ch, n):
        return correlate_block(win, jnp.int64(0), jnp.int64(0), rem, cfq,
                               cfr, pfp, ch, taps, FS, b["n_chips"],
                               b["blk"], params.rounding, remove_dc,
                               num=n)[0]

    ref = np.asarray(jax.vmap(chan)(
        jnp.asarray(b["win"].numpy(), jnp.float32), jnp.asarray(b["rem"]),
        jnp.asarray(b["code_freq"]), jnp.asarray(b["carr_freq"]),
        jnp.asarray(b["phase_fp"]), chips, jnp.asarray(b["num"])))
    got = _port_windows(scene, b, remove_dc).numpy()
    assert got.shape == ref.shape == (3, len(params.taps), 2)
    ip = params.i_prompt
    prompt = np.mean(np.hypot(ref[:, ip, 0], ref[:, ip, 1]))
    # a locked prompt (amplitude 2.5-3 per sample; the int16 version is
    # scaled by 50): the comparison is of signal, not of noise
    assert prompt > 1.5 * b["num"].mean() * (50 if remove_dc else 1)
    assert np.max(np.abs(got - ref)) < 1e-5 * prompt, \
        np.max(np.abs(got - ref)) / prompt


@pytest.mark.parametrize("kind,pdi_ms,remove_dc", [
    ("epl", 1, False), ("epl", 10, True), ("pos_multicorr", 10, False)])
def test_windows_bank_equals_fetching_bank(scene, kind, pdi_ms, remove_dc):
    """Both banks run one plain function, so over the same samples (the
    windows cut at `off`, the chunk read at `ptr_off = off`) they agree
    bit for bit."""
    params = _params(scene["tcfg"], kind, pdi_ms=pdi_ms)
    b = _window_inputs(scene, params, int16=remove_dc)
    got = _port_windows(scene, b, remove_dc)
    t64 = lambda a: torch.as_tensor(np.array(a), dtype=torch.int64)
    carr_fp = np.round(b["carr_freq"] / FS * Q32).astype(np.int64)
    ref, fault = cb.correlator_bank(
        b["raw"], b["off"], torch.from_numpy(b["rem"].copy()),
        torch.from_numpy(b["code_freq"].copy()), t64(b["phase_fp"]),
        t64(carr_fp), t64(b["num"]), scene["chips"],
        cb.tap_offsets_fp(b["taps"], "cpu"), FS, b["blk"], remove_dc)
    assert int(fault[0]) == 0
    assert torch.equal(got, ref)


def test_windows_bank_fault_and_validation(scene):
    """A block length outside [1, blk] and an NCO word that is not finite
    raise the flag and zero that channel; wrong shapes and types raise.
    The CPU path launches no kernel."""
    b = _window_inputs(scene, TTrackParams.epl(scene["tcfg"], pdi_ms=10))
    before = cb.correlator_bank_windows.launches
    good = _port_windows(scene, b, False)
    assert cb.correlator_bank_windows.launches == before
    t64 = lambda a: torch.as_tensor(np.array(a), dtype=torch.int64)
    carr_fp = np.round(b["carr_freq"] / FS * Q32).astype(np.int64)
    for field, ch, value in (("num", 0, 0), ("num", 2, b["blk"] + 1),
                             ("code_freq", 1, np.nan), ("rem", 2, np.inf)):
        bad = {k: np.array(v, copy=True) if isinstance(v, np.ndarray) else v
               for k, v in b.items()}
        bad[field][ch] = value
        corr, fault = cb.correlator_bank_windows(
            bad["win"], torch.from_numpy(bad["rem"]),
            torch.from_numpy(bad["code_freq"]), t64(bad["phase_fp"]),
            t64(carr_fp), t64(bad["num"]), scene["chips"],
            cb.tap_offsets_fp(bad["taps"], "cpu"), FS)
        assert int(fault[0]) == ch + 1
        with pytest.raises(RuntimeError, match=f"channel {ch}"):
            cb.raise_on_fault(fault)
        others = [c for c in range(3) if c != ch]
        assert torch.equal(corr[others], good[others])
        assert not corr[ch].any()
    words = (torch.zeros(3).double(), torch.zeros(3).double(),
             torch.zeros(3, dtype=torch.int64),
             torch.zeros(3, dtype=torch.int64),
             torch.ones(3, dtype=torch.int64))
    tail = (scene["chips"], cb.tap_offsets_fp((0.0,), "cpu"), FS)
    with pytest.raises(ValueError, match=r"\(N, blk, 2\)"):
        cb.correlator_bank_windows(b["win"].float(), *words, *tail)
    with pytest.raises(ValueError, match="multiple of 128"):
        cb.correlator_bank_windows(b["win"][:, :1000], *words, *tail)
    with pytest.raises(ValueError, match="int64"):
        cb.correlator_bank_windows(b["win"], *words[:4],
                                   torch.ones(3, dtype=torch.int32), *tail)


# ------------------------------------------------------- (3) the two trackers


@pytest.mark.parametrize("kind,kw,n_steps", [
    ("epl", dict(pdi_ms=1), 40),
    ("epl", dict(pdi_ms=10, negate_iq=True), 12),
    ("pos_multicorr", dict(pdi_ms=1), 20),
    ("pos_multicorr", dict(pdi_ms=10), 8)])
def test_track_scan_equals_track_chunk_plain(scene, kind, kw, n_steps):
    """`track_scan` (windows cut, bank over windows, `block_step`) and
    `track_chunk_reference` (bank reading the chunk, `block_step`) are one
    arithmetic: every record field and the end state equal bit for bit."""
    spec = _params(scene["tcfg"], kind, **kw).chunk_spec(scene["tcfg"])
    raw, start = _chunk(scene, spec, n_steps)
    st = scene["locked"]
    rec_s, end_s = ttrack.track_scan(raw, start, st, scene["chips"], spec,
                                     n_steps)
    rec_c, end_c = tc.track_chunk_reference(raw, start, st, scene["chips"],
                                            spec, n_steps)
    assert rec_s.keys() == rec_c.keys()
    assert rec_s["corr"].shape == (n_steps, 3, len(spec.taps), 2)
    for f in rec_c:
        assert rec_s[f].dtype == rec_c[f].dtype, f
        assert torch.equal(rec_s[f], rec_c[f]), f
    assert int(rec_s["fault"][0]) == 0
    for f, a, b in zip(end_c._fields, end_s, end_c):
        assert a.dtype == b.dtype and torch.equal(a, b), f
    # the tracker holds lock through the segment
    S = scene["tcfg"].signal.samples_per_ms
    assert (rec_s["num_sample"] - spec.pdi_ms * S).abs().max() <= 2


def test_track_scan_faults(scene):
    """A window that leaves the chunk and a code NCO that is not finite set
    the fault flag, which `raise_on_fault` turns into an error; a chunk too
    short for the blocks asked is refused at entry."""
    tcfg = scene["tcfg"]
    spec = TTrackParams.epl(tcfg, pdi_ms=10).chunk_spec(tcfg)
    raw, start = _chunk(scene, spec, 4)
    st = scene["locked"]
    with pytest.raises(ValueError, match="does not cover"):
        ttrack.track_scan(raw[:-1], start, st, scene["chips"], spec, 4)
    # the code NCO runs 30 % slow: blocks grow past the window
    slow = st._replace(code_freq=st.code_freq * 0.7)
    rec, _ = ttrack.track_scan(raw, start, slow, scene["chips"], spec, 2)
    assert int(rec["fault"][0]) == 3
    with pytest.raises(RuntimeError, match="channel 2"):
        tc.raise_on_fault(rec)
    nan = st._replace(rem_chip=torch.tensor([0.0, float("nan"), 0.0],
                                            dtype=torch.float64))
    rec, _ = ttrack.track_scan(raw, start, nan, scene["chips"], spec, 1)
    assert int(rec["fault"][0]) == 2
    assert ttrack.track_scan(raw, start, st, scene["chips"], spec,
                             0)[0]["corr"].shape == (0, 3, 3, 2)


# ---------------------------------------------- (4) track_scan against JAX


def test_track_scan_matches_jax_nco_10ms(scene):
    """40 blocks of pdi 10 ms with negated correlators from the locked
    state, through the JAX `track_scan(replica="nco")` and the port's:
    integer block chain exact.  The other fields cannot keep the 1 ms
    bounds of tests/test_torch_track_chunk.py (correlators 1e-4 of their
    mean, frequencies 1e-3 Hz, code phase 1e-6 chip): a block is 10 times
    as long, so one LSB of carr_fp turns the block's last sample 10 times
    as far (6e-5 rad) and the float32 sums of the JAX dot are 10 times as
    long, while the loop gains per block are unchanged.  Measured here:
    correlators 1.8e-4, code frequency 2.9e-3 Hz, carrier frequency 1.6e-3
    Hz, code phase 2.6e-5 chip; held at 5e-4, 1e-2 Hz and 1e-4 chip."""
    import jax.numpy as jnp
    from gps_sdr_tpu.ops.cacode import ca_code_table
    from gps_sdr_tpu.tracking import TrackParams, TrackState, track_scan
    cfg, tcfg, st = scene["cfg"], scene["tcfg"], scene["locked"]
    n_steps = 40
    tparams = TTrackParams.epl(tcfg, pdi_ms=10, negate_iq=True)
    spec = tparams.chunk_spec(tcfg)
    raw, start = _chunk(scene, spec, n_steps)
    trec, tend = ttrack.track_scan(raw, start, st, scene["chips"], spec,
                                   n_steps)
    assert int(trec["fault"][0]) == 0
    jstate = TrackState(**{f: jnp.asarray(v) for f, v in
                           convert.track_state_to_numpy(st).items()})
    chips = jnp.asarray(np.stack([ca_code_table()[p - 1] for p in PRNS]),
                        jnp.float32)
    jend, jrec = track_scan(
        jnp.asarray(raw.numpy(), jnp.float32), jnp.int64(start), jstate,
        chips, TrackParams.epl(cfg, pdi_ms=10, negate_iq=True,
                               replica="nco"),
        n_steps, float(FS), spec.window.blk, float(cfg.signal.code_freq_basis))
    j = {f: np.asarray(v) for f, v in jrec.items()}
    t = {f: v.numpy() for f, v in trec.items()}
    np.testing.assert_array_equal(t["num_sample"], j["num_sample"])
    np.testing.assert_array_equal(t["absolute_sample"], j["absolute_sample"])
    np.testing.assert_array_equal(tend.ptr.numpy(), np.asarray(jend.ptr))
    scale = np.mean(np.abs(j["corr"]))
    dphi = np.angle(np.exp(1j * (t["rem_phase"] - j["rem_phase"])))
    diffs = dict(
        rem_chip=np.abs(t["rem_chip"] - j["rem_chip"]).max(),
        corr_rel=np.abs(t["corr"] - j["corr"]).max() / scale,
        code_freq=np.abs(t["code_freq"] - j["code_freq"]).max(),
        carr_freq=np.abs(t["carr_freq"] - j["carr_freq"]).max(),
        phase=np.abs(dphi).max())
    print("track_scan against the JAX scan, pdi 10:", diffs)
    assert diffs["rem_chip"] < 1e-4 and diffs["corr_rel"] < 5e-4, diffs
    assert max(diffs["code_freq"], diffs["carr_freq"]) < 1e-2, diffs
    assert diffs["phase"] < 1e-3, diffs
    assert t["corr"].dtype == j["corr"].dtype == np.float32


# ------------------------------------------------------------- (5) routing


@pytest.mark.parametrize("pdi_ms,scan_calls,chunk_calls", [
    (1, 0, 3), (2, 0, 3), (10, 3, 0)])
def test_run_tracking_routes_on_pdi(scene, monkeypatch, pdi_ms, scan_calls,
                                    chunk_calls):
    """Blocks longer than 2 ms go through `track_scan`, the others through
    `track_chunk` (gps_sdr_tpu/tracking.py:550-554): one call per chunk."""
    calls = {"scan": 0, "chunk": 0}
    real_scan, real_chunk = ttrack.track_scan, ttrack.track_chunk

    def scan(*a):
        calls["scan"] += 1
        return real_scan(*a)

    def chunk(*a):
        calls["chunk"] += 1
        return real_chunk(*a)

    monkeypatch.setattr(ttrack, "track_scan", scan)
    monkeypatch.setattr(ttrack, "track_chunk", chunk)
    tcfg = scene["tcfg"]
    rec, _ = ttrack.run_tracking(
        scene["src"], tcfg, PRNS, scene["locked"],
        TTrackParams.epl(tcfg, pdi_ms=pdi_ms), 120, chunk_ms=40)
    assert calls == {"scan": scan_calls, "chunk": chunk_calls}
    assert rec.corr.shape[0] == 120 // pdi_ms


# ------------------------------------------- (6) the reference's eph schedule


REF_EPH = dict(
    sqrta=5153.6413, ecc=0.00122963, m0=2.14587329, omega0=1.25789432,
    i0=0.96679784, w=-0.89245321, deltan=4.3267e-09, omegadot=-7.2345e-09,
    idot=-4.2e-10, cuc=1.5272e-07, cus=2.3842e-07, crc=287.46875,
    crs=-2.59375, cic=-7.45058e-09, cis=1.3039e-08, toe=388800.0,
    toc=388800.0, af0=1.8364e-04, af1=2.0464e-12, af2=0.0,
    tgd=-7.4506e-09, iodc=23, iode=23, health=0, ura=0)
N1, N10, MIN_TRANSITION = 700, 800, 300


@pytest.fixture(scope="module")
def schedule(tmp_path_factory):
    """The capture of tests/test_reference_schedule.py (5 MHz, PRNs 9 and
    23 with navigation bits, skip 1 ms, 700 + 800 ms) through both
    packages' `track_for_eph_reference(min_transition_index=300)`."""
    from gps_sdr_tpu.config import (FileConfig, ReceiverConfig, SignalConfig,
                                    TrackConfig)
    from gps_sdr_tpu.io import lnav
    from gps_sdr_tpu.io.ifdata import IFSampleSource, write_if_file
    from gps_sdr_tpu.io.synthetic import SyntheticSV, generate_if_samples
    from gps_sdr_tpu.pipeline import Receiver
    cfg = ReceiverConfig(
        file=FileConfig(name="refsched", skip_ms=1),
        signal=SignalConfig(f_if=1.25e6, fs=5e6),
        track=TrackConfig(ms_eph_1ms=N1, ms_eph_10ms=N10))
    bits = lnav.encode_frames(REF_EPH, 2239, 388800.0, 13)
    svs = [SyntheticSV(prn=9, amplitude=2.5, doppler_hz=987.0,
                       code_delay_samples=1500.0, nav_bits=bits),
           SyntheticSV(prn=23, amplitude=2.2, doppler_hz=-2100.0,
                       code_delay_samples=100.0, nav_bits=bits)]
    iq = generate_if_samples(cfg, svs, duration_ms=1 + N1 + N10 + 60,
                             noise_std=8.0, seed=9)
    root = tmp_path_factory.mktemp("torch_sched")
    path = str(root / "refsched.bin")
    write_if_file(path, iq, cfg.file)
    jrx = Receiver(cfg, IFSampleSource(path, cfg.file), mesh=None)
    jrec = jrx.track_for_eph_reference(min_transition_index=MIN_TRANSITION)
    tcfg = convert.config_from_jax(cfg)
    trx = TReceiver(tcfg, TSource(path, tcfg.file),
                    artifact_dir=str(root / "torch"), device="cpu")
    trec = trx.track_for_eph_reference(min_transition_index=MIN_TRANSITION)
    return dict(cfg=cfg, tcfg=tcfg, path=path, jrx=jrx, trx=trx,
                jrec=convert.records_from_jax(jrec), trec=trec,
                dir=str(root / "torch"))


def _countinx(rec, n_ch):
    from gps_sdr_tpu_torch.pipeline import detect_bit_transition
    return np.array([detect_bit_transition(rec.p_i[:N1, ch],
                                           min_index=MIN_TRANSITION)
                     for ch in range(n_ch)])


def test_reference_schedule_matches_jax(schedule):
    """Both packages' 3-phase records: same acquisition, same `countinx`
    (re-detected on the phase (a)/(b) prefix, which is what the schedule
    detected), same shapes and dtypes.  The integer block chain is exact up
    to the first trajectory split (the first row whose carrier frequencies
    are more than 1e-3 Hz apart, see tests/test_torch_slice.py) and within
    one sample after; the prompt signs, which are the navigation bits,
    agree on at least 99 % of the rows."""
    j, t = schedule["jrec"], schedule["trec"]
    ja, ta = schedule["jrx"].acquisition(), schedule["trx"].acquisition()
    np.testing.assert_array_equal(ta.sv, ja.sv)
    np.testing.assert_array_equal(ta.code_delay, ja.code_delay)
    assert sorted(ta.sv.tolist()) == [9, 23]
    cnt_j, cnt_t = _countinx(j, 2), _countinx(t, 2)
    np.testing.assert_array_equal(cnt_t, cnt_j)
    tn, jn = convert.records_to_numpy(t), convert.records_to_numpy(j)
    assert tn.keys() == jn.keys()
    for f in tn:
        assert tn[f].shape == jn[f].shape and tn[f].dtype == jn[f].dtype, f
    assert t.corr.shape == (N1 + int(cnt_t.max()) + N10, 2, 3, 2)
    dcarr = np.abs(t.carr_freq - j.carr_freq) > 1e-3
    split = int(np.argmax(dcarr.any(axis=1))) if dcarr.any() else len(dcarr)
    print(f"reference schedule: countinx {cnt_t}, first split at row {split}"
          f" of {len(dcarr)}")
    assert split >= 200, split
    np.testing.assert_array_equal(t.num_sample[:split], j.num_sample[:split])
    np.testing.assert_array_equal(t.absolute_sample[:split],
                                  j.absolute_sample[:split])
    assert np.max(np.abs(t.absolute_sample - j.absolute_sample)) <= 1
    assert np.mean(np.sign(t.p_i) == np.sign(j.p_i)) >= 0.99


def test_reference_schedule_structure(schedule):
    """Phase (c) in the port's record: past each channel's switch row the
    rows are 10 ms blocks replicated ×10 (runs of 10 equal rows, block
    length ≈ 10·S); the 1 ms prefix equals a plain 1 ms run bit for bit; the
    10 ms phase went through `track_scan` and still carries the data bits
    (negated outputs keep the 20 ms bit structure)."""
    t, tcfg = schedule["trec"], schedule["tcfg"]
    S = tcfg.signal.samples_per_ms
    cnt = _countinx(t, 2)
    for ch in range(2):
        sw = N1 + int(cnt[ch])
        for f in ("corr", "num_sample", "absolute_sample", "carr_freq"):
            tail = getattr(t, f)[sw:sw + N10, ch]
            runs = tail.reshape(N10 // 10, 10, *tail.shape[1:])
            np.testing.assert_array_equal(runs, runs[:, :1].repeat(10, 1))
        assert np.all(np.abs(t.num_sample[sw:sw + N10, ch] - 10 * S) < 100)
        assert np.all(np.abs(t.num_sample[:sw, ch] - S) < 10)
        # 20 ms bits: consecutive 10 ms blocks pair up in sign
        p = np.sign(t.p_i[sw:sw + N10:10, ch])
        assert np.mean(p[:-1] == p[1:]) > 0.45
        assert np.abs(t.p_i[sw + 100:sw + N10, ch]).mean() \
            > 5 * np.abs(t.p_i[N1 - 200:N1, ch]).mean()
    acq = schedule["trx"].acquisition()
    plain, _ = ttrack.run_tracking(
        TSource(schedule["path"], tcfg.file), tcfg, [int(p) for p in acq.sv],
        ttrack.init_track_state(tcfg, acq.code_delay, acq.fine_freq_hz,
                                "cpu"),
        TTrackParams.epl(tcfg), N1 + int(cnt.max()))
    for ch in range(2):
        sw = N1 + int(cnt[ch])
        for f in convert.records_to_numpy(plain):
            np.testing.assert_array_equal(getattr(t, f)[:sw, ch],
                                          getattr(plain, f)[:sw, ch], f)


def test_schedules_keep_their_own_records(schedule):
    """One `tckeph_` stem for both schedules is a fault of the JAX package
    (gps_sdr_tpu/pipeline.py:211: whichever schedule ran first is loaded
    for the other).  The port diverges: the reference schedule's record has
    a stem keyed on the schedule, so a second Receiver on the same
    directory tracks the plain schedule itself and, asked for the reference
    schedule, loads exactly the reference record."""
    import os
    tcfg, d = schedule["tcfg"], schedule["dir"]
    ref_stem = f"tckeph_ref_refsched_{N1}_{N10}_{MIN_TRANSITION}.npz"
    assert ref_stem in os.listdir(d)
    assert "tckeph_refsched.npz" not in os.listdir(d)
    src = TSource(schedule["path"], tcfg.file)
    rx2 = TReceiver(tcfg, src, artifact_dir=d, device="cpu")
    plain = rx2.track_for_eph(n_ms=900)
    assert plain.corr.shape[0] == 900          # tracked, not the ref record
    assert "tckeph_refsched.npz" in os.listdir(d)
    S = tcfg.signal.samples_per_ms
    assert np.all(np.abs(plain.num_sample - S) < 10)
    rx3 = TReceiver(tcfg, src, artifact_dir=d, device="cpu")
    again = rx3.track_for_eph_reference(min_transition_index=MIN_TRANSITION)
    for f, a in convert.records_to_numpy(again).items():
        np.testing.assert_array_equal(a, getattr(schedule["trec"], f), f)
    # another schedule length is another record
    cfg4 = dataclasses.replace(tcfg, track=dataclasses.replace(
        tcfg.track, ms_eph_10ms=100))
    rx4 = TReceiver(cfg4, src, artifact_dir=d, device="cpu")
    short = rx4.track_for_eph_reference(
        min_transition_index=MIN_TRANSITION)
    assert short.corr.shape[0] == again.corr.shape[0] - (N10 - 100)


def _copy_artifacts(src_dir, dst, prefixes):
    import os
    import shutil
    for f in os.listdir(src_dir):
        if f.startswith(prefixes):
            shutil.copy(os.path.join(src_dir, f), dst)


def test_decode_reads_the_reference_record(schedule, tmp_path, monkeypatch):
    """A second Receiver on a directory that holds only the reference
    schedule's record (no countinx_ or eph_ artifact) decodes that record
    and tracks nothing (`run_tracking` counted by a spy); its countinx is
    the record's.  With the plain schedule's record beside it, neither built
    by the Receiver, decode raises and names both files."""
    import os

    from gps_sdr_tpu_torch import navdecode, pipeline
    from gps_sdr_tpu_torch.pipeline import detect_bit_transition
    tcfg = schedule["tcfg"]
    _copy_artifacts(schedule["dir"], tmp_path, ("acquired_", "tckeph_ref_"))
    calls = []
    real = pipeline.run_tracking
    monkeypatch.setattr(pipeline, "run_tracking",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    src = TSource(schedule["path"], tcfg.file)
    rx = TReceiver(tcfg, src, artifact_dir=str(tmp_path), device="cpu")
    eph, sbf = rx.decode(start_offset_ms=0)
    cnt = rx.countinx(min_transition_index=MIN_TRANSITION)
    assert calls == []
    trec = schedule["trec"]
    acq = rx.acquisition()
    want_eph, want_sbf = navdecode.decode_all(
        {int(p): trec.p_i[:, ch] for ch, p in enumerate(acq.sv)}, 0)
    assert sbf == want_sbf and sorted(eph) == sorted(want_eph)
    np.testing.assert_array_equal(cnt, [detect_bit_transition(
        trec.p_i[:, ch], min_index=MIN_TRANSITION) for ch in range(2)])
    # both schedules' records on disk: ambiguous
    rx._save_records("tckeph_refsched.npz", trec)
    for stem in ("eph_refsched.pkl", "countinx_refsched.npz"):
        os.remove(tmp_path / stem)
    rx2 = TReceiver(tcfg, src, artifact_dir=str(tmp_path), device="cpu")
    ref_stem = f"tckeph_ref_refsched_{N1}_{N10}_{MIN_TRANSITION}.npz"
    with pytest.raises(RuntimeError, match="tckeph_refsched.npz") as err:
        rx2.decode(start_offset_ms=0)
    assert ref_stem in str(err.value)
    assert calls == []


def test_port_refuses_pickles_it_did_not_write(schedule, tmp_path,
                                               monkeypatch):
    """The JAX package decodes into a directory (its `eph_{name}.pkl`); a
    port Receiver on that directory raises a ValueError that names the file
    and the JAX package, and unpickles nothing.  An untagged pickle of the
    port's own classes (what the port wrote before it tagged its pickles)
    is refused the same way; a tagged one loads."""
    import pickle

    from gps_sdr_tpu.io.ifdata import IFSampleSource
    from gps_sdr_tpu.pipeline import Receiver
    cfg, tcfg = schedule["cfg"], schedule["tcfg"]
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdir.mkdir()
    tdir.mkdir()
    _copy_artifacts(schedule["dir"], jdir, ("acquired_",))
    Receiver._save_records(str(jdir / "tckeph_refsched.npz"),
                           schedule["jrx"]._eph_records)
    jrx = Receiver(cfg, IFSampleSource(schedule["path"], cfg.file),
                   artifact_dir=str(jdir), mesh=None)
    jeph, jsbf = jrx.decode(start_offset_ms=0)
    assert (jdir / "eph_refsched.pkl").exists()

    def no_unpickling(*a, **k):
        raise AssertionError("unpickled a file that is not the port's")

    src = TSource(schedule["path"], tcfg.file)
    with monkeypatch.context() as m:
        m.setattr(pickle, "loads", no_unpickling)
        m.setattr(pickle, "load", no_unpickling)
        rx = TReceiver(tcfg, src, artifact_dir=str(jdir), device="cpu")
        with pytest.raises(ValueError, match="written by gps_sdr_tpu,") as e:
            rx.decode(start_offset_ms=0)
        assert str(jdir / "eph_refsched.pkl") in str(e.value)
        assert "not this package's artifact" in str(e.value)
    teph, tsbf = convert.ephemeris_from_jax(jeph, jsbf)
    with open(tdir / "eph_refsched.pkl", "wb") as f:
        pickle.dump((teph, tsbf), f)
    rx = TReceiver(tcfg, src, artifact_dir=str(tdir), device="cpu")
    with pytest.raises(ValueError, match="written by gps_sdr_tpu_torch,"):
        rx.decode(start_offset_ms=0)
    rx._save_pickle("eph_refsched.pkl", (teph, tsbf))
    eph, sbf = TReceiver(tcfg, src, artifact_dir=str(tdir),
                         device="cpu").decode(start_offset_ms=0)
    assert sbf == tsbf and sorted(eph) == sorted(teph)


# ------------------------- (2) against the TPU kernel over windows (interpret)


@pytest.mark.parametrize("case", ["epl", "epl_dc", "multicorr25"])
def test_windows_bank_against_pallas_interpret(case):
    """Against the TPU kernel `pallas_correlator.correlator_bank` in
    interpret mode, on the inputs of tests/test_pallas_correlator.py
    (1.023 MHz, PRNs 3 / 7 / 11, integer noise, the initial NCO state, its
    window offsets; the DC case with its +11 offset).

    That kernel is the table replica: a code table sampled at the nominal
    rate, each tap interpolated linearly between neighbouring samples.  At
    this rate a sample is a chip, so a tap at a fraction f of a chip is, in
    the table model, (1 − f)·X[n] + f·X[n + 1] with X[n] the correlation at
    the whole-chip offset n, while the exact replica steps from X[n] to
    X[n + 1] in one go: the fractional taps of the two models share nothing
    that a bound could hold (at ±0.5 chip they differ by the order of the
    prompt itself).  What both share is everything else (the Q32 carrier
    mix, the mask to `num`, DC removal, the sums) and the code at whole-chip
    offsets: with zero code phase and the nominal code rate the table's
    sample n is the exact replica's chip at tap n.  So the port's bank is
    run at the whole-chip taps −1, 0, +1 and the identity above rebuilds
    every tap of the TPU kernel from it: within 1e-5 of the largest
    correlator (float32 summation order; measured 5e-7 to 8e-7, against
    2e-4 between that kernel and its XLA twin in
    tests/test_pallas_correlator.py)."""
    import jax.numpy as jnp
    from gps_sdr_tpu.config import FileConfig, ReceiverConfig, SignalConfig
    from gps_sdr_tpu.ops.pallas_correlator import correlator_bank
    from gps_sdr_tpu.tracking import TrackParams, build_shift_tables_2d
    cfg = ReceiverConfig(file=FileConfig(skip_ms=0),
                         signal=SignalConfig(f_if=2.5e5, fs=1.023e6))
    fs, prns = 1.023e6, [3, 7, 11]
    seed, ptr, dfreq, offset, remove_dc = {
        "epl": (0, [0, 37, 411], 700.0, 0, False),
        "epl_dc": (1, [0, 0, 0], 250.0, 11, True),
        "multicorr25": (2, [3, 0, 99], -500.0, 0, False)}[case]
    params = (TrackParams.pos_multicorr(cfg) if case == "multicorr25"
              else TrackParams.epl(cfg))
    taps = np.asarray(params.taps, np.float64)
    S = cfg.signal.samples_per_ms
    blk = -(-(S + 256) // 128) * 128
    rng = np.random.default_rng(seed)
    vals = (rng.integers(-64, 64, size=(3 * S + blk, 2)) + offset
            ).astype(np.int8)
    num = np.full(3, 1023, np.int64)          # round(1023 chips / 1.0)
    carr_fp = np.full(3, np.round((cfg.signal.f_if + dfreq) / fs * Q32),
                      np.int64)
    win = cb.cut_windows(torch.from_numpy(vals), torch.tensor(ptr), blk)

    tables, margin = build_shift_tables_2d(cfg, prns, blk)
    pos = margin + taps[None, :].repeat(3, 0) / (cfg.signal.code_freq_basis
                                                 / fs)
    xw = win.numpy().astype(np.float32).transpose(0, 2, 1).reshape(
        3, 2, blk // 128, 128)
    ref = np.asarray(correlator_bank(
        jnp.asarray(xw), jnp.asarray(tables),
        jnp.asarray(np.floor(pos).astype(np.int32)),
        jnp.asarray((pos - np.floor(pos)).astype(np.float32)),
        jnp.zeros(3, jnp.int32), jnp.asarray(carr_fp.astype(np.int32)),
        jnp.asarray(num.astype(np.int32)), ntaps=len(taps),
        remove_dc=remove_dc, interpret=True))

    def port(tap_list):
        corr, fault = cb.correlator_bank_windows(
            win, torch.zeros(3, dtype=torch.float64),
            torch.full((3,), cfg.signal.code_freq_basis,
                       dtype=torch.float64),
            torch.zeros(3, dtype=torch.int64), torch.from_numpy(carr_fp),
            torch.from_numpy(num), chip_tables(prns, "cpu"),
            cb.tap_offsets_fp(tap_list, "cpu"), fs, remove_dc)
        assert int(fault[0]) == 0
        return corr.numpy()

    whole = port((-1.0, 0.0, 1.0))                       # X[−1], X[0], X[1]
    lo = np.floor(taps).astype(int)                      # −1 or 0
    f = (taps - lo)[None, :, None]
    rebuilt = (1 - f) * whole[:, lo + 1] + f * whole[:, lo + 2]
    scale = np.abs(ref).max()
    err = np.abs(rebuilt - ref).max() / scale
    apart = np.abs(port(taps) - ref).max() / scale
    print(f"{case}: rebuilt − TPU kernel {err:.2e} of the largest "
          f"correlator; the port's own fractional taps are {apart:.2f} apart")
    assert ref.shape == (3, len(taps), 2)
    assert err < 1e-5, err


# ------------------------------------------------------- (8) on the card


@pytest.mark.gpu
def test_cuda_windows_bank_matches_plain():
    """The CUDA bank over windows against the plain version on the CPU: 3
    and 25 taps, int8 and int16 with DC removal, 1 and several CTAs per
    channel, a block short enough for one segment of 256 rows per CTA and
    one long enough for several (n_split=1: 704 rows): within 1e-5 of the
    mean correlator magnitude (the CPU's sin/cos differ from the card's in
    the last float32 bits).  On the card itself it equals the fetching
    bank bit for bit, and a block length past the window raises the flag.
    """
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _check_windows_kernel(torch.device("cuda"))


def _check_windows_kernel(dev):
    launched = int(dev.type == "cuda")
    rng = np.random.default_rng(4)
    n, prns = 5, [3, 7, 16, 22, 27]
    i64, f64 = torch.int64, torch.float64
    for blk, pdi in ((2816, 1), (90112, 36)):
        nominal = int(round(1023 * pdi / 1.023e6 * 2.5e6))
        L = n * blk + 500
        vals8 = torch.from_numpy(rng.integers(-60, 60, (L, 2))
                                 .astype(np.int8))
        off = torch.tensor([0, 17, blk + 3, 2 * blk + 101, L - blk],
                           dtype=i64)
        words = dict(
            rem_chip=torch.tensor(rng.uniform(-0.5, 1.5, n), dtype=f64),
            code_freq=torch.tensor(1.023e6 + rng.uniform(-3, 3, n),
                                   dtype=f64),
            phase_fp=torch.tensor(rng.integers(-2 ** 31, 2 ** 31, n),
                                  dtype=i64),
            carr_fp=torch.tensor(np.round((0.6e6 + rng.uniform(-5e3, 5e3, n))
                                          / 2.5e6 * 2.0 ** 32), dtype=i64),
            num=torch.tensor([nominal + d for d in (-2, -1, 0, 1, 2)],
                             dtype=i64))
        for tap_list in ((-0.5, 0.0, 0.5),
                         tuple(round(0.6 - 0.05 * i, 4) for i in range(25))):
            for vals, remove_dc in ((vals8, False),
                                    (vals8.to(torch.int16) * 40 + 300, True)):
                win = cb.cut_windows(vals, off, blk)
                ref, _ = cb.correlator_bank_windows(
                    win, *words.values(), chip_tables(prns, "cpu"),
                    cb.tap_offsets_fp(tap_list, "cpu"), 2.5e6, remove_dc)
                scale = float(ref.abs().mean())
                dwin = cb.cut_windows(vals.to(dev), off.to(dev), blk)
                assert torch.equal(dwin.cpu(), win)
                dwords = [a.to(dev) for a in words.values()]
                tail = (chip_tables(prns, dev),
                        cb.tap_offsets_fp(tap_list, dev), 2.5e6)
                for n_split in (1, 7, None):
                    before = cb.correlator_bank_windows.launches
                    out, fault = cb.correlator_bank_windows(
                        dwin, *dwords, *tail, remove_dc, n_split=n_split)
                    assert cb.correlator_bank_windows.launches \
                        == before + launched
                    cb.raise_on_fault(fault)
                    assert float((out.cpu() - ref).abs().max()) \
                        < 1e-5 * scale
                    fetched, fault = cb.correlator_bank(
                        vals.to(dev), off.to(dev), *dwords, *tail, blk,
                        remove_dc, n_split=n_split)
                    cb.raise_on_fault(fault)
                    assert torch.equal(out, fetched)
        long = dict(words, num=words["num"].clone())
        long["num"][3] = blk + 1
        out, fault = cb.correlator_bank_windows(
            dwin, *[a.to(dev) for a in long.values()], *tail, True)
        assert int(fault[0]) == 4 and not out[3].any()


# ------------------------------------ (9) one CUDA graph a chunk (ScanGraph)

G_FS = 2.5e6
G_SVS = [dict(prn=7, amplitude=3.0, doppler_hz=1234.5,
              code_delay_samples=800.0),
         dict(prn=21, amplitude=2.5, doppler_hz=-2500.25,
              code_delay_samples=1345.0),
         dict(prn=13, amplitude=2.8, doppler_hz=310.0,
              code_delay_samples=2100.5)]
G_LOCK_MS, G_CHUNK_MS, G_MS = 60, 50, 170   # 10 ms chunks of 5, 5, 5, 2
# IF, data precision (2: int16, DC removal), TrackParams maker, its keywords
G_CASES = {"int8_if_3taps": (0.6e6, 1, "epl", dict(negate_iq=True)),
           "int16_dc": (0.0, 2, "epl", {}),
           "taps25": (0.6e6, 1, "pos_multicorr", {})}
_G_SCENES = {}


def _graph_scene(case):
    """A port-only capture for `case` (the port's generator at 2.5 MHz,
    three SVs; int16 ×40 with DC 230 − 95j), the NCO state after
    G_LOCK_MS ms of 1 ms tracking on the CPU, and the 10 ms params."""
    if case in _G_SCENES:
        return _G_SCENES[case]
    from gps_sdr_tpu_torch.config import (FileConfig, ReceiverConfig,
                                          SignalConfig)
    from gps_sdr_tpu_torch.io.synthetic import (SyntheticSV,
                                                generate_if_samples,
                                                quantize_iq)
    f_if, precision, kind, kw = G_CASES[case]
    cfg = ReceiverConfig(
        file=FileConfig(name="graph", skip_ms=0, data_precision=precision),
        signal=SignalConfig(f_if=f_if, fs=G_FS))
    iq = generate_if_samples(cfg, [SyntheticSV(**sv) for sv in G_SVS],
                             G_LOCK_MS + G_MS + 20, noise_std=4.0, seed=7,
                             device="cpu")
    if precision == 2:
        values = quantize_iq(iq * 40 + complex(230, -95), np.int16)
    else:
        values = quantize_iq(iq)
    sig, S = cfg.signal, cfg.signal.samples_per_ms
    delays, fine = [], []
    for sv in G_SVS:
        f_code = sig.code_freq_basis * (1 + sv["doppler_hz"] / sig.fc)
        epoch = sv["code_delay_samples"] % (1023 / f_code * G_FS)
        delays.append(int(round((S - epoch) % S)))
        fine.append(f_if + sv["doppler_hz"] + 3.0)
    src = TSource.from_array(values, cfg.file)
    prns = [sv["prn"] for sv in G_SVS]
    _, locked = ttrack.run_tracking(
        src, cfg, prns, ttrack.init_track_state(cfg, delays, fine, "cpu"),
        TTrackParams.epl(cfg), G_LOCK_MS)
    params = _params(cfg, kind, pdi_ms=10, **kw)
    _G_SCENES[case] = scene = (cfg, src, prns, locked, params)
    return scene


def _to(state, dev):
    return ttrack.TrackState(*(t.to(dev) for t in state))


def _window(src, spec, state, nb, dev, extra=0):
    """The chunk `run_tracking`'s feed cuts for `nb` blocks from `state`
    (with `extra` samples more), on `dev`: (raw, chunk_start)."""
    feed = ChunkFeed(src, dev, spec.window)
    try:
        raw, lo = feed.next(state.ptr, nb, 0)
    finally:
        feed.close()
    if extra:
        raw = torch.from_numpy(
            src.read_iq_values(lo, raw.shape[0] + extra)).to(dev)
    return raw, lo


def _eager_chunks(src, spec, state, chips, n_blocks, per):
    """`track_scan` chunk by chunk over the windows `run_tracking` cuts:
    each chunk's records (on the host) and the end state."""
    parts, left = [], n_blocks
    while left:
        nb = min(per, left)
        raw, lo = _window(src, spec, state, nb, state.ptr.device)
        rec, state = ttrack.track_scan(raw, lo, state, chips, spec, nb)
        tc.raise_on_fault(rec)
        parts.append({f: v.cpu() for f, v in rec.items()})
        left -= nb
    return parts, state


def test_scan_graph_route_rule():
    """The graph route's rule: `uses_scan_graph` takes only blocks of
    `track_scan` on a CUDA device, staged, unsharded, over more than one
    chunk; a `ScanGraph` captures its first chunk into a buffer of the
    window plus its slack, replays while chunks of its number of blocks
    fit, captures again for a larger window, and runs a chunk of another
    number of blocks through `track_scan` (the replay and the eager scan
    stubbed here to record the decision)."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert ttrack.uses_scan_graph(cuda, 10, True, False, 4000, 100)
    for dev, pdi, staged, sharded, n, per in (
            (cpu, 10, True, False, 4000, 100),      # the CPU
            (cuda, 1, True, False, 40000, 1000),    # track_chunk
            (cuda, 2, True, False, 500, 500 // 2),  # one chunk of 2 ms
            (cuda, 10, False, False, 4000, 100),    # resident capture
            (cuda, 10, True, True, 4000, 100),      # a mesh
            (cuda, 10, True, False, 100, 100),      # a single chunk
            (cuda, 10, True, False, 60, 100)):
        assert not ttrack.uses_scan_graph(dev, pdi, staged, sharded, n, per)
    cfg, _, prns, st, params = _graph_scene("int8_if_3taps")
    spec, chips = params.chunk_spec(cfg), chip_tables(prns, "cpu")
    S, first = cfg.signal.samples_per_ms, 27_000
    graph = ttrack.ScanGraph(4 * S)
    assert graph.capacity is None and graph.n_steps is None
    seen = []
    capture = graph._capture

    def chunk(length, n_steps):
        graph(torch.zeros((length, 2), dtype=torch.int8), 0, st, chips,
              spec, n_steps)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graph, "_capture", lambda raw, *a: (
            seen.append(("capture", raw.shape[0])), capture(raw, *a)))
        mp.setattr(graph, "_replay", lambda raw, *a: seen.append(
            ("replay", raw.shape[0])))
        mp.setattr(ttrack, "track_scan", lambda raw, *a: seen.append(
            ("eager", raw.shape[0])))
        chunk(first, 5)
        cap = graph.capacity
        assert cap == first + 4 * S and graph.n_steps == 5
        for length, n_steps in ((first, 5), (cap, 5), (cap + 1, 5),
                                (first, 2), (3 * cap, 2)):
            chunk(length, n_steps)
    assert seen == [("capture", first), ("replay", first),
                    ("replay", first), ("replay", cap),
                    ("capture", cap + 1), ("replay", cap + 1),
                    ("eager", first), ("eager", 3 * cap)]
    assert graph.capacity == cap + 1 + 4 * S and graph.n_steps == 5


@pytest.mark.parametrize("case", list(G_CASES))
def test_scan_graph_equals_track_scan(case):
    """`ScanGraph` run over its fixed tensors (eagerly here: the capture
    needs the card) against `track_scan` on each chunk the feed cuts:
    every record field and the end state equal, chunk after chunk, with
    the chunk at the buffer's head, the tail stale, `chunk_start` a
    device scalar and the end state written back.  A code NCO 30 % slow
    on channel 1 raises its flag as `track_scan` does, and the next call
    starts from a cleared flag; a window past the buffer is captured
    again into a larger one, with the same records."""
    cfg, src, prns, st, params = _graph_scene(case)
    spec = params.chunk_spec(cfg)
    chips = chip_tables(prns, "cpu")
    nb = G_CHUNK_MS // params.pdi_ms
    feed = ChunkFeed(src, "cpu", spec.window)
    graph = ttrack.ScanGraph(feed.slack)
    st_e = st_g = st
    try:
        for _ in range(3):
            raw, lo = feed.next(st_e.ptr, nb, nb)
            rec_e, st_e = ttrack.track_scan(raw, lo, st_e, chips, spec, nb)
            rec_g, st_g = graph(raw, lo, st_g, chips, spec, nb)
            assert graph.graph is None and graph.held == 0
            assert st_g is graph.state and raw.shape[0] < graph.capacity
            assert rec_g.keys() == rec_e.keys()
            for f in rec_e:
                assert torch.equal(rec_g[f], rec_e[f]), f
            for f, a, b in zip(st_e._fields, st_g, st_e):
                assert a.dtype == b.dtype and torch.equal(a, b), f
            assert int(rec_g["fault"][0]) == 0
    finally:
        feed.close()
    slow = st_e._replace(code_freq=st_e.code_freq * torch.tensor(
        [1.0, 0.7, 1.0], dtype=torch.float64))
    raw, lo = _window(src, spec, slow, nb, "cpu")
    rec_e, _ = ttrack.track_scan(raw, lo, slow, chips, spec, nb)
    rec_g, _ = graph(raw, lo, slow, chips, spec, nb)
    assert int(rec_g["fault"][0]) == int(rec_e["fault"][0]) == 2
    with pytest.raises(RuntimeError, match="channel 1"):
        tc.raise_on_fault(rec_g)
    raw, lo = _window(src, spec, st_e, nb, "cpu")
    assert int(graph(raw, lo, st_e, chips, spec, nb)[0]["fault"][0]) == 0
    cap = graph.capacity
    raw, lo = _window(src, spec, st_e, nb, "cpu", extra=cap)
    rec_g, st_g = graph(raw, lo, st_e, chips, spec, nb)
    rec_e, st_e = ttrack.track_scan(raw, lo, st_e, chips, spec, nb)
    assert graph.capacity == raw.shape[0] + feed.slack > cap
    for f in rec_e:
        assert torch.equal(rec_g[f], rec_e[f]), f
    for f, a, b in zip(st_e._fields, st_g, st_e):
        assert torch.equal(a, b), f


def test_graphed_scan_captures_once_a_call():
    """A `ScanGraph` driven over a call's chunks as `run_tracking` drives
    it, from a `ChunkFeed` (on the CPU it runs eagerly): one
    `tracking.capture` of the first chunk's blocks, a `tracking.replay`
    for each full chunk, the short last chunk eager through `track_scan`,
    a window past the buffer captured again; records and end state those
    of `track_scan` chunk by chunk."""
    cfg, src, prns, st, params = _graph_scene("int8_if_3taps")
    spec = params.chunk_spec(cfg)
    chips = chip_tables(prns, "cpu")
    per, n_blocks = G_CHUNK_MS // 10, G_MS // 10
    want, _ = _eager_chunks(src, spec, st, chips, n_blocks, per)
    calls = {"eager": 0}
    real = ttrack.track_scan

    def counted(*a):
        calls["eager"] += 1
        return real(*a)

    feed = ChunkFeed(src, "cpu", spec.window)
    scan = ttrack.ScanGraph(feed.slack)
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.time_ns()
        got, left, state = [], n_blocks, st
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ttrack, "track_scan", counted)
            try:
                while left:
                    nb = min(per, left)
                    raw, lo = feed.next(state.ptr, nb,
                                        min(per, left - nb))
                    rec, state = scan(raw, lo, state, chips, spec, nb)
                    got.append({f: v.clone() for f, v in rec.items()})
                    left -= nb
            finally:
                feed.close()
            first = scan.buf
            # a window larger than the buffer: captured again
            raw, lo = _window(src, spec, st, per, "cpu",
                              extra=scan.capacity)
            scan(raw, lo, st, chips, spec, per)
        found = spans.recorded(t0, time.time_ns())
    assert scan.buf is not first and calls == {"eager": 1}
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for f in w:
            assert torch.equal(g[f], w[f]), f
    caps = [s.n for s in found if s.name == "tracking.capture"]
    reps = [s.n for s in found if s.name == "tracking.replay"]
    assert caps == [per, per] and reps == [per] * 4


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(G_CASES))
def test_cuda_run_tracking_replays_track_scan(case):
    """`run_tracking` at pdi 10 on the card over 3 full chunks and a short
    one, its graph route against `track_scan` called chunk by chunk over
    the same windows: every record field and the end state equal bit for
    bit; one capture of a chunk's blocks, three replays, the short chunk
    eager; `correlator_bank_windows.launches` adds up to the eager
    count, the replays adding what the graph holds; a code NCO driven
    past the block window still raises through `raise_on_fault`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    cfg, src, prns, st, params = _graph_scene(case)
    st = _to(st, dev)
    spec = params.chunk_spec(cfg)
    per, n_blocks = G_CHUNK_MS // 10, G_MS // 10
    before = cb.correlator_bank_windows.launches
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.time_ns()
        rec, end = ttrack.run_tracking(src, cfg, prns, st, params, G_MS,
                                       chunk_ms=G_CHUNK_MS)
        found = spans.recorded(t0, time.time_ns())
    graphed = cb.correlator_bank_windows.launches - before
    before = cb.correlator_bank_windows.launches
    parts, end_e = _eager_chunks(src, spec, st, chip_tables(prns, dev),
                                 n_blocks, per)
    eager = cb.correlator_bank_windows.launches - before
    assert graphed == eager == n_blocks
    for f in ttrack._REC_FIELDS:
        want = torch.cat([p[f] for p in parts])
        got = torch.from_numpy(getattr(rec, f))
        assert got.dtype == want.dtype and torch.equal(got, want), f
    for f, a, b in zip(end_e._fields, end, end_e):
        assert a.device == b.device and torch.equal(a, b), f
    assert [s.n for s in found if s.name == "tracking.capture"] == [per]
    assert [s.n for s in found if s.name == "tracking.replay"] == [per] * 3
    slow = st._replace(code_freq=st.code_freq * torch.tensor(
        [1.0, 1.0, 0.7], dtype=torch.float64, device=dev))
    with pytest.raises(RuntimeError, match="channel 2"):
        ttrack.run_tracking(src, cfg, prns, slow, params, G_MS,
                            chunk_ms=G_CHUNK_MS)
