"""The port's vector tracking (gps_sdr_tpu_torch/receiver/vt.py) and its
correlator bank (ops/corr_bank.py) against the JAX package, on the CPU.

One capture for the whole file: the scenario constellation (5 SVs,
transmit-time geometry + atmosphere) for 2.6 s at 2.5 MHz, written by the
JAX `write_file_fast` into a temporary directory.  The JAX package acquires
it and tracks 1500 ms of CT-POS; the VT warm start is taken from those
records at row 1399, with the broadcast ephemerides the capture was made
from and each channel's transmit time from the generator's own light-time
solve (what the decoded subframes would give, without a 32 s capture).

(a) Bank, module level: `correlator_bank_reference` against
    `jax.vmap(correlate_block)` with `num` given (the "nco" branch of
    vt_scan), and against the Pallas kernel `correlator_bank_hbm` in
    interpret mode fed as vt_scan feeds it.
(b) VT step level: 120 ms of the JAX `run_vector_tracking` (replica "nco")
    and of the port's from the same VTState, carried over by convert.py.
(c) The cadences under chunking, faults, parameter presets.
(d) The CUDA kernel against the plain version (needs a card).

The port runs its plain versions here (`device="cpu"`).
"""

import dataclasses

import numpy as np
import pytest
import torch

from gps_sdr_tpu_torch import convert
from gps_sdr_tpu_torch.io.ifdata import IFSampleSource as TSource
from gps_sdr_tpu_torch.ops import corr_bank as cb
from gps_sdr_tpu_torch.receiver import vt as tvt
from gps_sdr_tpu_torch.tracking import chip_tables

torch.set_num_threads(2)

FS, F_IF = 2.5e6, 0.6e6
DURATION_MS, CT_MS, SLOT = 2600, 1500, 1399


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """Capture, JAX CT records, and the JAX VT warm-start state."""
    import scenario as sc
    from gps_sdr_tpu.acquisition import run_acquisition
    from gps_sdr_tpu.config import SignalConfig
    from gps_sdr_tpu.geo.coords import llh2xyz
    from gps_sdr_tpu.geo.ephemeris import Ephemeris
    from gps_sdr_tpu.io.ifdata import IFSampleSource
    from gps_sdr_tpu.io.synthetic import GeometrySignal, GeometrySV
    from gps_sdr_tpu.tracking import (TrackParams, init_track_state,
                                      run_tracking)

    root = tmp_path_factory.mktemp("torch_vt")
    cfg = sc.CFG.replace(signal=SignalConfig(f_if=F_IF, fs=FS))
    prns = list(sc.SCN_PRNS)
    usr = np.asarray(llh2xyz(np.asarray(sc.TRUTH_LLH)))
    ephs = sc.visible_constellation(len(prns))
    gs = GeometrySignal(
        cfg, [GeometrySV(prn=p, eph=e, amplitude=a)
              for p, e, a in zip(prns, ephs, sc.AMPLITUDES)],
        usr, sc.TOW0, clk_bias_s=sc.CLK_BIAS_S,
        clk_drift_sps=sc.CLK_DRIFT_SPS, atmosphere=True,
        iono_alpha=cfg.cmn.iono_alpha, iono_beta=cfg.cmn.iono_beta,
        doy=cfg.cmn.day_of_year)
    path = str(root / "capture.bin")
    gs.write_file_fast(path, DURATION_MS, noise_std=sc.NOISE_STD, seed=11)
    src = IFSampleSource(path, cfg.file)
    acq = run_acquisition(src, cfg, prns=prns)
    assert list(acq.sv) == prns
    ct_rec, _ = run_tracking(
        src, cfg, prns, init_track_state(cfg, acq.code_delay,
                                         acq.fine_freq_hz),
        TrackParams.pos_epl(cfg, replica="nco"), CT_MS)
    # transmit time at each channel's handoff sample: the generator's
    # SV-clock time there, snapped to the code epoch the records count from
    f0 = cfg.signal.code_freq_basis
    tt0 = np.empty(len(prns))
    for ch, p in enumerate(prns):
        tau = ct_rec.absolute_sample[SLOT, ch] / FS
        t_sv = sc.TOW0 + tau + gs.sv_clock_delta(p, np.array([tau]))[0]
        rem_s = ct_rec.rem_chip[SLOT, ch] / f0
        tt0[ch] = np.round((t_sv - rem_s) * 1e3) / 1e3 + rem_s
    eph_struct = Ephemeris(**{k: np.asarray([e[k] for e in ephs], np.float64)
                              for k in Ephemeris._fields})
    return dict(cfg=cfg, tcfg=convert.config_from_jax(cfg), prns=prns,
                usr=usr, path=path, src=src, ct_rec=ct_rec, tt0=tt0,
                ephs=ephs, eph_struct=eph_struct,
                est_pos=usr + np.array([20.0, -15.0, 10.0]),
                clk_bias_m=sc.CLK_BIAS_S * 299792458.0)


def _jax_state(scene, params):
    from gps_sdr_tpu.receiver.vt import init_vt_state
    n = len(scene["prns"])
    return init_vt_state(scene["cfg"], scene["ct_rec"], list(range(n)),
                         {ch: SLOT for ch in range(n)}, scene["tt0"],
                         scene["est_pos"], np.zeros(3), scene["clk_bias_m"],
                         0.0, params)


def _torch_eph(scene):
    from gps_sdr_tpu_torch.geo.ephemeris import Ephemeris
    return Ephemeris.stack(scene["ephs"], "cpu")


def _run_port(scene, state, params, n_ms, chunk_ms=1000):
    tcfg = scene["tcfg"]
    return tvt.run_vector_tracking(
        TSource(scene["path"], tcfg.file), tcfg, scene["prns"],
        _torch_eph(scene), state, params, n_ms, scene["usr"],
        chunk_ms=chunk_ms)


# ------------------------------------------------------------ (a) the bank


def _bank_inputs(scene, taps):
    """NCO state of the warm start, block lengths nominal −2..+2."""
    from gps_sdr_tpu.receiver.vt import VTParams
    st = _jax_state(scene, VTParams())
    cfg = scene["cfg"]
    S = cfg.signal.samples_per_ms
    blk = -(-(S + 256) // 128) * 128
    ptr = np.asarray(st.ptr)
    start = int(ptr.min())
    length = -(-(int(ptr.max()) - start + S + blk + 64 + 2048) // 128) * 128
    vals = scene["src"].read_iq_values(start, length)
    rem = np.asarray(st.rem_chip)
    code_freq = np.asarray(st.code_freq)
    num = np.ceil((1023 - rem) / (code_freq / FS)).astype(np.int64) \
        + np.array([-2, -1, 0, 1, 2])
    return dict(vals=vals, start=start, blk=blk, ptr=ptr, rem=rem,
                code_freq=code_freq, carr_freq=np.asarray(st.carr_freq),
                phase_fp=np.asarray(st.phase_fp), num=num,
                taps=np.asarray(taps, np.float64))


def _port_bank(scene, b, remove_dc):
    t64 = lambda a: torch.as_tensor(np.array(a), dtype=torch.int64)
    carr_fp = np.round(b["carr_freq"] / FS * 2.0 ** 32).astype(np.int64)
    corr, fault = cb.correlator_bank(
        torch.from_numpy(b["vals"].copy()), t64(b["ptr"] - b["start"]),
        torch.from_numpy(b["rem"].copy()),
        torch.from_numpy(b["code_freq"].copy()), t64(b["phase_fp"]),
        t64(carr_fp), t64(b["num"]), chip_tables(scene["prns"], "cpu"),
        cb.tap_offsets_fp(b["taps"], "cpu"), FS, b["blk"], remove_dc)
    assert int(fault[0]) == 0
    return corr.numpy()


@pytest.mark.parametrize("remove_dc", [False, True])
@pytest.mark.parametrize("ntaps", [3, 29])
def test_bank_plain_matches_jax_nco(scene, ntaps, remove_dc):
    """Same chunk, NCO state, `num` and taps through vmap(correlate_block)
    and the port's plain bank: within 1e-5 of the mean prompt magnitude
    (float32 summation order; the JAX dot sums in float32, the port in
    float64)."""
    import jax
    import jax.numpy as jnp
    from gps_sdr_tpu.ops.cacode import ca_code_table
    from gps_sdr_tpu.receiver.vt import VTParams
    from gps_sdr_tpu.tracking import _stage_raw, correlate_block

    params = VTParams.multicorr() if ntaps == 29 else VTParams()
    b = _bank_inputs(scene, params.taps)
    raw = _stage_raw(jnp.asarray(b["vals"]), "pairs")
    chips = jnp.asarray(np.stack([ca_code_table()[p - 1]
                                  for p in scene["prns"]]), jnp.float32)
    taps = jnp.asarray(params.taps, jnp.float64)

    def chan(ptr, rem, cfq, cfr, pfp, ch, n):
        return correlate_block(raw, b["start"], ptr, rem, cfq, cfr, pfp, ch,
                               taps, FS, 1023, b["blk"], "ceil", remove_dc,
                               num=n)[0]

    ref = np.asarray(jax.vmap(chan)(
        jnp.asarray(b["ptr"]), jnp.asarray(b["rem"]),
        jnp.asarray(b["code_freq"]), jnp.asarray(b["carr_freq"]),
        jnp.asarray(b["phase_fp"]), chips, jnp.asarray(b["num"])))
    got = _port_bank(scene, b, remove_dc)
    assert got.shape == ref.shape == (5, ntaps, 2)
    prompt = np.mean(np.hypot(ref[:, params.i_prompt, 0],
                              ref[:, params.i_prompt, 1]))
    assert np.max(np.abs(got - ref)) < 1e-5 * prompt, \
        np.max(np.abs(got - ref)) / prompt


@pytest.mark.parametrize("ntaps", [3, 29])
def test_bank_plain_against_pallas_interpret(scene, ntaps):
    """Against the TPU kernel `correlator_bank_hbm` (interpret mode), fed
    as vt_scan feeds it.  That kernel is a different replica model: a code
    table sampled at the nominal rate, interpolated linearly between
    neighbouring samples.  At this capture's 2.44 samples per chip the
    interpolation blends every sample pair that straddles a chip edge, so
    its correlators are 1-29 % smaller than the exact replica's, by an
    amount that depends on each channel's sub-sample code phase (measured
    here: largest difference 0.25 of the mean prompt magnitude at 3 and at
    29 taps).  The 2e-3 bound of tests/test_pallas_fused.py holds between
    two implementations of the table model, not between it and the exact
    one, so it cannot be asked here.  What both models must share is held
    instead: the carrier phase of the prompt (same Q32 mix) within 0.03 rad,
    the prompt magnitude ratio exact/table inside [0.98, 1.35], and the
    normalised early-minus-late discriminator within 0.08."""
    import jax.numpy as jnp
    from gps_sdr_tpu.ops.pallas_track import (build_shift_tables_fused,
                                              correlator_bank_hbm)
    from gps_sdr_tpu.receiver.vt import VTParams
    from gps_sdr_tpu.tracking import _stage_raw

    params = VTParams.multicorr() if ntaps == 29 else VTParams()
    b = _bank_inputs(scene, params.taps)
    cfg = scene["cfg"]
    tables, margin = build_shift_tables_fused(cfg, scene["prns"], b["blk"])
    step_nom = cfg.signal.code_freq_basis / FS
    pos = margin + (b["rem"][:, None] + b["taps"][None, :]) / step_nom
    carr_fp = np.round(b["carr_freq"] / FS * 2.0 ** 32).astype(np.int64)
    ref = np.asarray(correlator_bank_hbm(
        _stage_raw(jnp.asarray(b["vals"]), "rows"),
        jnp.asarray((b["ptr"] - b["start"]).astype(np.int32)),
        jnp.asarray(np.floor(pos).astype(np.int32)),
        jnp.asarray((pos - np.floor(pos)).astype(np.float32)),
        jnp.asarray(b["phase_fp"].astype(np.int32)),
        jnp.asarray(carr_fp.astype(np.int32)),
        jnp.asarray(b["num"].astype(np.int32)), jnp.asarray(tables),
        ntaps=ntaps, blk=b["blk"], remove_dc=False, interpret=True))
    got = _port_bank(scene, b, False)
    prompt = np.mean(np.hypot(ref[:, params.i_prompt, 0],
                              ref[:, params.i_prompt, 1]))
    gc, rc = got[..., 0] + 1j * got[..., 1], ref[..., 0] + 1j * ref[..., 1]
    ie, ip, il = params.i_early, params.i_prompt, params.i_late
    ratio = np.abs(gc[:, ip]) / np.abs(rc[:, ip])
    assert np.all((ratio > 0.98) & (ratio < 1.35)), ratio
    dphase = np.angle(gc[:, ip] / rc[:, ip])
    assert np.max(np.abs(dphase)) < 0.03, dphase

    def disc(c):
        e, l = np.abs(c[:, ie]), np.abs(c[:, il])
        return (e - l) / (e + l)

    assert np.max(np.abs(disc(gc) - disc(rc))) < 0.08, (disc(gc), disc(rc))
    assert np.max(np.abs(got - ref)) < 0.3 * prompt


def test_bank_fault_and_validation(scene):
    """A window past the chunk, a block length outside [1, blk] and a NaN
    NCO word raise the flag (and zero that channel); nothing is clamped.
    The CPU path launches no kernel."""
    b = _bank_inputs(scene, (0.5, 0.0, -0.5))
    before = cb.correlator_bank.launches
    good = _port_bank(scene, b, False)
    assert cb.correlator_bank.launches == before
    L = b["vals"].shape[0]
    for field, ch, value in (("ptr", 1, b["start"] + L - 100),
                             ("ptr", 0, b["start"] - 1),
                             ("num", 2, 0), ("num", 3, b["blk"] + 1),
                             ("code_freq", 4, np.nan), ("rem", 2, np.inf)):
        bad = {k: np.array(v, copy=True) if isinstance(v, np.ndarray) else v
               for k, v in b.items()}
        bad[field][ch] = value
        t64 = lambda a: torch.as_tensor(np.array(a), dtype=torch.int64)
        carr_fp = np.round(bad["carr_freq"] / FS * 2.0 ** 32)
        corr, fault = cb.correlator_bank(
            torch.from_numpy(bad["vals"].copy()),
            t64(bad["ptr"] - bad["start"]), torch.from_numpy(bad["rem"]),
            torch.from_numpy(bad["code_freq"]), t64(bad["phase_fp"]),
            t64(carr_fp), t64(bad["num"]), chip_tables(scene["prns"], "cpu"),
            cb.tap_offsets_fp(bad["taps"], "cpu"), FS, bad["blk"])
        assert int(fault[0]) == ch + 1
        with pytest.raises(RuntimeError, match=f"channel {ch}"):
            cb.raise_on_fault(fault)
        others = [c for c in range(5) if c != ch]
        np.testing.assert_array_equal(corr.numpy()[others], good[others])
        assert not corr[ch].any()
    with pytest.raises(ValueError, match="int64"):
        cb.correlator_bank(
            torch.from_numpy(b["vals"].copy()),
            torch.zeros(5, dtype=torch.int32), torch.zeros(5).double(),
            torch.zeros(5).double(), torch.zeros(5, dtype=torch.int64),
            torch.zeros(5, dtype=torch.int64),
            torch.ones(5, dtype=torch.int64),
            chip_tables(scene["prns"], "cpu"),
            cb.tap_offsets_fp((0.0,), "cpu"), FS, b["blk"])


# ------------------------------------------------------- (b) the VT step


WARM_MS, COLD_MS, STEP_MS = 300, 40, 120


@pytest.fixture(scope="module", params=["default", "r40"])
def vt_pair(request, scene):
    """Both packages from one state, twice: COLD_MS ms from the warm start
    itself, and STEP_MS ms from the state the JAX package reaches after
    WARM_MS ms.  "r40" sets r_update_ms=40; in both cases the Kepler group
    head (50), the atmosphere refresh (100), the C/N0 window (20) and
    adaptive R (40, or 200 at step 400) all fire inside the STEP_MS ms."""
    from gps_sdr_tpu.receiver.vt import VTParams, run_vector_tracking
    kw = dict(r_update_ms=40) if request.param == "r40" else {}
    jparams, tparams = VTParams(replica="nco", **kw), tvt.VTParams(**kw)

    def jrun(state, n_ms):
        return run_vector_tracking(
            scene["src"], scene["cfg"], scene["prns"], scene["eph_struct"],
            state, jparams, n_ms, scene["usr"])

    def trun(jstate, n_ms):
        return _run_port(scene, convert.vt_state_from_jax(jstate, "cpu"),
                         tparams, n_ms)

    jstate0 = _jax_state(scene, jparams)
    jtrk0, jsol0, jmid = jrun(jstate0, WARM_MS)
    ttrk0, tsol0, _ = trun(jstate0, COLD_MS)
    jtrk, jsol, jend = jrun(jmid, STEP_MS)
    ttrk, tsol, tend = trun(jmid, STEP_MS)
    return dict(jtrk=jtrk, jsol=jsol, jend=jend, ttrk=ttrk, tsol=tsol,
                tend=tend, jtrk0=jtrk0, jsol0=jsol0, ttrk0=ttrk0,
                tsol0=tsol0, r40=request.param == "r40")


def test_vt_step_matches_jax(vt_pair):
    """From the converged state: integer chain exact; correlators to 1e-4
    of the mean prompt; NCOs, total state and innovations at the float32
    round-off of the EKF (measured: correlators 4e-6 of the prompt, code
    frequency 5e-5 Hz, position 2e-5 m, innovations 3e-4 m)."""
    j = convert.vt_records_to_numpy(convert.vt_records_from_jax(
        vt_pair["jtrk"]))
    t = convert.vt_records_to_numpy(vt_pair["ttrk"])
    assert t.keys() == j.keys()
    for k in t:
        assert t[k].shape == j[k].shape and t[k].dtype == j[k].dtype, k
    np.testing.assert_array_equal(t["num_sample"], j["num_sample"])
    np.testing.assert_array_equal(t["absolute_sample"], j["absolute_sample"])
    prompt = np.mean(np.hypot(j["corr"][:, :, 1, 0], j["corr"][:, :, 1, 1]))
    np.testing.assert_allclose(t["corr"], j["corr"], rtol=0,
                               atol=1e-4 * prompt)
    np.testing.assert_allclose(t["code_freq"], j["code_freq"], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(t["carr_freq"], j["carr_freq"], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(t["rem_chip"], j["rem_chip"], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(t["transmit_time"], j["transmit_time"],
                               rtol=0, atol=1e-12)
    js = convert.vt_solutions_to_numpy(convert.vt_solutions_from_jax(
        vt_pair["jsol"]))
    ts = convert.vt_solutions_to_numpy(vt_pair["tsol"])
    assert ts.keys() == js.keys()
    for k in ts:
        assert ts[k].shape == js[k].shape and ts[k].dtype == js[k].dtype, k
    np.testing.assert_allclose(ts["usr_pos"], js["usr_pos"], rtol=0,
                               atol=0.05)
    np.testing.assert_allclose(ts["usr_vel"], js["usr_vel"], rtol=0,
                               atol=0.05)
    np.testing.assert_allclose(ts["clk_bias_m"], js["clk_bias_m"], rtol=0,
                               atol=0.05)
    np.testing.assert_allclose(ts["innovation"], js["innovation"], rtol=0,
                               atol=0.05)
    np.testing.assert_allclose(ts["usr_pos_llh"][:, :2],
                               js["usr_pos_llh"][:, :2], rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts["usr_pos_enu"], js["usr_pos_enu"], rtol=0,
                               atol=0.05)
    np.testing.assert_allclose(ts["sat_el_deg"], js["sat_el_deg"], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(ts["cn0_dbhz"], js["cn0_dbhz"], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(ts["r_diag"], js["r_diag"], rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_array_equal(ts["valid"], js["valid"])
    if vt_pair["r40"]:     # adaptive R fired: R left its start values
        assert len(np.unique(ts["r_diag"][:, 0])) >= 3


def test_vt_cold_start_matches_jax(vt_pair):
    """From the warm start itself, where step 0 keeps the code NCO.  There
    P = 1e4-1e5 m² against R = 0.1-0.3 makes the float32 gain solve
    ill-conditioned: the two packages' LU solves, fed innovations equal to
    1e-4 m, already differ by 0.18 m in the first position update, and the
    vector loop turns a position step into a code-frequency step
    (ΔPr / 1 ms), so for the first tens of ms the two runs are two
    realisations of one converging filter (measured over 40 ms: positions
    up to 5.7 m apart and 1.7 m at the end, 4 block lengths one sample
    apart).  Row 0 is held tightly up to the solve; the rest loosely.  The
    step itself is held tightly from the converged state
    (test_vt_step_matches_jax: positions 2e-5 m apart)."""
    j = convert.vt_records_to_numpy(convert.vt_records_from_jax(
        vt_pair["jtrk0"]))
    t = convert.vt_records_to_numpy(vt_pair["ttrk0"])
    js = convert.vt_solutions_to_numpy(convert.vt_solutions_from_jax(
        vt_pair["jsol0"]))
    ts = convert.vt_solutions_to_numpy(vt_pair["tsol0"])
    n = COLD_MS
    assert len(t["num_sample"]) == n
    prompt = np.mean(np.hypot(j["corr"][:, :, 1, 0], j["corr"][:, :, 1, 1]))
    np.testing.assert_array_equal(t["num_sample"][0], j["num_sample"][0])
    np.testing.assert_array_equal(t["code_freq"][0], j["code_freq"][0])
    np.testing.assert_allclose(t["corr"][0], j["corr"][0], rtol=0,
                               atol=1e-4 * prompt)
    np.testing.assert_allclose(ts["innovation"][0], js["innovation"][0],
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(ts["usr_pos"][0], js["usr_pos"][0], rtol=0,
                               atol=0.5)
    assert np.max(np.abs(t["absolute_sample"]
                         - j["absolute_sample"][:n])) <= 1
    np.testing.assert_allclose(ts["usr_pos"], js["usr_pos"][:n], rtol=0,
                               atol=12.0)
    np.testing.assert_allclose(ts["usr_vel"], js["usr_vel"][:n], rtol=0,
                               atol=0.5)
    np.testing.assert_array_equal(ts["valid"], js["valid"][:n])


def test_vt_end_state_matches_jax(vt_pair):
    j = convert.vt_state_to_numpy(vt_pair["jend"])
    t = convert.vt_state_to_numpy(vt_pair["tend"])
    assert t.keys() == j.keys()
    for k in t:
        assert t[k].shape == j[k].shape and t[k].dtype == j[k].dtype, k
    for k in ("ptr", "step_count", "valid"):
        np.testing.assert_array_equal(t[k], j[k])
    assert int(t["step_count"]) == WARM_MS + STEP_MS
    np.testing.assert_allclose(t["total_state"], j["total_state"], rtol=0,
                               atol=0.05)
    np.testing.assert_allclose(t["zk"], j["zk"], rtol=1e-3)
    np.testing.assert_allclose(t["iono_m"], j["iono_m"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(t["tropo_m"], j["tropo_m"], rtol=0, atol=1e-6)


# ------------------------------------- (c) cadences, faults, presets


def _port_state(scene, params):
    n = len(scene["prns"])
    return tvt.init_vt_state(
        scene["tcfg"], convert.records_from_jax(scene["ct_rec"]),
        list(range(n)), {ch: SLOT for ch in range(n)}, scene["tt0"],
        scene["est_pos"], np.zeros(3), scene["clk_bias_m"], 0.0, params,
        device="cpu")


def test_init_vt_state_matches_jax(scene):
    from gps_sdr_tpu.receiver.vt import VTParams
    j = convert.vt_state_to_numpy(_jax_state(scene, VTParams()))
    t = convert.vt_state_to_numpy(_port_state(scene, tvt.VTParams()))
    assert t.keys() == j.keys()
    for k in t:
        assert t[k].dtype == j[k].dtype, k
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def test_vt_cadence_under_chunking(scene):
    """chunk_ms 70 against 1000, with kepler_update_ms=30 dividing neither
    the chunk nor corr_update_ms: the integer chain is identical and the
    atmosphere keeps its cadence (el changes at least every corr_update_ms
    + kepler_update_ms).  The records cannot agree to round-off: each
    chunking puts its group heads, and with them the instants at which the
    geometry is re-linearised and the atmosphere refreshed, elsewhere.
    Measured: positions 0.017 m apart at most, which the vector loop turns
    into 0.063 Hz of code frequency (ΔPr over 1 ms)."""
    params = tvt.VTParams(kepler_update_ms=30)
    # from a converged filter: at the warm start itself the gain solve
    # amplifies round-off (see test_vt_cold_start_matches_jax)
    _, _, mid = _run_port(scene, _port_state(scene, params), params, WARM_MS)
    out = {}
    for chunk in (70, 1000):
        out[chunk] = _run_port(scene, mid, params, 450, chunk_ms=chunk)
    (t70, s70, e70), (t1k, s1k, e1k) = out[70], out[1000]
    np.testing.assert_array_equal(t70.num_sample, t1k.num_sample)
    np.testing.assert_array_equal(t70.absolute_sample, t1k.absolute_sample)
    np.testing.assert_array_equal(s70.valid, s1k.valid)
    np.testing.assert_allclose(s70.usr_pos, s1k.usr_pos, rtol=0, atol=0.05)
    np.testing.assert_allclose(t70.code_freq, t1k.code_freq, rtol=0,
                               atol=0.2)
    prompt = np.mean(np.hypot(t1k.corr[:, :, 1, 0], t1k.corr[:, :, 1, 1]))
    np.testing.assert_allclose(t70.corr, t1k.corr, rtol=0,
                               atol=2e-2 * prompt)   # measured 7e-3
    assert int(e70.step_count) == int(e1k.step_count) == WARM_MS + 450
    for sol in (s70, s1k):
        el = sol.sat_el_deg[:, 0]
        assert len(np.unique(el)) >= 3, np.unique(el)
        change = np.flatnonzero(np.diff(el) != 0)
        assert change.size >= 2
        assert np.max(np.diff(change)) <= 130 + 1, np.max(np.diff(change))


def test_vt_faults_raise(scene):
    """A NaN code frequency in the state raises at the end of the chunk
    (the JAX package lets it through its clip into the int cast,
    vt.py:325); so does a window that leaves the chunk."""
    params = tvt.VTParams()
    st = _port_state(scene, params)
    bad = st.code_freq.clone()
    bad[2] = float("nan")
    with pytest.raises(RuntimeError, match="not finite"):
        _run_port(scene, st._replace(code_freq=bad), params, 30)
    tcfg = scene["tcfg"]
    S = tcfg.signal.samples_per_ms
    blk = -(-(S + 256) // 128) * 128
    start = int(st.ptr.min())
    short = TSource(scene["path"], tcfg.file).read_iq_values(start, 5 * S)
    _, rec = tvt.vt_scan(
        torch.from_numpy(short.copy()), start, st,
        chip_tables(scene["prns"], "cpu"), _torch_eph(scene),
        tcfg.cmn.iono_alpha, tcfg.cmn.iono_beta, params, 12, FS, blk, F_IF,
        tcfg.signal.fc, tcfg.signal.code_freq_basis, tcfg.cmn.day_of_year)
    with pytest.raises(RuntimeError, match="left the chunk"):
        cb.raise_on_fault(rec["fault"])


@pytest.mark.parametrize("preset", ["default", "legacy", "multicorr"])
def test_vt_params_carry_the_jax_values(preset):
    from gps_sdr_tpu.receiver.vt import VTParams
    make = (lambda c: c()) if preset == "default" else \
        (lambda c: getattr(c, preset)())
    j, t = make(VTParams), make(tvt.VTParams)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    if preset == "legacy":
        assert (t.r_pr0, t.r_prr0) == (1e-1, 1e-2)
        assert (t.q_pos, t.q_vel, t.q_clk, t.q_clkd) == (1.0, 0.1, 100.0,
                                                         10.0)
        assert t.r_update_ms > 1_000_000 and t.taps == (0.5, 0.0, -0.5)
    if preset == "multicorr":
        assert len(t.taps) == 29
        assert (t.i_early, t.i_prompt, t.i_late) == (4, 14, 24)
        assert (t.taps[4], t.taps[14], t.taps[24]) == (0.5, 0.0, -0.5)


# ------------------------- (c2) the static-state scan and its CUDA graphs


# the scenario's position, epoch and broadcast set (tests/scenario.py), kept
# here so that the cases below need nothing but the port
_STATIC_LLH = (0.3897057693107332, 1.9926489077944098, 4.0)
_STATIC_TOW = 388799.0
_STATIC_EPH = dict(
    sqrta=5153.6413, ecc=0.00122963, m0=2.14587329, omega0=1.25789432,
    i0=0.96679784, w=-0.89245321, deltan=4.3267e-09, omegadot=-7.2345e-09,
    idot=-4.2e-10, cuc=1.5272e-07, cus=2.3842e-07, crc=287.46875,
    crs=-2.59375, cic=-7.45058e-09, cis=1.3039e-08, toe=388800.0,
    toc=388800.0, af0=1.8364e-04, af1=2.0464e-12, af2=0.0,
    tgd=-7.4506e-09, iodc=23, iode=23, health=0, ura=0)


def _static_scene(device, n_ms, seed=4):
    """A capture and a VT start that need only the port: five SVs of the
    broadcast set spread in longitude, seen from the scenario's position;
    constant-dynamics signals at 2.5 MHz whose Doppler is the line-of-sight
    rate the EKF will predict, so the filter starts near its fixed point.
    Returns what `vt_scan` takes."""
    from gps_sdr_tpu_torch.config import ReceiverConfig, SignalConfig
    from gps_sdr_tpu_torch.geo.coords import llh2xyz
    from gps_sdr_tpu_torch.geo.ephemeris import Ephemeris, sv_pos_vel_clock
    from gps_sdr_tpu_torch.io.synthetic import (SyntheticSV,
                                                generate_if_samples,
                                                quantize_iq)
    cfg = ReceiverConfig(signal=SignalConfig(f_if=F_IF, fs=FS))
    sig = cfg.signal
    S = sig.samples_per_ms
    rng = np.random.default_rng(seed)
    prns = [3, 7, 16, 22, 27]
    n = len(prns)
    usr = llh2xyz(np.asarray(_STATIC_LLH)).numpy()
    ephs = [dict(_STATIC_EPH, omega0=_STATIC_EPH["omega0"] + 0.5 * k,
                 m0=_STATIC_EPH["m0"] + 0.3 * k) for k in range(n)]
    eph_cpu = Ephemeris.stack(ephs, "cpu")
    tt0 = np.full(n, _STATIC_TOW) + rng.uniform(0.0, 1e-3, n)
    sv = sv_pos_vel_clock(eph_cpu, tt0)
    los = sv["pos"].numpy() - usr
    los /= np.linalg.norm(los, axis=1, keepdims=True)
    dopp = -(los * sv["vel"].numpy()).sum(axis=1) * sig.fc / 299792458.0
    delay = rng.uniform(0.0, S, n)
    values = quantize_iq(generate_if_samples(
        cfg, [SyntheticSV(prn=p, amplitude=3.0, doppler_hz=float(d),
                          code_delay_samples=float(c))
              for p, d, c in zip(prns, dopp, delay)],
        n_ms + 8, noise_std=4.0, seed=seed, device=device))
    f_code = sig.code_freq_basis * (1.0 + dopp / sig.fc)
    ptr = np.ceil(delay).astype(np.int64)

    def t(a, dtype=torch.float64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    params = tvt.VTParams()
    state = tvt.VTState(
        ptr=t(ptr, torch.int64), rem_chip=t((ptr - delay) * f_code / FS),
        code_freq=t(f_code), carr_freq=t(F_IF + dopp),
        carr_freq_basis=t(F_IF + dopp),
        phase_fp=t(rng.integers(-2 ** 31, 2 ** 31, n), torch.int32),
        pll_nco=t(np.zeros(n)), pll_last=t(np.zeros(n)),
        transmit_time=t(tt0), predicted_pr_last=t(np.zeros(n)),
        iono_m=t(np.zeros(n)), tropo_m=t(np.zeros(n)),
        el_rad=t(np.full(n, np.pi / 4)), az_rad=t(np.zeros(n)),
        total_state=t(np.concatenate([usr + [20.0, -15.0, 10.0],
                                      np.zeros(3), [1.5e5, 0.0]])),
        state_cov=t(1e2 * np.diag([0.1] * 6 + [1.0, 1.0])),
        r_diag=t(np.concatenate([np.full(n, params.r_pr0),
                                 np.full(n, params.r_prr0)])),
        innov_sq_sum=t(np.zeros(2 * n)),
        step_count=torch.tensor(0, dtype=torch.int32, device=device),
        zk=t(np.zeros((n, params.cn0_window))),
        snr_hist=t(np.full((n, 5), 99.0)), cn0=t(np.full(n, 99.0)),
        valid=torch.ones(n, dtype=torch.bool, device=device))
    blk = -(-(S + 256) // 128) * 128
    raw = torch.from_numpy(values.reshape(-1, 2).copy()).to(device)
    args = dict(chips=chip_tables(prns, device),
                eph=Ephemeris.stack(ephs, device),
                iono_alpha=cfg.cmn.iono_alpha, iono_beta=cfg.cmn.iono_beta,
                params=params, fs=FS, blk=blk, f_if=F_IF, fc=sig.fc,
                code_freq_basis=sig.code_freq_basis,
                doy=cfg.cmn.day_of_year)
    return raw, state, args


def _list_and_stack_scan(raw, chunk_start, state, n_steps, chips, eph,
                         iono_alpha, iono_beta, params, fs, blk, f_if, fc,
                         code_freq_basis, doy):
    """`vt_scan` as a scan over rebound values: the carry and the group
    cache are rebound to each step's new tensors and the records are lists
    stacked at the end; nothing is written in place."""
    run = tvt._VTChunk(raw, chunk_start, state, chips, eph, iono_alpha,
                       iono_beta, params, fs, blk, f_if, fc, code_freq_basis,
                       doy)
    rows, count, done = [], run.count0, 0
    group = max(1, int(params.kepler_update_ms))
    while done < n_steps:
        n_group = min(group, n_steps - done)
        new = run.refresh_values(run.atmosphere_due(count, n_group))
        run.g = {k: new[k] for k in tvt._GROUP_FIELDS}
        run.st = {**run.st, **{k: new[k] for k in tvt._ATMOSPHERE_FIELDS}}
        for _ in range(n_group):
            new, rec = run.step_values(
                count == 0, (count + 1) % params.cn0_window == 0,
                (count + 1) % params.r_update_ms == 0)
            rows.append(rec)
            run.st = {**run.st, **new}
            run.row = run.row + 1
            count += 1
        done += n_group
    recs = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
    recs["fault"] = run.fault
    return run.end_state(count), recs


def _assert_same_scan(a, b):
    (state_a, recs_a), (state_b, recs_b) = a, b
    assert recs_a.keys() == recs_b.keys()
    for k in recs_a:
        assert recs_a[k].dtype == recs_b[k].dtype, k
        assert torch.equal(recs_a[k], recs_b[k]), k
    for k, v in state_a._asdict().items():
        w = getattr(state_b, k)
        assert v.dtype == w.dtype and torch.equal(v, w), k


@pytest.mark.parametrize("r_update_ms", [200, 60])
def test_vt_static_state_equals_list_and_stack(r_update_ms):
    """The scan that updates fixed tensors in place and writes preallocated
    records at a device row index gives, bit for bit, the records and the
    end state of the scan that rebinds its carry and stacks lists: 230 ms
    from step count 0 in two calls (130 + 100, so the second starts inside
    a Kepler group's cadence and off the C/N0 window's), across eleven
    C/N0 windows, the adaptive-R update (step 199, or every 60), five
    refreshes of which three renew the atmosphere.  The caller's state is
    not written."""
    raw, state, args = _static_scene("cpu", 240)
    args["params"] = dataclasses.replace(args["params"],
                                         r_update_ms=r_update_ms)
    keep = {k: v.clone() for k, v in state._asdict().items()}
    got, want = [], []
    for scan, out in ((tvt.vt_scan, got), (_list_and_stack_scan, want)):
        st = state
        for n_steps in (130, 100):
            if scan is tvt.vt_scan:
                st, rec = scan(raw, 0, st, n_steps=n_steps, **args)
            else:
                st, rec = scan(raw, 0, st, n_steps, **args)
            cb.raise_on_fault(rec["fault"])
            out.append((st, rec))
    for a, b in zip(got, want):
        _assert_same_scan(a, b)
    for k, v in state._asdict().items():
        assert torch.equal(v, keep[k]), k
    end, rec = got[-1]
    assert int(end.step_count) == 230 and rec["corr"].shape == (100, 5, 3, 2)
    assert end.phase_fp.dtype == torch.int32
    assert end.state_cov.dtype == torch.float32
    first = got[0][1]
    # the cadences did fire: the gate's C/N0 moved, R left its start values,
    # the atmosphere was renewed; the loops hold the signals
    assert len(torch.unique(first["cn0"][:, 0])) >= 5
    r_all = torch.cat([first["r_diag"], rec["r_diag"]])
    assert len(torch.unique(r_all[:, 0])) >= (2 if r_update_ms == 200 else 3)
    assert len(torch.unique(first["el"][:, 0])) >= 2
    assert bool(rec["valid"].all())
    prompt = torch.hypot(rec["corr"][:, :, 1, 0], rec["corr"][:, :, 1, 1])
    early = torch.hypot(rec["corr"][:, :, 0, 0], rec["corr"][:, :, 0, 1])
    assert float(prompt.mean()) > 1.5 * float(early.mean())


def test_vt_scan_refuses_graphs_on_the_cpu():
    raw, state, args = _static_scene("cpu", 20)
    with pytest.raises(ValueError, match="CUDA"):
        tvt.vt_scan(raw, 0, state, n_steps=5, graph=True, **args)
    _, rec = tvt.vt_scan(raw, 0, state, n_steps=0, **args)
    assert list(rec) == ["fault"]


# ------------------------------------------------------- (d) on the card


@pytest.mark.gpu
def test_cuda_bank_matches_plain():
    """The CUDA bank against the plain version on the CPU, 3 and 29 taps,
    with and without DC removal, split over 1 and several CTAs per channel:
    within 1e-5 of the mean prompt magnitude (the CPU's sin/cos differ from
    the card's in the last float32 bits).  Run on the card with
        python -m pytest --noconftest -p no:cacheprovider -m gpu \\
            tests/test_torch_vt.py
    """
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    n, blk, L = 5, 2816, 9000
    vals = torch.from_numpy(rng.integers(-60, 60, (L, 2)).astype(np.int8))
    prns = [3, 7, 16, 22, 27]
    i64, f64_ = torch.int64, torch.float64
    args = dict(
        ptr_off=torch.tensor([0, 17, 1500, 3001, L - 2503], dtype=i64),
        rem_chip=torch.tensor(rng.uniform(-0.5, 1.5, n), dtype=f64_),
        code_freq=torch.tensor(1.023e6 + rng.uniform(-3, 3, n), dtype=f64_),
        phase_fp=torch.tensor(rng.integers(-2 ** 31, 2 ** 31, n), dtype=i64),
        carr_fp=torch.tensor(np.round((F_IF + rng.uniform(-5e3, 5e3, n))
                                      / FS * 2.0 ** 32), dtype=i64),
        num=torch.tensor([2499, 2500, 2501, 2502, 2503], dtype=i64))
    for taps in (tvt.VTParams().taps, tvt.VTParams.multicorr().taps):
        for remove_dc in (False, True):
            ref, _ = cb.correlator_bank(
                vals, *args.values(), chip_tables(prns, "cpu"),
                cb.tap_offsets_fp(taps, "cpu"), FS, blk, remove_dc)
            for n_split in (1, 7, None):
                before = cb.correlator_bank.launches
                out, fault = cb.correlator_bank(
                    vals.to(dev), *[a.to(dev) for a in args.values()],
                    chip_tables(prns, dev), cb.tap_offsets_fp(taps, dev),
                    FS, blk, remove_dc, n_split=n_split)
                assert cb.correlator_bank.launches == before + 1
                cb.raise_on_fault(fault)
                scale = float(ref.abs().mean())
                assert float((out.cpu() - ref).abs().max()) < 1e-5 * scale


@pytest.mark.gpu
def test_cuda_bank_tap_counts_without_an_instance():
    """1, 2 and 4 taps, which run the kernel instance that reads its tap
    count at run time, over a block long enough for the widest CTA (10 ms
    at 2.5 MHz), on one CTA per channel and split, through both entries:
    the launch is accepted and gives the plain version's values.  Run on
    the card as the test above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    n, blk, L = 3, 25088, 60000
    vals = torch.from_numpy(rng.integers(-60, 60, (L, 2)).astype(np.int8))
    prns = [3, 16, 27]
    i64, f64_ = torch.int64, torch.float64
    args = dict(
        ptr_off=torch.tensor([0, 1701, L - blk], dtype=i64),
        rem_chip=torch.tensor(rng.uniform(-0.5, 1.5, n), dtype=f64_),
        code_freq=torch.tensor(1.023e6 + rng.uniform(-3, 3, n), dtype=f64_),
        phase_fp=torch.tensor(rng.integers(-2 ** 31, 2 ** 31, n), dtype=i64),
        carr_fp=torch.tensor(np.round((F_IF + rng.uniform(-5e3, 5e3, n))
                                      / FS * 2.0 ** 32), dtype=i64),
        num=torch.tensor([24999, 25001, 25003], dtype=i64))
    on_card = [a.to(dev) for a in args.values()]
    for ntaps in (1, 2, 4):
        taps = np.linspace(-0.5, 0.5, ntaps)
        ref, _ = cb.correlator_bank(
            vals, *args.values(), chip_tables(prns, "cpu"),
            cb.tap_offsets_fp(taps, "cpu"), FS, blk)
        scale = float(ref.abs().mean())
        chips, tap_fp = chip_tables(prns, dev), cb.tap_offsets_fp(taps, dev)
        win = cb.cut_windows(vals.to(dev), on_card[0], blk)
        for n_split in (1, 4, None):
            out, fault = cb.correlator_bank(
                vals.to(dev), *on_card, chips, tap_fp, FS, blk,
                n_split=n_split)
            same, fault_w = cb.correlator_bank_windows(
                win, *on_card[1:], chips, tap_fp, FS, n_split=n_split)
            cb.raise_on_fault(fault)
            cb.raise_on_fault(fault_w)
            assert torch.equal(out, same)
            assert float((out.cpu() - ref).abs().max()) < 1e-5 * scale


@pytest.mark.gpu
def test_cuda_vt_graph_equals_eager():
    """On the card, `vt_scan` replaying its captured graphs against the
    same scan run eagerly: every record field and the end state equal
    bit for bit over 230 ms in two calls (as the CPU test above), and the
    bank launches counted once per ms either way.  Run on the card with
        python -m pytest --noconftest -p no:cacheprovider -m gpu \\
            tests/test_torch_vt.py
    """
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    raw, state, args = _static_scene(torch.device("cuda"), 240)
    out = {}
    for graph in (False, True):
        st, runs = state, []
        before = cb.correlator_bank.launches
        for n_steps in (130, 100):
            st, rec = tvt.vt_scan(raw, 0, st, n_steps=n_steps, graph=graph,
                                  **args)
            cb.raise_on_fault(rec["fault"])
            runs.append((st, rec))
        assert cb.correlator_bank.launches == before + 230
        out[graph] = runs
    for a, b in zip(out[True], out[False]):
        _assert_same_scan(a, b)
    assert bool(torch.isfinite(out[True][-1][1]["total_state"]).all())
