"""The port's multi-device paths in worlds of 2 and 3 ranks on the CPU.

One `parallel.distributed.launch` per world (gloo, each rank a process of
its own on the CPU, each launch with its own time limit) runs the five
legs: `track` (both routes, 8 channels), `epoch`, `vt` (the JAX package's
8-channel fixture), `ingest` (host-local reads of a small capture) and
`receiver` (the staged `Receiver(mesh="auto")` over a capture written
under pytest's tmp directory, never `.cache/`).  8 channels over 3 ranks
and 5 over 2 or 3 exercise the padding.

What each rank ends with must be:
- bit for bit the port's single-process run: the tracking records and end
  state of both routes, the VT records, solutions and end state, the
  stitched ingest record, the receiver's acquisition table, eph record,
  ephemerides and CT records, and its VT stage against a single-process VT
  stage from the same CT hand-off;
- within tests/test_mesh_pipeline.py's tolerances where the sum order
  differs: the WLS fixes (normal equations reduced over the ranks against
  the host solver's least squares: position 1e-6 m, clock 1e-5 m, velocity
  1e-6 m/s, DOP 1e-9), and the VT stage against the single-process
  Receiver that started from its own WLS fix (the exact fields exact, the
  others rtol 1e-9, atol 1e-4);
- against the JAX package, the port's stated parity: the integer block
  chain exact, the rest within tests/test_torch_track_chunk.py's and
  tests/test_torch_vt.py's bounds.

The receiver leg's capture: 2 s at 2.5 MHz of tests/scenario.py's five
SVs started 0.3 s before a subframe.  A 2 s capture cannot be decoded, so
the decode artifact (ephemerides and subframe rows) is made beforehand
from the synthesizer's own navigation bits at each channel's transmit
time, as `decode` would find them in a 40 s track, and put into every
Receiver's artifact directory, as tests/test_mesh_pipeline.py copies the
decode-stage artifacts.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from gps_sdr_tpu_torch import navdecode
from gps_sdr_tpu_torch.config import (CommonConfig, FileConfig,
                                      ReceiverConfig, SignalConfig,
                                      SolutionConfig, TrackConfig)
from gps_sdr_tpu_torch.geo.coords import llh2xyz
from gps_sdr_tpu_torch.io.ifdata import IFSampleSource
from gps_sdr_tpu_torch.io.synthetic import GeometrySignal, GeometrySV
from gps_sdr_tpu_torch.parallel import distributed as tdist
from gps_sdr_tpu_torch.pipeline import Receiver
from gps_sdr_tpu_torch.tracking import _REC_FIELDS

torch.set_num_threads(2)

WORLDS = (2, 3)
LEGS = ("track", "epoch", "vt", "ingest", "receiver")
FS, F_IF, CAPTURE_MS = 2.5e6, 0.6e6, 2000
NAME = "rxdist"
CT_KW = dict(n_ms=620)
VT_KW = dict(n_ms=250, ct_n_ms=620)
LAUNCH_TIMEOUT_S = 240


def _cfg():
    from tests import scenario as sc
    return ReceiverConfig(
        file=FileConfig(name=NAME, skip_ms=0),
        signal=SignalConfig(f_if=F_IF, fs=FS),
        track=TrackConfig(ms_eph_1ms=400, ms_eph_10ms=600,
                          ct_pdi_switch_ms=500),
        solu=SolutionConfig(truth_llh=sc.TRUTH_LLH),
        cmn=CommonConfig(multicorr_ct=False))


def _decode_artifact(gs, cfg, acq):
    """(eph, sbf) as `decode` finds them: each channel's ideal prompt
    stream, its sign the synthesizer's navigation bit at the transmit ms of
    each record row (row 0 starts at the acquisition's code epoch)."""
    S = cfg.signal.samples_per_ms
    rebase = gs.tow0 - gs.msg_tow0
    streams = {}
    for prn, delay in zip(acq.sv, acq.code_delay):
        tau = (S - int(delay) + 1) / cfg.signal.fs
        t_tx = rebase + tau + float(gs.sv_clock_delta(
            int(prn), torch.tensor([tau]))[0])
        ms = int(round(t_tx * 1000)) + np.arange(40000)
        streams[int(prn)] = 1.0 - 2.0 * gs.bits[int(prn)][ms // 20]
    return navdecode.decode_all(streams, start_offset_ms=0)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The capture, the decode artifact, and the single-process Receiver's
    artifacts (`ref`) and results from the receiver leg's calls."""
    from tests import scenario as sc
    root = tmp_path_factory.mktemp("torch_distributed")
    cfg = _cfg()
    usr = llh2xyz(np.asarray(sc.TRUTH_LLH)).numpy()
    gs = GeometrySignal(
        cfg, [GeometrySV(prn=p, eph=e, amplitude=a) for p, e, a in zip(
            sc.SCN_PRNS, sc.visible_constellation(len(sc.SCN_PRNS)),
            sc.AMPLITUDES)],
        usr, sc.TOW0 + 0.7, clk_bias_s=sc.CLK_BIAS_S,
        clk_drift_sps=sc.CLK_DRIFT_SPS, atmosphere=True,
        iono_alpha=cfg.cmn.iono_alpha, iono_beta=cfg.cmn.iono_beta,
        doy=cfg.cmn.day_of_year, device="cpu")
    path = str(root / "capture.bin")
    out = np.memmap(path, dtype=np.int8, mode="w+",
                    shape=(2 * CAPTURE_MS * cfg.signal.samples_per_ms,))
    gs.synthesize(CAPTURE_MS, noise_std=sc.NOISE_STD, seed=11, out=out)
    out.flush()
    del out
    src = IFSampleSource(path, cfg.file)
    ref_dir = str(root / "ref")
    rx = Receiver(cfg, src, artifact_dir=ref_dir, device="cpu", mesh=None)
    eph_stem = f"eph_{NAME}.pkl"
    rx._save_pickle(eph_stem, _decode_artifact(gs, cfg, rx.acquisition()))
    rx.track_for_eph_reference()
    ct = rx.ct_position(**CT_KW)
    vt = rx.vt_position(**VT_KW)
    return dict(root=root, cfg=cfg, path=path, ref_dir=ref_dir, usr=usr,
                eph_pickle=os.path.join(ref_dir, eph_stem), rx=rx, ct=ct,
                vt=vt)


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"{n}ranks")
def world(request, scene, tmp_path_factory):
    """One launch of every leg in a world of `request.param` ranks."""
    n = request.param
    work = str(tmp_path_factory.mktemp(f"world{n}"))
    art = os.path.join(work, "rx")
    os.makedirs(art)
    shutil.copy(scene["eph_pickle"], art)
    res = tdist.launch(
        legs=LEGS, n_processes=n, device="cpu", timeout_s=LAUNCH_TIMEOUT_S,
        work_dir=work, receiver=dict(
            cfg=scene["cfg"], capture=scene["path"], artifact_dir=art,
            ref_dir=scene["ref_dir"], ct_kw=CT_KW, vt_kw=VT_KW))
    assert sorted(res) == list(range(n))
    return dict(n=n, res=res, work=work, art=art)


def _npz(world, name):
    with np.load(os.path.join(world["work"], name)) as z:
        return {k: z[k] for k in z.files}


def test_world_and_mesh(world):
    for rank, r in world["res"].items():
        assert (r["rank"], r["world"], r["backend"], r["device"]) == (
            rank, world["n"], "gloo", "cpu")


def test_track_leg(world):
    """Both routes: each rank's gathered records and end state equal the
    unsharded run's; the ranks held complementary slices of the padded
    channel axis; every rank holds the same records."""
    n = world["n"]
    per = -(-tdist.TRACK_CHANNELS // n)
    for rank, r in world["res"].items():
        assert r["track"]["ok"], (rank, r["track"])
        assert r["track"]["local_channels"] == [rank * per, (rank + 1) * per]
        assert r["track"]["routes"]["track_scan"]["rows"] == 20
    for route in tdist.TRACK_ROUTES:
        first = _npz(world, f"track_{route}_rank0.npz")
        for rank in range(1, n):
            other = _npz(world, f"track_{route}_rank{rank}.npz")
            for f in _REC_FIELDS:
                np.testing.assert_array_equal(other[f], first[f])


@pytest.mark.parametrize("route", list(tdist.TRACK_ROUTES))
def test_track_leg_against_jax(world, route):
    """The sharded records against the JAX package's scan of the same
    chunk (`replica="nco"`, unsharded): the integer block chain exact; the
    correlators within 1e-4 of their mean magnitude at pdi 1 and 5e-4 at
    pdi 10 (tests/test_torch_track_chunk.py's and test_torch_sched.py's
    bounds) on each channel's rows before its loops part, the first row
    whose carrier differs by more than 1e-3 Hz: on random samples the two
    float32 loops follow equally valid noise paths from there (the rule of
    tests/test_torch_time_segments.py)."""
    import jax.numpy as jnp
    from gps_sdr_tpu.ops.cacode import ca_code_table
    from gps_sdr_tpu.tracking import (TrackParams, init_track_state,
                                      track_scan)

    from gps_sdr_tpu.config import (FileConfig as JFile,
                                    ReceiverConfig as JConfig,
                                    SignalConfig as JSignal)

    pdi, n_ms, _ = tdist.TRACK_ROUTES[route]
    cfg = JConfig(file=JFile(name="dist", skip_ms=0),
                  signal=JSignal(**tdist._SMALL_SIG))
    n = tdist.TRACK_CHANNELS
    S = cfg.signal.samples_per_ms
    blk = -(-(S * pdi + 256) // 128) * 128
    vals = tdist.track_raw(route).reshape(-1, 2).astype(np.float32)
    st = init_track_state(cfg, np.zeros(n, np.int64),
                          np.full(n, cfg.signal.f_if + 1000.0))
    st = st._replace(ptr=jnp.zeros(n, jnp.int64))
    chips = jnp.asarray(np.stack([ca_code_table()[p] for p in range(n)]),
                        jnp.float32)
    _, jrec = track_scan(jnp.asarray(vals), jnp.int64(0), st, chips,
                         TrackParams.epl(cfg, pdi_ms=pdi, replica="nco"),
                         n_ms // pdi, float(cfg.signal.fs), blk,
                         float(cfg.signal.code_freq_basis))
    j = {f: np.asarray(v) for f, v in jrec.items()}
    t = _npz(world, f"track_{route}_rank0.npz")
    np.testing.assert_array_equal(t["num_sample"], j["num_sample"])
    np.testing.assert_array_equal(t["absolute_sample"], j["absolute_sample"])
    scale = np.mean(np.abs(j["corr"]))
    tol = 1e-4 if pdi == 1 else 5e-4
    parted = np.abs(t["carr_freq"] - j["carr_freq"]) > 1e-3
    for ch in range(n):
        rows = np.nonzero(parted[:, ch])[0]
        first = rows[0] if len(rows) else parted.shape[0]
        assert first >= 3, (ch, first)
        assert np.abs(t["corr"][:first, ch] - j["corr"][:first, ch]
                      ).max() <= tol * scale, ch


def test_epoch_leg(world):
    """The reduced Gauss-Newton step against NumPy's and the whole epoch
    against the host solver; every rank holds the same bits."""
    first = _npz(world, "epoch_rank0.npz")
    for rank, r in world["res"].items():
        assert r["epoch"]["ok"], (rank, r["epoch"])
        other = _npz(world, f"epoch_rank{rank}.npz")
        for k, v in first.items():
            np.testing.assert_array_equal(other[k], v, err_msg=k)


def test_epoch_leg_against_jax(world):
    """The JAX package's sharded epoch solver on its 8-device CPU mesh,
    same fixture: within tests/test_mesh_pipeline.py's tolerances."""
    from gps_sdr_tpu.config import L1_WAVELENGTH
    from gps_sdr_tpu.parallel.epoch import make_epoch_solver
    from gps_sdr_tpu.parallel.mesh import make_mesh

    fx = tdist.epoch_fixture()
    est, dop, vel, drift = make_epoch_solver(make_mesh(), L1_WAVELENGTH)(
        fx["pr"], fx["sv"], fx["sv_vel"], fx["doppler"], fx["clk_rate"],
        fx["valid"], fx["init"])
    t = _npz(world, "epoch_rank0.npz")
    np.testing.assert_allclose(t["est"], est, rtol=0, atol=1e-6)
    np.testing.assert_allclose(t["dop"], dop, rtol=0, atol=1e-9)
    np.testing.assert_allclose(t["vel"], vel, rtol=0, atol=1e-8)
    assert abs(float(t["drift"]) - drift) <= 1e-8


def test_vt_leg(world):
    """Records, solutions and end state of the sharded VT equal the
    unsharded run's bit for bit (one gather a ms, the EKF replicated)."""
    for rank, r in world["res"].items():
        assert r["vt"]["ok"], (rank, r["vt"])
        assert r["vt"]["bit_equal"] and not r["vt"]["differ"]


def test_vt_leg_against_jax(world):
    """The JAX package's `vt_scan` on the same fixture (unsharded).  The
    fixture is random samples at one sample a chip, so the two float32
    loops part within a few ms (a block length one sample apart), and a
    chip edge falls on a sample edge: a 1e-7 chip difference moves a whole
    sample between taps, so neither the correlators nor the EKF they feed
    are compared.  Up to the row where the loops part: the integer block
    chain exact, the transmit times to 1e-12 s, the SV positions to 1e-3
    m.  (tests/test_torch_vt.py holds the
    unsharded port against the JAX package on a real signal; the sharded
    port equals the unsharded one bit for bit.)"""
    import jax.numpy as jnp
    from gps_sdr_tpu.parallel.distributed import _vt_fixture
    from gps_sdr_tpu.receiver.vt import vt_scan

    cfg, params, state, eph, tables, raw, blk, n_steps = _vt_fixture(
        tdist.VT_CHANNELS)
    assert n_steps == tdist.VT_STEPS
    np.testing.assert_array_equal(
        np.asarray(raw).reshape(-1),
        tdist._vt_fixture(tdist.VT_CHANNELS, "cpu")[5])
    _, j = vt_scan(jnp.asarray(raw), jnp.int64(0), state, jnp.asarray(tables),
                   eph, jnp.asarray(cfg.cmn.iono_alpha, jnp.float64),
                   jnp.asarray(cfg.cmn.iono_beta, jnp.float64), params,
                   n_steps, float(cfg.signal.fs), blk, float(cfg.signal.f_if),
                   float(cfg.signal.fc), float(cfg.signal.code_freq_basis),
                   int(cfg.cmn.day_of_year), 0)
    j = {k: np.asarray(v) for k, v in j.items()}
    t = _npz(world, "vt_rank0.npz")
    parted = np.nonzero((t["trk_num_sample"] != j["num_sample"]).any(1))[0]
    n = parted[0] if len(parted) else n_steps
    assert n >= 2, n
    np.testing.assert_array_equal(t["trk_absolute_sample"][:n],
                                  j["absolute_sample"][:n])
    np.testing.assert_allclose(t["trk_transmit_time"][:n],
                               j["transmit_time"][:n], rtol=0, atol=1e-12)
    np.testing.assert_allclose(t["sol_sv_pos"][:n], j["sv_pos"][:n], rtol=0,
                               atol=1e-3)


def test_ingest_leg(world):
    """Host-local reads: each rank read only its segments' byte range (the
    assertions of tests/test_distributed.py), ranges in rank order whose
    union covers the tracked span with only the overlap-save halo in
    common; the stitched record equals the single-process segmented run's
    bit for bit."""
    rs = [world["res"][r]["ingest"] for r in range(world["n"])]
    for r in rs:
        assert r["ok"], r
        assert r["read_fraction"] < 0.62, r
        assert r["rows"] == tdist.INGEST_N_MS
    assert [r["segments"] for r in rs][0][0] == 0
    assert rs[-1]["segments"][1] == tdist.INGEST_SEG
    for a, b in zip(rs, rs[1:]):
        assert a["segments"][1] == b["segments"][0]
        assert a["byte_range"][0] < b["byte_range"][0]
        assert b["byte_range"][1] > a["byte_range"][1]
        overlap = a["byte_range"][1] - b["byte_range"][0]
        assert 0 < overlap < 0.4 * a["file_bytes"], (overlap, a, b)


def test_ingest_leg_against_jax(world):
    """The JAX package's segmented run on the same capture: the block
    chain exact until a channel's loops part (the first row whose carrier
    differs by more than 1e-3 Hz) and within one sample after; prompt signs
    equal on > 0.999 of the rows past the first segment's pull-in (its
    halo) of each channel that locks (tests/test_torch_time_segments.py).  PRN 7 of this fixture does not
    lock in either package (its prompt no stronger than its quadrature),
    PRN 21 does."""
    from gps_sdr_tpu.io.ifdata import IFSampleSource as JSource
    from gps_sdr_tpu.parallel.time_segments import run_tracking_segmented
    from gps_sdr_tpu.tracking import TrackParams

    from gps_sdr_tpu.config import (FileConfig as JFile,
                                    ReceiverConfig as JConfig,
                                    SignalConfig as JSignal)

    cfg = JConfig(file=JFile(name="dist", skip_ms=0),
                  signal=JSignal(**tdist._SMALL_SIG))
    spec = tdist._ingest_init(os.path.join(world["work"],
                                           "ingest_capture.bin"))
    j = run_tracking_segmented(
        JSource(spec["capture"], cfg.file), cfg, spec["prns"],
        spec["delays"], spec["fine"], TrackParams.epl(cfg, replica="shift"),
        spec["n_ms"], n_segments=spec["segments"],
        halo_ms=spec["halo_ms"])
    t = _npz(world, "ingest_stitched.npz")
    jd = {f: np.asarray(getattr(j, f)) for f in _REC_FIELDS}
    split = np.abs(t["carr_freq"] - jd["carr_freq"]) > 1e-3
    for ch in range(t["num_sample"].shape[1]):
        rows = np.nonzero(split[:, ch])[0]
        first = rows[0] if len(rows) else t["num_sample"].shape[0]
        np.testing.assert_array_equal(t["absolute_sample"][:first, ch],
                                      jd["absolute_sample"][:first, ch])
    assert np.abs(t["absolute_sample"] - jd["absolute_sample"]).max() <= 1
    locked = (np.abs(jd["corr"][:, :, 1, 0]).mean(0)
              > 3 * np.abs(jd["corr"][:, :, 1, 1]).mean(0))
    assert list(locked) == [False, True]
    past = slice(tdist.INGEST_HALO_MS, None)
    agree = np.mean(np.sign(t["corr"][past, locked, 1, 0])
                    == np.sign(jd["corr"][past, locked, 1, 0]))
    assert agree > 0.999, agree


def test_receiver_leg(world, scene):
    """`Receiver(mesh="auto")` found the world; each rank's acquisition
    table, eph record, ephemerides and CT record equal the single-process
    Receiver's bit for bit, its WLS fixes agree within 1e-6 m, its VT stage
    keeps the split against the single-process stage (which started from
    its own WLS fix) and equals a single-process VT stage from the same CT
    hand-off bit for bit; no kernel launched on the CPU."""
    from tests import scenario as sc
    for rank, r in world["res"].items():
        rx = r["receiver"]
        assert rx["ok"], (rank, rx)
        assert rx["acquired"] == list(sc.SCN_PRNS)
        assert rx["channels"] == len(sc.SCN_PRNS)
        assert rx["wls"]["epochs"] > 50 and rx["wls"]["pos_m"] <= 1e-6
        assert rx["vt_ms"] == VT_KW["n_ms"]
        # one gather a ms, one a Kepler group, the records' once a chunk
        assert VT_KW["n_ms"] < rx["gathers"]["vt"] < VT_KW["n_ms"] + 60, rx
        assert rx["gathers"]["acquisition"] == 1 and rx["vt_scan_ms_per_step"]
        assert rx["vt_vs_single_same_handoff"]["bit_equal"], rx
        assert rx["launches"] == dict(track_chunk=0,
                                      correlator_bank_windows=0,
                                      correlator_bank=0)
        assert set(rx["stage_s"]) == {"acquisition", "eph", "decode",
                                      "usable_svs", "ct", "vt"}


def test_receiver_leg_writes_on_rank_zero(world, scene):
    """Rank 0 alone wrote the artifacts: one set, under the stems the
    single-process Receiver writes, each loading to what it holds."""
    names = sorted(f for f in os.listdir(world["art"])
                   if os.path.isfile(os.path.join(world["art"], f)))
    assert names == sorted(f for f in os.listdir(scene["ref_dir"])
                           if os.path.isfile(os.path.join(scene["ref_dir"],
                                                          f)))
    rx = Receiver(scene["cfg"], IFSampleSource(scene["path"],
                                               scene["cfg"].file),
                  artifact_dir=world["art"], device="cpu", mesh=None)
    rec, nav = rx.ct_position(**CT_KW)
    ref_rec, ref_nav = scene["ct"]
    for f in _REC_FIELDS:
        np.testing.assert_array_equal(getattr(rec, f), getattr(ref_rec, f))
    np.testing.assert_allclose(nav.usr_pos, ref_nav.usr_pos, rtol=0,
                               atol=1e-6)
    err = np.linalg.norm(nav.usr_pos - scene["usr"], axis=1)
    assert np.median(err) < 60.0, np.median(err)


@pytest.mark.gpu
def test_cuda_two_ranks_vt_chunk(tmp_path):
    """On the card: a world of 2 ranks sharing it, the sharded VT of the
    fixture (B2 launched by each rank every ms, one gather a ms) equal to
    the unsharded run bit for bit.  Run on the card with
        python -m pytest --noconftest -p no:cacheprovider -m gpu \\
            tests/test_torch_distributed.py
    """
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = tdist.launch(legs=("vt",), n_processes=2, device=None,
                       timeout_s=300, work_dir=str(tmp_path))
    for rank, r in res.items():
        assert r["device"].startswith("cuda"), r
        assert r["vt"]["ok"] and r["vt"]["bit_equal"], (rank, r["vt"])
