"""Multi-process execution: the sharded stages in a world of ranks.

The counterpart of the JAX package's `gps_sdr_tpu/parallel/distributed.py`:
`launch` spawns N worker processes that join one `torch.distributed`
world (gloo, meeting in a file store under the launch's `work_dir`),
builds each rank's mesh (`parallel/mesh.make_mesh`) and runs the requested
legs on it; each leg checks what its rank ends with and returns a small
dict.

- **track**: `run_tracking(mesh=…)` on both routes (pdi 1 through
  `track_chunk`, pdi 10 through `track_scan`), 8 channels of random
  samples; the gathered records and end state must equal the unsharded
  run's bit for bit.
- **epoch**: one Gauss-Newton step with its normal equations reduced over
  the ranks against NumPy's, and the whole epoch (`make_epoch_solver`)
  against the host solver, with a channel masked out.
- **vt**: `run_vector_tracking(mesh=…)` on the JAX package's VT fixture (8
  channels): records, solutions and end state against the unsharded run.
- **ingest**: host-local reads.  The capture's time axis is cut into
  overlap-save segments (`parallel/time_segments`); each rank reads only
  the byte range its segments need, tracks them through `track_chunk`
  over that slice, and the records are gathered and stitched; the result
  must equal the single-process `run_tracking_segmented` bit for bit.
- **receiver**: the staged `Receiver(mesh="auto")` over a capture file,
  held against single-process Receivers making the same calls: one that
  ran from scratch (its artifacts in `ref_dir`), and one that runs the VT
  stage again alone from this run's own artifacts.
- **scaling**: the probe of the JAX package's `bench.bench_scaling_curve`:
  the same problem for a world of D ranks (the acquisition grid over 2·D
  PRNs, 2·D channels tracked through `track_chunk`) timed unsharded by rank
  0 alone, then sharded over the D ranks; it returns the times and checks
  nothing.

The small fixtures (`_small_cfg`, `_vt_fixture`, `write_ingest_capture`)
are the JAX package's, copied.  The receiver leg's workload, and the ingest
leg's where it is not the small one, come with the job (`launch(receiver=…,
ingest=…)`).  Workers import the port after `init_process_group`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

# ---------------------------------------------------------------------------
# shared fixtures (the same on every rank)

_SMALL_SIG = dict(f_if=2.5e5, fs=1.023e6)
_EPH_BASE = dict(sqrta=5153.6413, ecc=0.0012, i0=0.9668, w=-0.8925,
                 deltan=4.3e-09, omegadot=-7.2e-09, idot=-4.2e-10,
                 cuc=1.5e-07, cus=2.4e-07, crc=287.5, crs=-2.6,
                 cic=-7.5e-09, cis=1.3e-08, toe=388800.0, toc=388800.0,
                 af0=1.8e-04, af1=2.0e-12, af2=0.0, tgd=-7.5e-09)
INGEST_SVS = (7, 21)
INGEST_N_MS = 360
INGEST_SEG = 4
INGEST_SEG_MS = 90
INGEST_HALO_MS = 40
TRACK_CHANNELS = 8
# route → (pdi ms, signal ms tracked, chunk ms): two chunks each
TRACK_ROUTES = {"track_chunk": (1, 100, 60), "track_scan": (10, 200, 100)}
EPOCH_ROWS = 12
RANK_THREADS = 2          # torch's CPU threads in each rank
VT_CHANNELS, VT_STEPS, VT_CHUNK_MS = 8, 40, 25
# the exact fields of the VT records (tests/test_mesh_pipeline.py's split)
VT_EXACT = ("corr", "carr_err", "code_err", "num_sample", "absolute_sample",
            "rem_phase")
# the scaling leg's problem beside its size (bench.py:548-551, 590-591):
# blocks and Doppler bins of the acquisition grid; timed calls of each side
SCALING_BLOCKS, SCALING_FREQS, SCALING_REPS = 4, 9, 5


def _small_cfg():
    from gps_sdr_tpu_torch.config import (FileConfig, ReceiverConfig,
                                          SignalConfig)

    return ReceiverConfig(file=FileConfig(name="dist", skip_ms=0),
                          signal=SignalConfig(**_SMALL_SIG))


def write_ingest_capture(path: str) -> None:
    """Deterministic int8 IQ capture for the ingest leg (written once by
    the launcher; the ranks read near-disjoint byte ranges of it)."""
    from gps_sdr_tpu_torch.io.synthetic import (SyntheticSV,
                                                generate_if_samples)

    cfg = _small_cfg()
    svs = [SyntheticSV(prn=p, amplitude=2.5 + 0.3 * i,
                       doppler_hz=(1234.5, -2500.25)[i],
                       code_delay_samples=(80.0, 345.0)[i])
           for i, p in enumerate(INGEST_SVS)]
    dur = INGEST_SEG * INGEST_SEG_MS + INGEST_HALO_MS + 8
    iq = generate_if_samples(cfg, svs, dur, noise_std=4.0, seed=9,
                             device="cpu").numpy()
    vals = np.empty(2 * iq.size)
    vals[0::2] = iq.real
    vals[1::2] = iq.imag
    np.clip(np.round(vals), -127, 127).astype(np.int8).tofile(path)


def _ingest_init(capture: str) -> dict:
    """The small ingest job on `capture` (`write_ingest_capture`'s): the
    config, PRNs, code delays and fine frequencies, the schedule."""
    cfg = _small_cfg()
    S = cfg.signal.samples_per_ms
    delays, fine = [], []
    for i in range(len(INGEST_SVS)):
        dop = (1234.5, -2500.25)[i]
        delay = (80.0, 345.0)[i]
        f_code = cfg.signal.code_freq_basis * (1 + dop / cfg.signal.fc)
        next_epoch = delay % (1023 / f_code * cfg.signal.fs)
        delays.append(int(round((S - next_epoch) % S)))
        fine.append(cfg.signal.f_if + dop + 3.0)
    return dict(cfg=cfg, capture=capture, prns=list(INGEST_SVS),
                delays=np.array(delays),
                fine=np.array(fine), n_ms=INGEST_N_MS, segments=INGEST_SEG,
                halo_ms=INGEST_HALO_MS)


def track_raw(route: str) -> np.ndarray:
    """The track leg's interleaved int8 samples for `route`: random integers
    in [−64, 64), as the JAX package's leg draws its chunk (seed 0 for
    `track_chunk`, 1 for `track_scan`)."""
    pdi, n_ms, _ = TRACK_ROUTES[route]
    S = _small_cfg().signal.samples_per_ms
    rng = np.random.default_rng(0 if route == "track_chunk" else 1)
    n = (n_ms + 2 * pdi + 2) * S + 1024
    return rng.integers(-64, 64, size=2 * n).astype(np.int8)


def epoch_fixture():
    """One WLS epoch of 6 channels with the third gated out
    (tests/test_mesh_pipeline.py's masked fixture)."""
    rng = np.random.default_rng(5)
    n = 6
    usr = np.array([-2.418e6, 5.386e6, 2.404e6])
    sv = usr + rng.normal(size=(n, 3)) * 5e6 + np.array([0, 0, 2.0e7])
    pr = np.linalg.norm(sv - usr, axis=1) + 1234.5 + rng.normal(size=n)
    return dict(pr=pr, sv=sv, sv_vel=rng.normal(size=(n, 3)) * 3e3,
                clk_rate=rng.normal(size=n) * 1e-2,
                doppler=rng.normal(size=n) * 1e3,
                valid=np.array([1, 1, 0, 1, 1, 1], bool),
                init=np.concatenate([usr + 1000.0, [0.0]]))


def _vt_fixture(n_ch: int, device):
    """The VT scan inputs of the JAX package's leg (bench.bench_vt's
    fixture at the small front end), the same on every rank: (cfg,
    params, state, eph, prns, interleaved int8 samples, n_steps, usr)."""
    from gps_sdr_tpu_torch.geo.ephemeris import Ephemeris
    from gps_sdr_tpu_torch.ops.track_chunk import ChunkWindow
    from gps_sdr_tpu_torch.receiver.vt import VTParams, VTState

    cfg = _small_cfg()
    S = cfg.signal.samples_per_ms
    params = VTParams()
    blk = ChunkWindow(S, params.pdi_ms).blk
    rng = np.random.default_rng(3)
    f64 = dict(dtype=torch.float64, device=device)

    def t(a, **kw):
        return torch.as_tensor(np.asarray(a), **(kw or f64))

    eph = Ephemeris(**{
        k: t(np.full(n_ch, v, np.float64)) for k, v in _EPH_BASE.items()
    } | {"m0": t(rng.uniform(0, 2 * np.pi, n_ch)),
         "omega0": t(rng.uniform(0, 2 * np.pi, n_ch))})
    usr = np.array([-2.4e6, 5.38e6, 2.41e6])
    carr = np.full(n_ch, cfg.signal.f_if + 1234.0)
    state = VTState(
        ptr=torch.zeros(n_ch, dtype=torch.int64, device=device),
        rem_chip=t(np.zeros(n_ch)),
        code_freq=t(np.full(n_ch, cfg.signal.code_freq_basis)),
        carr_freq=t(carr), carr_freq_basis=t(carr),
        phase_fp=torch.zeros(n_ch, dtype=torch.int32, device=device),
        pll_nco=t(np.zeros(n_ch)), pll_last=t(np.zeros(n_ch)),
        transmit_time=t(388800.0 + rng.uniform(0, 1e-3, n_ch) - 0.075),
        predicted_pr_last=t(np.zeros(n_ch)), iono_m=t(np.zeros(n_ch)),
        tropo_m=t(np.zeros(n_ch)), el_rad=t(np.full(n_ch, np.pi / 4)),
        az_rad=t(np.zeros(n_ch)),
        total_state=t(np.concatenate([usr, np.zeros(3), [0.0, 0.0]])),
        state_cov=t(1e5 * np.diag([0.1] * 6 + [1.0, 1.0])),
        r_diag=t(np.concatenate([np.full(n_ch, 0.3), np.full(n_ch, 0.1)])),
        innov_sq_sum=t(np.zeros(2 * n_ch)),
        step_count=torch.tensor(0, dtype=torch.int32, device=device),
        zk=t(np.zeros((n_ch, params.cn0_window))),
        snr_hist=t(np.full((n_ch, 5), 99.0)), cn0=t(np.full(n_ch, 99.0)),
        valid=torch.ones(n_ch, dtype=torch.bool, device=device))
    rng2 = np.random.default_rng(4)
    raw = rng2.integers(-64, 64, size=((VT_STEPS + 2) * S + blk, 2)
                        ).astype(np.int8).reshape(-1)
    return cfg, params, state, eph, list(range(1, n_ch + 1)), raw, usr


# ---------------------------------------------------------------------------
# worker legs


def _launches() -> Dict[str, int]:
    from gps_sdr_tpu_torch.ops import corr_bank, track_chunk

    return dict(track_chunk=track_chunk.track_chunk.launches,
                correlator_bank_windows=corr_bank.correlator_bank_windows
                .launches, correlator_bank=corr_bank.correlator_bank.launches)


def _zero_launches() -> None:
    from gps_sdr_tpu_torch.ops import corr_bank, track_chunk

    track_chunk.track_chunk.launches = 0
    corr_bank.correlator_bank_windows.launches = 0
    corr_bank.correlator_bank.launches = 0


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _differing(a, b, fields) -> list:
    """The fields of two records (dataclasses or dicts) that differ."""
    get = (lambda r, f: r[f]) if isinstance(a, dict) else getattr
    return [f for f in fields
            if not np.array_equal(np.asarray(get(a, f)), np.asarray(get(b, f)))]


def _state_differs(a, b) -> list:
    return [f for f in a._fields
            if not torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())]


def _leg_track(mesh, job) -> dict:
    from gps_sdr_tpu_torch.io.ifdata import IFSampleSource
    from gps_sdr_tpu_torch.tracking import (_REC_FIELDS, TrackParams,
                                            init_track_state, run_tracking)

    cfg = _small_cfg()
    n = TRACK_CHANNELS
    prns = list(range(1, n + 1))
    mine = mesh.rows(n + (-n) % mesh.size)
    out = {"n_channels": n, "local_channels": [mine.start, mine.stop],
           "routes": {}}
    for route, (pdi, n_ms, chunk_ms) in TRACK_ROUTES.items():
        src = IFSampleSource.from_array(track_raw(route), cfg.file)
        st = init_track_state(cfg, np.zeros(n, np.int64),
                              np.full(n, cfg.signal.f_if + 1000.0),
                              mesh.device)
        st = st._replace(ptr=torch.zeros(n, dtype=torch.int64,
                                         device=mesh.device))
        params = TrackParams.epl(cfg, pdi_ms=pdi)
        ref, ref_st = run_tracking(src, cfg, prns, st, params, n_ms,
                                   chunk_ms=chunk_ms)
        rec, rec_st = run_tracking(src, cfg, prns, st, params, n_ms,
                                   chunk_ms=chunk_ms, mesh=mesh)
        bad = (_differing(rec, ref, _REC_FIELDS)
               + [f"state.{f}" for f in _state_differs(rec_st, ref_st)])
        np.savez(os.path.join(job["out_dir"], f"track_{route}_rank"
                              f"{mesh.rank}.npz"),
                 **{f: getattr(rec, f) for f in _REC_FIELDS})
        out["routes"][route] = {"ok": not bad, "differ": bad,
                                "rows": int(rec.corr.shape[0])}
    out["ok"] = all(r["ok"] for r in out["routes"].values())
    return out


def _leg_epoch(mesh, job) -> dict:
    from gps_sdr_tpu_torch.config import L1_WAVELENGTH
    from gps_sdr_tpu_torch.parallel.epoch import (make_epoch_solver,
                                                  sharded_wls_normal_equations)
    from gps_sdr_tpu_torch.positioning.wls import (doppler_velocity_ls,
                                                   iterated_ls_position)

    rng = np.random.default_rng(1)
    sv_pos = rng.normal(scale=2.6e7, size=(EPOCH_ROWS, 3))
    resid = rng.normal(scale=30.0, size=(EPOCH_ROWS,))
    usr = np.array([-2.4e6, 5.38e6, 2.41e6])
    # NumPy Gauss-Newton step (olspos.m:40-53)
    d = sv_pos - usr
    h = np.concatenate([-d / np.linalg.norm(d, axis=1)[:, None],
                        np.ones((EPOCH_ROWS, 1))], axis=1)
    delta_ref = np.linalg.solve(h.T @ h, h.T @ resid)
    rows = mesh.rows(EPOCH_ROWS)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=mesh.device)

    delta = sharded_wls_normal_equations(mesh)(t(sv_pos[rows]),
                                               t(resid[rows]), t(usr))
    delta = delta.cpu().numpy()
    ok_step = bool(np.allclose(delta, delta_ref, rtol=1e-9, atol=1e-9))

    fx = epoch_fixture()
    v = fx["valid"]
    est, dop, vel, drift = make_epoch_solver(mesh, L1_WAVELENGTH)(
        fx["pr"], fx["sv"], fx["sv_vel"], fx["doppler"], fx["clk_rate"], v,
        fx["init"])
    est_h, dop_h = iterated_ls_position(fx["pr"][v], fx["sv"][v], fx["init"])
    vel_h, drift_h, _ = doppler_velocity_ls(
        est_h[:3], fx["sv"][v], fx["sv_vel"][v], fx["doppler"][v],
        L1_WAVELENGTH, fx["clk_rate"][v])
    diff = dict(pos=float((est - est_h).abs().max()),
                dop=float((dop - dop_h).abs().max()),
                vel=float((vel - vel_h).abs().max()),
                drift=abs(drift - float(drift_h)))
    ok_epoch = (diff["pos"] <= 1e-6 and diff["dop"] <= 1e-9
                and diff["vel"] <= 1e-8 and diff["drift"] <= 1e-8)
    np.savez(os.path.join(job["out_dir"], f"epoch_rank{mesh.rank}.npz"),
             delta=delta, est=est.numpy(), dop=dop.numpy(), vel=vel.numpy(),
             drift=drift)
    return {"ok": ok_step and ok_epoch, "ok_step": ok_step,
            "ok_epoch": ok_epoch, "n_sv": EPOCH_ROWS, "epoch_diff": diff}


def _vt_equal(trk_a, sol_a, trk_b, sol_b) -> dict:
    """The VT records and solutions of two runs: the fields that differ
    at all, and the split of tests/test_mesh_pipeline.py (the exact fields
    exact, the others within rtol 1e-9, atol 1e-4; the solution's
    validity exact)."""
    differ, close = [], True
    for what, a, b in (("trk", trk_a, trk_b), ("sol", sol_a, sol_b)):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if x is None or np.array_equal(x, y):
                continue
            differ.append(f"{what}.{f.name}")
            if (f.name in VT_EXACT or f.name == "valid"
                    or not np.allclose(x, y, rtol=1e-9, atol=1e-4)):
                close = False
    return {"bit_equal": not differ, "split_ok": close, "differ": differ}


# `.mat` exports of a world against one process's (`compare_mat_exports`):
# the WLS fixes within the receiver leg's bounds (position 1e-6 m, clock
# 1e-5 m, velocity 1e-6 m/s, DOP 1e-9; latitude and longitude in degrees
# at 1e-11, ~1e-6 m; elevation and azimuth 1e-9 degrees), every other
# navSolCT field and every other file exact, but the VT files, held to the
# split above: the exact fields exact, the others within atol 1e-4 and
# rtol 1e-9
WLS_MAT_TOL = dict(usrPos=1e-6, usrPosENU=1e-6,
                   usrPosLLH=np.array([1e-11, 1e-11, 1e-6]), clkBias=1e-5,
                   usrVel=1e-6, usrVelENU=1e-6, clkDrift=1e-6, DOP=1e-9,
                   satEA=1e-9, satAZ=1e-9)
VT_MAT_EXACT = ("E_i", "E_q", "P_i", "P_q", "L_i", "L_q", "carrError",
                "codeError", "absoluteSample", "codedelay", "remCarrPhase",
                "amplitude", "navi_data", "navi_dataL035", "prRate")
VT_SPLIT_ATOL, VT_SPLIT_RTOL = 1e-4, 1e-9


def _mat_leaves(x, path):
    """(path, array) of every numeric leaf of a loadmat value, in order:
    struct fields by name, cells element by element."""
    x = np.asarray(x)
    if x.dtype.names:
        for idx in np.ndindex(x.shape):
            for name in x.dtype.names:
                yield from _mat_leaves(x[idx][name], path + (name,))
    elif x.dtype == object:
        for idx in np.ndindex(x.shape):
            yield from _mat_leaves(x[idx], path)
    else:
        yield path, x


def _mat_tolerance(var: str, field: str):
    """(atol, rtol) of a leaf of variable `var`, field `field` (None:
    exact)."""
    if var == "navSolutionsCT":
        atol = WLS_MAT_TOL.get(field)
        return None if atol is None else (atol, 0.0)
    if var == "navSolutionsVT" or var == "CN0_VT" or (
            var == "TckResultVT" and field not in VT_MAT_EXACT):
        return VT_SPLIT_ATOL, VT_SPLIT_RTOL
    return None


def compare_mat_exports(dir_a: str, dir_b: str) -> dict:
    """The `.mat` sets of two `export_mat` runs (a world's and one
    process's) held to WLS_MAT_TOL and the VT split: the file names, the
    fields that differ at all, those outside their tolerance, and `ok`."""
    import scipy.io as sio

    files = sorted(os.listdir(dir_a))
    out = {"files": files, "same_files": files == sorted(os.listdir(dir_b)),
           "differ": {}, "outside": {}}
    if not out["same_files"]:
        out["ok"] = False
        return out
    for name in files:
        a, b = (sio.loadmat(os.path.join(d, name)) for d in (dir_a, dir_b))
        keys = sorted(k for k in a if not k.startswith("__"))
        if keys != sorted(k for k in b if not k.startswith("__")):
            out["outside"].setdefault(name, []).append("variables")
            continue
        for var in keys:
            la, lb = list(_mat_leaves(a[var], (var,))), list(
                _mat_leaves(b[var], (var,)))
            if [p for p, _ in la] != [p for p, _ in lb]:
                out["outside"].setdefault(name, []).append(var)
                continue
            for (path, x), (_, y) in zip(la, lb):
                field = path[-1]
                if x.shape == y.shape and np.array_equal(x, y):
                    continue
                if field not in out["differ"].setdefault(name, []):
                    out["differ"][name].append(field)
                tol = _mat_tolerance(var, field)
                if tol is None or x.shape != y.shape or not np.all(
                        np.abs(x - y) <= tol[0] + tol[1] * np.abs(y)):
                    if field not in out["outside"].setdefault(name, []):
                        out["outside"][name].append(field)
    out["outside"] = {k: v for k, v in out["outside"].items() if v}
    out["ok"] = not out["outside"]
    return out


def _leg_vt(mesh, job) -> dict:
    from gps_sdr_tpu_torch.io.ifdata import IFSampleSource
    from gps_sdr_tpu_torch.receiver.vt import run_vector_tracking

    cfg, params, state, eph, prns, raw, usr = _vt_fixture(VT_CHANNELS,
                                                         mesh.device)
    src = IFSampleSource.from_array(raw, cfg.file)
    kw = dict(chunk_ms=VT_CHUNK_MS)
    trk0, sol0, st0 = run_vector_tracking(src, cfg, prns, eph, state,
                                          params, VT_STEPS, usr, **kw)
    trk, sol, st = run_vector_tracking(src, cfg, prns, eph, state, params,
                                       VT_STEPS, usr, mesh=mesh, **kw)
    res = _vt_equal(trk, sol, trk0, sol0)
    res["state_differs"] = _state_differs(st, st0)
    np.savez(os.path.join(job["out_dir"], f"vt_rank{mesh.rank}.npz"),
             **{f"{what}_{k}": v for what, r in (("trk", trk), ("sol", sol))
                for k, v in dataclasses.asdict(r).items() if v is not None})
    res["ok"] = res["bit_equal"] and not res["state_differs"]
    return res


def _gather_uneven(mesh, a: np.ndarray, counts: Sequence[int]) -> np.ndarray:
    """Every rank's `a` (axis 1 of length counts[rank]) tiled in rank order
    along axis 1: padded to the longest, gathered, each cut back."""
    width = max(counts)
    pad = np.zeros((a.shape[0], width - a.shape[1], *a.shape[2:]), a.dtype)
    full = mesh.all_gather_rows(torch.from_numpy(
        np.concatenate([a, pad], axis=1)).to(mesh.device), dim=1).cpu().numpy()
    return np.concatenate([full[:, r * width:r * width + c]
                           for r, c in enumerate(counts)], axis=1)


def _leg_ingest(mesh, job) -> dict:
    """Host-local ingest: this rank reads ONLY the byte range its time
    segments need, tracks them (`track_chunk` over that slice, held on its
    device), and the whole record is assembled by a gather in rank order
    and the overlap-save stitch."""
    from gps_sdr_tpu_torch.io.ifdata import IFSampleSource, upload_capture
    from gps_sdr_tpu_torch.parallel.time_segments import (
        run_tracking_segmented, segmented_initial_state, stitch_segments)
    from gps_sdr_tpu_torch.tracking import (_REC_FIELDS, TrackParams,
                                            TrackRecords, TrackState,
                                            run_tracking)

    spec = job["ingest"]
    cfg, prns, capture = spec["cfg"], list(spec["prns"]), spec["capture"]
    D, halo, n_ms = spec["segments"], spec["halo_ms"], spec["n_ms"]
    n = len(prns)
    seg_ms = -(-n_ms // D)
    params = TrackParams.epl(cfg)
    t0 = time.perf_counter()
    state = segmented_initial_state(cfg, spec["delays"], spec["fine"], D,
                                    seg_ms, halo, "cpu")
    bounds = [(r * D // mesh.size, (r + 1) * D // mesh.size)
              for r in range(mesh.size)]
    s_lo, s_hi = bounds[mesh.rank]
    ptrs = state.ptr.numpy().reshape(D, n)
    my_ptr_lo = int(ptrs[s_lo:s_hi].min())
    need = params.chunk_spec(cfg).window.need(seg_ms + halo + 2)
    bps = cfg.file.bytes_per_sample
    file_bytes = os.path.getsize(capture)
    byte_lo = my_ptr_lo * bps
    byte_hi = min((int(ptrs[s_lo:s_hi].max()) + need) * bps, file_bytes)

    # the host-local read: only [byte_lo, byte_hi) of the capture
    dtype = np.int8 if cfg.file.data_precision == 1 else np.int16
    with open(capture, "rb") as f:
        f.seek(byte_lo)
        mine = np.frombuffer(f.read(byte_hi - byte_lo), dtype)
    src = IFSampleSource.from_array(mine, cfg.file)
    read_s = time.perf_counter() - t0

    # this rank's segment states, rebased into the slice's coordinates
    my = TrackState(*[f.reshape(D, n)[s_lo:s_hi].reshape(-1) for f in state])
    my = TrackState(*[f.to(mesh.device) for f in my._replace(
        ptr=my.ptr - my_ptr_lo)])
    t1 = time.perf_counter()
    _zero_launches()
    rec, _ = run_tracking(src, cfg, [p for _ in range(s_hi - s_lo)
                                     for p in prns], my, params,
                          seg_ms + halo,
                          resident=upload_capture(src, mesh.device))
    rec.absolute_sample += my_ptr_lo          # back to capture coordinates
    _sync(mesh.device)
    track_s = time.perf_counter() - t1
    launches = _launches()

    # the world's record: gathered in rank order, then stitched
    counts = [(hi - lo) * n for lo, hi in bounds]
    full = TrackRecords(
        **{f: _gather_uneven(mesh, getattr(rec, f), counts)
           for f in _REC_FIELDS},
        i_early=params.i_early, i_prompt=params.i_prompt,
        i_late=params.i_late)
    stitched = stitch_segments(full, n, D, seg_ms, halo, n_ms, params)

    # the single-process segmented run over the whole file
    ref = run_tracking_segmented(IFSampleSource(capture, cfg.file), cfg,
                                 prns, spec["delays"], spec["fine"], params,
                                 n_ms, n_segments=D, halo_ms=halo,
                                 device=mesh.device)
    bad = _differing(stitched, ref, _REC_FIELDS)
    if mesh.rank == 0:
        np.savez(os.path.join(job["out_dir"], "ingest_stitched.npz"),
                 **{f: getattr(stitched, f) for f in _REC_FIELDS})
    return {"ok": not bad, "differ": bad, "segments": [s_lo, s_hi],
            "byte_range": [int(byte_lo), int(byte_hi)],
            "file_bytes": int(file_bytes),
            "read_fraction": (byte_hi - byte_lo) / file_bytes,
            "read_s": read_s, "track_s": track_s, "launches": launches,
            "rows": int(stitched.corr.shape[0])}


def _leg_receiver(mesh, job) -> dict:
    """The staged Receiver with a mesh over a capture file, then the same
    calls by single-process Receivers: one whose artifacts (`ref_dir`)
    were made from scratch, one that runs the VT stage alone again from
    this run's artifacts (so from the same CT hand-off)."""
    import torch.distributed as dist

    from gps_sdr_tpu_torch.io.ifdata import IFSampleSource
    from gps_sdr_tpu_torch.parallel import vt as pvt
    from gps_sdr_tpu_torch.pipeline import Receiver
    from gps_sdr_tpu_torch.tracking import _REC_FIELDS

    kw = job["receiver"]
    cfg, dev = kw["cfg"], mesh.device
    src = IFSampleSource(kw["capture"], cfg.file)
    calls = [("acquisition", "acquisition", {}),
             ("eph", "track_for_eph_reference", {}),
             ("decode", "decode", {}), ("usable_svs", "usable_svs", {}),
             ("ct", "ct_position", kw.get("ct_kw", {})),
             ("vt", "vt_position", kw.get("vt_kw", {}))]

    def run(rx) -> dict:
        out, walls, gathers = {}, {}, {}
        for name, method, args in calls:
            _sync(dev)
            n0, t = counts["gather"], time.perf_counter()
            out[name] = getattr(rx, method)(**args)
            _sync(dev)
            walls[name] = time.perf_counter() - t
            gathers[name] = counts["gather"] - n0
        return out, walls, gathers

    # the mesh's gathers, and the sharded vt_scan's calls timed (device
    # synchronised), counted while this rank's Receiver runs
    counts = {"gather": 0, "scan_s": 0.0}
    real_gather, real_scan = dist.all_gather, pvt.vt_scan

    def counted_gather(*a, **k):
        counts["gather"] += 1
        return real_gather(*a, **k)

    def timed_scan(*a, **k):
        _sync(dev)
        t = time.perf_counter()
        out = real_scan(*a, **k)
        _sync(dev)
        counts["scan_s"] += time.perf_counter() - t
        return out

    _zero_launches()
    rx = Receiver(cfg, src, artifact_dir=kw["artifact_dir"], device=dev)
    if rx.mesh is None or rx.mesh.size != mesh.size:
        raise RuntimeError("Receiver(mesh='auto') did not find the world")
    dist.all_gather, pvt.vt_scan = counted_gather, timed_scan
    try:
        got, walls, gathers = run(rx)
    finally:
        dist.all_gather, pvt.vt_scan = real_gather, real_scan
    launches = _launches()
    ref, _, _ = run(Receiver(cfg, src, artifact_dir=kw["ref_dir"],
                             device=dev, mesh=None))

    a, b = got["acquisition"], ref["acquisition"]
    res = {"stage_s": walls, "launches": launches, "device": str(dev),
           "vt_ms": int(got["vt"][1].usr_pos.shape[0]),
           "channels": len(got["usable_svs"]),
           "acquired": [int(p) for p in a.sv]}
    res["gathers"] = gathers
    res["vt_scan_ms_per_step"] = counts["scan_s"] * 1e3 / res["vt_ms"]
    res["vt_stage_ms_per_ms"] = walls["vt"] * 1e3 / res["vt_ms"]
    res["vt_step"] = ("two CUDA graphs around the gather"
                      if dev.type == "cuda" else "eager")
    res["acquisition_equal"] = not _differing(
        a, b, [f.name for f in dataclasses.fields(a)])
    res["eph_record_equal"] = not _differing(got["eph"], ref["eph"],
                                             _REC_FIELDS)
    res["ephemerides_equal"] = got["decode"] == ref["decode"]
    (ct_rec, nav), (ref_rec, ref_nav) = got["ct"], ref["ct"]
    res["ct_record_equal"] = not _differing(ct_rec, ref_rec, _REC_FIELDS)
    res["wls"] = dict(
        epochs=int(nav.usr_pos.shape[0]),
        pos_m=float(np.abs(nav.usr_pos - ref_nav.usr_pos).max()),
        clk_m=float(np.abs(nav.clk_bias_m - ref_nav.clk_bias_m).max()),
        vel_ms=float(np.abs(nav.usr_vel - ref_nav.usr_vel).max()),
        dop=float(np.abs(nav.dop - ref_nav.dop).max()),
        valid_equal=bool(np.array_equal(nav.valid, ref_nav.valid)))
    w = res["wls"]
    res["wls_ok"] = (nav.usr_pos.shape == ref_nav.usr_pos.shape
                     and w["pos_m"] <= 1e-6 and w["clk_m"] <= 1e-5
                     and w["vel_ms"] <= 1e-6 and w["dop"] <= 1e-9
                     and w["valid_equal"])
    res["vt_vs_reference"] = _vt_equal(*got["vt"], *ref["vt"])

    # the VT stage alone, single-process, from this run's own artifacts
    alone = os.path.join(kw["artifact_dir"], f"vt_alone_rank{mesh.rank}")
    os.makedirs(alone, exist_ok=True)
    for name in os.listdir(kw["artifact_dir"]):
        if not name.startswith("navvt2_") and os.path.isfile(
                os.path.join(kw["artifact_dir"], name)):
            shutil.copy(os.path.join(kw["artifact_dir"], name), alone)
    single = Receiver(cfg, src, artifact_dir=alone, device=dev, mesh=None)
    res["vt_vs_single_same_handoff"] = _vt_equal(
        *got["vt"], *single.vt_position(**kw.get("vt_kw", {})))
    res["ok"] = bool(res["acquisition_equal"] and res["eph_record_equal"]
                     and res["ephemerides_equal"] and res["ct_record_equal"]
                     and res["wls_ok"]
                     and res["vt_vs_reference"]["split_ok"]
                     and res["vt_vs_single_same_handoff"]["bit_equal"])
    return res


def _timed(fn, device, before=None) -> list:
    """Seconds of each of SCALING_REPS calls of `fn` after one untimed
    call, each ended by a device synchronisation; `before` runs untimed
    ahead of every call."""
    fn()
    _sync(device)
    times = []
    for _ in range(SCALING_REPS):
        if before is not None:
            before()
        t = time.perf_counter()
        fn()
        _sync(device)
        times.append(time.perf_counter() - t)
    return times


def _leg_scaling(mesh, job) -> dict:
    """The same problem for this world's size D, run unsharded by rank 0
    alone while the others wait (on the CPU with the threads of the whole
    world, so both sides use the same cores), then sharded over the D ranks
    (each call started together, after a barrier): the acquisition grid
    over 2·D PRNs (`sharded_acquisition_power`) and `steps` blocks of 2·D
    channels at 1.023 MHz through `track_chunk` (`sharded_tracker`, the
    records gathered).  Rank 0's seconds per call of each."""
    from gps_sdr_tpu_torch.acquisition import acquisition_power_grid
    from gps_sdr_tpu_torch.ops.track_chunk import track_chunk
    from gps_sdr_tpu_torch.parallel.acquisition import (
        sharded_acquisition_power)
    from gps_sdr_tpu_torch.parallel.tracking import (shard_channels,
                                                     sharded_tracker)
    from gps_sdr_tpu_torch.tracking import (TrackParams, chip_tables,
                                            init_track_state)

    size, dev, d = job["scaling"], mesh.device, mesh.size
    n, S, steps = 2 * d, size["samples"], size["steps"]
    rng = np.random.default_rng(0)

    def c64(rows):
        z = rng.normal(size=(rows, S)) + 1j * rng.normal(size=(rows, S))
        return torch.as_tensor(z.astype(np.complex64), device=dev)

    blocks, carriers = c64(SCALING_BLOCKS), c64(SCALING_FREQS)
    code_fft = torch.as_tensor(np.fft.fft(rng.choice(
        [-1.0, 1.0], size=(n, S))).astype(np.complex64), device=dev)
    cfg = _small_cfg()
    spec = TrackParams.epl(cfg).chunk_spec(cfg)
    raw = torch.as_tensor(rng.integers(
        -64, 64,
        size=((steps + 2) * cfg.signal.samples_per_ms + spec.window.blk, 2)
    ).astype(np.int8), device=dev)
    state = init_track_state(cfg, np.zeros(n, np.int64),
                             np.full(n, cfg.signal.f_if + 1000.0), dev)
    state = state._replace(ptr=torch.zeros(n, dtype=torch.int64, device=dev))
    chips = chip_tables(list(range(1, n + 1)), dev)

    out = {"ranks": d, "prns": n, "channels": n, "samples": S,
           "steps": steps}
    if mesh.rank == 0:
        threads = torch.get_num_threads()
        if dev.type == "cpu":
            torch.set_num_threads(threads * d)
        try:
            out["acq_unsharded_s"] = _timed(lambda: acquisition_power_grid(
                blocks, carriers, code_fft), dev)
            out["track_unsharded_s"] = _timed(lambda: track_chunk(
                raw, 0, state, chips, spec, steps), dev)
        finally:
            torch.set_num_threads(threads)
    mesh.barrier()
    power = sharded_acquisition_power(mesh)
    out["acq_sharded_s"] = _timed(lambda: power(blocks, carriers, code_fft),
                                  dev, mesh.barrier)
    mine = shard_channels(mesh, state, chips)      # 2·D rows: no padding
    tracker = sharded_tracker(mesh, track_chunk, n)
    out["track_sharded_s"] = _timed(lambda: tracker(raw, 0, *mine, spec,
                                                    steps), dev, mesh.barrier)
    return out


LEGS = {"track": _leg_track, "epoch": _leg_epoch, "vt": _leg_vt,
        "ingest": _leg_ingest, "receiver": _leg_receiver,
        "scaling": _leg_scaling}


# ---------------------------------------------------------------------------
# worker entry


def run_legs(job_path: str, out_path: str) -> int:
    """Worker body, after `init_process_group`: the mesh of the world on
    the job's device, then each leg; the results as JSON in `out_path`."""
    import torch.distributed as dist

    from gps_sdr_tpu_torch.parallel.mesh import make_mesh

    with open(job_path, "rb") as f:     # written by `launch`
        job = pickle.load(f)
    torch.set_num_threads(RANK_THREADS)
    mesh = make_mesh(device=job["device"])
    out = {"rank": mesh.rank, "world": mesh.size, "backend": mesh.backend,
           "device": str(mesh.device)}
    if mesh.device.type == "cuda":
        out["device_name"] = torch.cuda.get_device_name(mesh.device)
    for leg in job["legs"]:
        t = time.perf_counter()
        out[leg] = LEGS[leg](mesh, job)
        out[leg]["wall_s"] = time.perf_counter() - t
    with open(out_path, "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# launcher


def launch(legs: Sequence[str] = ("track", "epoch"), n_processes: int = 2,
           device=None, timeout_s: int = 900, work_dir: Optional[str] = None,
           receiver: Optional[dict] = None, ingest: Optional[dict] = None,
           scaling: Optional[dict] = None) -> Dict[int, dict]:
    """Spawn `n_processes` workers in one gloo world (a file store in
    `work_dir`, so that worlds launched at once cannot meet), run `legs` on
    every rank and return {rank: result dict}.  Raises on any worker's
    failure or time-out (every worker is stopped).

    `device`: each rank's device (None: its card, `mesh.rank_device`;
    "cpu" for the CPU).  `receiver`: the receiver leg's `cfg`, `capture`,
    `artifact_dir` (rank 0 writes there), `ref_dir` (the single-process
    artifacts) and the keyword arguments of its `ct_position` and
    `vt_position` calls (`ct_kw`, `vt_kw`; the eph stage is the reference
    schedule).  `ingest`: the ingest leg's `cfg`, `capture`, `prns`, code
    `delays`, `fine` frequencies, `n_ms`, `segments` and `halo_ms`
    (default: the small fixture, its capture written into `work_dir`).
    `scaling`: the scaling leg's problem, `samples` per acquisition block
    and tracking `steps`."""
    unknown = set(legs) - set(LEGS)
    if unknown:
        raise ValueError(f"unknown legs {sorted(unknown)}")
    work_dir = work_dir or tempfile.mkdtemp(prefix="gps_sdr_torch_dist_")
    os.makedirs(work_dir, exist_ok=True)
    if "ingest" in legs and ingest is None:
        capture = os.path.join(work_dir, "ingest_capture.bin")
        if not os.path.exists(capture):
            write_ingest_capture(capture)
        ingest = _ingest_init(capture)
    job_path = os.path.join(work_dir, "job.pkl")
    with open(job_path, "wb") as f:
        pickle.dump(dict(legs=list(legs), device=device, receiver=receiver,
                         ingest=ingest, scaling=scaling, out_dir=work_dir), f)
    # the ranks meet in a file store of this launch's own: a TCP port
    # found free here and bound by rank 0 later could be taken in between
    store = os.path.join(work_dir, "store")
    if os.path.exists(store):
        os.remove(store)    # a crashed launch's; a store needs a new file
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs, outs = [], []
    for rank in range(n_processes):
        outs.append(os.path.join(work_dir, f"result_{rank}.json"))
        # the world first, then the port
        boot = ("import datetime, sys, torch.distributed as dist;"
                "dist.init_process_group('gloo', "
                f"init_method={'file://' + store!r}, rank={rank}, "
                f"world_size={n_processes}, "
                f"timeout=datetime.timedelta(seconds={timeout_s}));"
                "from gps_sdr_tpu_torch.parallel import distributed as d;"
                f"sys.exit(d.run_legs({job_path!r}, {outs[-1]!r}))")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", boot], env=env, cwd=root,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    results: Dict[int, dict] = {}
    errs = []
    deadline = time.monotonic() + timeout_s
    try:
        for rank, p in enumerate(procs):
            try:
                stdout, _ = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                stdout, _ = p.communicate()
                errs.append(f"rank {rank} timed out\n{stdout[-3000:]}")
                continue
            if p.returncode != 0:
                errs.append(f"rank {rank} rc={p.returncode}\n"
                            f"{stdout[-3000:]}")
                continue
            with open(outs[rank]) as f:
                results[rank] = json.load(f)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if errs:
        raise RuntimeError("distributed launch failed:\n"
                           + "\n---\n".join(errs))
    return results
