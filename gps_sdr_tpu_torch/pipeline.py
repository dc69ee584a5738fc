"""Receiver pipeline orchestration with artifact checkpointing.

Equivalent of the reference driver `SDR_main.m` on the main path:
acquisition → eph tracking → nav decode → usable-SV filter → CT-POS
tracking + WLS, every stage output checkpointed in the caller's
`artifact_dir` and skipped when the artifact already exists
(SDR_main.m:21-27,34-61).  Artifacts carry the JAX package's stems and
schemas; every write is atomic (temp file, then `os.replace`), so an
interrupted or concurrent run never leaves a truncated artifact behind.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import tempfile
from typing import Optional

import numpy as np
import torch

from gps_sdr_tpu_torch import navdecode
from gps_sdr_tpu_torch.acquisition import AcquisitionResult, run_acquisition
from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.geo.coords import llh2xyz
from gps_sdr_tpu_torch.geo.ephemeris import Ephemeris
from gps_sdr_tpu_torch.io.ifdata import IFSampleSource
from gps_sdr_tpu_torch.receiver.ct import NavSolutions, run_ct_positioning
from gps_sdr_tpu_torch.receiver.vt import (VTParams, init_vt_state,
                                           run_vector_tracking)
from gps_sdr_tpu_torch.tracking import (_REC_FIELDS, TrackParams,
                                        TrackRecords, init_track_state,
                                        run_tracking, state_from_records)
from gps_sdr_tpu_torch.utils.device import resolve_device


def detect_bit_transition(p_i: np.ndarray, min_index: int = 600) -> int:
    """`countinx`: ms offset of the first clean data-bit transition.

    trackingCT.m:178-213: find i ≥ min_index where the 6 previous ms
    disagree with ms i and the following 17 agree; return mod(i,20)−1
    with the reference's 1-based i.
    """
    s = np.sign(p_i)
    n = len(s)
    for i in range(max(6, min_index - 1), n - 18):
        if np.all(s[i - 6:i] != s[i]) and np.all(s[i + 1:i + 18] == s[i]):
            return int((i + 1) % 20 - 1)
    return 0


def _atomic_write(path: str, write) -> None:
    """Call write(file) on a temp file beside `path`, then rename it over
    `path`."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=os.path.basename(path) + ".")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


class Receiver:
    """Staged receiver with artifact caching, on one device: the CUDA
    card unless `device` says otherwise (`device="cpu"` for the CPU).

    Stage artifacts (mirroring SDR_main.m's .mat files):
      acquired_{name}_{skip}.npz    Acquired{sv,SNR,Doppler,codedelay,fineFreq}
      tckeph_{name}.npz             per-ms tracking records for nav decode
      tckeph_ref_{name}_{n1}_{n10}_{min}.npz   the same from the reference's
                                    3-phase schedule (its own stem: a
                                    record is never taken for the other
                                    schedule's)
      countinx_{name}.npz           per-channel first bit transition
      eph_{name}.pkl                {prn: EphemerisRecord} + sbf{nav1,sfb1}
      nacquired_{name}_{skip}.npz   acquisition fields of the usable SVs
      tckct_{key}.npz / navct_{key}.pkl   CT-POS records + WLS solutions
      navvt2_{key}.pkl              (VTTrackRecords, VTSolutions)
    """

    def __init__(self, cfg: ReceiverConfig, source: IFSampleSource,
                 artifact_dir: Optional[str] = None, device=None):
        self.cfg = cfg
        self.source = source
        self.dir = artifact_dir
        self.device = resolve_device(device)
        if artifact_dir:
            os.makedirs(artifact_dir, exist_ok=True)
        self._acq: Optional[AcquisitionResult] = None
        self._eph_records: Optional[TrackRecords] = None
        self._eph = None
        self._sbf = None

    # ---------- artifact helpers ----------
    def _path(self, stem: str) -> Optional[str]:
        return os.path.join(self.dir, stem) if self.dir else None

    def _have(self, stem: str) -> bool:
        p = self._path(stem)
        return p is not None and os.path.exists(p)

    def _save_npz(self, stem: str, **arrays) -> None:
        if self.dir:
            _atomic_write(self._path(stem), lambda f: np.savez(f, **arrays))

    def _save_pickle(self, stem: str, obj) -> None:
        if self.dir:
            _atomic_write(self._path(stem), lambda f: pickle.dump(obj, f))

    def _load_pickle(self, stem: str):
        # artifacts this receiver wrote itself into the caller's directory
        with open(self._path(stem), "rb") as f:
            return pickle.load(f)

    def _save_records(self, stem: str, rec: TrackRecords) -> None:
        self._save_npz(stem, i_early=rec.i_early, i_prompt=rec.i_prompt,
                       i_late=rec.i_late,
                       **{f: getattr(rec, f) for f in _REC_FIELDS})

    def _load_records(self, stem: str) -> TrackRecords:
        z = np.load(self._path(stem))
        return TrackRecords(**{f: z[f] for f in _REC_FIELDS},
                            i_early=int(z["i_early"]),
                            i_prompt=int(z["i_prompt"]),
                            i_late=int(z["i_late"]))

    # ---------- stages ----------
    def acquisition(self) -> AcquisitionResult:
        """Stage 1 (SDR_main.m:22): FFT parallel code-phase search."""
        if self._acq is not None:
            return self._acq
        stem = f"acquired_{self.cfg.file.name}_{self.cfg.file.skip_ms}.npz"
        if self._have(stem):
            z = np.load(self._path(stem))
            self._acq = AcquisitionResult(
                sv=z["sv"], snr_db=z["snr_db"], doppler_hz=z["doppler_hz"],
                code_delay=z["code_delay"], fine_freq_hz=z["fine_freq_hz"])
        else:
            self._acq = run_acquisition(self.source, self.cfg,
                                        device=self.device)
            a = self._acq
            self._save_npz(stem, sv=a.sv, snr_db=a.snr_db,
                           doppler_hz=a.doppler_hz, code_delay=a.code_delay,
                           fine_freq_hz=a.fine_freq_hz)
        return self._acq

    def track_for_eph(self, n_ms: Optional[int] = None,
                      chunk_ms: int = 1000) -> TrackRecords:
        """Stage 2 (SDR_main.m:38): 1 ms E/P/L tracking long enough to
        decode the ephemerides (≥ ~31 s of bits)."""
        if self._eph_records is not None:
            return self._eph_records
        stem = f"tckeph_{self.cfg.file.name}.npz"
        if self._have(stem):
            self._eph_records = self._load_records(stem)
            return self._eph_records
        acq = self.acquisition()
        n_ms = n_ms or (self.cfg.track.ms_eph_1ms + self.cfg.track.ms_eph_10ms)
        state = init_track_state(self.cfg, acq.code_delay, acq.fine_freq_hz,
                                 self.device)
        rec, _ = run_tracking(self.source, self.cfg, list(acq.sv), state,
                              TrackParams.epl(self.cfg), n_ms,
                              chunk_ms=chunk_ms)
        self._eph_records = rec
        self._save_records(stem, rec)
        return rec

    def track_for_eph_reference(self, chunk_ms: int = 1000,
                                min_transition_index: int = 600
                                ) -> TrackRecords:
        """The reference's 3-phase eph-decoding schedule (trackingCT.m):

        (a) ms_eph_1ms ms at 1 ms from the acquisition pointer → the first
            data-bit transition offset `countinx` (trackingCT.m:178-213)
        (b) re-track ms_eph_1ms + countinx ms at 1 ms from the same pointer
            (trackingCT.m:215-369)
        (c) ms_eph_10ms ms at 10 ms with negated correlator outputs, each
            block replicated ×10 into the per-ms record
            (trackingCT.m:377-525)

        All channels run in one batch per phase: (b) tracks every channel
        to the latest switch row and each keeps its first n1 + countinx
        rows; (c) resumes each channel's loop state from the (b) records at
        its own switch row (`state_from_records`) with the re-based pointer
        ptr0 + (n1 + countinx)·S (trackingCT.m:403).  Phase (c)'s blocks go
        through `tracking.track_scan`.

        The record is what `decode` consumes in place of `track_for_eph`'s.
        Its artifact stem is keyed on the schedule (the JAX package shares
        `tckeph_{name}.npz` between both schedules), so a later Receiver on
        the same directory never loads one schedule's record as the
        other's.
        """
        cfg = self.cfg
        if self._eph_records is not None:
            return self._eph_records
        n1, n10 = cfg.track.ms_eph_1ms, cfg.track.ms_eph_10ms
        stem = (f"tckeph_ref_{cfg.file.name}_{n1}_{n10}"
                f"_{min_transition_index}.npz")
        if self._have(stem):
            self._eph_records = self._load_records(stem)
            return self._eph_records
        acq = self.acquisition()
        S = cfg.signal.samples_per_ms
        prns = [int(p) for p in acq.sv]
        n_ch = len(prns)
        params1 = TrackParams.epl(cfg)

        def fresh_state():
            return init_track_state(cfg, acq.code_delay, acq.fine_freq_hz,
                                    self.device)

        # (a) 1 ms tracking → countinx per channel
        rec_a, _ = run_tracking(self.source, cfg, prns, fresh_state(),
                                params1, n1, chunk_ms=chunk_ms)
        cnt = np.array([detect_bit_transition(
            rec_a.p_i[:, ch], min_index=min_transition_index)
            for ch in range(n_ch)])
        cnt_max = int(cnt.max())

        # (b) re-track to the latest switch point
        rec_b, _ = run_tracking(self.source, cfg, prns, fresh_state(),
                                params1, n1 + cnt_max, chunk_ms=chunk_ms)

        # (c) 10 ms blocks, negated, from per-channel re-based pointers;
        # loop state resumed at each channel's switch row (countinx may be
        # −1, then that is the row before the last of phase (a))
        st_c = state_from_records(rec_b, n1 + cnt - 1, acq.fine_freq_hz,
                                  params1.dll_freq_sign,
                                  cfg.signal.code_freq_basis, self.device)
        ptr0 = cfg.file.skip_ms * S + S - acq.code_delay.astype(np.int64) + 1
        st_c = st_c._replace(ptr=torch.as_tensor(
            ptr0 + (n1 + cnt) * S, dtype=torch.int64, device=self.device))
        rec_c, _ = run_tracking(
            self.source, cfg, prns, st_c,
            TrackParams.epl(cfg, pdi_ms=10, negate_iq=True), n10,
            chunk_ms=chunk_ms)

        # merge: per channel, its own (b) prefix + the ×10-replicated (c)
        # rows, edge-padded to the common length
        t_max = n1 + cnt_max + n10
        merged = {}
        for f in _REC_FIELDS:
            b, c = getattr(rec_b, f), np.repeat(getattr(rec_c, f), 10, axis=0)
            rows = []
            for ch in range(n_ch):
                a = np.concatenate([b[:n1 + cnt[ch], ch], c[:, ch]])
                pad = t_max - a.shape[0]
                if pad:
                    a = np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])
                rows.append(a)
            merged[f] = np.stack(rows, axis=1)
        self._eph_records = TrackRecords(**merged)
        self._save_records(stem, self._eph_records)
        return self._eph_records

    def countinx(self, min_transition_index: int = 600) -> np.ndarray:
        """Per-channel first-bit-transition offsets, ordered like acq.sv
        (the reference persists these as countinx.mat, trackingCT.m:530)."""
        acq = self.acquisition()
        stem = f"countinx_{self.cfg.file.name}.npz"
        if self._have(stem):
            return np.load(self._path(stem))["countinx"]
        rec = self.track_for_eph()
        cnt = np.array([detect_bit_transition(
            rec.p_i[:, ch], min_index=min_transition_index)
            for ch in range(len(acq.sv))])
        self._save_npz(stem, sv=acq.sv, countinx=cnt)
        return cnt

    def decode(self, start_offset_ms: int = 3000):
        """Stage 3 (SDR_main.m:54): nav decode → ephemerides + sbf."""
        if self._eph is not None:
            return self._eph, self._sbf
        stem = f"eph_{self.cfg.file.name}.pkl"
        if self._have(stem):
            self._eph, self._sbf = self._load_pickle(stem)
            return self._eph, self._sbf
        acq = self.acquisition()
        rec = self.track_for_eph()
        streams = {int(p): rec.p_i[:, ch] for ch, p in enumerate(acq.sv)}
        self._eph, self._sbf = navdecode.decode_all(streams, start_offset_ms)
        self._save_pickle(stem, (self._eph, self._sbf))
        return self._eph, self._sbf

    def usable_svs(self):
        """Stage 4 (SDR_main.m:65, findPosSV.m): PRNs with complete healthy
        ephemerides; the acquisition fields of that set are persisted as
        the nAcquired-style artifact (findPosSV.m:42)."""
        eph, _ = self.decode()
        svs = navdecode.usable_svs(eph)
        stem = (f"nacquired_{self.cfg.file.name}"
                f"_{self.cfg.file.skip_ms}.npz")
        if self.dir and not self._have(stem):
            acq = self.acquisition()
            ch = [acq.channel_index(p) for p in svs]
            self._save_npz(stem, sv=np.asarray(svs), snr_db=acq.snr_db[ch],
                           doppler_hz=acq.doppler_hz[ch],
                           code_delay=acq.code_delay[ch],
                           fine_freq_hz=acq.fine_freq_hz[ch])
        return svs

    @staticmethod
    def _init_token(init_pos_ecef) -> str:
        if init_pos_ecef is None:
            return "def"
        h = hashlib.sha1(np.asarray(init_pos_ecef, np.float64).tobytes())
        return h.hexdigest()[:8]

    def ct_position(self, n_ms: Optional[int] = None,
                    init_pos_ecef: Optional[np.ndarray] = None,
                    multicorr: Optional[bool] = None, chunk_ms: int = 1000,
                    pdi_switch_ms: Optional[int] = None,
                    countinx: Optional[np.ndarray] = None):
        """Stage 5 (SDR_main.m:110-115): CT-POS tracking + WLS positioning.

        Re-tracks the usable SVs with the POS correlator configuration
        (the 25-tap bank if `multicorr`; default cmn.multicorr_ct), then
        forms the WLS epochs.

        `pdi_switch_ms` (default cfg.track.ct_pdi_switch_ms) turns on the
        reference's per-channel coherent-integration switch
        (trackingCT_POS_updated.m:183,294): channel ch runs pdi = 1 ms for
        its first pdi_switch_ms + countinx[ch] record rows and pdi = 10 ms
        after (those blocks go through `tracking.track_scan`); `n_ms` then
        counts record rows, not signal ms.  `countinx` overrides the
        detected offsets (ordered like the usable-SV list).
        Returns (TrackRecords, NavSolutions).
        """
        cfg = self.cfg
        if multicorr is None:
            multicorr = cfg.cmn.multicorr_ct
        if pdi_switch_ms is None:
            pdi_switch_ms = cfg.track.ct_pdi_switch_ms
        n_ms = n_ms or cfg.track.ms_ct_pos
        tag = "mc" if multicorr else "epl"
        key = (f"{tag}_{cfg.file.name}_{n_ms}"
               + (f"_sw{pdi_switch_ms}" if pdi_switch_ms else "")
               + ("" if countinx is None else
                  "_c" + "_".join(str(int(c)) for c in countinx))
               + f"_{self._init_token(init_pos_ecef)}")
        stem_t, stem_n = f"tckct_{key}.npz", f"navct_{key}.pkl"
        eph, sbf = self.decode()
        pos_svs = self.usable_svs()
        if len(pos_svs) < 4:
            raise ValueError(
                f"only {len(pos_svs)} SVs with complete ephemeris "
                f"({pos_svs}); positioning needs >= 4 — capture too short "
                "(< ~31 s of nav data) or signals too weak")
        acq = self.acquisition()
        if init_pos_ecef is None:
            init_pos_ecef = llh2xyz(np.asarray(cfg.solu.truth_llh)).numpy()
        if self._have(stem_t) and self._have(stem_n):
            return self._load_records(stem_t), self._load_pickle(stem_n)

        chans = [acq.channel_index(p) for p in pos_svs]
        state = init_track_state(cfg, acq.code_delay[chans],
                                 acq.fine_freq_hz[chans], self.device)
        mk = TrackParams.pos_multicorr if multicorr else TrackParams.pos_epl
        params1 = mk(cfg)
        if pdi_switch_ms is None:
            rec, _ = run_tracking(self.source, cfg, pos_svs, state, params1,
                                  n_ms, chunk_ms=chunk_ms)
            pdi_rows = 1
        else:
            cnt = np.asarray(countinx if countinx is not None
                             else self.countinx()[chans])
            sw = pdi_switch_ms + cnt               # (N,) rows at pdi = 1
            sw_max, sw_min = int(sw.max()), int(sw.min())
            if n_ms <= sw_max:
                raise ValueError(f"n_ms={n_ms} rows must exceed the last "
                                 f"pdi switch at row {sw_max}")
            rec1, _ = run_tracking(self.source, cfg, pos_svs, state, params1,
                                   sw_max, chunk_ms=chunk_ms)
            st2 = state_from_records(rec1, sw - 1, acq.fine_freq_hz[chans],
                                     params1.dll_freq_sign,
                                     cfg.signal.code_freq_basis, self.device)
            # run_tracking counts signal ms: (n_ms − sw_min)·10 of them at
            # pdi = 10 are n_ms − sw_min blocks, one record row each, the
            # most any channel's merge below consumes
            rec2, _ = run_tracking(self.source, cfg, pos_svs, st2,
                                   mk(cfg, pdi_ms=10), (n_ms - sw_min) * 10,
                                   chunk_ms=chunk_ms)
            merged = {f: np.stack(
                [np.concatenate([getattr(rec1, f)[:sw[ch], ch],
                                 getattr(rec2, f)[:n_ms - sw[ch], ch]])
                 for ch in range(len(pos_svs))], axis=1)
                for f in _REC_FIELDS}
            rec = TrackRecords(**merged, i_early=params1.i_early,
                               i_prompt=params1.i_prompt,
                               i_late=params1.i_late)
            pdi_rows = np.where(np.arange(n_ms)[:, None] < sw[None, :], 1, 10)
        nav: NavSolutions = run_ct_positioning(rec, cfg, pos_svs, eph, sbf,
                                               init_pos_ecef,
                                               pdi_ms_per_block=pdi_rows)
        self._save_records(stem_t, rec)
        self._save_pickle(stem_n, nav)
        return rec, nav

    def _vt_stem(self, n_ms: Optional[int] = None,
                 ct_n_ms: Optional[int] = None,
                 init_pos_ecef: Optional[np.ndarray] = None,
                 multicorr: Optional[bool] = None,
                 replica: str = "auto", **_ignored) -> str:
        """Artifact stem of a vt_position result for the given kwargs (the
        JAX package's; `replica` only names the artifact there and here)."""
        cfg = self.cfg
        if multicorr is None:
            multicorr = cfg.cmn.multicorr_vt
        n_ms = n_ms or cfg.track.ms_vt
        return (f"navvt2_{'mc_' if multicorr else ''}{cfg.file.name}"
                f"_{n_ms}_{ct_n_ms or 'def'}"
                + ("" if replica == "auto" else f"_{replica}")
                + f"_{self._init_token(init_pos_ecef)}.pkl")

    def vt_position(self, n_ms: Optional[int] = None,
                    ct_n_ms: Optional[int] = None,
                    init_pos_ecef: Optional[np.ndarray] = None,
                    multicorr: Optional[bool] = None,
                    chunk_ms: int = 1000, replica: str = "auto"):
        """Stage 6 (SDR_main.m:94-99): vector tracking + EKF, warm-started
        from the CT stage (trackingVT_POS_updated.m:66-70,109-132).

        `multicorr` selects the 29-tap recording bank
        (trackingVT_POS_updated_multicorrelator.m:26); default from
        cmn.multicorr_vt.  The port has one correlator engine
        (`ops/corr_bank`), so `replica` only keys the artifact, as the JAX
        package's stems do.  Returns (VTTrackRecords, VTSolutions).
        """
        cfg = self.cfg
        if multicorr is None:
            multicorr = cfg.cmn.multicorr_vt
        n_ms = n_ms or cfg.track.ms_vt
        stem = self._vt_stem(n_ms=n_ms, ct_n_ms=ct_n_ms,
                             init_pos_ecef=init_pos_ecef,
                             multicorr=multicorr, replica=replica)
        if self._have(stem):
            return self._load_pickle(stem)
        eph, sbf = self.decode()
        pos_svs = self.usable_svs()
        if init_pos_ecef is None:
            init_pos_ecef = llh2xyz(np.asarray(cfg.solu.truth_llh)).numpy()
        ct_rec, ct_nav = self.ct_position(n_ms=ct_n_ms,
                                          init_pos_ecef=init_pos_ecef,
                                          chunk_ms=chunk_ms)

        # warm-start PVT from the CT epoch at skiptime_vt
        epoch0 = cfg.file.skiptime_vt_ms // cfg.solu.nav_sol_period_ms - 1
        est_pos = ct_nav.usr_pos[epoch0]
        est_vel = ct_nav.usr_vel[epoch0]
        clk_bias = float(ct_nav.clk_bias_m[epoch0])
        clk_drift = float(ct_nav.clk_drift_ms[epoch0])

        # per-channel NCO handoff at first-subframe + skiptime_vt ms
        start_slot = {}
        tt0 = np.empty(len(pos_svs))
        for ch, p in enumerate(pos_svs):
            first_sf_ms = sbf["nav1"][p] + eph[p].sfb[0] * 20
            slot = first_sf_ms + cfg.file.skiptime_vt_ms - 1  # 0-based row
            start_slot[ch] = slot
            tt0[ch] = (eph[p].tow[0] + (slot + 1 - first_sf_ms) / 1000.0
                       + ct_rec.rem_chip[slot, ch]
                       / cfg.signal.code_freq_basis)
        vt_kw = dict(remove_dc=cfg.file.data_precision == 2,
                     pll_bw_hz=cfg.track.pll_bw_hz,
                     pll_damping=cfg.track.pll_damping,
                     pll_gain=cfg.track.pll_gain, replica=replica)
        params = (VTParams.multicorr(**vt_kw) if multicorr
                  else VTParams(**vt_kw))
        state = init_vt_state(cfg, ct_rec, list(range(len(pos_svs))),
                              start_slot, tt0, est_pos, est_vel, clk_bias,
                              clk_drift, params, self.device)
        eph_struct = Ephemeris.stack([eph[p].latest(0) for p in pos_svs],
                                     self.device)
        trk, sol, _ = run_vector_tracking(
            self.source, cfg, pos_svs, eph_struct, state, params, n_ms,
            init_pos_ecef, chunk_ms=chunk_ms)
        self._save_pickle(stem, (trk, sol))
        return trk, sol

    def position(self, **kw):
        """Mode dispatch (SDR_main.m:73-121 on solu.mode / cmn.vtEnable):
        mode 0 → WLS (CT) solutions; mode 2 (with cmn.vt_enable) → VT/EKF
        warm-started from CT.  Mode 1, the legacy position-domain EKF
        (`ct_position_kf`), is not ported yet."""
        if self.cfg.solu.mode == 2 and self.cfg.cmn.vt_enable:
            return self.vt_position(**kw)
        if self.cfg.solu.mode == 1:
            raise NotImplementedError(
                "solu.mode == 1 (the legacy position-domain EKF, "
                "ct_position_kf) is not ported yet")
        return self.ct_position(**kw)
