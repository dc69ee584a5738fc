"""Receiver pipeline orchestration with artifact checkpointing.

Equivalent of the reference driver `SDR_main.m` on the main path:
acquisition → eph tracking → nav decode → usable-SV filter → CT-POS
tracking + WLS, every stage output checkpointed in the caller's
`artifact_dir` and skipped when the artifact already exists
(SDR_main.m:21-27,34-61); then the legacy position filter (mode 1), the
reference's `.mat` artifact chain and the result plots.  Artifacts carry
the JAX package's stems and schemas; every write is atomic (temp file,
then `os.replace`), so an interrupted or concurrent run never leaves a
truncated artifact behind.  Pickles carry the port's tag: the port loads
only the pickles it wrote itself.
"""

from __future__ import annotations

import glob
import hashlib
import os
import pickle
import pickletools
import re
import tempfile
from typing import Dict, Optional

import numpy as np
import torch

from gps_sdr_tpu_torch import navdecode
from gps_sdr_tpu_torch.acquisition import AcquisitionResult, run_acquisition
from gps_sdr_tpu_torch.config import ReceiverConfig
from gps_sdr_tpu_torch.geo.coords import llh2xyz
from gps_sdr_tpu_torch.geo.ephemeris import Ephemeris
from gps_sdr_tpu_torch.io.ifdata import IFSampleSource
from gps_sdr_tpu_torch.parallel.mesh import resolve_mesh
from gps_sdr_tpu_torch.parallel.time_segments import run_tracking_segmented
from gps_sdr_tpu_torch.receiver.ct import NavSolutions, run_ct_positioning
from gps_sdr_tpu_torch.receiver.ct_legacy import run_ct_positioning_kf
from gps_sdr_tpu_torch.receiver.vt import (VTParams, init_vt_state,
                                           run_vector_tracking)
from gps_sdr_tpu_torch.tracking import (_REC_FIELDS, TrackParams,
                                        TrackRecords, init_track_state,
                                        run_tracking, state_from_records)
from gps_sdr_tpu_torch.utils.device import resolve_device
from gps_sdr_tpu_torch.utils.metrics import cn0_series

# written ahead of every pickle the Receiver saves; a pickle without it was
# not written by this package and is not unpickled
PICKLE_TAG = b"gps_sdr_tpu_torch artifact pickle 1\n"
# pull-in halo of each segment of a time-segmented eph stage (the JAX
# package's run_tracking_segmented default, which its Receiver uses)
SEGMENT_HALO_MS = 400


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


def _pickle_writer(data: bytes) -> str:
    """The package of the first class a pickle names, read from its opcodes
    without unpickling anything."""
    strings = []
    try:
        for op, arg, _ in pickletools.genops(data):
            if op.name in ("GLOBAL", "INST"):
                return arg.split()[0].split(".")[0]
            if op.name == "STACK_GLOBAL" and len(strings) >= 2:
                return strings[-2].split(".")[0]
            if isinstance(arg, str):
                strings.append(arg)
    except ValueError:
        pass
    return "an unknown writer"


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
    card unless `device` says otherwise (`device="cpu"` for the CPU); or,
    with a mesh, one rank of a world of them, each on its own device.

    Stage artifacts (mirroring SDR_main.m's .mat files):
      acquired_{name}_{skip}.npz    Acquired{sv,SNR,Doppler,codedelay,fineFreq}
      tckeph_{name}.npz             per-ms tracking records for nav decode
      tckeph_seg{D}_{halo}_{name}.npz   the same tracked in D time segments
      tckeph_ref_{name}_{n1}_{n10}_{min}.npz   the same from the reference's
                                    3-phase schedule (its own stem: a
                                    record is never taken for the other
                                    schedule's)
      countinx_{name}.npz           per-channel first bit transition
      eph_{name}.pkl                {prn: EphemerisRecord} + sbf{nav1,sfb1}
      nacquired_{name}_{skip}.npz   acquisition fields of the usable SVs
      tckct_{key}.npz / navct_{key}.pkl   CT-POS records + WLS solutions
      tckct_kf_{key}.npz / navct_kf_{key}.pkl   the legacy filter's
                                    records + NavSolutionsKF (mode 1)
      navvt2_{key}.pkl              (VTTrackRecords, VTSolutions)

    Every .pkl starts with `PICKLE_TAG`, then the pickle.  `_load_pickle`
    refuses a file without the tag (the JAX package's pickles under the
    same stems, and the untagged ones of the port's first versions) and
    names the package that wrote it, before unpickling anything.
    `decode` and `countinx` read the eph record on disk whichever schedule
    wrote it (serial, time-segmented or the reference's), and track only
    when there is none.
    """

    def __init__(self, cfg: ReceiverConfig, source: IFSampleSource,
                 artifact_dir: Optional[str] = None, device=None,
                 mesh="auto"):
        """`mesh`: "auto" (the default) is a mesh over the
        `torch.distributed` world when one of more than one rank is
        initialised (`parallel/mesh.resolve_mesh`), else None, a single
        device; or a `parallel.mesh.Mesh`, or None.  With a mesh every rank
        runs the same calls: acquisition shards the PRN axis, tracking and
        vector tracking the channel axis (bit for bit the single-device
        records), every WLS epoch reduces its normal equations over the
        ranks (`parallel/`); every rank ends a stage holding the full
        results, and rank 0 alone writes the artifacts while the others
        wait.  The device defaults to the mesh's (the rank's card)."""
        self.cfg = cfg
        self.source = source
        self.dir = artifact_dir
        self.mesh = resolve_mesh(mesh, device)
        self.device = (self.mesh.device if self.mesh is not None
                       and device is None else resolve_device(device))
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
        return self._agree(p is not None and os.path.exists(p))

    def _agree(self, found):
        """What rank 0 found on disk, on every rank (without a mesh,
        `found`): what is there decides each rank's next step, and rank 0
        may have written there before a slower rank looks."""
        return found if self.mesh is None else self.mesh.broadcast(found)

    def _writer(self) -> bool:
        """Whether this process writes files: rank 0 of a mesh, or the one
        process without."""
        return self.mesh is None or self.mesh.rank == 0

    def _written(self) -> None:
        """With a mesh, every rank waits here until rank 0 has written."""
        if self.mesh is not None:
            self.mesh.barrier()

    def _write(self, stem: str, write) -> None:
        if self.dir:
            if self._writer():
                _atomic_write(self._path(stem), write)
            self._written()

    def _save_npz(self, stem: str, **arrays) -> None:
        self._write(stem, lambda f: np.savez(f, **arrays))

    def _save_pickle(self, stem: str, obj) -> None:
        def write(f):
            f.write(PICKLE_TAG)
            pickle.dump(obj, f)
        self._write(stem, write)

    def _load_pickle(self, stem: str):
        path = self._path(stem)
        with open(path, "rb") as f:
            data = f.read()
        if not data.startswith(PICKLE_TAG):
            writer = _pickle_writer(data)
            raise ValueError(
                f"{path}: this pickle was written by {writer}, without the "
                "gps_sdr_tpu_torch tag; it is not this package's artifact "
                "and is not loaded (the JAX package gps_sdr_tpu writes its "
                "own pickles under the same stems, and the port's early "
                "versions wrote untagged ones) — give this Receiver an "
                "artifact_dir of its own")
        return pickle.loads(data[len(PICKLE_TAG):])

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
            power_fn = None
            if self.mesh is not None:
                from gps_sdr_tpu_torch.parallel.acquisition import (
                    sharded_acquisition_power)
                power_fn = sharded_acquisition_power(self.mesh)
            self._acq = run_acquisition(self.source, self.cfg,
                                        device=self.device, power_fn=power_fn)
            a = self._acq
            self._save_npz(stem, sv=a.sv, snr_db=a.snr_db,
                           doppler_hz=a.doppler_hz, code_delay=a.code_delay,
                           fine_freq_hz=a.fine_freq_hz)
        return self._acq

    def track_for_eph(self, n_ms: Optional[int] = None,
                      chunk_ms: int = 1000,
                      n_segments: int = 1) -> TrackRecords:
        """Stage 2 (SDR_main.m:38): 1 ms E/P/L tracking long enough to
        decode the ephemerides (≥ ~31 s of bits).

        `n_segments > 1` tracks with overlap-save time parallelism
        (`parallel/time_segments`): D segments with a halo of
        `SEGMENT_HALO_MS` each, (channel × segment) as one batch over the
        capture held on the device.  Its record has a stem of its own,
        `tckeph_seg{D}_{halo}_{name}.npz` (the JAX package writes it under
        the serial stem), so a later Receiver never takes one schedule's
        record for the other's."""
        if self._eph_records is not None:
            return self._eph_records
        stem = (f"tckeph_{self.cfg.file.name}.npz" if n_segments == 1 else
                self._seg_stem(n_segments, SEGMENT_HALO_MS))
        if self._have(stem):
            self._eph_records = self._load_records(stem)
            return self._eph_records
        acq = self.acquisition()
        n_ms = n_ms or (self.cfg.track.ms_eph_1ms + self.cfg.track.ms_eph_10ms)
        params = TrackParams.epl(self.cfg)
        if n_segments > 1:
            rec = run_tracking_segmented(
                self.source, self.cfg, list(acq.sv), acq.code_delay,
                acq.fine_freq_hz, params, n_ms, n_segments=n_segments,
                halo_ms=SEGMENT_HALO_MS, chunk_ms=chunk_ms,
                device=self.device)
        else:
            state = init_track_state(self.cfg, acq.code_delay,
                                     acq.fine_freq_hz, self.device)
            rec, _ = run_tracking(self.source, self.cfg, list(acq.sv), state,
                                  params, n_ms, chunk_ms=chunk_ms,
                                  mesh=self.mesh)
        self._eph_records = rec
        self._save_records(stem, rec)
        return rec

    def _seg_stem(self, n_segments: int, halo_ms: int) -> str:
        return f"tckeph_seg{n_segments}_{halo_ms}_{self.cfg.file.name}.npz"

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
        stem = f"{self._ref_prefix()}{min_transition_index}.npz"
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
                                params1, n1, chunk_ms=chunk_ms,
                                mesh=self.mesh)
        cnt = np.array([detect_bit_transition(
            rec_a.p_i[:, ch], min_index=min_transition_index)
            for ch in range(n_ch)])
        cnt_max = int(cnt.max())

        # (b) re-track to the latest switch point
        rec_b, _ = run_tracking(self.source, cfg, prns, fresh_state(),
                                params1, n1 + cnt_max, chunk_ms=chunk_ms,
                                mesh=self.mesh)

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
            chunk_ms=chunk_ms, mesh=self.mesh)

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

    def _ref_prefix(self) -> str:
        """Stem of the reference schedule's records, up to the
        min_transition_index that ends it."""
        t = self.cfg.track
        return (f"tckeph_ref_{self.cfg.file.name}"
                f"_{t.ms_eph_1ms}_{t.ms_eph_10ms}_")

    def _decode_records(self) -> TrackRecords:
        """The eph record `decode` and `countinx` read: this Receiver's
        own, else the one on disk, whichever schedule wrote it
        (`tckeph_{name}.npz`, `tckeph_seg{D}_{halo}_{name}.npz` or
        `tckeph_ref_…`); the plain schedule is tracked only when there is
        none.  Two records on disk and none built here is ambiguous and
        raises."""
        if self._eph_records is not None:
            return self._eph_records
        stems = [s for s in [f"tckeph_{self.cfg.file.name}.npz"]
                 if self._have(s)]
        if self.dir:
            def on_disk(prefix, suffix, key):
                found = (os.path.basename(p) for p in glob.glob(os.path.join(
                    glob.escape(self.dir), glob.escape(prefix) + "*"
                    + glob.escape(suffix))))
                return sorted(f for f in found
                              if key(f[len(prefix):len(f) - len(suffix)]))
            stems += on_disk("tckeph_seg", f"_{self.cfg.file.name}.npz",
                             lambda k: re.fullmatch(r"\d+_\d+", k))
            stems += on_disk(self._ref_prefix(), ".npz", str.isdigit)
        stems = self._agree(stems)
        if len(stems) > 1:
            raise RuntimeError(
                f"{self.dir} holds eph records of more than one schedule "
                f"({', '.join(stems)}) and this Receiver built none of them: "
                "call track_for_eph() (with the n_segments that wrote the "
                "record) or track_for_eph_reference() first to say which "
                "one to decode")
        if stems:
            self._eph_records = self._load_records(stems[0])
            return self._eph_records
        return self.track_for_eph()

    def countinx(self, min_transition_index: int = 600) -> np.ndarray:
        """Per-channel first-bit-transition offsets, ordered like acq.sv
        (the reference persists these as countinx.mat, trackingCT.m:530)."""
        acq = self.acquisition()
        stem = f"countinx_{self.cfg.file.name}.npz"
        if self._have(stem):
            return np.load(self._path(stem))["countinx"]
        rec = self._decode_records()
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
        rec = self._decode_records()
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
                                  n_ms, chunk_ms=chunk_ms, mesh=self.mesh)
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
                                   sw_max, chunk_ms=chunk_ms, mesh=self.mesh)
            st2 = state_from_records(rec1, sw - 1, acq.fine_freq_hz[chans],
                                     params1.dll_freq_sign,
                                     cfg.signal.code_freq_basis, self.device)
            # run_tracking counts signal ms: (n_ms − sw_min)·10 of them at
            # pdi = 10 are n_ms − sw_min blocks, one record row each, the
            # most any channel's merge below consumes
            rec2, _ = run_tracking(self.source, cfg, pos_svs, st2,
                                   mk(cfg, pdi_ms=10), (n_ms - sw_min) * 10,
                                   chunk_ms=chunk_ms, mesh=self.mesh)
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
                                               pdi_ms_per_block=pdi_rows,
                                               mesh=self.mesh)
        self._save_records(stem_t, rec)
        self._save_pickle(stem_n, nav)
        return rec, nav

    def ct_position_kf(self, n_ms: Optional[int] = None,
                       init_pos_ecef: Optional[np.ndarray] = None,
                       epoch_ms: Optional[int] = None,
                       chunk_ms: int = 1000):
        """The legacy stage (trackingCT_POS.m, `solu.mode == 1`): 1 ms
        CT-POS E/P/L tracking of the usable SVs (`track_chunk`, one launch
        a chunk on the card), then the per-epoch position-domain 8-state
        EKF over relative pseudoranges (receiver/ct_legacy.py).  Returns
        (TrackRecords, NavSolutionsKF)."""
        cfg = self.cfg
        n_ms = n_ms or cfg.track.ms_ct_pos
        key = (f"kf_{cfg.file.name}_{n_ms}_{epoch_ms or 'def'}"
               f"_{self._init_token(init_pos_ecef)}")
        stem_t, stem_n = f"tckct_{key}.npz", f"navct_{key}.pkl"
        eph, sbf = self.decode()
        pos_svs = self.usable_svs()
        if len(pos_svs) < 4:
            raise ValueError(f"only {len(pos_svs)} usable SVs ({pos_svs}); "
                             "positioning needs >= 4")
        acq = self.acquisition()
        if init_pos_ecef is None:
            init_pos_ecef = llh2xyz(np.asarray(cfg.solu.truth_llh)).numpy()
        if self._have(stem_t) and self._have(stem_n):
            return self._load_records(stem_t), self._load_pickle(stem_n)
        chans = [acq.channel_index(p) for p in pos_svs]
        state = init_track_state(cfg, acq.code_delay[chans],
                                 acq.fine_freq_hz[chans], self.device)
        rec, _ = run_tracking(self.source, cfg, pos_svs, state,
                              TrackParams.pos_epl(cfg), n_ms,
                              chunk_ms=chunk_ms, mesh=self.mesh)
        nav = run_ct_positioning_kf(rec, cfg, pos_svs, eph, sbf,
                                    init_pos_ecef, epoch_ms=epoch_ms)
        self._save_records(stem_t, rec)
        self._save_pickle(stem_n, nav)
        return rec, nav

    def _vt_stem(self, n_ms: Optional[int] = None,
                 ct_n_ms: Optional[int] = None,
                 init_pos_ecef: Optional[np.ndarray] = None,
                 multicorr: Optional[bool] = None,
                 replica: str = "auto", **_ignored) -> str:
        """Artifact stem of a vt_position result for the given kwargs (the
        JAX package's; `replica` only names the artifact there and here),
        shared by vt_position's cache and export_mat's has-VT-run check."""
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
        # the caller's start position, None included, so that the CT stage
        # is found under the key it was written with (the JAX package
        # resolves the default first and tracks CT again under a hashed
        # key); the default is resolved for this stage's own use after
        ct_rec, ct_nav = self.ct_position(n_ms=ct_n_ms,
                                          init_pos_ecef=init_pos_ecef,
                                          chunk_ms=chunk_ms)
        if init_pos_ecef is None:
            init_pos_ecef = llh2xyz(np.asarray(cfg.solu.truth_llh)).numpy()

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
            init_pos_ecef, chunk_ms=chunk_ms, mesh=self.mesh)
        self._save_pickle(stem, (trk, sol))
        return trk, sol

    def position(self, **kw):
        """Mode dispatch (SDR_main.m:73-121 on solu.mode / cmn.vtEnable):
        mode 0 → WLS (CT) solutions; mode 1 → the legacy position-domain
        EKF over relative pseudoranges (`ct_position_kf`); mode 2 (with
        cmn.vt_enable) → VT/EKF warm-started from CT."""
        if self.cfg.solu.mode == 2 and self.cfg.cmn.vt_enable:
            return self.vt_position(**kw)
        if self.cfg.solu.mode == 1:
            return self.ct_position_kf(**kw)
        return self.ct_position(**kw)

    def export_mat(self, out_dir: str, ct_kw: Optional[Dict] = None,
                   vt: Optional[bool] = None,
                   vt_kw: Optional[Dict] = None) -> None:
        """Write the stage artifacts as MATLAB `.mat` files in the
        reference's schemas (SDR_main.m's chain: nAcquired / eph / sbf /
        tckRstCT / navSolCT, plus tckRstVT / navSolVT when the VT stage
        runs, trackingVT_POS_updated.m:532-533), so reference users keep
        their MATLAB tooling; `io/matref` loads them back.

        `vt`: None (default) exports the VT chain when the configured mode
        runs VT (solu.mode == 2 with cmn.vt_enable, SDR_main.m:73) and the
        VT stage has already run for `vt_kw` (its artifact is on disk), so
        a CT export never starts vector tracking by itself; True exports it
        (running the stage if needed); False skips it.  With a mesh every
        rank runs the stages and rank 0 writes the files."""
        cfg = self.cfg
        eph, sbf = self.decode()
        pos_svs = self.usable_svs()
        acq = self.acquisition()
        rec, nav = self.ct_position(**(ct_kw or {}))
        if vt is None:
            vt = (cfg.solu.mode == 2 and cfg.cmn.vt_enable
                  and self._have(self._vt_stem(**(vt_kw or {}))))
        vt_res = self.vt_position(**(vt_kw or {})) if vt else None
        if self._writer():
            self._write_mat(out_dir, eph, sbf, pos_svs, acq, rec, nav, vt_res,
                            vt_kw)
        self._written()

    def _write_mat(self, out_dir, eph, sbf, pos_svs, acq, rec, nav, vt_res,
                   vt_kw) -> None:
        """The `.mat` files of `export_mat` from the stages' results."""
        from gps_sdr_tpu_torch.io import matref

        os.makedirs(out_dir, exist_ok=True)
        cfg = self.cfg
        ch = [acq.channel_index(p) for p in pos_svs]
        name = cfg.file.name
        matref.save_nacquired_mat(
            os.path.join(out_dir, f"nAcquired_{name}_{cfg.file.skip_ms}.mat"),
            pos_svs, acq.snr_db[ch], acq.doppler_hz[ch],
            acq.code_delay[ch], acq.fine_freq_hz[ch])
        matref.save_eph_mat(
            os.path.join(out_dir, f"eph_{name}.mat"), eph, sbf=sbf,
            sbf_path=os.path.join(out_dir, f"sbf_{name}.mat"))
        # each row's coherent time from the block sizes (the records carry
        # the per-channel pdi 1 → 10 ms switch when it is on); the C/N0
        # windows are normalized by it and the file tag is the final pdi,
        # as the reference's tckRstCT_10ms_* names it
        pdi_rows, _ = matref.pdi_from_block_sizes(
            rec.num_sample, cfg.signal.samples_per_ms)
        cn0 = cn0_series(rec.p_i, rec.p_q, t_coh_s=pdi_rows * 1e-3)
        tag = int(pdi_rows.max())
        matref.save_tck_records_mat(
            os.path.join(out_dir, f"tckRstCT_{tag}ms_{name}.mat"), rec,
            pos_svs, bytes_per_sample=cfg.file.bytes_per_sample,
            cn0_ct=cn0, samples_per_ms=cfg.signal.samples_per_ms)
        matref.save_navsol_mat(
            os.path.join(out_dir, f"navSolCT_{tag}ms_{name}.mat"), nav)

        if vt_res is not None:
            vt_trk, vt_sol = vt_res
            multicorr = (vt_kw or {}).get("multicorr")
            if multicorr is None:
                multicorr = cfg.cmn.multicorr_vt
            p = VTParams.multicorr() if multicorr else VTParams()
            # CN0_VT: one row per moment-estimator window; the per-ms cn0
            # refreshes every cn0_window blocks, so the fresh values sit at
            # rows k·W − 1 (trackingVT_POS_updated.m:294-303)
            cn0_vt = vt_sol.cn0_dbhz[p.cn0_window - 1::p.cn0_window]
            matref.save_vt_records_mat(
                os.path.join(out_dir, f"tckRstVT_{name}_updated.mat"),
                vt_trk, pos_svs,
                bytes_per_sample=cfg.file.bytes_per_sample,
                samples_per_ms=cfg.signal.samples_per_ms,
                cn0_vt=cn0_vt, i_early=p.i_early, i_prompt=p.i_prompt,
                i_late=p.i_late)
            matref.save_navsol_vt_mat(
                os.path.join(out_dir, f"navSolVT_{name}_updated.mat"),
                vt_sol, eph={q: eph[q] for q in pos_svs},
                trk=vt_trk, r_update_ms=p.r_update_ms)

    def report(self, out_dir: str, vt: bool = True,
               ct_kw: Optional[Dict] = None,
               vt_kw: Optional[Dict] = None) -> None:
        """Stage 7: the Task 1-5 result plots (Plot_task_1..5.m) and the
        channel dashboards as PNG files, and the decoded-ephemeris CSV
        (Task_3_table.m).  Needs matplotlib: without it the plots raise
        its ImportError.  With a mesh rank 0 writes the files."""
        from gps_sdr_tpu_torch.analysis import plots
        from gps_sdr_tpu_torch.utils.metrics import export_ephemeris_table

        acq = self.acquisition()
        eph, _ = self.decode()
        pos_svs = self.usable_svs()
        truth = llh2xyz(np.asarray(self.cfg.solu.truth_llh)).numpy()
        rec, nav = self.ct_position(**(ct_kw or {}))
        vt_sol = vt_trk = None
        if vt:
            vt_trk, vt_sol = self.vt_position(**(vt_kw or {}))
        if self._writer():
            plots.save_all(acq=acq, records=rec, prns=pos_svs, eph=eph,
                           nav=nav, vt_sol=vt_sol, truth_ecef=truth,
                           out_dir=out_dir, vt_trk=vt_trk)
            export_ephemeris_table(
                eph, os.path.join(out_dir, "task3_ephemeris.csv"), pos_svs)
        self._written()
