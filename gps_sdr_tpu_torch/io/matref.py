"""MATLAB `.mat` artifacts in and out, in the reference's schemas.

The reference writes every stage's output as MATLAB save files
(`tckRstCT_10ms_Opensky.mat`, `navSolCT_10ms_Opensky.mat`, `eph_*_90.mat`,
`sbf_*_90.mat`, `nAcquired_*_5000.mat`, `tckRstVT_*`, `navSolVT_*`).  The
loaders map them onto this package's structures, so the positioning stage
can be replayed from the reference's own tracked records; the writers
export this package's results so reference users keep their MATLAB
tooling.  Host numpy; `scipy.io` is imported inside each function, so the
package imports without scipy.

Unit conventions (trackingCT_POS_updated.m):
- `absoluteSample` is an `ftell` BYTE offset (…:286); native records use
  sample indices, so the loader divides by dataType·dataPrecision
  (2 bytes/complex-int8-sample for the Opensky front end,
  initParameters.m:37-38).
- per-channel coherent length is not stored; it is recovered from
  `numSample` (≈ S → pdi 1 ms, ≈ 10·S → pdi 10 ms; …:183,294).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np

from gps_sdr_tpu_torch.geo.earth import earth_rotation_correction
from gps_sdr_tpu_torch.navdecode import EphemerisRecord
from gps_sdr_tpu_torch.receiver.vt import VTTrackRecords
from gps_sdr_tpu_torch.tracking import TrackRecords

# eph_*.mat field name → EphemerisRecord attribute (ini_eph.m:19-55;
# NB the reference names Ω₀ "omegae" and URA "N")
_EPH_FIELD_MAP = {
    "TOW": "tow", "TOW1": "tow1", "sfb": "sfb", "sfb1": "sfb1",
    "weeknum": "weeknum", "N": "ura", "health": "health", "IODC": "iodc",
    "TGD": "tgd", "toc": "toc", "af2": "af2", "af1": "af1", "af0": "af0",
    "IODE2": "iode2", "Crs": "crs", "deltan": "deltan", "M0": "m0",
    "Cuc": "cuc", "ecc": "ecc", "Cus": "cus", "sqrta": "sqrta",
    "toe": "toe", "Cic": "cic", "omegae": "omega0", "Cis": "cis",
    "i0": "i0", "Crc": "crc", "w": "w", "omegadot": "omegadot",
    "IODE3": "iode3", "idot": "idot", "updatetime": "updatetime_ms",
    "updatetime_tow": "updatetime_tow",
}


def _cell(v) -> np.ndarray:
    """Flatten a loadmat cell/matrix field to a 1-D array (unwrapping
    the 0-d object scalars squeeze_me leaves around struct fields)."""
    v = np.asarray(v)
    while v.dtype == object and v.ndim == 0:
        v = np.asarray(v[()])
    return np.atleast_1d(v.squeeze())


def pdi_from_block_sizes(num_sample: np.ndarray,
                         samples_per_ms: float | None = None
                         ) -> Tuple[np.ndarray, float]:
    """Recover the per-row coherent-integration length (pdi, in ms)
    from tracked block sizes (T, N) — the single implementation behind
    the loader, the saver, and Receiver.export_mat.

    With `samples_per_ms` (exact, e.g. cfg.signal.samples_per_ms) the
    recovery is exact.  Without it, the base (pdi=1) block is estimated
    as the smallest per-channel 10th-percentile size — robust to later
    10 ms rows as long as ≥10% of each channel's rows are pdi=1 (NOT
    guaranteed for long runs past the reference's 1→10 ms switch, which
    is why callers that know the config must pass it).
    """
    if samples_per_ms is None:
        s0 = float(np.round(np.min(
            np.percentile(num_sample, 10, axis=0))))
        pdi0 = np.clip(np.round(num_sample / s0), 1, None)
        samples_per_ms = float(np.round(np.median(num_sample / pdi0)))
    s = float(samples_per_ms)
    pdi = np.clip(np.round(num_sample / s), 1, None).astype(np.int64)
    # consistency check: block sizes only wobble by the code-NCO drift
    # (a few samples per ms of Doppler), so |numSample − pdi·s| beyond
    # ~1e-4·s per coherent ms means the recovery is wrong (the silent
    # failure mode of the percentile heuristic when <10% of a channel's
    # rows are pdi=1 — downstream C/N0 normalization and epoch
    # interpolation would be corrupted without this guard)
    resid = np.max(np.abs(num_sample - pdi * s) / pdi)
    if resid > max(4.0, 2e-4 * s):
        import warnings
        warnings.warn(
            f"pdi_from_block_sizes: residual {resid:.1f} samples/ms vs "
            f"base block {s:.0f} — the pdi recovery is inconsistent; "
            "pass the exact samples_per_ms (cfg.signal.samples_per_ms)",
            stacklevel=2)
    return pdi, s


def load_tck_records(path: str, prns: Sequence[int],
                     bytes_per_sample: int = 2,
                     samples_per_ms: float | None = None
                     ) -> Tuple[TrackRecords, np.ndarray]:
    """`tckRstCT_*` → (TrackRecords, pdi_ms (T, N)).

    `prns` selects and orders the channels (the .mat struct is indexed
    by PRN, 1-based).  Correlator taps are ordered E/P/L to match
    TrackParams.pos_epl record conventions.
    """
    import scipy.io as sio

    m = sio.loadmat(path, squeeze_me=True)
    key = next(k for k in m if k.startswith("TckResult"))
    t = m[key]
    fields = ("E_i", "E_q", "P_i", "P_q", "L_i", "L_q", "carrError",
              "codeError", "codeFreq", "carrFreq", "numSample", "remChip",
              "remCarrPhase", "absoluteSample")
    per = {f: np.stack([np.asarray(t[p - 1][f], np.float64)
                        for p in prns], axis=1) for f in fields}
    T, N = per["P_i"].shape
    corr = np.stack([
        np.stack([per["E_i"], per["E_q"]], axis=-1),
        np.stack([per["P_i"], per["P_q"]], axis=-1),
        np.stack([per["L_i"], per["L_q"]], axis=-1)], axis=2)  # (T,N,3,2)
    rec = TrackRecords(
        corr=corr.astype(np.float32),
        code_err=per["codeError"], carr_err=per["carrError"],
        code_freq=per["codeFreq"], carr_freq=per["carrFreq"],
        num_sample=per["numSample"].astype(np.int64),
        rem_chip=per["remChip"], rem_phase=per["remCarrPhase"],
        absolute_sample=per["absoluteSample"] / bytes_per_sample,
        i_early=0, i_prompt=1, i_late=2)
    pdi, _ = pdi_from_block_sizes(per["numSample"], samples_per_ms)
    return rec, pdi


def load_eph(path: str) -> Dict[int, EphemerisRecord]:
    """`eph_*_90.mat` → {prn: EphemerisRecord} (SI-scaled, as the
    reference decodes them)."""
    import scipy.io as sio

    m = sio.loadmat(path, squeeze_me=True)
    eph_arr = m["eph"]
    out: Dict[int, EphemerisRecord] = {}
    for i in range(eph_arr.shape[0] if eph_arr.ndim else len(eph_arr)):
        row = eph_arr[i]
        rec = EphemerisRecord()
        for mat_name, attr in _EPH_FIELD_MAP.items():
            vals = _cell(row[mat_name])
            setattr(rec, attr, [float(v) for v in vals])
        flag = _cell(row["updateflag"])
        rec.updateflag = int(flag[0]) if flag.size else 0
        if len(rec.tow) or rec.updateflag:
            out[i + 1] = rec
    return out


def load_sbf(path: str) -> Dict[str, Dict[int, int]]:
    """`sbf_*_90.mat` → {"nav1": {prn: ms}, "sfb1": {prn: count}}
    (1-based conventions preserved, SURVEY.md §4)."""
    import scipy.io as sio

    m = sio.loadmat(path, squeeze_me=True)
    sbf = m["sbf"]
    nav1 = _cell(sbf["nav1"])
    sfb1 = _cell(sbf["sfb1"])
    return {"nav1": {p + 1: int(v) for p, v in enumerate(nav1)},
            "sfb1": {p + 1: int(v) for p, v in enumerate(sfb1)}}


def load_nacquired(path: str):
    """`nAcquired_*.mat` → dict of arrays {sv, snr_db, doppler_hz,
    code_delay, fine_freq_hz}."""
    import scipy.io as sio

    m = sio.loadmat(path, squeeze_me=True)
    na = m["nAcquired"]
    return dict(sv=_cell(na["sv"]).astype(int),
                snr_db=_cell(na["SNR"]).astype(float),
                doppler_hz=_cell(na["Doppler"]).astype(float),
                code_delay=_cell(na["codedelay"]).astype(int),
                fine_freq_hz=_cell(na["fineFreq"]).astype(float))


@dataclasses.dataclass
class RefNavSolutions:
    """navSolCT_* fields, epochs × channels."""

    raw_pseudorange: np.ndarray
    usr_pos: np.ndarray
    usr_vel: np.ndarray
    usr_pos_enu: np.ndarray
    usr_pos_llh: np.ndarray
    clk_bias_m: np.ndarray
    usr_vel_enu: np.ndarray
    clk_drift_ms: np.ndarray
    dop: np.ndarray
    sat_el_deg: np.ndarray
    sat_az_deg: np.ndarray
    transmit_time: np.ndarray
    code_phase_meas: np.ndarray
    local_time: np.ndarray


def load_navsol(path: str) -> RefNavSolutions:
    import scipy.io as sio

    m = sio.loadmat(path, squeeze_me=True)
    key = next(k for k in m if k.startswith("navSolutions"))
    n = m[key]
    g = {f: np.asarray(n[f][()]) for f in n.dtype.names}
    return RefNavSolutions(
        raw_pseudorange=g["rawPseudorange"], usr_pos=g["usrPos"],
        usr_vel=g["usrVel"], usr_pos_enu=g["usrPosENU"],
        usr_pos_llh=g["usrPosLLH"], clk_bias_m=g["clkBias"],
        usr_vel_enu=g["usrVelENU"], clk_drift_ms=g["clkDrift"],
        dop=g["DOP"], sat_el_deg=g["satEA"], sat_az_deg=g["satAZ"],
        transmit_time=g["timeTransmit"], code_phase_meas=g["codePhaseMeas"],
        local_time=g["localTime"])


def save_tck_records_mat(path: str, rec: TrackRecords,
                         prns: Sequence[int], max_prn: int = 32,
                         bytes_per_sample: int = 2,
                         cn0_ct: np.ndarray | None = None,
                         samples_per_ms: int | None = None) -> None:
    """Export TrackRecords as a reference-schema `tckRstCT_*`-style .mat:
    a 1×max_prn `TckResultCT_pos` struct array with the 18 per-ms fields
    MATLAB users of the reference load (SURVEY.md §4), absoluteSample
    converted back to ftell byte offsets.  Fields this build does not
    keep (absoluteSampleCodedelay, codedelay, codedelay2, delayValue)
    are derived: codedelay = mod(abs_bytes/dataType, S) as the reference
    computes it (trackingVT_POS_updated.m:345), delayValue =
    numSample − round(mean) per channel."""
    import scipy.io as sio

    T = rec.absolute_sample.shape[0]
    empty = np.zeros(0)
    rows = {p: i for i, p in enumerate(prns)}
    # base (pdi=1) block size — the codedelay modulus is ALWAYS the 1 ms
    # size (reference mods by fs·ms, trackingVT_POS_updated.m:345) even
    # for 10 ms rows; pass samples_per_ms for exactness (per-block sizes
    # jitter ±few samples with the code NCO, so an estimate can be off
    # by 1-2 and delayValue scales that by pdi)
    pdi, s_per_ms = pdi_from_block_sizes(rec.num_sample, samples_per_ms)
    out = np.zeros((1, max_prn), dtype=[
        (n, object) for n in (
            "E_i", "E_q", "P_i", "P_q", "L_i", "L_q", "carrError",
            "codeError", "codeFreq", "carrFreq", "numSample", "remChip",
            "remCarrPhase", "absoluteSample", "absoluteSampleCodedelay",
            "codedelay", "codedelay2", "delayValue")])
    for p in range(1, max_prn + 1):
        if p in rows:
            ch = rows[p]
            abs_b = rec.absolute_sample[:, ch] * bytes_per_sample
            cd = np.mod(abs_b / bytes_per_sample, s_per_ms)
            vals = dict(
                E_i=rec.e_i[:, ch], E_q=rec.corr[:, ch, rec.i_early, 1],
                P_i=rec.p_i[:, ch], P_q=rec.p_q[:, ch],
                L_i=rec.l_i[:, ch], L_q=rec.corr[:, ch, rec.i_late, 1],
                carrError=rec.carr_err[:, ch],
                codeError=rec.code_err[:, ch],
                codeFreq=rec.code_freq[:, ch],
                carrFreq=rec.carr_freq[:, ch],
                numSample=rec.num_sample[:, ch],
                remChip=rec.rem_chip[:, ch],
                remCarrPhase=rec.rem_phase[:, ch],
                absoluteSample=abs_b,
                absoluteSampleCodedelay=abs_b - cd * bytes_per_sample,
                codedelay=cd, codedelay2=cd,
                # delayValue = numSample − Sample·pdi
                # (trackingCT_POS_updated.m:191)
                delayValue=(rec.num_sample[:, ch]
                            - s_per_ms * pdi[:, ch]))
        else:
            vals = {}
        for name in out.dtype.names:
            out[0, p - 1][name] = np.asarray(
                vals.get(name, empty), np.float64).reshape(1, -1)
    payload = {"TckResultCT_pos": out}
    if cn0_ct is not None:
        payload["CN0_CT"] = np.asarray(cn0_ct, np.float64)
    sio.savemat(path, payload)


def save_navsol_mat(path: str, nav, var_name: str = "navSolutionsCT"
                    ) -> None:
    """Export NavSolutions as the reference's 14-field `navSolCT_*`
    schema (navSolutionsWLS record, trackingCT_POS_updated.m:533-552).
    The reference's usrVelENU third row is down-positive (its ENU
    rotation negates the U row, …:523-526); the native NavSolutions
    carries true up-positive U, so the export flips the third column to
    match the reference's convention exactly — a MATLAB consumer diffing
    against reference artifacts sees identical signs."""
    import scipy.io as sio

    rec = np.zeros((1, 1), dtype=[(n, object) for n in (
        "rawPseudorange", "usrPos", "usrVel", "usrPosENU", "usrPosLLH",
        "clkBias", "usrVelENU", "clkDrift", "DOP", "satEA", "satAZ",
        "timeTransmit", "codePhaseMeas", "localTime")])
    m = rec[0, 0]
    m["rawPseudorange"] = nav.raw_pseudorange
    m["usrPos"] = nav.usr_pos
    m["usrVel"] = nav.usr_vel
    m["usrPosENU"] = nav.usr_pos_enu
    m["usrPosLLH"] = nav.usr_pos_llh
    m["clkBias"] = nav.clk_bias_m.reshape(1, -1)
    m["usrVelENU"] = nav.usr_vel_enu * np.array([1.0, 1.0, -1.0])
    m["clkDrift"] = nav.clk_drift_ms.reshape(1, -1)
    m["DOP"] = nav.dop
    m["satEA"] = nav.sat_el_deg
    m["satAZ"] = nav.sat_az_deg
    m["timeTransmit"] = nav.transmit_time
    m["codePhaseMeas"] = nav.code_phase_meas
    m["localTime"] = nav.local_time.reshape(-1, 1)
    sio.savemat(path, {var_name: rec})


def _eph_struct(eph: Dict[int, EphemerisRecord], max_prn: int = 32
                ) -> np.ndarray:
    """The 1×max_prn eph struct array in the reference's field layout
    (shared by save_eph_mat and the navSolVT export, which saves 'eph'
    alongside the solutions, trackingVT_POS_updated.m:532)."""
    names = list(_EPH_FIELD_MAP) + ["updateflag"]
    out = np.zeros((1, max_prn), dtype=[(n, object) for n in names])
    empty = np.zeros(0)
    for p in range(1, max_prn + 1):
        r = eph.get(p)
        for mat_name, attr in _EPH_FIELD_MAP.items():
            v = np.asarray(getattr(r, attr), np.float64) if r else empty
            out[0, p - 1][mat_name] = v.reshape(1, -1)
        out[0, p - 1]["updateflag"] = np.asarray(
            [[r.updateflag]] if r else [[0]], np.float64)
    return out


def save_eph_mat(path: str, eph: Dict[int, EphemerisRecord],
                 sbf: Dict[str, Dict[int, int]] | None = None,
                 max_prn: int = 32, sbf_path: str | None = None) -> None:
    """Export ephemerides (and optionally sbf) in the reference's
    `eph_*`/`sbf_*` schemas (ini_eph.m field names: Ω₀ as 'omegae',
    URA as 'N')."""
    import scipy.io as sio

    sio.savemat(path, {"eph": _eph_struct(eph, max_prn)})
    if sbf is not None and sbf_path is not None:
        nav1 = np.zeros((1, max_prn))
        sfb1 = np.zeros((1, max_prn))
        for p, v in sbf["nav1"].items():
            if p <= max_prn:
                nav1[0, p - 1] = v
        for p, v in sbf["sfb1"].items():
            if p <= max_prn:
                sfb1[0, p - 1] = v
        rec = np.zeros((1, 1), dtype=[("nav1", object), ("sfb1", object)])
        rec[0, 0]["nav1"] = nav1
        rec[0, 0]["sfb1"] = sfb1
        sio.savemat(sbf_path, {"sbf": rec})


def save_nacquired_mat(path: str, sv, snr_db, doppler_hz, code_delay,
                       fine_freq_hz) -> None:
    """Export the nAcquired artifact in the reference's schema
    (findPosSV.m:42)."""
    import scipy.io as sio

    rec = np.zeros((1, 1), dtype=[(n, object) for n in (
        "sv", "SNR", "Doppler", "codedelay", "fineFreq")])
    m = rec[0, 0]
    m["sv"] = np.asarray(sv, np.float64).reshape(1, -1)
    m["SNR"] = np.asarray(snr_db, np.float64).reshape(1, -1)
    m["Doppler"] = np.asarray(doppler_hz, np.float64).reshape(1, -1)
    m["codedelay"] = np.asarray(code_delay, np.float64).reshape(1, -1)
    m["fineFreq"] = np.asarray(fine_freq_hz, np.float64).reshape(1, -1)
    sio.savemat(path, {"nAcquired": rec})


def reconstruct_meas_start(rec: TrackRecords, pdi: np.ndarray,
                           nav: RefNavSolutions, tow1: np.ndarray,
                           nav1: np.ndarray, sfb1: np.ndarray,
                           fs: float, code_length: int = 1023
                           ) -> np.ndarray:
    """Per-channel reconstruction of the reference's first measurement
    sample from epoch 0 of its own navigation solution — inverts the
    codePhaseMeas interpolation (trackingCT_POS_updated.m:448-457).
    All channels must agree to a fraction of a sample; the spread is the
    caller's consistency check that the record adaptation is exact."""
    n_ch = rec.absolute_sample.shape[1]
    ms_elapsed = np.cumsum(pdi, axis=0)
    cur = np.empty(n_ch)
    for ch in range(n_ch):
        cpm = nav.code_phase_meas[0, ch]
        tt = nav.transmit_time[0, ch]
        anchor = nav1[ch] + sfb1[ch] * 20
        target_ms = int(round((tt - tow1[ch]) * 1000.0
                              - cpm / code_length + anchor))
        idx = int(np.searchsorted(ms_elapsed[:, ch], target_ms))
        if idx >= ms_elapsed.shape[0]:
            raise ValueError(
                f"channel {ch}: epoch-0 transmit time implies signal ms "
                f"{target_ms}, beyond the record's "
                f"{int(ms_elapsed[-1, ch])} ms — navSol and tckRst "
                "artifacts are inconsistent (or wrong nav1/sfb1 anchors)")
        step = rec.code_freq[idx, ch] / fs
        cur[ch] = (rec.absolute_sample[idx, ch]
                   + (cpm - rec.rem_chip[idx, ch]) / step)
    return cur


# ---------------------------------------------------------------------------
# VT-stage .mat interop (trackingVT_POS_updated.m:532-533 artifact chain)
# ---------------------------------------------------------------------------

_VT_TCK_FIELDS = (
    "E_i", "E_q", "P_i", "P_q", "L_i", "L_q", "amplitude", "navi_data",
    "navi_dataL035", "carrError", "codeError", "remChip", "remCarrPhase",
    "codeFreq", "carrFreq", "carrNco", "absoluteSample", "sv_vel",
    "codedelay", "deltaPr", "prRate")


def save_vt_records_mat(path: str, trk, prns: Sequence[int],
                        max_prn: int = 32, bytes_per_sample: int = 2,
                        samples_per_ms: int = 58000,
                        cn0_vt: np.ndarray | None = None,
                        i_early: int = 0, i_prompt: int = 1,
                        i_late: int = 2) -> None:
    """Export VTTrackRecords as the reference's 21-field `tckRstVT_*`
    schema (TckResultVT record fields at trackingVT_POS_updated.m:324-352,
    saved with CN0_VT at :533).

    Conventions preserved from the reference's shipped artifact
    (`tckRstVT_Opensky_updated.mat`):
    - `absoluteSample` is an ftell BYTE offset (…:344);
    - `codedelay` = mod(absoluteSample/bytes, Fs·ms) (…:347);
    - `amplitude`/`navi_data`/`navi_dataL035` are dead fields the
      reference initializes to 0 and never updates (…:138-140, recorded
      at :332-334) — exported as zeros, exactly as shipped;
    - `prRate` is declared (…:142) but never assigned — all-zeros in the
      shipped record — exported as zeros;
    - E/P/L are the loop taps (±0.5, 0); the multicorrelator variant's
      50-series bank is a different file schema this writer does not
      emit (trackingVT_POS_updated_multicorrelator.m:401-450).
    `i_early/i_prompt/i_late` select the loop taps out of `trk.corr`
    (0/1/2 for the 3-tap engine; 4/14/24 for VTParams.multicorr)."""
    import scipy.io as sio

    rows = {p: i for i, p in enumerate(prns)}
    T = trk.absolute_sample.shape[0]
    empty = np.zeros(0)
    out = np.zeros((1, max_prn),
                   dtype=[(n, object) for n in _VT_TCK_FIELDS])
    zeros_t = np.zeros(T)
    for p in range(1, max_prn + 1):
        if p in rows:
            ch = rows[p]
            abs_b = np.asarray(trk.absolute_sample[:, ch],
                               np.float64) * bytes_per_sample
            vals = dict(
                E_i=trk.corr[:, ch, i_early, 0],
                E_q=trk.corr[:, ch, i_early, 1],
                P_i=trk.corr[:, ch, i_prompt, 0],
                P_q=trk.corr[:, ch, i_prompt, 1],
                L_i=trk.corr[:, ch, i_late, 0],
                L_q=trk.corr[:, ch, i_late, 1],
                amplitude=zeros_t, navi_data=zeros_t,
                navi_dataL035=zeros_t,
                carrError=trk.carr_err[:, ch],
                codeError=trk.code_err[:, ch],
                remChip=trk.rem_chip[:, ch],
                remCarrPhase=trk.rem_phase[:, ch],
                codeFreq=trk.code_freq[:, ch],
                carrFreq=trk.carr_freq[:, ch],
                carrNco=trk.carr_nco[:, ch],
                absoluteSample=abs_b,
                codedelay=np.mod(abs_b / bytes_per_sample,
                                 samples_per_ms),
                deltaPr=trk.delta_pr[:, ch], prRate=zeros_t)
        else:
            vals = {}
        for name in _VT_TCK_FIELDS:
            if name == "sv_vel":
                v = (np.asarray(trk.sv_vel[:, rows[p]], np.float64)
                     if p in rows else np.zeros((0, 3)))
                out[0, p - 1][name] = v
            else:
                out[0, p - 1][name] = np.asarray(
                    vals.get(name, empty), np.float64).reshape(1, -1)
    payload = {"TckResultVT": out}
    if cn0_vt is not None:
        payload["CN0_VT"] = np.asarray(cn0_vt, np.float64)
    sio.savemat(path, payload)


def load_vt_records(path: str, prns: Sequence[int],
                    bytes_per_sample: int = 2):
    """`tckRstVT_*` → (VTTrackRecords, CN0_VT or None).

    Inverse of save_vt_records_mat (also loads the reference's own
    shipped `tckRstVT_Opensky_updated.mat`).  Fields the schema does not
    carry are reconstructed or None:
    - num_sample: diff of absoluteSample (the schema drops the first
      block's size, trackingVT_POS_updated.m:164 vs :344 — row 0 is
      estimated as the per-channel median of the remaining rows, which
      is within the code-NCO jitter of the true value);
    - transmit_time: None (not in the reference schema).
    """
    import scipy.io as sio

    m = sio.loadmat(path, squeeze_me=True)
    t = m["TckResultVT"]
    scalars = ("E_i", "E_q", "P_i", "P_q", "L_i", "L_q", "carrError",
               "codeError", "remChip", "remCarrPhase", "codeFreq",
               "carrFreq", "carrNco", "absoluteSample", "deltaPr")
    per = {f: np.stack([np.asarray(t[p - 1][f], np.float64)
                        for p in prns], axis=1) for f in scalars}
    sv_vel = np.stack([np.asarray(t[p - 1]["sv_vel"], np.float64)
                       for p in prns], axis=1)          # (T, N, 3)
    corr = np.stack([
        np.stack([per["E_i"], per["E_q"]], axis=-1),
        np.stack([per["P_i"], per["P_q"]], axis=-1),
        np.stack([per["L_i"], per["L_q"]], axis=-1)], axis=2)
    abs_s = per["absoluteSample"] / bytes_per_sample
    num = np.empty_like(abs_s)
    num[1:] = np.diff(abs_s, axis=0)
    # the first block's size is not recoverable from the record; estimate
    # it as the per-channel nominal block (median of the other rows —
    # within the code-NCO jitter of the true value)
    num[0] = (np.round(np.median(num[1:], axis=0))
              if abs_s.shape[0] > 1 else 0.0)
    trk = VTTrackRecords(
        corr=corr.astype(np.float32), carr_err=per["carrError"],
        code_err=per["codeError"], code_freq=per["codeFreq"],
        carr_freq=per["carrFreq"], delta_pr=per["deltaPr"],
        num_sample=num.astype(np.int64), absolute_sample=abs_s,
        transmit_time=None, sv_vel=sv_vel, rem_chip=per["remChip"],
        rem_phase=per["remCarrPhase"], carr_nco=per["carrNco"])
    cn0 = np.asarray(m["CN0_VT"], np.float64) if "CN0_VT" in m else None
    return trk, cn0


def save_navsol_vt_mat(path: str, sol, *, r_update_ms: int, eph=None,
                       max_prn: int = 32,
                       var_name: str = "navSolutionsVT",
                       trk=None) -> None:
    """Export VTSolutions as the reference's `navSolVT_*_updated` schema
    (navSolutionsVT fields recorded per ms at
    trackingVT_POS_updated.m:418-437, R at :466, saved with 'eph' at
    :532).

    Field-by-field mapping from the native record:
    - state = error_state post-update = K·z (…:398,428);
    - predicted_z = H·δx, meas_inno = newZ − predicted_z (…:434-435;
      NB the reference's recordR at :396 is the PRE-fit innovation
      because the predicted error state is always zero — that is `newZ`);
    - kalman_gain stored (8, 2N, T) as the reference's (:,:,msIndex);
    - svxyz_pos stored (N, 3, T);
    - satePos/sateVel are the reference's loop-variable leak: the LAST
      channel's values (…:426-427) — satePos is the earth-rotation-
      corrected svxyzr (…:372), reconstructed here by rotating the last
      channel's sol.sv_pos through |sv − usr| + clkBias (the reference
      rotates through its full predictedPr incl. sv-clock/iono/tropo,
      …:370-372; the travel-time difference is ~µs → mm-level satePos
      difference); sateVel needs the tracking record (`trk`, a
      VTTrackRecords) and is zeros when it is not supplied;
    - R: one row per adaptive-R firing — every `r_update_ms`-th ms
      (the reference appends exactly one row per fire, …:445-467, so
      row k is the k-th update at ~(k+1)·r_update_ms; `r_update_ms` is
      required — it must be the VTParams.r_update_ms actually used,
      because clamped values can repeat, so firings cannot be
      recovered from value changes);
    - usrVelENU's U row is flipped to the reference's down-positive
      convention (…:408-415);
    - record_correction (NLOS correction) is always zero (…:130,469).
    """
    import scipy.io as sio

    T = sol.usr_pos.shape[0]
    n2 = sol.innovation.shape[1]
    err_state = np.einsum("tij,tj->ti", sol.kalman_gain, sol.innovation)
    meas_inno = sol.innovation - sol.predicted_z
    # one R row per adaptive-R fire (see docstring)
    r_rows = (sol.r_diag[r_update_ms - 1::r_update_ms]
              if 0 < r_update_ms <= T else np.zeros((0, n2)))
    rec = np.zeros((1, 1), dtype=[(n, object) for n in (
        "localTime", "usrPos", "usrVel", "usrPosENU", "usrVelENU",
        "usrPosLLH", "clkDrift", "clkBias", "satePos", "sateVel",
        "state", "svxyz_pos", "kalman_gain", "state_cov", "meas_inno",
        "newZ", "predicted_z", "satEA", "satAZ", "R",
        "record_correction")])
    m = rec[0, 0]
    m["localTime"] = sol.local_time.reshape(-1, 1)
    m["usrPos"] = sol.usr_pos
    m["usrVel"] = sol.usr_vel
    m["usrPosENU"] = sol.usr_pos_enu
    m["usrVelENU"] = sol.usr_vel_enu * np.array([1.0, 1.0, -1.0])
    m["usrPosLLH"] = sol.usr_pos_llh
    m["clkDrift"] = sol.clk_drift_ms.reshape(-1, 1)
    m["clkBias"] = sol.clk_bias_m.reshape(-1, 1)
    sv_last = np.asarray(sol.sv_pos[:, -1, :], np.float64)
    travel_m = (np.linalg.norm(sv_last - sol.usr_pos, axis=-1)
                + np.asarray(sol.clk_bias_m, np.float64))
    m["satePos"] = earth_rotation_correction(sv_last, travel_m).numpy()
    m["sateVel"] = (np.asarray(trk.sv_vel[:, -1, :], np.float64)
                    if trk is not None else np.zeros((T, 3)))
    m["state"] = err_state
    m["svxyz_pos"] = np.transpose(sol.sv_pos, (1, 2, 0))
    m["kalman_gain"] = np.transpose(sol.kalman_gain, (1, 2, 0))
    m["state_cov"] = sol.state_cov_diag
    m["meas_inno"] = meas_inno
    m["newZ"] = sol.innovation
    m["predicted_z"] = sol.predicted_z
    m["satEA"] = sol.sat_el_deg
    m["satAZ"] = sol.sat_az_deg
    m["R"] = r_rows
    m["record_correction"] = np.zeros((T, n2 // 2))
    payload = {var_name: rec}
    if eph is not None:
        payload["eph"] = _eph_struct(eph, max_prn)
    sio.savemat(path, payload)


def load_navsol_vt(path: str) -> Dict[str, np.ndarray]:
    """`navSolVT_*` → dict of arrays keyed by the reference field names
    (kalman_gain / svxyz_pos kept in the reference's (·,·,T) layout)."""
    import scipy.io as sio

    m = sio.loadmat(path, squeeze_me=True)
    key = next(k for k in m if k.startswith("navSolutions"))
    n = m[key]
    return {f: np.asarray(n[f][()]) for f in n.dtype.names}
