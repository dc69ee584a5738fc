"""Output kind "ct": the (`TrackRecords`, `NavSolutions`) of `ct_position`,
the CT-POS stage (trackingCT_POS_updated.m and its multicorrelator
variant): the usable channels tracked at 1 ms from the acquisition state
with no switch, then a WLS fix every `nav_sol_period_ms` from the first
subframe that every channel decoded.

The records are judged row by row, as the output kind "track" judges a
serial schedule (`reference.block_plan`, `reference.judge_track`), under
the mix's `tracker`, whose keys, where left out, take the CT-POS E/P/L
tracker (`pos_epl`): taps (+d, +0.05, −d) of the configuration's spacing
d, columns (0, 1, 2), ceil block lengths, DLL sign +1, the "serial"
schedule (the only one this stage runs).

Every epoch is judged against the plain WLS reference below, in float64,
worked out from the pass's own records (judged row by row already), the
ephemerides as the synthesizer encoded them into its navigation bits, the
configuration's atmosphere and the synthesizer's subframe times.  It
imports numpy, torch and `frozen/` alone.

A pass covers the capture from the acquisition pointer to the last sample
its last row read, and launches B1 once a `chunk_ms` chunk of rows
(`run_tracking`, 1000 where the mix leaves it out).
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from sdrbench import judge as J
from sdrbench import launches as L
from sdrbench import reference as ref
from sdrbench.frozen import lnav
from sdrbench.frozen.atmosphere import klobuchar_delay, tropo_unb3_delay
from sdrbench.frozen.cacode import ca_code
from sdrbench.frozen.coords import elevation_azimuth, llh2xyz, xyz2llh
from sdrbench.frozen.earth import earth_rotation_correction
from sdrbench.frozen.ephemeris import Ephemeris, sv_pos_vel_clock

FIELDS = ("corr", "code_err", "carr_err", "code_freq", "carr_freq",
          "num_sample", "rem_chip", "rem_phase", "absolute_sample")
NAV_FIELDS = ("usr_pos", "usr_vel", "clk_bias_m", "clk_drift_ms", "dop",
              "sat_el_deg", "sat_az_deg", "transmit_time",
              "raw_pseudorange", "local_time", "cn0_dbhz", "valid")
C_LIGHT = 299_792_458.0
# the reference's carrier wavelength (initParameters.m), not c / fc
L1_WAVELENGTH = 0.190293672798365
CODE_LENGTH = 1023
# the broadcast fields as the LNAV encoder quantizes them (IS-GPS-200
# table 20-III): least significant bit's power of 2, width, signed, scale
# (GPS π for angles), and whether the angle wraps into [−π, π)
BROADCAST = {
    "tgd": (-31, 8, True, 1.0, False), "toc": (4, 16, False, 1.0, False),
    "af2": (-55, 8, True, 1.0, False), "af1": (-43, 16, True, 1.0, False),
    "af0": (-31, 22, True, 1.0, False), "crs": (-5, 16, True, 1.0, False),
    "deltan": (-43, 16, True, lnav.PI, False),
    "m0": (-31, 32, True, lnav.PI, True), "cuc": (-29, 16, True, 1.0, False),
    "ecc": (-33, 32, False, 1.0, False), "cus": (-29, 16, True, 1.0, False),
    "sqrta": (-19, 32, False, 1.0, False), "toe": (4, 16, False, 1.0, False),
    "cic": (-29, 16, True, 1.0, False),
    "omega0": (-31, 32, True, lnav.PI, True),
    "cis": (-29, 16, True, 1.0, False), "i0": (-31, 32, True, lnav.PI, False),
    "crc": (-5, 16, True, 1.0, False), "w": (-31, 32, True, lnav.PI, True),
    "omegadot": (-43, 24, True, lnav.PI, False),
    "idot": (-43, 14, True, lnav.PI, False)}


def tracker(case) -> dict:
    d = case.cfg["receiver"]["track"]["correlator_spacing"]
    t = J.tracker(case, dict(taps=[d, 0.05, -d], epl=[0, 1, 2],
                             rounding="ceil", dll_sign=1.0,
                             schedule="serial"))
    if t["schedule"] != "serial" or t["rounding"] not in ("round", "ceil"):
        raise ValueError(f"tracker: schedule {t['schedule']!r} is not "
                         f"'serial' or rounding {t['rounding']!r} not "
                         "'round' or 'ceil'")
    return t


def keep(out) -> Dict[str, np.ndarray]:
    """The host arrays of a pass's result that the judge and the readers
    read: the records' fields, and the fixes' under `nav_`."""
    rec, nav = out
    d = {f: np.asarray(getattr(rec, f)) for f in FIELDS}
    d.update({"nav_" + f: np.asarray(getattr(nav, f)) for f in NAV_FIELDS})
    return d


def covered_samples(rec: Dict[str, np.ndarray], acq_ptr: np.ndarray) -> int:
    """Capture samples a pass covered: from the acquisition pointer to the
    last sample its last row read."""
    return int(rec["absolute_sample"][-1].max() - np.min(acq_ptr))


def steps(rec: Dict[str, np.ndarray]) -> int:
    return 0


def chunk_ms(case) -> int:
    return max(1, int(case.mix["pass"][1].get("chunk_ms", 1000)))


def launches(ctx, rec: Dict[str, np.ndarray]) -> dict:
    """The bound of each B1 launch: one `run_tracking` call over the
    record's rows from the channels' acquisition state."""
    ch = channels(ctx.case)
    case = SimpleNamespace(S=ctx.case.S, dc=ctx.case.dc, init=ch["init"])
    T, n_ch = rec["num_sample"].shape
    return {"b1": L.chunk_launches(case, rec, [T], np.full(n_ch, T),
                                   len(tracker(ctx.case)["taps"]),
                                   chunk_ms(ctx.case), ctx.sample_bytes)}


# ------------------------------------------------------------ the channels


def channels(case) -> dict:
    """The stage's channels (the usable SVs), known to the case by their
    codes: each one's PRN, its acquisition row and the state the stage
    starts it from (trackingCT.m:63)."""
    if not hasattr(case, "_ct_channels"):
        book = {p: ca_code(p).astype(np.float64) for p in range(1, 33)}
        prns = [next(p for p, c in book.items() if np.array_equal(c, code))
                for code in case.codes]
        sv = [int(p) for p in case.acq["sv"]]
        rows = np.array([sv.index(p) for p in prns])
        init = ref.init_state(np.asarray(case.acq["code_delay"])[rows],
                              np.asarray(case.acq["fine_freq_hz"])[rows],
                              case.skip, case.S, case.code_basis)
        case._ct_channels = dict(prns=prns, init=init)
    return case._ct_channels


def broadcast(eph: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The synthesizer's ephemerides, field by field (N,), as its LNAV
    encoder put them into the bits and a decoder reads them back."""
    out = {}
    for f, v in eph.items():
        if f not in BROADCAST:
            out[f] = np.asarray(v, np.float64)
            continue
        lsb, width, signed, scale, wrap = BROADCAST[f]
        vals = []
        for x in np.asarray(v, np.float64):
            x = lnav._wrap_semicircle(float(x)) if wrap else float(x)
            q = lnav._quant(x, lsb, width, signed, scale)
            if signed and q >= 1 << (width - 1):
                q -= 1 << width
            vals.append(q * (2.0 ** lsb) * scale)
        out[f] = np.asarray(vals)
    return out


def constants(case) -> dict:
    """The WLS stage's constants: the configuration's front end, epoch
    period, mask, atmosphere and start position (its truth), the decode's
    start row, and the GPS time at which the synthesizer's message
    starts (the frame boundary at least a second before the capture's
    first sample)."""
    r = case.cfg["receiver"]
    decode = [kw for stage, kw in case.mix["setup"] if stage == "decode"]
    tow0 = case.cfg["sky"]["tow0"]
    return dict(fs=case.fs, f_if=r["signal"]["f_if"],
                step=int(case.fs * r["solu"]["nav_sol_period_ms"] / 1000),
                mask_db=r["solu"]["mask_snr_db"],
                alpha=r["cmn"]["iono_alpha"], beta=r["cmn"]["iono_beta"],
                doy=r["cmn"]["day_of_year"],
                init_pos=llh2xyz(np.asarray(r["solu"]["truth_llh"])).numpy(),
                decode_from=(decode[0] if decode else {}).get(
                    "start_offset_ms", 3000),
                msg_tow0=math.floor((tow0 - 1.0) / 30.0) * 30.0)


# ------------------------------------------------------------ the judge


def judge(case, recs: List[Dict[str, np.ndarray]], rng: np.random.Generator,
          n_sample: int, dtype=np.float64) -> List[ref.Gaps]:
    """The reference's gaps for each pass: every row, the correlators of
    `n_sample` rows a pass drawn by `rng` and of the first row, and every
    WLS epoch."""
    return [judge_pass(case, r, rng, n_sample, dtype) for r in recs]


def judge_pass(case, rec: Dict[str, np.ndarray], rng: np.random.Generator,
               n_sample: int, dtype=np.float64) -> ref.Gaps:
    g = ref.Gaps()
    t = tracker(case)
    ch = channels(case)
    if rec["corr"].shape[2] != len(t["taps"]):
        # another bank than the tracker's: no row can be held to it
        g.put("bank_corr_rel", math.inf)
        return g
    plan = ref.block_plan(rec, ch["init"], case.cfg["receiver"]["track"],
                          case.fs, case.S, g, t)
    sample = np.unique(np.concatenate([
        [0], rng.integers(0, ref.plan_blocks(plan), n_sample)]))
    ref.judge_track(rec, plan, case.capture, case.codes, case.dc, sample,
                    case.device, g, dtype)
    k = constants(case)
    want = wls(rec, k, ch["prns"], case.eph, case.truth_chips, t["epl"][1])
    if dtype == np.float64:
        got = program_epochs(rec)
    else:
        with np.errstate(over="ignore", invalid="ignore"):
            got = wls(rec, k, ch["prns"], case.eph, case.truth_chips,
                      t["epl"][1], dtype, follow=want)
    judge_epochs(g, got, want)
    return g


def program_epochs(rec: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    n = {f: rec["nav_" + f] for f in NAV_FIELDS}
    return dict(tt=n["transmit_time"], pr=n["raw_pseudorange"],
                lt=n["local_time"], pos=n["usr_pos"], clk=n["clk_bias_m"],
                vel=n["usr_vel"], drift=n["clk_drift_ms"], dop=n["dop"],
                el=n["sat_el_deg"], az=n["sat_az_deg"],
                valid=n["valid"].astype(bool))


def judge_epochs(g: ref.Gaps, got: dict, want: dict) -> None:
    """Hold the candidate's epochs against the reference's: a flag that
    differs, or an epoch one side has and the other has not, counts in
    `wls_valid_mismatch` (each of its channels); the rest are the largest
    gaps over the epochs both have (a gap that is not a number reads as
    infinite)."""
    e_got, e_want = len(got["pos"]), len(want["pos"])
    n_ch = want["valid"].shape[1] if e_want else got["valid"].shape[-1]
    e = min(e_got, e_want)
    g.add("wls_valid_mismatch", abs(e_got - e_want) * n_ch + np.count_nonzero(
        got["valid"][:e] != want["valid"][:e]))
    g.add("wls_epochs_checked", e)
    if not e:
        return

    def put(name, d):
        d = np.asarray(d, np.float64)
        v = float(np.max(d)) if d.size else 0.0
        g.put(name, v if np.isfinite(v) else math.inf)

    def gap(key, norm=False):
        d = np.abs(np.asarray(got[key][:e], np.float64)
                   - np.asarray(want[key][:e], np.float64))
        return np.linalg.norm(d, axis=-1) if norm else d

    az = (np.asarray(got["az"][:e], np.float64)
          - np.asarray(want["az"][:e], np.float64))
    put("wls_tt_s", np.concatenate([gap("tt").ravel(), gap("lt")]))
    put("wls_pr_m", gap("pr"))
    put("wls_pos_m", gap("pos", norm=True))
    put("wls_clk_m", gap("clk"))
    put("wls_vel_mps", gap("vel", norm=True))
    put("wls_drift_mps", gap("drift"))
    put("wls_dop", gap("dop"))
    put("wls_el_deg", np.concatenate([
        gap("el").ravel(), np.abs((az + 180.0) % 360.0 - 180.0).ravel()]))


# ------------------------------------------------------------ plain WLS


def gate(corr: np.ndarray, prompt: int, mask_db: float, dtype
         ) -> np.ndarray:
    """(T, N) validity of each row: the moment-method SNR of each window
    of 20 prompt powers (trackingCT.m:120-134), the mean of the last five
    windows (fewer at the start) in force from the window after, the first
    window's from the start; a channel drops below `mask_db` and comes
    back above `mask_db` + 3 dB, valid at the start."""
    p = corr[..., prompt, :].astype(dtype)
    p2 = p[..., 0] ** 2 + p[..., 1] ** 2
    T, N = p2.shape
    n_win = T // 20
    valid = np.ones((T, N), bool)
    if mask_db <= 0 or n_win == 0:
        return valid
    snr = ref.moment_snr_db(np.moveaxis(
        p2[:n_win * 20].reshape(n_win, 20, N), 1, 2).astype(np.float64))
    mean5 = np.stack([snr[max(0, w - 4):w + 1].mean(0)
                      for w in range(n_win)])
    cur = np.ones(N, bool)
    for w in range(n_win + 1):
        m = mean5[min(max(w - 1, 0), n_win - 1)]
        cur = np.where(cur, m >= mask_db, m >= mask_db + 3.0)
        valid[w * 20:(w + 1) * 20] = cur
    return valid


def ls_position(pr, sv, x, dtype, n_iter: int = 10):
    """Gauss-Newton on the pseudoranges from state x = [pos, clock]
    (olspos.m:40-61): 10 trips, each H = [unit(x − sv), 1], y = pr − range
    − clock, x += H⁺y; the DOP (G, P, H, V) from the last trip's H."""
    f = dtype
    pr, sv, x = pr.astype(f), sv.astype(f), x.astype(f)
    for _ in range(n_iter):
        d = x[None, :3] - sv
        rng = np.sqrt((d * d).sum(-1))
        H = np.concatenate([d / rng[:, None], np.ones((len(pr), 1), f)], 1)
        x = x + lstsq(H, pr - rng - x[3])
    q = (np.linalg.inv(H.T @ H) if np.isfinite(H).all()
         else np.full((4, 4), np.nan, f))
    d = np.diagonal(q)
    return x, np.sqrt(np.array([d.sum(), d[:3].sum(), d[:2].sum(), d[2]]))


def lstsq(A: np.ndarray, y: np.ndarray) -> np.ndarray:
    """A⁺y in A's precision; not a number where the system has none (a
    control in float32 can leave the fix's basin)."""
    if not (np.isfinite(A).all() and np.isfinite(y).all()):
        return np.full(A.shape[1], np.nan, A.dtype)
    return np.linalg.lstsq(A, y, rcond=None)[0].astype(A.dtype)


def ls_velocity(pos, sv, sv_vel, doppler, clk_rate, dtype):
    """One-shot velocity and clock drift (LS_SA_code_Vel.m:58-97): rows
    [unit(pos − sv), 1], y = Doppler·λ − a·v_sv + the SV clock rate."""
    f = dtype
    d = pos.astype(f)[None, :] - sv.astype(f)
    a = d / np.sqrt((d * d).sum(-1))[:, None]
    A = np.concatenate([a, np.ones((len(a), 1), f)], 1)
    b = (a * sv_vel.astype(f)).sum(-1) - clk_rate.astype(f)
    x = lstsq(A, doppler.astype(f) * f(L1_WAVELENGTH) - b)
    return x[:3], x[3]


def wls(rec: Dict[str, np.ndarray], k: dict, prns, eph: dict, truth,
        prompt: int, dtype=np.float64, follow: Optional[dict] = None
        ) -> Dict[str, np.ndarray]:
    """The stage's epochs from its records (trackingCT_POS_updated.m:
    151-164, 437-554), in `dtype` (the SV states and the atmosphere in
    float64 from the `dtype` times and fix):

    - each channel's anchor: 20 rows after the row that starts its first
      subframe past the decode's start (the synthesizer's SV time at each
      row's end, its chip count less the row's code phase over 1023, gives
      the row's ms; subframes start every 6 s); the grid starts one sample
      after the latest anchor row's end and steps the epoch period;
    - at each epoch, each channel's last row ending at or before it; its
      code phase carried to the epoch at the row's code rate; transmit
      time the subframe's, the rows since its anchor in ms and the code
      phase over 1023 ms; the local time max + 75 ms at the first epoch,
      then moved by the bias each fix finds and by the period;
    - SV position, velocity and clock at the transmit time, the
      pseudorange with the SV clock and the group delay, rotated by the
      Earth over the range (Sagnac), less Klobuchar and UNB3 at the last
      fix (its elevation and azimuth too);
    - the rows' validity gate (`gate`; all channels where fewer than 4
      pass), the iterated LS from the last fix and the Doppler LS.

    With `follow` (the float64 epochs of the same records) each epoch
    after the first starts from the fix and the local time `follow` left,
    as the control follows the program's state row by row."""
    f = dtype
    abs_s = rec["absolute_sample"]
    T, N = abs_s.shape
    rem, code_freq = rec["rem_chip"], rec["code_freq"]
    chips = np.stack([truth(p, abs_s[:, c]) for c, p in enumerate(prns)], 1)
    ms = np.round((chips - rem) / CODE_LENGTH).astype(np.int64)
    end_ms = int(round(k["msg_tow0"] * 1000)) + ms      # SV ms at row end
    # each channel's first subframe: the first row past the decode's start
    # that starts on a 6 s boundary of SV time.  The stage anchors at the
    # row 20 ms on (absoluteSample(nav1 + sfb·20), …:156, with the
    # decoder's 1-based bit index sfb of the subframe) and gives that
    # row's end the subframe's own time, so its transmit times run 21 ms
    # behind the SV's clock; the reference keeps the stage's rule
    first = (((end_ms - 1) % 6000 == 0)
             & (np.arange(T)[:, None] > k["decode_from"]))
    if not first.any(axis=0).all():
        return empty(N, f)
    chan = np.arange(N)
    sub = np.argmax(first, axis=0)
    anchor = sub + 20
    if anchor.max() >= T:
        return empty(N, f)
    tow1 = (end_ms[sub, chan] - 1) / 1000.0
    meas_start = float(abs_s[anchor, chan].max()) + 1
    sample_end = abs_s[-1].min() - 1
    valid_rows = gate(rec["corr"], prompt, k["mask_db"], f)
    bc = broadcast(eph)
    e = Ephemeris(*[torch.as_tensor(bc[n], dtype=torch.float64)
                    for n in Ephemeris._fields])
    est = np.concatenate([k["init_pos"], [0.0]]).astype(f)
    out = {n: [] for n in ("tt", "pr", "lt", "pos", "clk", "vel", "drift",
                           "dop", "el", "az", "valid")}
    local_time = None
    epoch = 0
    while True:
        cur = meas_start + k["step"] * epoch
        if cur > sample_end:
            break
        idx = np.array([np.searchsorted(abs_s[:, c], cur, side="right") - 1
                        for c in chan])
        if np.any(idx < 0) or np.any(idx >= T - 1):
            break
        if follow is not None and epoch:
            est = np.append(follow["pos"][epoch - 1],
                            follow["clk"][epoch - 1]).astype(f)
            local_time = f(follow["lt"][epoch - 1]) + f(k["step"] / k["fs"])
        code_phase = (rem[idx, chan].astype(f) + code_freq[idx, chan].astype(f)
                      / f(k["fs"]) * f(cur - abs_s[idx, chan]))
        tt = (code_phase / f(CODE_LENGTH) / f(1000.0)
              + (idx - anchor).astype(f) / f(1000.0) + tow1.astype(f))
        if local_time is None:
            local_time = tt.max() + f(75e-3)
        pr = (local_time - tt) * f(C_LIGHT)
        sv = sv_pos_vel_clock(e, torch.as_tensor(tt, dtype=torch.float64))
        prvec = (torch.as_tensor(pr, dtype=torch.float64) + sv["clk_m"]
                 - sv["tgd_s"] * C_LIGHT)
        sv_rot = earth_rotation_correction(sv["pos"], prvec)
        usr = torch.as_tensor(est[:3], dtype=torch.float64)
        el, az = elevation_azimuth(sv_rot, usr)
        llh = xyz2llh(usr)
        iono = klobuchar_delay(tt.astype(np.float64), sv_rot, usr,
                               k["alpha"], k["beta"])
        tropo = torch.abs(tropo_unb3_delay(
            float(k["doy"]), torch.rad2deg(llh[0]), llh[2],
            torch.rad2deg(el)))
        corrected = (prvec - iono - tropo).numpy().astype(f)
        m = valid_rows[idx, chan]
        if m.sum() < 4:
            m = np.ones(N, bool)
        sv_np = sv_rot.numpy().astype(f)
        est, dop = ls_position(corrected[m], sv_np[m], est, f)
        doppler = (rec["carr_freq"][idx, chan] - k["f_if"]).astype(f)
        vel, drift = ls_velocity(est[:3], sv_np[m],
                                 sv["vel"].numpy()[m], doppler[m],
                                 sv["clk_rate_ms"].numpy()[m], f)
        for name, v in (("tt", tt), ("pr", pr), ("pos", est[:3]),
                        ("clk", est[3]), ("vel", vel), ("drift", drift),
                        ("dop", dop), ("el", np.rad2deg(el.numpy())),
                        ("az", np.rad2deg(az.numpy())), ("valid", m)):
            out[name].append(v)
        local_time = local_time - est[3] / f(C_LIGHT)
        out["lt"].append(local_time)
        local_time = local_time + f(k["step"] / k["fs"])
        epoch += 1
    if not epoch:
        return empty(N, f)
    return {n: np.asarray(v) for n, v in out.items()}


def empty(n_ch: int, dtype) -> Dict[str, np.ndarray]:
    z = np.zeros((0, n_ch), dtype)
    return dict(tt=z, pr=z, lt=np.zeros(0, dtype),
                pos=np.zeros((0, 3), dtype), clk=np.zeros(0, dtype),
                vel=np.zeros((0, 3), dtype), drift=np.zeros(0, dtype),
                dop=np.zeros((0, 4), dtype), el=z, az=z,
                valid=np.zeros((0, n_ch), bool))
