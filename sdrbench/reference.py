"""The plain reference that decides a run's `correct`.

It imports numpy and torch alone: nothing of the program under test, of
the JAX package or of JAX.  It reads the capture the benchmark made, the
acquisition result the timed stage was handed, and the records the timed
stage returned, and it judges those records block by block.

A tracking loop rounds float64 NCO words to integers every block (the
block length, the Q32 carrier step), so two correct trackers that differ
by one rounding follow different, equally valid, noise paths after it.
The reference therefore follows the program step by step from the
program's own recorded state: for every record row it takes the state
the row before left (block end, code phase, code and carrier frequency,
Q32 carrier phase, the last discriminator outputs) and works out this
row again.  The stage's start, the state it is handed, comes from the
acquisition result by the reference's own rule (trackingCT.m:63).

Two layers are judged:

- the loops, on every row of every pass: block length and end (exact),
  Q32 carrier phase (exact), code phase, the discriminators from the
  row's own correlator sums, both loop filters and the NCO words they
  set;
- the correlators, on rows drawn from the seed: the sums worked out
  again from the capture's samples in float64 (the Q32 carrier phase and
  code index the configuration states; DC removal where it is on), held
  against the row's sums relative to the row's mean prompt magnitude.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

Q32 = 4294967296.0
CODE_LENGTH = 1023


def loop_coefficients(bw_hz: float, zeta: float, gain: float):
    """(tau1, tau2) of a 2nd-order loop (calcLoopCoef.m:41-45)."""
    wn = bw_hz * 8.0 * zeta / (4.0 * zeta * zeta + 1.0)
    return gain / (wn * wn), 2.0 * zeta / wn


def detect_bit_transition(p_i: np.ndarray, min_index: int = 600) -> int:
    """`countinx` (trackingCT.m:178-213): the first i ≥ min_index whose 6
    previous ms disagree with ms i and whose 17 following agree; mod(i,20)
    − 1 with the reference's 1-based i."""
    s = np.sign(p_i)
    for i in range(max(6, min_index - 1), len(s) - 18):
        if np.all(s[i - 6:i] != s[i]) and np.all(s[i + 1:i + 18] == s[i]):
            return int((i + 1) % 20 - 1)
    return 0


def wrap32(x: np.ndarray) -> np.ndarray:
    """int64 → the int32 value congruent mod 2³², kept in int64."""
    return np.remainder(x + 2 ** 31, 2 ** 32) - 2 ** 31


def phase_word(rem_phase: np.ndarray) -> np.ndarray:
    """The Q32 carrier phase word of a recorded phase in [0, 2π)."""
    return wrap32(np.round(rem_phase / (2.0 * np.pi) * Q32).astype(np.int64))


def tap_words(taps) -> np.ndarray:
    return np.round(np.asarray(taps, np.float64) * Q32).astype(np.int64)


# ------------------------------------------------------------ correlators


def correlate(capture: np.ndarray, ptr, num, rem, step, phase, carr_fp,
              codes: np.ndarray, taps, remove_dc: bool, device,
              dtype=np.float64) -> np.ndarray:
    """(N, T, 2) [I, Q] correlator sums of one block of each channel.

    capture (L, 2) int IQ; per channel: `ptr` first sample, `num` block
    length, `rem` code phase [chips] and `step` chips per sample at the
    block start, `phase` and `carr_fp` the Q32 carrier phase and step
    words; codes (N, 1023) ±1.  Sample k is mixed by e^{iθ_k}, θ_k =
    2π·((phase + k·carr_fp) mod 2³²)/2³², I = imag, Q = real
    (trackingCT.m:113), and tap t reads chip ((round(rem·2³²) + tap_t −
    1 + k·round(step·2³²)) >> 32) mod 1023.  `dtype` is the precision of
    the phasor and the sums."""
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    n = len(ptr)
    tap_fp = torch.as_tensor(tap_words(taps), device=device)
    out = np.zeros((n, len(taps), 2), dtype)
    for ch in range(n):
        m = int(num[ch])
        x = torch.as_tensor(capture[int(ptr[ch]):int(ptr[ch]) + m],
                            device=device).to(tdt)
        if x.shape[0] != m:
            raise ValueError(f"block [{ptr[ch]}, +{m}) leaves the capture")
        if remove_dc:
            x = x - x.to(torch.float64).mean(dim=0).to(tdt)
        k = torch.arange(m, dtype=torch.int64, device=device)
        word = torch.remainder(int(phase[ch]) + k * int(carr_fp[ch]),
                               2 ** 32)
        theta = word.to(torch.float64) * (2.0 * math.pi / Q32)
        c, s = torch.cos(theta).to(tdt), torch.sin(theta).to(tdt)
        i_mix = x[:, 0] * s + x[:, 1] * c
        q_mix = x[:, 0] * c - x[:, 1] * s
        base = int(round(float(rem[ch]) * Q32))
        step_fp = int(round(float(step[ch]) * Q32))
        cidx = torch.remainder(torch.bitwise_right_shift(
            base + tap_fp[:, None] - 1 + k[None, :] * step_fp, 32),
            CODE_LENGTH)
        code = torch.as_tensor(codes[ch], device=device).to(tdt)[cidx]
        prod = torch.stack([code * i_mix, code * q_mix], dim=-1)
        if dtype == np.float64:
            out[ch] = prod.sum(dim=1).cpu().numpy()
        else:
            # float32 sums in the plain order, one sample after another
            out[ch] = np.cumsum(prod.cpu().numpy(), axis=1,
                                dtype=np.float32)[:, -1]
    return out


def corr_gap(cand: np.ndarray, ref: np.ndarray, i_prompt: int) -> float:
    """Largest |cand − ref| of a row's sums over the row's mean prompt
    magnitude."""
    mag = np.sqrt(ref[:, i_prompt, 0] ** 2 + ref[:, i_prompt, 1] ** 2).mean()
    return float(np.abs(cand.astype(np.float64) - ref).max() / mag)


# ------------------------------------------------------------ scalar loops


def dll_disc(corr: np.ndarray, ie: int, il: int, dtype) -> np.ndarray:
    """0.5·(E − L)/(E + L) of the envelopes (trackingCT.m:137-139): the
    envelopes in the sums' precision, the ratio in `dtype`."""
    c = corr.astype(np.float32) if dtype == np.float32 else corr
    e = np.sqrt(c[..., ie, 0] ** 2 + c[..., ie, 1] ** 2).astype(dtype)
    late = np.sqrt(c[..., il, 0] ** 2 + c[..., il, 1] ** 2).astype(dtype)
    return 0.5 * (e - late) / np.maximum(e + late, dtype(1e-30))


def pll_disc(corr: np.ndarray, ip: int, dtype) -> np.ndarray:
    """atan(Q/I)/2π in cycles (trackingCT.m:146): never atan2."""
    c = corr.astype(np.float32) if dtype == np.float32 else corr
    i, q = c[..., ip, 0], c[..., ip, 1]
    i = np.where(i == 0, c.dtype.type(1e-30), i)
    return (np.arctan(q / i) / c.dtype.type(2.0 * np.pi)).astype(dtype)


def loop_rows(prev: Dict[str, np.ndarray], corr: np.ndarray, spec: dict,
              dtype=np.float64) -> Dict[str, np.ndarray]:
    """The rows a scalar tracker makes from the state `prev` left, given
    the rows' correlator sums `corr` (..., T, 2): arrays of any shape.

    prev: ptr (int64), rem, code_freq, carr_freq (float64), phase (Q32
    int64), code_err, carr_err (the last discriminator outputs).  spec:
    n_chips, fs, ceil, dll_sign, gains (dll p, dll i, pll p, pll i),
    epl."""
    f = dtype
    fs = f(spec["fs"])
    code_freq = prev["code_freq"].astype(f)
    carr_freq = prev["carr_freq"].astype(f)
    rem = prev["rem"].astype(f)
    step = code_freq / fs
    n_exact = (f(spec["n_chips"]) - rem) / step
    num = (np.ceil(n_exact) if spec["ceil"] else np.round(n_exact)
           ).astype(np.int64)
    carr_fp = wrap32(np.round(carr_freq / fs * f(Q32)).astype(np.int64))
    new_rem = num.astype(f) * step + rem - f(spec["n_chips"])
    phase = wrap32(prev["phase"] + num * carr_fp)
    ie, ip, il = spec["epl"]
    code_err = dll_disc(corr, ie, il, f)
    carr_err = pll_disc(corr, ip, f)
    gp_c, gi_c, gp_r, gi_r = (f(g) for g in spec["gains"])
    d_code = gp_c * (code_err - prev["code_err"].astype(f)) + code_err * gi_c
    d_carr = gp_r * (carr_err - prev["carr_err"].astype(f)) + carr_err * gi_r
    return dict(num=num, ptr=prev["ptr"] + num, rem=new_rem, phase=phase,
                code_err=code_err, carr_err=carr_err,
                code_freq=code_freq + f(spec["dll_sign"]) * d_code,
                carr_freq=carr_freq + d_carr, step=step, carr_fp=carr_fp)


def track_spec(track: dict, fs: float, pdi_ms: int, tracker: dict) -> dict:
    """The loop constants of a scalar tracker: the configuration's loop
    filters, dt = 1 ms, and the tracker's taps, E/P/L columns, rounding of
    the block length and DLL sign (codeFreq = basis + dll_sign·nco)
    (trackingCT.m: taps (−d, 0, +d), round(), −1;
    trackingCT_POS_updated.m: ceil(), +1); the sums are not negated."""
    tc1, tc2 = loop_coefficients(track["dll_bw_hz"], track["dll_damping"],
                                 track["dll_gain"])
    tr1, tr2 = loop_coefficients(track["pll_bw_hz"], track["pll_damping"],
                                 track["pll_gain"])
    return dict(n_chips=CODE_LENGTH * pdi_ms, fs=fs,
                ceil=tracker["rounding"] == "ceil",
                dll_sign=float(tracker["dll_sign"]),
                gains=(tc2 / tc1, 1e-3 / tc1, tr2 / tr1, 1e-3 / tr1),
                epl=tuple(int(i) for i in tracker["epl"]),
                taps=tuple(float(t) for t in tracker["taps"]),
                sign=1.0)


def init_state(code_delay: np.ndarray, fine_freq: np.ndarray, skip_ms: int,
               samples_per_ms: int, code_basis: float) -> Dict[str, np.ndarray]:
    """The state a stage starts from, from the acquisition result: the
    pointer skip·S + S − codedelay + 1 (trackingCT.m:63), code phase 0,
    the nominal code rate, the fine carrier frequency, loops at rest."""
    n = len(code_delay)
    z = np.zeros(n)
    return dict(ptr=skip_ms * samples_per_ms + samples_per_ms
                - np.asarray(code_delay, np.int64) + 1,
                rem=z, code_freq=np.full(n, code_basis),
                carr_freq=np.asarray(fine_freq, np.float64),
                phase=np.zeros(n, np.int64), code_err=z, carr_err=z)


def state_after(rec: Dict[str, np.ndarray], rows, chans) -> Dict[str, np.ndarray]:
    """The state recorded rows `rows` of channels `chans` left."""
    return dict(ptr=rec["absolute_sample"][rows, chans],
                rem=rec["rem_chip"][rows, chans],
                code_freq=rec["code_freq"][rows, chans],
                carr_freq=rec["carr_freq"][rows, chans],
                phase=phase_word(rec["rem_phase"][rows, chans]),
                code_err=rec["code_err"][rows, chans],
                carr_err=rec["carr_err"][rows, chans])


class Gaps:
    """The widest gaps of a run's comparisons, by name."""

    def __init__(self):
        self.v: Dict[str, float] = {}

    def put(self, name: str, value: float) -> None:
        self.v[name] = max(self.v.get(name, 0.0), float(value))

    def add(self, name: str, count: int) -> None:
        self.v[name] = self.v.get(name, 0.0) + int(count)


def judge_rows(g: Gaps, rows: Dict[str, np.ndarray],
               cand: Dict[str, np.ndarray]) -> None:
    """Hold candidate rows `cand` against the reference's `rows`."""
    g.add("loop_block_mismatch", np.count_nonzero(
        (cand["num"] != rows["num"]) | (cand["ptr"] != rows["ptr"])))
    g.add("loop_phase_mismatch",
          np.count_nonzero(cand["phase"] != rows["phase"]))
    for k, name in (("rem", "loop_rem_chip"),
                    ("code_freq", "loop_code_freq_hz"),
                    ("carr_freq", "loop_carr_freq_hz")):
        d = np.abs(cand[k].astype(np.float64) - rows[k].astype(np.float64))
        g.put(name, d.max() if d.size else 0.0)


def recorded_rows(rec: Dict[str, np.ndarray], rows, chans
                  ) -> Dict[str, np.ndarray]:
    """What the program recorded for rows `rows` of channels `chans`, under
    `loop_rows`' names."""
    return dict(num=rec["num_sample"][rows, chans],
                ptr=rec["absolute_sample"][rows, chans],
                rem=rec["rem_chip"][rows, chans],
                phase=phase_word(rec["rem_phase"][rows, chans]),
                code_err=rec["code_err"][rows, chans],
                carr_err=rec["carr_err"][rows, chans],
                code_freq=rec["code_freq"][rows, chans],
                carr_freq=rec["carr_freq"][rows, chans])


# ------------------------------------------------------------ track stages


def block_plan(rec: Dict[str, np.ndarray], init: dict, track: dict,
               fs: float, S: int, g: Gaps, tracker: dict, n1: int = 0,
               min_transition: int = 600):
    """The blocks of a scalar tracking stage's record, phase by phase: a
    list of (spec, rows (B, N), prev-state dict of (B, N) arrays[,
    channel]), by the tracker's `schedule`:

    - "serial": every row at 1 ms from `init`, with no switch;
    - "eph_ref", the 3-phase schedule's merged record (trackingCT.m): per
      channel n1 + countinx rows at 1 ms from `init`, then 10 ms blocks,
      each repeated ×10, from the re-based pointer ptr0 + (n1+countinx)·S
      with the loops resumed from the last 1 ms row, edge-padded at the
      end.  countinx is found again from the 1 ms rows' prompt; a channel
      whose record does not switch where it says counts as a mismatch."""
    T, N = rec["num_sample"].shape
    chans = np.arange(N)
    s1 = track_spec(track, fs, 1, tracker)
    if tracker["schedule"] == "serial":
        rows = np.arange(T)[:, None].repeat(N, 1)
        prev = {k: np.concatenate([v[None], state_after(
            rec, rows[:-1], chans[None, :])[k]]) for k, v in init.items()}
        return [(s1, rows, prev)]
    # the 10 ms phase negates its correlator outputs (trackingCT.m:377-525)
    s10 = dict(track_spec(track, fs, 10, tracker), sign=-1.0)
    prompt = s1["epl"][1]
    cnt = np.array([detect_bit_transition(rec["corr"][:n1, ch, prompt, 0],
                                          min_transition) for ch in chans])
    # the record's own switch, the first row of a 10 ms block, against
    # the one countinx puts it at
    sw = np.argmax(rec["num_sample"] > 5 * S, axis=0)
    g.add("loop_block_mismatch", np.count_nonzero(sw != n1 + cnt))
    n_blocks = (T - int(sw.max())) // 10
    # the ×10 replication and the edge padding, exact
    mism = 0
    for ch in chans:
        a = int(sw[ch])
        rep = rec["absolute_sample"][a:a + 10 * n_blocks, ch].reshape(-1, 10)
        mism += np.count_nonzero(rep != rep[:, :1])
        mism += np.count_nonzero(rec["absolute_sample"][a + 10 * n_blocks:, ch]
                                 != rep[-1, 0])
    g.add("loop_block_mismatch", mism)
    # 1 ms rows: rows [0, sw[ch]) of each channel
    m = int(sw.min())
    rows1 = np.arange(m)[:, None].repeat(N, 1)
    prev1 = {k: np.concatenate([v[None], state_after(
        rec, rows1[:-1], chans[None, :])[k]]) for k, v in init.items()}
    plan = [(s1, rows1, prev1)]
    for ch in chans:                          # each channel's 1 ms tail
        r = np.arange(m, int(sw[ch]))
        if r.size:
            rr = r[:, None]
            plan.append((s1, rr, {k: v[:, None] for k, v in state_after(
                rec, r - 1, np.full(r.size, ch)).items()}, ch))
    # 10 ms rows
    rows10 = sw[None, :] + 10 * np.arange(n_blocks)[:, None]
    first = state_after(rec, sw - 1, chans)
    first["ptr"] = init["ptr"] + sw * S
    prev10 = {k: np.concatenate([first[k][None], state_after(
        rec, rows10[:-1], chans[None, :])[k]]) for k in first}
    plan.append((s10, rows10, prev10))
    return plan


def judge_track(rec: Dict[str, np.ndarray], plan, capture: np.ndarray,
                codes: np.ndarray, remove_dc: bool, sample: np.ndarray,
                device, g: Gaps, dtype=np.float64) -> None:
    """Every row of `plan` through `loop_rows`, against the record (or,
    for the control, against the rows `dtype` makes); the correlators of
    the rows `sample` draws (indices into the flattened blocks of the
    plan), against `correlate` in float64."""
    offset = 0
    for item in plan:
        spec, rows, prev = item[:3]
        chans = (np.arange(rows.shape[1])[None, :] if len(item) == 3
                 else np.full((1, 1), item[3]))
        corr = rec["corr"][rows, chans]
        ref = loop_rows(prev, corr, spec)
        if dtype == np.float64:
            cand = recorded_rows(rec, rows, chans)
        else:
            cand = loop_rows(prev, corr, spec, dtype)
        judge_rows(g, ref, cand)
        n_b = rows.shape[0]
        pick = sample[(sample >= offset) & (sample < offset + n_b)] - offset
        offset += n_b
        for b in pick:
            c = chans[0]
            p = {k: v[b] for k, v in prev.items()}
            args = (capture, p["ptr"], ref["num"][b], p["rem"],
                    ref["step"][b], p["phase"], ref["carr_fp"][b],
                    codes[c], spec["taps"], remove_dc, device)
            want = correlate(*args) * spec["sign"]
            got = (corr[b] if dtype == np.float64 else
                   correlate(*args, dtype=dtype) * spec["sign"])
            g.put("bank_corr_rel", corr_gap(got, want, spec["epl"][1]))
    g.add("blocks_checked", offset)


def plan_blocks(plan) -> int:
    return sum(item[1].shape[0] for item in plan)


# ------------------------------------------------------------ acquisition


def judge_acquisition(g: Gaps, acq: dict, prns, truth_chips,
                      skip_ms: int, S: int) -> None:
    """The stage's start against the synthesizer's truth: the acquired
    PRNs are the sky's, and the acquisition pointer of each lies within a
    fraction of a chip of a code epoch.  `truth_chips(prn, samples)` gives
    the signal's chip count at capture samples."""
    got = sorted(int(p) for p in acq["sv"])
    g.add("acq_prn_mismatch", len(set(got) ^ set(int(p) for p in prns)))
    ptr0 = (skip_ms * S + S - np.asarray(acq["code_delay"], np.int64) + 1)
    for p, q in zip(acq["sv"], ptr0):
        if int(p) not in prns:
            continue
        chip = float(truth_chips(int(p), np.array([q]))[0])
        err = (chip + CODE_LENGTH / 2) % CODE_LENGTH - CODE_LENGTH / 2
        g.put("acq_code_chips", abs(err))


# ------------------------------------------------------------ vector tracking
#
# The stage (trackingVT_POS_updated.m) couples every channel through an
# 8-state EKF on [position, velocity, clock bias, clock drift].  The
# reference follows the program's recorded state step by step: for step
# t it takes the state step t − 1 left (the loops' NCO words, the transmit
# time, the total state) and works out again, in float64 and from the
# synthesizer's own ephemerides, everything the step derives from it: the
# predicted pseudorange and its rate Δpr (the code NCO's input), the two
# measurements z_pr and z_prr, the validity gate, the adaptive
# measurement noise, the covariance, the gain and the state update.  The
# covariance and the gate are its own chains from the stage's start (P₀),
# under the measurement noise the program's record says was in force.
#
# The stage's start (the CT warm start) is not recorded, and with P₀ the
# first update takes the measurements nearly whole, so the start cannot be
# worked back from step 0's record.  What reaches back to it is left out:
# Δpr, z and the state before step k["atmos"] + 1 (group 0's geometry and
# the atmosphere held from it are taken at the start), and the first
# interval of the adaptive noise (it sums step 0's z).


def vt_rows(prev: Dict[str, np.ndarray], row: Dict[str, np.ndarray],
            k: dict, dtype=np.float64) -> Dict[str, np.ndarray]:
    """The scalar part of a vector-tracking step (…:164-313) from the
    state `prev` left, given this row's correlator sums and its
    Δpseudorange: block length with the old code rate, the replica at the
    new one f0·(1 − Δpr/c), the scalar PLL and the transmit time."""
    f = dtype
    fs = f(k["fs"])
    rem = prev["rem"].astype(f)
    num = np.clip(np.ceil((f(CODE_LENGTH) - rem)
                          / (prev["code_freq"].astype(f) / fs)),
                  1, k["blk"]).astype(np.int64)
    code_freq = f(k["code_basis"]) * (f(1.0) - row["delta_pr"].astype(f)
                                      / f(k["c"]))
    carr_fp = wrap32(np.round(prev["carr_freq"].astype(f) / fs * f(Q32))
                     .astype(np.int64))
    new_rem = num.astype(f) * (code_freq / fs) + rem - f(CODE_LENGTH)
    carr_err = pll_disc(row["corr"], k["epl"][1], np.float32).astype(f)
    d_pll = (f(k["pll_p"]) * (carr_err - prev["carr_err"].astype(f))
             + carr_err * f(k["pll_i"]))
    return dict(num=num, ptr=prev["ptr"] + num, rem=new_rem,
                phase=wrap32(prev["phase"] + num * carr_fp),
                code_freq=code_freq, carr_err=carr_err,
                carr_freq=prev["carr_freq"].astype(f) + d_pll,
                tt=prev["tt"].astype(f) + num.astype(f) / fs,
                carr_fp=carr_fp)


def propagate(x: np.ndarray, dt: float) -> np.ndarray:
    """F·x of the constant-velocity, constant-drift model (…:440-442)."""
    out = x.copy()
    out[..., 0:3] += x[..., 3:6] * dt
    out[..., 6] += x[..., 7] * dt
    return out


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64,
                           device=device)


def vt_geometry(tt: np.ndarray, num: np.ndarray, x: np.ndarray,
                eph: dict, k: dict, device) -> Dict[str, np.ndarray]:
    """The geometry of every step of B passes, in float64.

    tt, num (B, T, N): the recorded transmit times and block lengths;
    x (B, T, 8) the recorded total states; `eph` the channels' broadcast
    ephemerides by field, (N,) each.  As the stage states it (…:84-86,
    208-215): the geometry is taken at the head of every group of
    k["group"] steps from the state the step before left (SV position,
    clock and its rate at that transmit time, the Sagnac-rotated range,
    the unit line of sight), the atmosphere (Klobuchar, UNB3) at every
    k["atmos"] steps; within a group the range moves along the head's
    line of sight by the SV's own motion (Kepler at every step) and the
    receiver's.  Step 0 starts from the recorded state of step 0 (its
    own start is not recorded); the judge leaves the steps that reach
    back to it out.

    Returns per step: `x0` the state the step starts from, `range_head`
    (r₁ + corrections at the step's head) and `range_move` (what the
    range moved since), `los` (B, T, N, 3), `sv_vel` (B, T, N, 3),
    `clk_rate` (B, T, N), and `head` (T,) each step's group head."""
    from sdrbench.frozen.atmosphere import klobuchar_delay, tropo_unb3_delay
    from sdrbench.frozen.coords import xyz2enu, xyz2llh
    from sdrbench.frozen.earth import earth_rotation_correction
    from sdrbench.frozen.ephemeris import Ephemeris, sv_pos_vel_clock

    B, T, N = tt.shape
    dt, fs = 1e-3, k["fs"]
    e = Ephemeris(*[_t(eph[f], device) for f in Ephemeris._fields])
    x0 = np.concatenate([x[:, :1], propagate(x[:, :-1], dt)], axis=1)
    tt_prev = np.concatenate([tt[:, :1] - num[:, :1] / fs, tt[:, :-1]],
                             axis=1)
    heads = np.arange(0, T, k["group"])
    head = (np.arange(T) // k["group"]) * k["group"]
    t_h = _t(tt_prev[:, heads], device)                   # (B, H, N)
    sv = sv_pos_vel_clock(e, t_h)
    pos0 = sv["pos"]
    est_h = _t(x0[:, heads, None, 0:3], device).expand_as(pos0)
    # the atmosphere at the heads of its cadence, held between them
    enu = xyz2enu(pos0, est_h)
    el = torch.atan2(enu[..., 2], torch.linalg.norm(enu[..., :2], dim=-1))
    llh = xyz2llh(est_h)
    iono = klobuchar_delay(t_h, pos0, est_h, _t(k["iono_alpha"], device),
                           _t(k["iono_beta"], device))
    tropo = torch.abs(tropo_unb3_delay(
        _t(float(k["doy"]), device), torch.rad2deg(llh[..., 0]),
        llh[..., 2], torch.rad2deg(el)))
    held = torch.as_tensor((heads // k["atmos"]) * k["atmos"]
                           // k["group"], device=device)
    iono, tropo = iono[:, held], tropo[:, held]
    clk_bias_h = _t(x0[:, heads, 6], device)[..., None]
    corr_m = (clk_bias_h + sv["clk_m"] - e.tgd * k["c"] - tropo - iono)
    r0 = torch.linalg.norm(pos0 - est_h, dim=-1)
    diff = earth_rotation_correction(pos0, r0 + corr_m) - est_h
    r1 = torch.linalg.norm(diff, dim=-1)
    los_h = diff / r1[..., None]
    # every step: the SV by Kepler at its transmit time
    svt = sv_pos_vel_clock(e, _t(tt, device))
    g = torch.as_tensor(head // k["group"], device=device)
    los = los_h[:, g]
    move = ((los * (svt["pos"] - pos0[:, g])).sum(-1)
            - (los * (_t(x0[:, :, None, 0:3], device)
                      - est_h[:, g])).sum(-1)
            + (_t(x0[:, :, None, 6], device) - clk_bias_h[:, g])
            + sv["clk_rate_ms"][:, g] * (_t(tt, device) - t_h[:, g]))
    return dict(x0=x0, range_head=(r1 + corr_m)[:, g].cpu().numpy(),
                range_move=move.cpu().numpy(), los=los.cpu().numpy(),
                sv_vel=svt["vel"].cpu().numpy(),
                clk_rate=sv["clk_rate_ms"][:, g].cpu().numpy(), head=head)


def vt_measurements(geo: dict, corr: np.ndarray, code_freq: np.ndarray,
                    carr_freq: np.ndarray, k: dict, dtype=np.float64):
    """(Δpr (B, T, N), z (B, T, 2N)) from the geometry, in `dtype`: the
    predicted pseudorange's step over dt (…:218-223), z_pr = the code
    discriminator × c / codeFreq (…:316-321), z_prr = a·(v − v_sv) −
    (carrFreq − IF)·c/fc − drift + the SV clock rate (…:379-382).
    corr (B, T, N, taps, 2), early and late at the columns k["epl"][0]
    and k["epl"][2]."""
    f = dtype
    pred = geo["range_head"].astype(f) + geo["range_move"].astype(f)
    delta = np.zeros_like(pred)
    delta[:, 1:] = (pred[:, 1:] - pred[:, :-1]) / f(1e-3)
    c = corr.astype(np.float32) if f == np.float32 else corr
    ie, _, il = k["epl"]
    e = np.sqrt(c[..., ie, 0] ** 2 + c[..., ie, 1] ** 2).astype(f)
    late = np.sqrt(c[..., il, 0] ** 2 + c[..., il, 1] ** 2).astype(f)
    code_err = f(-0.5) * (e - late) / np.maximum(e + late, f(1e-30))
    z_pr = code_err * (f(k["c"]) / code_freq.astype(f))
    x0 = geo["x0"].astype(f)
    prr_pred = ((x0[..., None, 3:6] - geo["sv_vel"].astype(f))
                * geo["los"].astype(f)).sum(-1)
    prr_meas = ((carr_freq.astype(f) - f(k["f_if"]))
                * f(k["c"] / k["fc"]))
    z_prr = prr_pred - prr_meas - x0[..., 7, None] + geo["clk_rate"].astype(f)
    return delta, np.concatenate([z_pr, z_prr], axis=-1)


def moment_snr_db(zk: np.ndarray) -> np.ndarray:
    """Post-correlation SNR [dB] of windows of prompt powers on the last
    axis, by the moment method (trackingCT.m:120-134), signed."""
    mean = zk.mean(-1)
    var = zk.var(-1, ddof=1)
    na2 = np.sqrt(np.maximum(mean * mean - var, 1e-30))
    ratio = na2 / np.maximum(mean - na2, 1e-30)
    return 10.0 * np.log10(np.maximum(ratio, 1e-30))


def measurement_matrix(los: np.ndarray) -> np.ndarray:
    """H (…, 2N, 8) of the unit lines of sight (…, N, 3) (…:374-376):
    pseudorange rows [−a 0 1 0], rate rows [0 −a 0 1]."""
    n = los.shape[-2]
    H = np.zeros(los.shape[:-2] + (2 * n, 8), los.dtype)
    H[..., :n, 0:3] = -los
    H[..., :n, 6] = 1.0
    H[..., n:, 3:6] = -los
    H[..., n:, 7] = 1.0
    return H


def ekf_chain(z: np.ndarray, p2: np.ndarray, los: np.ndarray, k: dict,
              dtype=np.float64, r_in: Optional[np.ndarray] = None,
              against: Optional[np.ndarray] = None,
              keep_gain: bool = False) -> Dict[str, np.ndarray]:
    """The EKF of B passes step by step from the stage's start (…:388-467),
    in `dtype`: the validity gate from the prompt powers p2 (B, T, N) (the
    mean SNR of the last 5 windows of k["window"] steps against the mask,
    3 dB of hysteresis), the measurement noise R (gated channels at
    k["r_masked"]; adaptive every k["r_update"] steps from the squares of
    z), P = F·P·Fᵀ + Q, K = P·Hᵀ·S⁻¹, Joseph's update, and K·z.  `los`
    (B, T, N, 3) gives H.  With `r_in` (B, T, 2N), the noise in force at
    each step, the gain takes that and R's own chain is only returned.

    Returns Kz (B, T, 8), P's diagonal, R and the gate of every step, with
    `against` (B, T, 8, 2N) `gain_rel` (B, T): each step's largest gap of
    a row of K against `against`, over that row's largest element of K;
    with `keep_gain` K itself."""
    f = dtype
    B, T, N = p2.shape
    n2 = 2 * N
    dt = 1e-3
    Fm = np.eye(8, dtype=f)
    Fm[0, 3] = Fm[1, 4] = Fm[2, 5] = Fm[6, 7] = dt
    Q = np.diag(np.array([k["q_pos"]] * 3 + [k["q_vel"]] * 3
                         + [k["q_clk"], k["q_clkd"]], f))
    P = np.broadcast_to(np.diag(np.array(k["p0"], f)), (B, 8, 8)).copy()
    r = np.broadcast_to(np.concatenate([np.full(N, k["r_pr0"]),
                                        np.full(N, k["r_prr0"])]).astype(f),
                        (B, n2)).copy()
    sq = np.zeros((B, n2), f)
    zk = np.zeros((B, N, k["window"]), np.float64)
    hist = np.full((B, N, 5), 99.0)
    valid = np.ones((B, N), bool)
    eye = np.eye(8, dtype=f)
    z = z.astype(f)
    out = dict(kz=np.zeros((B, T, 8), f), p_diag=np.zeros((B, T, 8), f),
               r=np.zeros((B, T, n2), f), valid=np.zeros((B, T, N), bool))
    if against is not None:
        out["gain_rel"] = np.zeros((B, T))
    if keep_gain:
        out["gain"] = np.zeros((B, T, 8, n2), f)
    H_all = measurement_matrix(los.astype(f))
    for t in range(T):
        zk[..., t % k["window"]] = p2[:, t]
        if (t + 1) % k["window"] == 0:
            hist = np.concatenate([hist[..., 1:],
                                   moment_snr_db(zk)[..., None]], axis=-1)
            m5 = hist.mean(-1)
            valid = np.where(valid, m5 >= k["mask_db"],
                             m5 >= k["mask_db"] + 3.0)
        v2 = np.concatenate([valid, valid], axis=-1)
        r_used = np.where(v2, r if r_in is None else r_in[:, t].astype(f),
                          f(k["r_masked"]))
        H = H_all[:, t]
        P = Fm @ P @ Fm.T + Q
        PHt = P @ H.transpose(0, 2, 1)
        S = H @ PHt
        S[:, np.arange(n2), np.arange(n2)] += r_used
        K = np.linalg.solve(S, PHt.transpose(0, 2, 1)).transpose(0, 2, 1)
        ikh = eye - K @ H
        P = ikh @ P @ ikh.transpose(0, 2, 1) \
            + (K * r_used[:, None, :]) @ K.transpose(0, 2, 1)
        P = f(0.5) * (P + P.transpose(0, 2, 1))
        sq += np.where(v2, z[:, t] * z[:, t], f(0.0))
        if (t + 1) % k["r_update"] == 0:
            m = sq / f(k["r_update"])
            r = np.concatenate([
                np.clip(m[:, :N] * f(10.0), k["r_min"], k["r_pr_max"]),
                np.clip(m[:, N:], k["r_min"], k["r_prr_max"])],
                axis=-1).astype(f)
            sq[:] = 0
        out["kz"][:, t] = (K @ z[:, t, :, None])[..., 0]
        out["p_diag"][:, t] = np.diagonal(P, axis1=1, axis2=2)
        out["r"][:, t] = r
        out["valid"][:, t] = valid
        if against is not None:
            row = np.abs(K).max(-1)
            gap = np.abs(against[:, t].astype(np.float64) - K).max(-1)
            out["gain_rel"][:, t] = (gap / np.maximum(row, 1e-30)).max(-1)
        if keep_gain:
            out["gain"][:, t] = K
    return out


def _stack(recs: List[Dict[str, np.ndarray]], key: str) -> np.ndarray:
    return np.stack([r[key] for r in recs])


def judge_vt(recs: List[Dict[str, np.ndarray]], k: dict, eph: dict,
             capture: np.ndarray, codes: np.ndarray, remove_dc: bool,
             samples: List[np.ndarray], device,
             dtype=np.float64) -> List[Gaps]:
    """The gaps of B vector-tracking passes: every step t ≥ 1 from step
    t − 1's recorded state (Δpr, z, the gain, the covariance and the state
    from step k["atmos"] + 1, the adaptive noise from its second
    interval), the EKF's chains from the start, and the correlators of
    the steps `samples[b]` draws against `correlate` in float64.  With
    `dtype` float32 the candidate is the control, the reference in
    float32, in the program's place."""
    S = {key: _stack(recs, key) for key in (
        "num_sample", "absolute_sample", "rem_chip", "code_freq",
        "carr_freq", "rem_phase", "carr_err", "transmit_time", "corr",
        "delta_pr")}
    x = np.concatenate([_stack(recs, "sol_usr_pos"),
                        _stack(recs, "sol_usr_vel"),
                        _stack(recs, "sol_clk_bias_m")[..., None],
                        _stack(recs, "sol_clk_drift_ms")[..., None]], axis=-1)
    B, T, N = S["num_sample"].shape
    a, b = slice(0, T - 1), slice(1, T)
    t0 = k["atmos"] + 1                     # the first step judged whole
    r_from = 2 * k["r_update"] - 1          # R's second update
    r_rec = _stack(recs, "sol_r_diag")
    r_in = np.concatenate([np.broadcast_to(np.concatenate(
        [np.full(N, k["r_pr0"]), np.full(N, k["r_prr0"])]), (B, 1, 2 * N)),
        r_rec[:, :-1]], axis=1)
    prev = dict(ptr=S["absolute_sample"][:, a], rem=S["rem_chip"][:, a],
                code_freq=S["code_freq"][:, a], carr_freq=S["carr_freq"][:, a],
                phase=phase_word(S["rem_phase"][:, a]),
                carr_err=S["carr_err"][:, a], tt=S["transmit_time"][:, a])
    corr = S["corr"]
    geo = vt_geometry(S["transmit_time"], S["num_sample"], x, eph, k, device)
    delta, z = vt_measurements(geo, corr, S["code_freq"], S["carr_freq"], k)
    ip = k["epl"][1]
    p2 = (corr[..., ip, 0].astype(np.float64) ** 2
          + corr[..., ip, 1].astype(np.float64) ** 2)
    ref = vt_rows(prev, dict(corr=corr[:, b], delta_pr=S["delta_pr"][:, b]),
                  k)
    if dtype == np.float64:
        cand = dict(num=S["num_sample"][:, b], ptr=S["absolute_sample"][:, b],
                    rem=S["rem_chip"][:, b],
                    phase=phase_word(S["rem_phase"][:, b]),
                    code_freq=S["code_freq"][:, b],
                    carr_err=S["carr_err"][:, b],
                    carr_freq=S["carr_freq"][:, b],
                    tt=S["transmit_time"][:, b], delta_pr=S["delta_pr"],
                    z=_stack(recs, "sol_innovation"), r=r_rec,
                    p_diag=_stack(recs, "sol_state_cov_diag"),
                    valid=_stack(recs, "sol_valid"), x=x[:, b])
        gain = _stack(recs, "sol_kalman_gain")
    else:
        c_delta, _ = vt_measurements(geo, corr, S["code_freq"],
                                     S["carr_freq"], k, dtype)
        cand = vt_rows(prev, dict(corr=corr[:, b], delta_pr=c_delta[:, b]),
                       k, dtype)
        code_freq = np.concatenate([S["code_freq"][:, :1],
                                    cand["code_freq"]], axis=1)
        carr_freq = np.concatenate([S["carr_freq"][:, :1],
                                    cand["carr_freq"]], axis=1)
        _, c_z = vt_measurements(geo, corr, code_freq, carr_freq, k, dtype)
        chain = ekf_chain(c_z, p2, geo["los"], k, dtype, keep_gain=True)
        gain = chain["gain"]
        x32 = x.astype(dtype)
        cand.update(delta_pr=c_delta, z=c_z, r=chain["r"],
                    p_diag=chain["p_diag"], valid=chain["valid"],
                    x=propagate(x32[:, a], dtype(1e-3)) + chain["kz"][:, b])
    own = ekf_chain(z, p2, geo["los"], k, r_in=r_in, against=gain)
    x_ref = propagate(x[:, a], 1e-3) + own["kz"][:, b]
    out = []
    for i in range(B):
        g = Gaps()

        def put(name, got, want):
            d = np.abs(np.asarray(got, np.float64)[i]
                       - np.asarray(want, np.float64)[i])
            g.put(name, d.max() if d.size else 0.0)

        def put_rel(name, got, want):
            w = np.asarray(want, np.float64)[i]
            d = np.abs(np.asarray(got, np.float64)[i] - w)
            g.put(name, (d / np.maximum(np.abs(w), 1e-30)).max())

        g.add("loop_block_mismatch", np.count_nonzero(
            (cand["num"][i] != ref["num"][i])
            | (cand["ptr"][i] != ref["ptr"][i])))
        g.add("loop_phase_mismatch",
              np.count_nonzero(cand["phase"][i] != ref["phase"][i]))
        for key, name in (("rem", "loop_rem_chip"),
                          ("code_freq", "loop_code_freq_hz"),
                          ("carr_freq", "loop_carr_freq_hz"),
                          ("tt", "vt_transmit_time_s")):
            put(name, cand[key], ref[key])
        put("vt_delta_pr_mps", cand["delta_pr"][:, t0:], delta[:, t0:])
        put("ekf_z_pr_m", cand["z"][:, t0:, :N], z[:, t0:, :N])
        put("ekf_z_prr_mps", cand["z"][:, t0:, N:], z[:, t0:, N:])
        g.add("vt_gate_mismatch",
              np.count_nonzero(cand["valid"][i] != own["valid"][i]))
        put_rel("ekf_r_rel", cand["r"][:, r_from:], own["r"][:, r_from:])
        put_rel("ekf_cov_rel", cand["p_diag"][:, t0:],
                own["p_diag"][:, t0:])
        g.put("ekf_gain_rel", own["gain_rel"][i, t0:].max())
        xs = slice(t0 - 1, None)            # x[:, b] starts at step 1
        put("ekf_pos_m", cand["x"][:, xs, 0:3], x_ref[:, xs, 0:3])
        put("ekf_vel_mps", cand["x"][:, xs, 3:6], x_ref[:, xs, 3:6])
        put("ekf_clk_m", cand["x"][:, xs, 6], x_ref[:, xs, 6])
        put("ekf_drift_mps", cand["x"][:, xs, 7], x_ref[:, xs, 7])
        for t in samples[i]:
            t = int(t)
            p = {kk: v[i, t] for kk, v in prev.items()}
            args = (capture, p["ptr"], ref["num"][i, t], p["rem"],
                    ref["code_freq"][i, t] / k["fs"], p["phase"],
                    ref["carr_fp"][i, t], codes, k["taps"], remove_dc,
                    device)
            want = correlate(*args)
            got = (corr[i, t + 1] if dtype == np.float64
                   else correlate(*args, dtype=dtype))
            g.put("bank_corr_rel", corr_gap(got, want, ip))
        g.add("blocks_checked", (T - 1) * N)
        out.append(g)
    return out
