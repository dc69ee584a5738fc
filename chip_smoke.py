#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA receiver (gps_sdr_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile-vt] [--ref-1000]

Phases, each printing one line of evidence:

1. Device and build: the card's name and power limit (nvidia-smi), then
   the kernel sources (track_chunk.cu; corr_bank.cu, which holds both
   banks) built together from gps_sdr_tpu_torch/csrc/ into build/.
2. Kernels against their plain PyTorch versions on the card, at the main
   path's shape (58 MHz, 8 channels), on the same inputs:
   - track_chunk: 1000 E/P/L blocks and 300 blocks of the 25-tap bank, plus
     a 77 ms chunk-chaining run, with the bounds of
     tests/test_pallas_fused.py; per-chunk times of both; every field bit
     for bit on clusters of 1 to 16 CTAs per channel (with their times),
     with DC removal, with int16 samples, and a chunk in which one channel
     runs into the fault (flag = 1 + channel, the others unharmed);
   - correlator_bank: one block at 3 taps and at the 29-tap VT grid, with
     and without DC removal, from the NCO state the tracker reached and
     from states spread over code phase, carrier frequency and block
     length; the fault flag for a window past the chunk; times of the
     kernel (as split over CTAs and on one CTA per channel), of the plain
     version and of an empty launch; the prepared launch (BankPlan) bit for
     bit against correlator_bank, for 4, 8, 12 and 32 channels (32: the
     VDFLL at the reference's full channel count, 4 parts a channel) and
     for 1, 2 and 4 taps (the instance that reads its tap count at run
     time), its time in a replayed graph and called eagerly, and its fault
     flag.
   - correlator_bank_windows (phase 2c): the bank over windows already cut
     out, at 3 taps and the 25-tap CT-POS grid, blocks of 1 ms and 10 ms,
     with and without DC removal, on 1 CTA per channel and the default
     split, from the tracked state and from spread states; equal bit for
     bit to correlator_bank on the same samples; the fault flag for a
     block length outside the window; times of the kernel, the wrapper,
     the window cut, the plain version, and of other splits; the prepared
     launch (WindowsPlan) bit for bit against it, in a graph and eagerly.
   - the same 100 blocks of 10 ms through tracking.track_scan (windows
     bank per block) and through track_chunk (one launch): every field
     equal bit for bit; times of both; track_scan's operations and launches per
     block (torch.profiler).
3. The main path: a 41 s, 58 MHz int8 capture of 8 SVs (transmit-time
   geometry + atmosphere, the repo's e2e workload) synthesized on the card
   into host memory, then Receiver.acquisition → track_for_eph(39800) →
   decode(1000) → usable_svs → ct_position(3000) → vt_position(1000), with
   both kernels' launches counted; then 200 ms of vt_scan from the VT
   stage's own start, run eagerly and replayed as CUDA graphs: every
   record field and the end state equal bit for bit, ms per step of each.
   Then the legacy position filter (solu.mode == 1): ct_position_kf(3000)
   on the same Receiver, its track_chunk launches counted on their own,
   and position() under a mode-1 config, served from its artifacts; then
   export_mat with the VT chain, which launches nothing, every file read
   back through io/matref equal to the results in memory.
4. The reference's 10 ms schedules on the same capture, a second Receiver
   with its own artifact directory: acquisition →
   track_for_eph_reference (500 ms at 1 ms, re-track, 40000 ms at 10 ms
   negated) → decode(1000) → usable_svs → ct_position(3000 rows with the
   per-channel pdi 1 → 10 ms switch), held against phase 3's ephemerides,
   with all three kernels' launches counted; then export_mat of the
   switched CT stage (tckRstCT_10ms_*, the pdi rows of the 1 → 10 switch).

5. Time-segmented eph tracking on phase 3's capture, a Receiver of its
   own: track_for_eph(39800, n_segments=8), 8 channels × 8 segments with a
   400 ms halo as one batch of 64, the capture uploaded to the card once
   and read in place by every chunk's track_chunk launch (6 of them); the
   last chunk, which reads past pair 2^31, again through the kernel and
   its plain version, every field and the end state equal bit for bit;
   the stitched record against phase 3's serial one (the gates of
   tests/test_time_segments.py, the alignment in chips); B1's time per
   chunk at 64 channels and its bound; then decode → the 8 ephemerides of
   phase 3 and ct_position(3000)'s WLS fixes.
6. The command line: a 47 s capture of the same scenario synthesized on
   the card into a file under build/, then
   `python -m gps_sdr_tpu_torch.cli <file> --preset opensky --ct-ms 3300
   --vt-ms 1000 --no-plots --out <dir>` in a process of its own: exit code,
   its acquisition table, usable SVs, the WLS and VT medians against the
   scenario's truth from its `.mat` files, every file read back through
   io/matref, its wall time and its kernel launches (it prints them).
7. Several processes (parallel/distributed.launch): a world of 2 ranks
   (gloo; both on the one card, kernels built by phase 1 before any rank
   starts) over phase 6's capture file at full width.  The `receiver` leg:
   Receiver(mesh="auto") makes the command's calls, acquisition (16 PRNs a
   rank) → track_for_eph_reference → decode → usable_svs → the switched
   ct_position(3300) (WLS epochs reduced over the ranks) → vt_position(1000)
   (one gather a ms), each rank's acquisition table, eph record,
   ephemerides and CT record bit for bit the command's (its artifacts), the
   fixes within 1e-6 m, VT within tests/test_mesh_pipeline.py's split of
   the command's and bit for bit a single-process VT stage from the same CT
   hand-off.  The `ingest` leg: the eph stage in 8 time segments, each rank
   reading only its segments' byte range of the file, the gathered and
   stitched record bit for bit the single-process segmented run (phase 5's
   route).  Per rank: its kernel launches, stage times, VT ms a step, read
   fraction.  One card shared by two ranks shows that the sharded path
   works on the card, not how it scales.
8. The command line under a world: `python -m torch.distributed.run
   --standalone --nproc-per-node 2 -m gps_sdr_tpu_torch.cli` over phase 6's
   file with phase 6's arguments and `--dist-backend gloo` (both ranks on
   the one card, kernels built by phase 1), cold: new `--artifacts` and
   `--out`.  Gates: exit code 0; the table, the usable SVs and the WLS and
   VT lines printed once, the same PRNs and usable SVs as phase 6; the
   `.mat` set read back and held against phase 6's files
   (parallel/distributed.compare_mat_exports: records exact, WLS within
   1e-6 m, VT within tests/test_mesh_pipeline.py's split); each rank's
   printed launch line with B1, B3 and B2 above 0.
9. The results record: `python -m gps_sdr_tpu_torch.results <dir>
   --no-plots --scaling-ranks 1,2` (the counterpart of make_results.py on
   the scenario of gps_sdr_tpu_torch/io/scenario.py, 32 s at 5 MHz) in a
   process of its own.  Gates: the 5 PRNs among those acquired and exactly
   those usable, the acquisition equal to the plain version's on the CPU
   over the same capture, WLS and VT medians < 120 m, RESULTS.md written
   with the card and its power limit at its head and the scaling table
   filled for 1 and 2 ranks, B1 and B2 launched.
10. The Urban front end (after phase 8, phase 6's capture deleted first): a
   47 s capture of the e2e scenario's 8 SVs at the `urban` preset's front
   end, 26 MHz int16 IQ at zero IF (the geometry's Dopplers of both signs),
   phase 6's C/N0, the front-end DC offset 230 − 95j added to the samples
   before they are quantized, the receiver at the preset's truth,
   synthesized on the card into a file
   under build/; then `python -m gps_sdr_tpu_torch.cli <file> --preset
   urban --ct-ms 3300 --vt-ms 1000 --no-plots --out <dir>` in a process of
   its own, with phase 6's gates, negative fine Dopplers among the 8 PRNs
   and the `.mat` set read back at 4 bytes a sample.  In this process, on
   the command's capture from its acquisition: track_chunk over a
   1000-block E/P/L chunk and a 300-block 25-tap chunk, the bank over 10 ms
   windows at 3 and 25 taps and the fetching bank at 3 taps (split, so the
   DC kernel runs first, and on one CTA per channel), all with DC removal,
   each bit for bit against its plain version, with times and bounds; the
   capture uploaded to the card as int16, rows equal to the file's; then
   the VT stage again from the command's CT artifacts, and 200 ms of its
   vt_scan (DC removal on) eager against replayed as CUDA graphs, every
   field and the end state bit for bit.

Receiver.report (the plots) is not run here: it needs matplotlib, which the
GPU machine does not have (hence the command's --no-plots); the CPU tests
run it.

Then one JSON line on the kernels, and as the last line
{"ok": true, "device": {...}}.  Any failure raises (exit code ≠ 0).
With --profile-vt, phase 3 also traces 100 ms of vt_scan with torch.profiler,
run eagerly and replayed, and prints where the host and the card spend
them and how many graph launches a replayed step takes.  With
--ref-1000, the eph schedule is run once more at the reference's own
1000 + 38000 ms and what it decodes is printed, without a gate.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from gps_sdr_tpu_torch import tracking
from gps_sdr_tpu_torch.acquisition import run_acquisition
from gps_sdr_tpu_torch.config import (CommonConfig, FileConfig,
                                      ReceiverConfig, SignalConfig,
                                      SolutionConfig, TrackConfig,
                                      opensky_config, urban_config)
from gps_sdr_tpu_torch.geo.coords import llh2xyz
from gps_sdr_tpu_torch.io.ifdata import (DeviceStager, IFSampleSource,
                                         upload_capture)
from gps_sdr_tpu_torch.io import matref
from gps_sdr_tpu_torch.io.synthetic import (GeometrySignal, GeometrySV,
                                            SyntheticSV, generate_if_samples,
                                            quantize_iq)
from gps_sdr_tpu_torch.io import scenario
from gps_sdr_tpu_torch.ops import _build
from gps_sdr_tpu_torch.ops import corr_bank as cb
from gps_sdr_tpu_torch.ops import track_chunk as tc
from gps_sdr_tpu_torch.parallel import distributed as pdist
from gps_sdr_tpu_torch.parallel import time_segments as ts
from gps_sdr_tpu_torch.pipeline import (SEGMENT_HALO_MS, Receiver,
                                        detect_bit_transition)
from gps_sdr_tpu_torch.receiver import vt as tvt
from gps_sdr_tpu_torch.receiver.ct_legacy import NavSolutionsKF
from gps_sdr_tpu_torch.receiver.vt import VTParams
from gps_sdr_tpu_torch.tracking import (TrackParams, chip_tables,
                                        init_track_state, run_tracking)

ROOT = os.path.dirname(os.path.abspath(__file__))

# ---- the repo's e2e workload (bench.py:353-419, tests/scenario.py) ----
FS, F_IF = 58e6, 4.58e6
CAPTURE_MS = 41000
EPH_MS, DECODE_OFFSET_MS, CT_MS, VT_MS = 39800, 1000, 3000, 1000
VT_SETTLE_MS = 500                      # VT gates read rows from here on
# phase 4, the reference's schedules (initParameters.m:66-68).  The 1 ms
# phases run 500 ms, not 1000, with the bit transition looked for from row
# 300: phase (c) restarts each channel at the re-based pointer
# ptr0 + (n1 + countinx)·S (trackingCT.m:403), which drops the code-Doppler
# drift of phases (a)/(b), |Doppler| / 1540 chips per second; after 1000 ms
# this workload's PRN 22 (2.9 kHz) and PRN 7 (−2.5 kHz) would restart 1.9
# and 1.7 chips off, past the ±1.5 chips the ±0.5-chip discriminator sees.
REF_1MS, REF_10MS, REF_MIN_TRANSITION, REF_CT_ROWS = 500, 40000, 300, 3000
PDI_SWITCH_MS = 1000
# the time-segmented eph stage: D segments of ceil(EPH_MS / D) ms, each with
# the Receiver's pull-in halo (SEGMENT_HALO_MS); its record's block ends must lie within
# SEG_ALIGN_CHIPS of the serial record's past row 300 (tests/
# test_time_segments.py allows 30 samples at 4.092 MHz, 7.5 chips)
SEGMENTS, SEG_ALIGN_CHIPS = 8, 1.0
PAIR_2_31 = 2 ** 31      # the segments' last chunk reads past this pair
# the command line: --preset opensky skips 5000 ms and tracks 1000 + 40000
# ms past it, so its capture is 47 s; it starts 7 s before TOW0 so that the
# first subframe decode() finds (from 3000 ms of the eph record on) lies at
# ~3.07 s, inside a CT record of CLI_CT_ROWS rows (10 ms each past the
# pdi switch at row 1000 + countinx)
CLI_MS, CLI_CT_ROWS, CLI_VT_MS = 47000, 3300, 1000
# phase 7: ranks of the world over the command's capture
RANKS = 2
# phase 10, the `urban` preset's front end (26 MHz int16, zero IF): the
# amplitudes and the noise ×URBAN_GAIN put the samples in the int16 range
# at phase 6's C/N0; the front end's DC offset (tests/test_urban_frontend.py)
URBAN_GAIN, URBAN_DC = 20.0, (230, -95)
SCAN_BLOCKS, SCAN_LEAD_MS = 100, 80     # the both-trackers segment
PRNS = (3, 7, 16, 22, 27, 1, 8, 30)
AMPS = (3.0, 2.6, 2.8, 2.4, 2.7, 2.2, 3.2, 2.0)
AMP_SCALE = 0.09
NOISE_STD = 8.0
TRUTH_LLH = (0.3897057693107332, 1.9926489077944098, 4.0)
TOW0 = 388799.0
CLI_TOW0 = TOW0 - 7.0
CLK_BIAS_S = 5e-4
CLK_DRIFT_SPS = 2e-9
WLS_GATE_M = 120.0                      # bench.py:470

# kernel-against-plain bounds (tests/test_pallas_fused.py)
BOUNDS = dict(rem_chip=2e-4, corr_rel=2e-3, freq_hz=0.05, phase_rad=0.02)
# correlator_bank against its plain version: largest difference over the
# mean prompt magnitude of the tracked state (both sum exact products in
# float64, so they differ at most where a sum rounds to float32)
BANK_BOUND_REL = 1e-6

# published peaks of one H100 SXM (dense): device memory and float32
# outside the tensor cores, which is what both kernels compute in
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# float32 operations per sample and channel: phasor product 6, mix 6, and
# per tap 2 products + 2 sums; DC removal adds 2 sums + 2 differences
OPS_PER_SAMPLE, OPS_PER_TAP, OPS_DC = 12, 4, 4


def cfg_e2e() -> ReceiverConfig:
    return ReceiverConfig(
        file=FileConfig(name="e2e58", skip_ms=0),
        signal=SignalConfig(f_if=F_IF, fs=FS),
        solu=SolutionConfig(truth_llh=TRUTH_LLH),
        cmn=CommonConfig(multicorr_ct=False, multicorr_vt=False))


def evidence(tag: str, **kw) -> None:
    print(json.dumps({"phase": tag, **kw}), flush=True)


def timed_ms(fn, repeat: int) -> float:
    """Mean device time of fn() over `repeat` runs (CUDA events)."""
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeat):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeat


def timed_graph_ms(fn, repeat: int, launches: int = 20) -> float:
    """Mean device time of fn(): `launches` calls captured in one CUDA
    graph, replayed `repeat` times.  Without the host's per-call work (the
    wrapper's checks and allocations), which `timed_ms` includes."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    return timed_ms(graph.replay, repeat) / launches


def compare(out, ref) -> dict:
    """Maxima of kernel − plain over two record dicts; raises past BOUNDS."""
    diff = (out["num_sample"] != ref["num_sample"]).nonzero()
    scale = float(ref["corr"].abs().mean())
    dphi = torch.remainder(out["rem_phase"] - ref["rem_phase"] + math.pi,
                           2 * math.pi) - math.pi
    m = dict(
        rem_chip=float((out["rem_chip"] - ref["rem_chip"]).abs().max()),
        corr_abs=float((out["corr"] - ref["corr"]).abs().max()),
        corr_scale=scale,
        code_freq_hz=float((out["code_freq"] - ref["code_freq"]).abs().max()),
        carr_freq_hz=float((out["carr_freq"] - ref["carr_freq"]).abs().max()),
        phase_rad=float(dphi.abs().max()),
        num_mismatch=int(diff.shape[0]),
        first_mismatch=diff[0].tolist() if diff.shape[0] else None)
    ok = (m["num_mismatch"] == 0
          and torch.equal(out["absolute_sample"], ref["absolute_sample"])
          and m["rem_chip"] <= BOUNDS["rem_chip"]
          and m["corr_abs"] <= BOUNDS["corr_rel"] * scale
          and max(m["code_freq_hz"], m["carr_freq_hz"]) <= BOUNDS["freq_hz"]
          and m["phase_rad"] <= BOUNDS["phase_rad"]
          and all(bool(torch.isfinite(out[f]).all())
                  for f in ("corr", "code_freq", "carr_freq", "rem_chip")))
    if not ok:
        raise AssertionError(f"kernel against plain out of bounds: {m}")
    return m


def bound_ms(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and float32 operations over the peak rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_FLOP_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=int(n_bytes), bound_operations=int(n_ops))


def chunk_bound(state, out: dict, raw: torch.Tensor, chips: torch.Tensor,
                spec) -> dict:
    """`bound_ms` of one track_chunk call: the chunk's samples once (the
    union of all block windows), the code tables, the records and state
    written once; the operations of every sample, tap and DC removal."""
    n_out = sum(out[f].numel() * out[f].element_size() for f in out)
    return bound_ms(
        union_samples(state.ptr, out["absolute_sample"][-1])
        * raw.element_size() * 2 + chips.numel() * 4 + n_out,
        int(out["num_sample"].sum()) * (
            OPS_PER_SAMPLE + OPS_PER_TAP * len(spec.taps)
            + OPS_DC * spec.remove_dc))


def bank_bound(raw: torch.Tensor, ptr: torch.Tensor, num: torch.Tensor,
               chips: torch.Tensor, ntaps: int, remove_dc: bool,
               windows: bool = False) -> dict:
    """`bound_ms` of one bank launch over blocks of `num` samples at `ptr`:
    the samples read once (each window's own for the windows entry, the
    union of the windows for the fetching one), the code tables, the NCO
    words, the result written once."""
    n = ptr.shape[0]
    n_samples = int(num.sum())
    read = n_samples if windows else union_samples(ptr, ptr + num)
    return bound_ms(
        read * 2 * raw.element_size() + chips.numel() * 4
        + n * (5 if windows else 6) * 8 + ntaps * 8 + n * ntaps * 2 * 4,
        n_samples * (OPS_PER_SAMPLE + OPS_PER_TAP * ntaps
                     + OPS_DC * remove_dc))


def union_samples(start: torch.Tensor, stop: torch.Tensor) -> int:
    """Samples covered by the union of the windows [start, stop)."""
    total, reach = 0, None
    for a, b in sorted(zip(start.tolist(), stop.tolist())):
        if reach is None or a > reach:
            total, reach = total + (b - a), b
        elif b > reach:
            total, reach = total + (b - reach), b
    return total


def ptxas_by_kernel(log: str) -> dict:
    """{kernel<template arguments>: what ptxas used} from `nvcc -Xptxas -v`
    output; the mangled entry names are read only as far as the kernels'
    own template lists (int..., then a for int8 or s for int16)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            mangled = m.group(1)
            k = re.search(r"\d+([a-z_]+?)I((?:Li\d+E)+)([as])EEv", mangled)
            if k:
                ints = re.findall(r"Li(\d+)E", k.group(2))
                name = (f"{k.group(1)}<{','.join(ints)},"
                        f"{'int8' if k.group(3) == 'a' else 'int16'}>")
            else:
                plain = re.findall(r"\d+([a-z]+(?:_[a-z]+)+)E", mangled)
                name = plain[-1] if plain else mangled
        elif name and "Used" in line and "registers" in line:
            out[name] = line.split(":", 1)[1].strip()
            name = None
    return out


def phase_device_and_build() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    built = _build.build_all(["track_chunk", "corr_bank"])
    wall = time.perf_counter() - t0
    tc.load_library()
    cb.load_library()
    evidence("build", wall_s=round(wall, 3), libraries={
        name: dict(library=os.path.relpath(path, ROOT),
                   build_s=round(secs, 3),
                   ptxas=ptxas_by_kernel(log))
        for name, (path, log, secs) in built.items()})
    return smi


def kernel_workload(dev: torch.device) -> dict:
    """What phase 2 tracks: simple-dynamics signals of the 8 e2e PRNs at
    their powers, 1100 ms at the e2e rates, and the channels' start."""
    cfg = cfg_e2e()
    S = cfg.signal.samples_per_ms
    rng = np.random.default_rng(3)
    dopp = rng.uniform(-4000.0, 4000.0, len(PRNS))
    delay = rng.uniform(0.0, S, len(PRNS))
    svs = [SyntheticSV(prn=p, amplitude=AMP_SCALE * a, doppler_hz=float(d),
                       code_delay_samples=float(c))
           for p, a, d, c in zip(PRNS, AMPS, dopp, delay)]
    n_ms = 1000 + 100     # 1000 blocks, or SCAN_LEAD_MS + 100 blocks of 10 ms
    values = quantize_iq(generate_if_samples(cfg, svs, n_ms, NOISE_STD,
                                             seed=5, device=dev))
    src = IFSampleSource.from_array(values, cfg.file)
    code_delays, fine = [], []
    for sv in svs:
        f_code = cfg.signal.code_freq_basis * (1 + sv.doppler_hz
                                               / cfg.signal.fc)
        next_epoch = sv.code_delay_samples % (1023 / f_code * FS)
        code_delays.append(int(round((S - next_epoch) % S)))
        fine.append(F_IF + sv.doppler_hz + 3.0)
    return dict(cfg=cfg, src=src, chips=chip_tables(PRNS, dev),
                stager=DeviceStager(dev), code_delays=code_delays, fine=fine)


def chunk_of(work: dict, kind: str, n_steps: int, dev: torch.device) -> tuple:
    """(raw, chunk_start, state, spec) of `n_steps` blocks of the tracker
    `kind` from the workload's start."""
    cfg = work["cfg"]
    spec = getattr(TrackParams, kind)(cfg).chunk_spec(cfg)
    state = init_track_state(cfg, work["code_delays"], work["fine"], dev)
    start = int(state.ptr.min())
    length = int(state.ptr.max()) - start + spec.chunk_samples(n_steps)
    raw = work["stager"].stage(work["src"].read_iq_values(start, length))
    return raw, start, state, spec


def phase_kernel_vs_plain(dev: torch.device) -> tuple:
    """The tracking kernel and its plain version on the same chunk at the
    e2e shape.  Returns (measurements, what the bank phases reuse: the
    capture, the code tables and the state after the 1000 E/P/L blocks)."""
    work = kernel_workload(dev)
    cfg, src, chips = work["cfg"], work["src"], work["chips"]
    code_delays, fine = work["code_delays"], work["fine"]
    res = {}
    for kind, n_steps in (("epl", 1000), ("pos_multicorr", 300)):
        raw, start, state, spec = chunk_of(work, kind, n_steps, dev)
        out, end = tc.track_chunk(raw, start, state, chips, spec, n_steps)
        ref, _ = tc.track_chunk_reference(raw, start, state, chips, spec,
                                          n_steps)
        tc.raise_on_fault(out)
        tc.raise_on_fault(ref)
        m = compare(out, ref)
        m["kernel_ms"] = timed_ms(lambda: tc.track_chunk(
            raw, start, state, chips, spec, n_steps), 5)
        m["plain_ms"] = timed_ms(lambda: tc.track_chunk_reference(
            raw, start, state, chips, spec, n_steps), 1)
        m["blocks"] = n_steps
        m.update(chunk_bound(state, out, raw, chips, spec))
        res[kind] = m
        if kind == "epl":
            tracked = end
            # the state the both-trackers segment starts from
            _, early = tc.track_chunk(raw, start, state, chips, spec,
                                      SCAN_LEAD_MS)
        if kind == "epl":
            res.update(_kernel_variants(raw, start, state, chips, spec, out))
        else:
            one, _ = tc._track_chunk_cuda(raw, start, state, chips, spec,
                                          n_steps, cluster=1)
            m["one_cta_differs"] = differing_fields(one, out)
            if m["one_cta_differs"]:
                raise AssertionError(f"{kind}: one CTA per channel differs "
                                     f"from the cluster in {m}")
    # chunk chaining: 77 ms chunks against one 1000 ms chunk, both kernel
    params = TrackParams.epl(cfg)
    one, _ = run_tracking(src, cfg, PRNS,
                          init_track_state(cfg, code_delays, fine, dev),
                          params, 1000)
    c77, _ = run_tracking(src, cfg, PRNS,
                          init_track_state(cfg, code_delays, fine, dev),
                          params, 1000, chunk_ms=77)
    m = compare({f: torch.as_tensor(getattr(c77, f)) for f in
                 ("corr", "code_freq", "carr_freq", "rem_chip", "rem_phase",
                  "num_sample", "absolute_sample")},
                {f: torch.as_tensor(getattr(one, f)) for f in
                 ("corr", "code_freq", "carr_freq", "rem_chip", "rem_phase",
                  "num_sample", "absolute_sample")})
    m["bitwise"] = all(np.array_equal(getattr(c77, f), getattr(one, f))
                       for f in ("corr", "code_freq", "carr_freq",
                                 "rem_chip", "rem_phase"))
    res["chain77"] = m
    evidence("kernel_vs_plain", bounds=BOUNDS, **res)
    return res, dict(cfg=cfg, src=src, chips=chips, stager=work["stager"],
                     tracked=tracked, early=early)


RECORD_FIELDS = ("corr", "code_err", "carr_err", "code_freq", "carr_freq",
                 "num_sample", "rem_chip", "rem_phase", "absolute_sample")
VARIANT_BLOCKS = 300


def differing_fields(a, b, rows=slice(None), chans=slice(None)) -> list:
    """The record fields of two runs that are not equal bit for bit."""
    return [f for f in RECORD_FIELDS
            if not torch.equal(a[f][rows][:, chans], b[f][rows][:, chans])]


def _kernel_variants(raw, start, state, chips, spec, out) -> dict:
    """track_chunk beyond the main path's shape, every field held bit for
    bit: cluster sizes against each other (1000 blocks, with their times),
    and over VARIANT_BLOCKS blocks DC removal on and int16 samples against
    the plain version and against one CTA per channel, and a chunk in which
    one channel's loop diverges into the fault."""
    dev = raw.device
    n = state.ptr.shape[0]
    n_steps = out["num_sample"].shape[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chosen = tc.cluster_size(n, sms)
    res = dict(cluster=chosen, cluster_ms={}, active_clusters={})
    c = 1
    while c <= 2 * tc.MAX_CLUSTER:   # the last is the non-portable size
        alt, _ = tc._track_chunk_cuda(raw, start, state, chips, spec, n_steps,
                                      cluster=c)
        diff = differing_fields(alt, out)
        if diff:
            raise AssertionError(f"track_chunk on clusters of {c} and of "
                                 f"{chosen} CTAs differs in {diff}")
        res["cluster_ms"][str(c)] = timed_ms(
            lambda: tc._track_chunk_cuda(raw, start, state, chips, spec,
                                         n_steps, cluster=c), 3)
        res["active_clusters"][str(c)] = tc.active_clusters(
            n, c, len(spec.taps), False, dev)
        c *= 2
    res["clusters_bitwise"] = True

    variants = dict(
        dc=(raw, spec._replace(remove_dc=True)),
        int16=(raw.to(torch.int16) * 100, spec),
        int16_dc=(raw.to(torch.int16) * 100, spec._replace(remove_dc=True)))
    for name, (x, sp) in variants.items():
        got, _ = tc.track_chunk(x, start, state, chips, sp, VARIANT_BLOCKS)
        one, _ = tc._track_chunk_cuda(x, start, state, chips, sp,
                                      VARIANT_BLOCKS, cluster=1)
        ref, _ = tc.track_chunk_reference(x, start, state, chips, sp,
                                          VARIANT_BLOCKS)
        for r in (got, one, ref):
            tc.raise_on_fault(r)
        m = dict(blocks=VARIANT_BLOCKS,
                 differs_from_plain=differing_fields(got, ref),
                 one_cta_differs=differing_fields(one, got),
                 kernel_ms=timed_ms(lambda: tc.track_chunk(
                     x, start, state, chips, sp, VARIANT_BLOCKS), 3))
        if m["differs_from_plain"] or m["one_cta_differs"]:
            raise AssertionError(f"track_chunk variant {name}: {m}")
        res[name] = m

    # one channel's DLL thrown far off: its blocks grow to millions of
    # samples and leave the chunk after a few; the other channels go on
    ch = n - 3
    bad = state._replace(dll_nco=state.dll_nco.clone())
    bad.dll_nco[ch] = -spec.dll_freq_sign * 1.0e6   # code_freq ~ 23 kHz
    clean, _ = tc.track_chunk(raw, start, state, chips, spec, VARIANT_BLOCKS)
    got, _ = tc.track_chunk(raw, start, bad, chips, spec, VARIANT_BLOCKS)
    ref, _ = tc.track_chunk_reference(raw, start, bad, chips, spec,
                                      VARIANT_BLOCKS)
    torch.cuda.synchronize()
    others = [c for c in range(n) if c != ch]
    m = dict(channel=ch, flag=int(got["fault"][0]),
             plain_flag=int(ref["fault"][0]),
             others_differ=differing_fields(got, clean, chans=others))
    try:
        tc.raise_on_fault(got)
    except RuntimeError:
        m["raised"] = True
    if not (m.get("raised") and m["flag"] == ch + 1 == m["plain_flag"]) \
            or m["others_differ"]:
        raise AssertionError(f"track_chunk fault case: {m}")
    res["fault"] = m
    return res


def _bank_case(raw, start, nco, chips, taps, blk, remove_dc, scale,
               fs=None):
    """One comparison: kernel (default split and one CTA per channel)
    against plain on the same inputs, at the rate `fs` (FS when None);
    raises past the bound."""
    dev, fs = raw.device, fs or FS
    tap_fp = cb.tap_offsets_fp(taps, dev)
    args = (raw, nco["ptr"] - start, nco["rem_chip"], nco["code_freq"],
            nco["phase_fp"], nco["carr_fp"], nco["num"], chips, tap_fp, fs,
            blk, remove_dc)
    out, fault = cb.correlator_bank(*args)
    one, fault1 = cb.correlator_bank(*args, n_split=1)
    ref, fault_ref = cb.correlator_bank_reference(*args)
    # the prepared launch (the tracked state's words are columns of a
    # packed state)
    plan = cb.BankPlan(raw, chips, tap_fp, fs, blk, remove_dc)
    words = tuple(t.contiguous() for t in args[1:7])
    prepared = plan(*words).clone()
    for f in (fault, fault1, fault_ref, plan.fault):
        cb.raise_on_fault(f)
    err = max(float((x - ref).abs().max()) for x in (out, one, prepared))
    m = dict(max_abs_err=err,
             bitwise=bool(torch.equal(out, ref) and torch.equal(one, ref)),
             prepared_bitwise=bool(torch.equal(prepared, out)),
             finite=bool(torch.isfinite(out).all()))
    if not (m["finite"] and m["prepared_bitwise"]) \
            or err > BANK_BOUND_REL * scale:
        raise AssertionError(f"correlator_bank against plain out of bounds "
                             f"({len(taps)} taps, remove_dc={remove_dc}): "
                             f"{m}, scale {scale}")
    m["args"] = args
    m["plan"], m["words"] = plan, words
    return m


def phase_bank_vs_plain(dev: torch.device, shared: dict) -> dict:
    """correlator_bank against correlator_bank_reference at 58 MHz and 8
    channels: from the NCO state the tracker reached after 1000 blocks
    (block lengths nominal −2..+2) and from states spread over code phase,
    carrier frequency (±5 kHz about the IF), carrier phase and window
    position."""
    cfg, src, chips = shared["cfg"], shared["src"], shared["chips"]
    st = shared["tracked"]
    n = st.ptr.shape[0]
    S = cfg.signal.samples_per_ms
    blk = -(-(S + 256) // 128) * 128
    i64, f64 = torch.int64, torch.float64
    rng = np.random.default_rng(17)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    def carr_fp_of(carr_freq):
        return torch.round(carr_freq / FS * tc.Q32).to(i64)

    nominal = torch.ceil((1023.0 - st.rem_chip) / (st.code_freq / FS)).to(i64)
    jitter = t([(i % 5) - 2 for i in range(n)], i64)
    locked = dict(ptr=st.ptr, rem_chip=st.rem_chip, code_freq=st.code_freq,
                  phase_fp=st.phase_fp.to(i64),
                  carr_fp=carr_fp_of(st.carr_freq), num=nominal + jitter)
    start = int(st.ptr.min()) - S
    raw = shared["stager"].stage(src.read_iq_values(start, 4 * S))
    dopp = rng.uniform(-5000.0, 5000.0, n)
    code_freq = t(cfg.signal.code_freq_basis * (1 + dopp / cfg.signal.fc),
                  f64)
    rem = t(rng.uniform(-0.4, 1.4, n), f64)
    spread = dict(
        ptr=t(start + rng.integers(0, 2 * S, n), i64), rem_chip=rem,
        code_freq=code_freq,
        phase_fp=t(rng.integers(-2 ** 31, 2 ** 31, n), i64),
        carr_fp=carr_fp_of(t(F_IF + dopp, f64)),
        num=torch.ceil((1023.0 - rem) / (code_freq / FS)).to(i64) + jitter)

    # the scale of every comparison: the tracked state's prompt magnitude
    epl = VTParams().taps
    p, _ = cb.correlator_bank_reference(
        raw, locked["ptr"] - start, locked["rem_chip"], locked["code_freq"],
        locked["phase_fp"], locked["carr_fp"], locked["num"], chips,
        cb.tap_offsets_fp(epl, dev), FS, blk)
    scale = float(torch.hypot(p[:, 1, 0], p[:, 1, 1]).mean())

    res = dict(bound_rel=BANK_BOUND_REL, prompt_scale=scale, cases={})
    timed = {}
    for name, taps in (("epl3", epl), ("vt29", VTParams.multicorr().taps)):
        for remove_dc in (False, True):
            for tag, nco in (("locked", locked), ("spread", spread)):
                m = _bank_case(raw, start, nco, chips, taps, blk, remove_dc,
                               scale)
                args, plan = m.pop("args"), m.pop("plan")
                words = m.pop("words")
                if tag == "locked":
                    flag = cb.new_fault(dev)
                    one_cta = cb.BankPlan(raw, chips, args[8], FS, blk,
                                          remove_dc, n_split=1)
                    # device time of the prepared launch from a replayed
                    # graph; host time of the same call run eagerly, and
                    # of the entry that checks and allocates on every call
                    m["kernel_ms"] = timed_graph_ms(
                        lambda: plan(*words), 10)
                    m["kernel_1cta_ms"] = timed_graph_ms(
                        lambda: one_cta(*words), 10)
                    m["prepared_eager_ms"] = timed_ms(
                        lambda: plan(*words), 200)
                    m["wrapper_ms"] = timed_ms(
                        lambda: cb.correlator_bank(*args, fault=flag), 50)
                    m["plain_ms"] = timed_ms(
                        lambda: cb.correlator_bank_reference(*args), 3)
                    timed[(name, remove_dc)] = m
                res["cases"][f"{name}_dc{int(remove_dc)}_{tag}"] = m
    res["max_abs_err"] = max(m["max_abs_err"] for m in res["cases"].values())
    res["bitwise"] = all(m["bitwise"] for m in res["cases"].values())
    res["n_split"] = cb.default_split(n, blk)
    res["threads"] = {f"{t}taps": cb.default_threads(t, res["n_split"], blk)
                      for t in (3, 29)}
    # other channel counts than the workload's 8: the first 4, 12 and 32
    # (the 8 again and again, each repeat's windows 1000 samples on)
    tap_fp = cb.tap_offsets_fp(epl, dev)
    res["channels"] = {}
    for count in (4, 12, 32):
        idx = torch.arange(count, device=dev) % n
        nco = {k: v[idx].contiguous() for k, v in locked.items()}
        nco["ptr"] = nco["ptr"] + 1000 * (torch.arange(count, device=dev)
                                          // n)
        words = (nco["ptr"] - start, nco["rem_chip"], nco["code_freq"],
                 nco["phase_fp"], nco["carr_fp"], nco["num"])
        sub = chips[idx].contiguous()
        plan = cb.BankPlan(raw, sub, tap_fp, FS, blk)
        got = plan(*words).clone()
        want, fault_ref = cb.correlator_bank_reference(
            raw, *words, sub, tap_fp, FS, blk)
        cb.raise_on_fault(plan.fault)
        cb.raise_on_fault(fault_ref)
        if not torch.equal(got, want):
            raise AssertionError(f"{count} channels: the prepared launch "
                                 "differs from the plain version")
        ms = timed_graph_ms(lambda: plan(*words), 10)
        res["channels"][str(count)] = dict(
            bitwise=True, n_split=cb.default_split(count, blk),
            kernel_ms=ms, kernel_us=ms * 1e3)
    # tap counts without an instance of their own, on one CTA per channel
    # and as split: the most threads a CTA of theirs may have
    res["other_tap_counts"] = {}
    words = tuple(t.contiguous() for t in (
        locked["ptr"] - start, locked["rem_chip"], locked["code_freq"],
        locked["phase_fp"], locked["carr_fp"], locked["num"]))
    for ntaps in (1, 2, 4):
        few = cb.tap_offsets_fp(np.linspace(-0.5, 0.5, ntaps), dev)
        want, _ = cb.correlator_bank_reference(raw, *words, chips, few, FS,
                                               blk)
        for n_split in (1, None):
            plan = cb.BankPlan(raw, chips, few, FS, blk, n_split=n_split)
            if not torch.equal(plan(*words), want):
                raise AssertionError(f"{ntaps} taps, n_split={n_split}: the "
                                     "prepared launch differs from the plain "
                                     "version")
            cb.raise_on_fault(plan.fault)
        res["other_tap_counts"][str(ntaps)] = dict(bitwise=True)
    res["empty_launch_ms"] = timed_graph_ms(lambda: cb.empty_launch(dev), 10)
    res["empty_launch_eager_ms"] = timed_ms(lambda: cb.empty_launch(dev), 200)

    # the main path's shape: 3 taps, int8 (no DC removal)
    head = timed[("epl3", False)]
    head.update(bank_bound(raw, locked["ptr"], locked["num"], chips, 3,
                           False))
    res["main_shape"] = head

    # nothing is clamped: a window past the end of the chunk raises the flag
    past = dict(locked, ptr=locked["ptr"].clone())
    past["ptr"][n - 1] = start + raw.shape[0] - 100
    _, fault = cb.correlator_bank(
        raw, past["ptr"] - start, past["rem_chip"], past["code_freq"],
        past["phase_fp"], past["carr_fp"], past["num"], chips,
        cb.tap_offsets_fp(epl, dev), FS, blk)
    plan = cb.BankPlan(raw, chips, tap_fp, FS, blk)
    zeroed = plan(*(t.contiguous() for t in (
        past["ptr"] - start, past["rem_chip"], past["code_freq"],
        past["phase_fp"], past["carr_fp"], past["num"])))
    res["fault_flag"] = int(fault[0])
    res["fault_flag_prepared"] = int(plan.fault[0])
    for f in (fault, plan.fault):
        try:
            cb.raise_on_fault(f)
        except RuntimeError:
            pass
        else:
            raise AssertionError("a window past the chunk raised no fault")
    if res["fault_flag"] != n or res["fault_flag_prepared"] != n \
            or bool(zeroed[n - 1].any()):
        raise AssertionError(f"fault flags {res['fault_flag']} / "
                             f"{res['fault_flag_prepared']}, expected {n}")
    evidence("bank_vs_plain", **res)
    return res


def _windows_case(raw, start, nco, chips, taps, blk, remove_dc, scale,
                  fs=None):
    """One comparison of the bank over windows: kernel (default split and
    one CTA per channel) against plain on the same windows, and against
    correlator_bank reading the same samples at ptr_off, at the rate `fs`
    (FS when None); raises past the bound or on any differing bit between
    the two kernels."""
    dev, fs = raw.device, fs or FS
    tap_fp = cb.tap_offsets_fp(taps, dev)
    off = nco["ptr"] - start
    cutter = cb.WindowCutter(raw, blk)
    win = cutter(off)
    words = (nco["rem_chip"], nco["code_freq"], nco["phase_fp"],
             nco["carr_fp"], nco["num"])
    args = (win, *words, chips, tap_fp, fs, remove_dc)
    out, fault = cb.correlator_bank_windows(*args)
    one, fault1 = cb.correlator_bank_windows(*args, n_split=1)
    ref, fault_ref = cb.correlator_bank_windows_reference(*args)
    fetched, fault_b2 = cb.correlator_bank(raw, off, *words, chips, tap_fp,
                                           fs, blk, remove_dc)
    for f in (fault, fault1, fault_ref, fault_b2):
        cb.raise_on_fault(f)
    err = max(float((out - ref).abs().max()), float((one - ref).abs().max()))
    m = dict(max_abs_err=err,
             bitwise=bool(torch.equal(out, ref) and torch.equal(one, ref)),
             equals_fetching_bank=bool(torch.equal(out, fetched)),
             finite=bool(torch.isfinite(out).all()))
    if not (m["finite"] and m["equals_fetching_bank"]) \
            or err > BANK_BOUND_REL * scale:
        raise AssertionError(
            f"correlator_bank_windows out of bounds ({len(taps)} taps, "
            f"blk {blk}, remove_dc={remove_dc}): {m}, scale {scale}")
    m["args"], m["out"] = args, out
    m["cut"] = (cutter, off)
    return m


def phase_windows_vs_plain(dev: torch.device, shared: dict) -> dict:
    """correlator_bank_windows against its plain version and against
    correlator_bank at 58 MHz and 8 channels: blocks of 1 and 10 ms, 3 taps
    and the 25-tap CT-POS grid, DC removal on and off, from the NCO state
    the tracker reached (block lengths nominal −2..+2) and from states
    spread over code phase, carrier and window position."""
    cfg, src, chips = shared["cfg"], shared["src"], shared["chips"]
    st = shared["early"]
    n = st.ptr.shape[0]
    S = cfg.signal.samples_per_ms
    i64, f64 = torch.int64, torch.float64
    rng = np.random.default_rng(23)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    def carr_fp_of(carr_freq):
        return torch.round(carr_freq / FS * tc.Q32).to(i64)

    start = int(st.ptr.min()) - S
    raw = shared["stager"].stage(src.read_iq_values(start, 14 * S))
    jitter = t([(i % 5) - 2 for i in range(n)], i64)
    dopp = rng.uniform(-5000.0, 5000.0, n)
    spread_freq = t(cfg.signal.code_freq_basis * (1 + dopp / cfg.signal.fc),
                    f64)
    spread_rem = t(rng.uniform(-0.4, 1.4, n), f64)
    grids = (("epl3", TrackParams.epl(cfg).taps),
             ("ct25", TrackParams.pos_multicorr(cfg).taps))

    res = dict(bound_rel=BANK_BOUND_REL, cases={}, n_split={})
    timed, split_args = {}, {}
    for pdi in (1, 10):
        blk = -(-(pdi * S + 256) // 128) * 128
        n_chips = 1023.0 * pdi
        res["n_split"][f"{pdi}ms"] = cb.default_split(n, blk)
        locked = dict(
            ptr=st.ptr, rem_chip=st.rem_chip, code_freq=st.code_freq,
            phase_fp=st.phase_fp.to(i64), carr_fp=carr_fp_of(st.carr_freq),
            num=torch.ceil((n_chips - st.rem_chip)
                           / (st.code_freq / FS)).to(i64) + jitter)
        spread = dict(
            ptr=t(start + rng.integers(0, 2 * S, n), i64),
            rem_chip=spread_rem, code_freq=spread_freq,
            phase_fp=t(rng.integers(-2 ** 31, 2 ** 31, n), i64),
            carr_fp=carr_fp_of(t(F_IF + dopp, f64)),
            num=torch.ceil((n_chips - spread_rem)
                           / (spread_freq / FS)).to(i64) + jitter)
        # the scale of this block length's comparisons: the prompt of the
        # tracked state
        p, _ = cb.correlator_bank_reference(
            raw, locked["ptr"] - start, locked["rem_chip"],
            locked["code_freq"], locked["phase_fp"], locked["carr_fp"],
            locked["num"], chips, cb.tap_offsets_fp(grids[0][1], dev), FS,
            blk)
        scale = float(torch.hypot(p[:, 1, 0], p[:, 1, 1]).mean())
        res[f"prompt_scale_{pdi}ms"] = scale
        for name, taps in grids:
            for remove_dc in (False, True):
                for tag, nco in (("locked", locked), ("spread", spread)):
                    m = _windows_case(raw, start, nco, chips, taps, blk,
                                      remove_dc, scale)
                    args, (cutter, off) = m.pop("args"), m.pop("cut")
                    out = m.pop("out")
                    if tag == "locked":
                        flag = cb.new_fault(dev)
                        # as track_scan calls it: prepared once (the
                        # tracked state's words are columns of a packed
                        # state); then the entry that prepares per call
                        plan, one_cta = (cb.WindowsPlan(
                            chips, args[7], FS, blk, remove_dc, flag,
                            n_split=k) for k in (None, 1))
                        call = tuple(t.contiguous() for t in args[:6])
                        if not torch.equal(plan(*call), out):
                            raise AssertionError(
                                "the prepared windows bank differs from "
                                "correlator_bank_windows")
                        m["kernel_ms"] = timed_graph_ms(
                            lambda: plan(*call), 10)
                        m["kernel_1cta_ms"] = timed_graph_ms(
                            lambda: one_cta(*call), 5, 5)
                        m["prepared_eager_ms"] = timed_ms(
                            lambda: plan(*call), 50)
                        m["wrapper_ms"] = timed_ms(
                            lambda: cb.correlator_bank_windows(
                                *args, fault=flag), 50)
                        m["plain_ms"] = timed_ms(
                            lambda: cb.correlator_bank_windows_reference(
                                *args), 3)
                        m["cut_ms"] = timed_graph_ms(
                            lambda: cutter(off), 10)
                        m["cut_eager_ms"] = timed_ms(
                            lambda: cutter(off), 50)
                        m["num"] = nco["num"]
                        timed[(name, pdi, remove_dc)] = m
                        if not remove_dc:
                            split_args[(name, pdi)] = args
                    res["cases"][f"{name}_{pdi}ms_dc{int(remove_dc)}_{tag}"] \
                        = m
    res["max_abs_err"] = max(m["max_abs_err"] for m in res["cases"].values())
    res["bitwise"] = all(m["bitwise"] for m in res["cases"].values())

    # the path's shape: 10 ms blocks, 3 taps, int8 (no DC removal)
    nums = {key: m.pop("num") for key, m in timed.items()}
    head = timed[("epl3", 10, False)]
    head.update(bank_bound(raw, st.ptr, nums[("epl3", 10, False)], chips, 3,
                           False, windows=True))
    res["main_shape"] = head
    # other numbers of CTAs per channel than the default
    flag = cb.new_fault(dev)
    for name, pdi, splits, dcs in (
            ("epl3", 1, (4, 8, 16, 32), (False, True)),
            ("epl3", 10, (8, 16, 24, 32, 64, 128), (False, True)),
            ("ct25", 10, (8, 16, 32, 64), (False,))):
        args = split_args[(name, pdi)]
        splits = sorted({*splits, cb.default_split(n, args[0].shape[1])})
        call = tuple(t.contiguous() for t in args[:6])
        for dc in dcs:
            plans = {k: cb.WindowsPlan(chips, args[7], FS, args[0].shape[1],
                                       dc, flag, n_split=k) for k in splits}
            res[f"split_{pdi}ms_{name}{'_dc' if dc else ''}_ms"] = {
                str(k): timed_graph_ms(lambda: plans[k](*call), 10)
                for k in splits}
    args = split_args[("epl3", 10)]

    # nothing is clamped: a block length outside [1, blk] raises the flag
    for bad_num, ch in ((blk + 1, n - 1), (0, 2)):
        num = locked["num"].clone()
        num[ch] = bad_num
        out, fault = cb.correlator_bank_windows(
            args[0], *args[1:5], num, *args[6:])
        try:
            cb.raise_on_fault(fault)
        except RuntimeError:
            pass
        else:
            raise AssertionError(f"num={bad_num} raised no fault")
        if int(fault[0]) != ch + 1 or bool(out[ch].any()):
            raise AssertionError(f"fault flag {int(fault[0])} for num="
                                 f"{bad_num} in channel {ch}")
    res["fault_flags"] = "raised"
    evidence("windows_vs_plain", **res)
    return res


def phase_both_trackers(dev: torch.device, shared: dict) -> dict:
    """The same SCAN_BLOCKS blocks of 10 ms (negated outputs, the eph
    schedule's phase (c)) from one state through `tracking.track_scan` and
    through the whole-chunk kernel `track_chunk`.  Gate: every record
    field equal bit for bit.  Also what one block of track_scan costs the host
    (torch.profiler: operations, kernel launches, device busy time)."""
    from torch.profiler import ProfilerActivity, profile
    cfg, src, chips = shared["cfg"], shared["src"], shared["chips"]
    st = shared["early"]
    spec = TrackParams.epl(cfg, pdi_ms=10, negate_iq=True).chunk_spec(cfg)
    start = int(st.ptr.min())
    length = int(st.ptr.max()) - start + spec.chunk_samples(SCAN_BLOCKS)
    raw = shared["stager"].stage(src.read_iq_values(start, length))

    def scan():
        return tracking.track_scan(raw, start, st, chips, spec, SCAN_BLOCKS)

    def chunk():
        return tc.track_chunk(raw, start, st, chips, spec, SCAN_BLOCKS)

    a, _ = scan()
    b, _ = chunk()
    tc.raise_on_fault(a)
    tc.raise_on_fault(b)
    same = bool(torch.equal(a["num_sample"], b["num_sample"])
                and torch.equal(a["absolute_sample"], b["absolute_sample"]))
    scale = float(b["corr"].abs().mean())
    dphi = torch.remainder(a["rem_phase"] - b["rem_phase"] + math.pi,
                           2 * math.pi) - math.pi
    res = dict(
        blocks=SCAN_BLOCKS, pdi_ms=10, integer_chain_identical=same,
        bitwise=all(bool(torch.equal(a[f], b[f])) for f in b),
        corr_abs=float((a["corr"] - b["corr"]).abs().max()), corr_scale=scale,
        code_freq_hz=float((a["code_freq"] - b["code_freq"]).abs().max()),
        carr_freq_hz=float((a["carr_freq"] - b["carr_freq"]).abs().max()),
        rem_chip=float((a["rem_chip"] - b["rem_chip"]).abs().max()),
        phase_rad=float(dphi.abs().max()))
    if not (same and res["bitwise"]):
        raise AssertionError(f"track_scan and track_chunk disagree (every "
                             f"field is to be equal bit for bit): {res}")

    def wall_ms(fn, repeat):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(repeat):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / repeat * 1e3

    res["track_scan_ms"] = wall_ms(scan, 3)
    res["track_chunk_ms"] = wall_ms(chunk, 3)
    res["track_scan_ms_per_block"] = res["track_scan_ms"] / SCAN_BLOCKS
    res["track_chunk_ms_per_block"] = res["track_chunk_ms"] / SCAN_BLOCKS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        scan()
        torch.cuda.synchronize()
    rows = prof.key_averages()

    def dev_us(r):
        return getattr(r, "self_device_time_total",
                       getattr(r, "self_cuda_time_total", 0.0))

    launches = sum(r.count for r in rows
                   if r.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC", "cuLaunchKernelEx"))
    res.update(
        aten_calls_per_block=sum(r.count for r in rows
                                 if r.key.startswith("aten::"))
        / SCAN_BLOCKS,
        kernel_launches_per_block=launches / SCAN_BLOCKS,
        device_busy_ms_per_block=sum(dev_us(r) for r in rows)
        / SCAN_BLOCKS / 1e3,
        top_device=[[r.key[:60], r.count, round(dev_us(r) / SCAN_BLOCKS, 2)]
                    for r in sorted(rows, key=lambda r: -dev_us(r))[:6]])
    evidence("both_trackers", **res)
    return res


class FirstScan:
    """Stands in for `receiver.vt.vt_scan` while the VT stage runs and keeps
    the arguments of the stage's first call: its chunk, the state the CT
    stage handed over, the ephemerides and the parameters."""

    def __init__(self):
        self.scan, self.args = tvt.vt_scan, None

    def __call__(self, *args, **kw):
        if self.args is None:
            self.args = args
        return self.scan(*args, **kw)

    def run(self, n_steps: int, graph: bool):
        """`n_steps` ms from the kept start; (end state, records, wall s)."""
        args = self.args[:8] + (n_steps,) + self.args[9:]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, rec = self.scan(*args, graph=graph)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        cb.raise_on_fault(rec["fault"])
        return state, rec, wall


def solve_capture_check(dev: torch.device, rows: int = 8) -> dict:
    """What vt_scan's captured step relies on, by itself:
    torch.linalg.solve_ex on a 16 × 16 float32 system (the EKF's size)
    captured into a CUDA graph as it is, beside an index_copy_ at a row index
    that the graph itself advances.  Replayed once per row and no more (a
    replay past the last row would write out of bounds): every row equal to
    the eager solve bit for bit, every info 0, the row index at `rows`; the
    graph is released before the function returns."""
    gen = torch.Generator(device=dev).manual_seed(3)
    a = torch.randn(rows, 16, 16, generator=gen, device=dev) \
        + 16.0 * torch.eye(16, device=dev)
    b = torch.randn(rows, 16, 8, generator=gen, device=dev)
    eager = torch.stack([torch.linalg.solve_ex(a[i], b[i])[0]
                         for i in range(rows)])
    a_in, b_in = a[0].clone(), b[0].clone()
    out = torch.zeros_like(b)
    infos = torch.full((rows,), -1, dtype=torch.int32, device=dev)
    row = torch.zeros(1, dtype=torch.int64, device=dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        x, info = torch.linalg.solve_ex(a_in, b_in)
        out.index_copy_(0, row, x.unsqueeze(0))
        infos.index_copy_(0, row, info.reshape(1))
        row += 1
    for i in range(rows):
        a_in.copy_(a[i])
        b_in.copy_(b[i])
        graph.replay()
    torch.cuda.synchronize()
    res = dict(rows=rows,
               rows_equal=[bool(torch.equal(out[i], eager[i]))
                           for i in range(rows)],
               infos=infos.tolist(), row_index=int(row[0]))
    del graph
    torch.cuda.synchronize()
    if not all(res["rows_equal"]) or any(res["infos"]) \
            or res["row_index"] != rows:
        raise AssertionError(f"solve_ex captured into a graph: {res}")
    return res


def vt_graph_vs_eager(first: FirstScan, n_ms: int = 200,
                      path: str = "main_path") -> dict:
    """`n_ms` of vt_scan from the VT stage's start, run eagerly and
    replayed as CUDA graphs (a C/N0 window every 20 ms, the adaptive-R
    update at step 200, four refreshes of which two renew the atmosphere):
    every record field and the end state equal bit for bit.  Then the
    whole chunk replayed once more: what a replayed step takes once the
    chunk's graphs are made, and what making them costs a chunk."""
    before = cb.correlator_bank.launches
    runs = {name: first.run(n_ms, graph)
            for name, graph in (("eager", False), ("graph", True),
                                ("graph_again", True))}
    launched = cb.correlator_bank.launches - before
    whole = first.run(VT_MS, True)[2]
    cb.correlator_bank.launches = before
    (st_e, rec_e, _), (st_g, rec_g, _) = runs["eager"], runs["graph"]
    differ = [k for k in rec_e if not torch.equal(rec_e[k], rec_g[k])] \
        + [f"state.{k}" for k, v in st_e._asdict().items()
           if not torch.equal(v, getattr(st_g, k))]
    res = dict(n_ms=n_ms, fields=len(rec_e), differing=differ,
               bank_launches=launched,
               **{f"{name}_ms_per_step": wall / n_ms * 1e3
                  for name, (_, _, wall) in runs.items()})
    again = runs["graph_again"][2]
    res["replayed_ms_per_step"] = (whole - again) / (VT_MS - n_ms) * 1e3
    res["captures_ms_per_chunk"] = (again - (whole - again)
                                    / (VT_MS - n_ms) * n_ms) * 1e3
    if differ or rec_e.keys() != rec_g.keys() or launched != 3 * n_ms:
        raise AssertionError(f"vt_scan replayed against eager: {res}")
    res["solve_capture"] = solve_capture_check(st_g.ptr.device)
    evidence("vt_graph_vs_eager", path=path, **res)
    return res


def profile_vt(first: FirstScan, n_ms: int = 100) -> None:
    """Trace `n_ms` of vt_scan from the VT stage's start, run eagerly
    and replayed: the step's operation count and its largest items on the
    host and the card, and the graph launches a replayed step takes."""
    from torch.profiler import ProfilerActivity, profile

    def dev_us(r):
        return getattr(r, "self_device_time_total",
                       getattr(r, "self_cuda_time_total", 0.0))

    before = cb.correlator_bank.launches
    res = {}
    for name, graph in (("eager", False), ("graph", True)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, _, wall = first.run(n_ms, graph)
        rows = prof.key_averages()
        res[name] = dict(
            wall_s=wall,
            aten_calls_per_step=sum(r.count for r in rows
                                    if r.key.startswith("aten::")) / n_ms,
            graph_launches_per_step=sum(
                r.count for r in rows
                if r.key in ("cudaGraphLaunch", "cuGraphLaunch")) / n_ms,
            host_self_ms_per_step=sum(r.self_cpu_time_total for r in rows)
            / n_ms / 1e3,
            device_busy_ms_per_step=sum(dev_us(r) for r in rows)
            / n_ms / 1e3,
            top_host=[[r.key, r.count,
                       round(r.self_cpu_time_total / n_ms, 2)]
                      for r in sorted(rows,
                                      key=lambda r: -r.self_cpu_time_total)
                      [:12]],
            top_device=[[r.key[:60], r.count, round(dev_us(r) / n_ms, 2)]
                        for r in sorted(rows, key=lambda r: -dev_us(r))[:8]])
    cb.correlator_bank.launches = before
    evidence("vt_profile", n_ms=n_ms, **res)


def kernel_launches() -> tuple:
    """(track_chunk, correlator_bank_windows, correlator_bank) counts."""
    return (tc.track_chunk.launches, cb.correlator_bank_windows.launches,
            cb.correlator_bank.launches)


def zero_launches() -> None:
    tc.track_chunk.launches = 0
    cb.correlator_bank_windows.launches = 0
    cb.correlator_bank.launches = 0


def legacy_filter(rx: Receiver, usr: np.ndarray) -> dict:
    """The legacy position filter (solu.mode == 1) on phase 3's Receiver:
    ct_position_kf(CT_MS) tracks the usable SVs again (one track_chunk
    launch a 1000 ms chunk) and runs the 8-state filter over relative
    pseudoranges from the truth position; then a Receiver with a mode-1
    config on the same directory answers position() from the artifacts,
    launching nothing."""
    zero_launches()
    t0 = time.perf_counter()
    rec, nav = rx.ct_position_kf(n_ms=CT_MS, init_pos_ecef=usr)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    want = (-(-CT_MS // 1000), 0, 0)
    if launches != want:
        raise AssertionError(f"ct_position_kf launched (track_chunk, windows "
                             f"bank, fetching bank) {launches}, expected "
                             f"{want}")
    if not isinstance(nav, NavSolutionsKF) or len(nav.usr_pos) == 0 \
            or not all(np.all(np.isfinite(np.asarray(v)))
                       for v in vars(nav).values()):
        raise AssertionError("no finite legacy-filter fixes")
    err = np.linalg.norm(nav.usr_pos - usr, axis=1)
    med = float(np.median(err))
    if med >= WLS_GATE_M:
        raise AssertionError(f"legacy filter median error {med:.1f} m >= "
                             f"{WLS_GATE_M}")
    # the common 75 ms-base offset of the relative pseudoranges is in the
    # clock state (tests/test_legacy_components.py)
    clk = float(nav.clk_bias_m[-1])
    if not 1e5 < abs(clk) < 3e6:
        raise AssertionError(f"clock state {clk:.0f} m does not hold the "
                             "75 ms-base offset")
    cfg1 = dataclasses.replace(rx.cfg, solu=dataclasses.replace(
        rx.cfg.solu, mode=1))
    zero_launches()
    _, nav1 = Receiver(cfg1, rx.source, artifact_dir=rx.dir,
                       device=rx.device).position(n_ms=CT_MS,
                                                  init_pos_ecef=usr)
    if kernel_launches() != (0, 0, 0) or not np.array_equal(nav1.usr_pos,
                                                            nav.usr_pos):
        raise AssertionError(f"position() under mode 1 launched "
                             f"{kernel_launches()} or differs from "
                             "ct_position_kf")
    res = dict(stage_s=wall, epochs=int(len(err)), track_chunk_launches=
               launches[0], median_err_m=med, max_err_m=float(np.max(err)),
               clk_bias_m_last=clk, mode1_position_launches=0)
    evidence("ct_position_kf", **res)
    return res


def _equal_fields(loaded, ref, fields, what) -> None:
    for f in fields:
        if not np.array_equal(getattr(loaded, f), getattr(ref, f)):
            raise AssertionError(f"{what}: {f} read back differs")


def export_and_reload(rx: Receiver, out: str, ct_kw: dict,
                      vt_kw: dict | None) -> dict:
    """Receiver.export_mat (with the VT chain when `vt_kw` is given) from
    the stage artifacts: no kernel launches; every file read back through
    io/matref equal to what the stages return from memory."""
    zero_launches()
    t0 = time.perf_counter()
    rx.export_mat(out, ct_kw=ct_kw, vt=vt_kw is not None, vt_kw=vt_kw)
    wall = time.perf_counter() - t0
    if kernel_launches() != (0, 0, 0):
        raise AssertionError(f"export_mat launched {kernel_launches()}")
    cfg, name = rx.cfg, rx.cfg.file.name
    S, bps = cfg.signal.samples_per_ms, cfg.file.bytes_per_sample
    prns = rx.usable_svs()
    eph, sbf = rx.decode()
    acq = rx.acquisition()
    rec, nav = rx.ct_position(**ct_kw)
    pdi_rows, _ = matref.pdi_from_block_sizes(rec.num_sample, S)
    tag = int(pdi_rows.max())
    files = sorted(os.listdir(out))
    want = sorted([f"nAcquired_{name}_{cfg.file.skip_ms}.mat",
                   f"eph_{name}.mat", f"sbf_{name}.mat",
                   f"tckRstCT_{tag}ms_{name}.mat",
                   f"navSolCT_{tag}ms_{name}.mat"]
                  + ([f"tckRstVT_{name}_updated.mat",
                      f"navSolVT_{name}_updated.mat"] if vt_kw else []))
    if files != want:
        raise AssertionError(f"export_mat wrote {files}, expected {want}")
    path = lambda f: os.path.join(out, f)
    got, got_pdi = matref.load_tck_records(
        path(f"tckRstCT_{tag}ms_{name}.mat"), prns, bytes_per_sample=bps,
        samples_per_ms=S)
    _equal_fields(got, rec, tracking._REC_FIELDS, "tckRstCT")
    if not np.array_equal(got_pdi, pdi_rows):
        raise AssertionError("tckRstCT: pdi rows differ")
    _equal_fields(matref.load_navsol(path(f"navSolCT_{tag}ms_{name}.mat")),
                  nav, ("usr_pos", "usr_vel", "clk_bias_m", "transmit_time",
                        "raw_pseudorange", "local_time"), "navSolCT")
    loaded = matref.load_eph(path(f"eph_{name}.mat"))
    decoded = [p for p, r in eph.items() if r.tow or r.updateflag]
    if sorted(loaded) != sorted(decoded) or any(
            dataclasses.asdict(loaded[p]) != dataclasses.asdict(eph[p])
            for p in decoded):
        raise AssertionError("eph read back differs")
    nav1 = matref.load_sbf(path(f"sbf_{name}.mat"))["nav1"]
    na = matref.load_nacquired(
        path(f"nAcquired_{name}_{cfg.file.skip_ms}.mat"))
    ch = [acq.channel_index(p) for p in prns]
    if any(nav1[p] != sbf["nav1"][p] for p in prns) \
            or list(na["sv"]) != list(prns) \
            or not np.array_equal(na["code_delay"], acq.code_delay[ch]):
        raise AssertionError("sbf / nAcquired read back differ")
    res = dict(export_s=wall, files=files, pdi_tag_ms=tag, launches=0,
               reloads_equal=True)
    if vt_kw:
        trk, sol = rx.vt_position(**vt_kw)
        got_trk, cn0 = matref.load_vt_records(
            path(f"tckRstVT_{name}_updated.mat"), prns, bytes_per_sample=bps)
        _equal_fields(got_trk, trk, ("corr", "carr_err", "code_err",
                                     "code_freq", "carr_freq", "delta_pr",
                                     "absolute_sample", "sv_vel", "rem_chip",
                                     "rem_phase", "carr_nco"), "tckRstVT")
        g = matref.load_navsol_vt(path(f"navSolVT_{name}_updated.mat"))
        if not (np.array_equal(g["usrPos"], sol.usr_pos)
                and np.array_equal(g["kalman_gain"],
                                   np.transpose(sol.kalman_gain, (1, 2, 0)))):
            raise AssertionError("navSolVT read back differs")
        res["cn0_vt_rows"] = int(cn0.shape[0])
    res["pdi_rows"] = pdi_rows
    return res


def phase_main_path(dev: torch.device, workdir: str,
                    with_profile: bool = False) -> dict:
    cfg = cfg_e2e()
    S = cfg.signal.samples_per_ms
    usr = llh2xyz(np.asarray(TRUTH_LLH)).numpy()
    ephs = scenario.visible_constellation(len(PRNS), truth_llh=TRUTH_LLH)
    gs = GeometrySignal(
        cfg, [GeometrySV(prn=p, eph=e, amplitude=AMP_SCALE * a)
              for p, e, a in zip(PRNS, ephs, AMPS)],
        usr, TOW0, clk_bias_s=CLK_BIAS_S, clk_drift_sps=CLK_DRIFT_SPS,
        atmosphere=True, iono_alpha=cfg.cmn.iono_alpha,
        iono_beta=cfg.cmn.iono_beta, doy=cfg.cmn.day_of_year, device=dev)
    t0 = time.perf_counter()
    values = gs.synthesize(CAPTURE_MS, noise_std=NOISE_STD, seed=11)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    src = IFSampleSource.from_array(values, cfg.file)
    rx = Receiver(cfg, src, artifact_dir=workdir, device=dev)

    stages = {}

    def stage(name, fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t
        return out

    tc.track_chunk.launches = 0
    cb.correlator_bank.launches = 0
    acq = stage("acquisition_s", rx.acquisition)
    eph_rec = stage("eph_tracking_s", lambda: rx.track_for_eph(n_ms=EPH_MS))
    stage("decode_s", lambda: rx.decode(start_offset_ms=DECODE_OFFSET_MS))
    usable = stage("usable_svs_s", rx.usable_svs)
    # the start position is given (the default, the truth position), so the
    # VT stage finds the CT stage's artifact under the same key
    ct_rec, nav = stage("ct_wls_s", lambda: rx.ct_position(
        n_ms=CT_MS, init_pos_ecef=usr))
    launches = tc.track_chunk.launches
    if cb.correlator_bank.launches != 0:
        raise AssertionError("the scalar path launched correlator_bank")
    # the vector-tracking path, counted on its own: its CT stage is served
    # from the artifact just written, so only the bank launches here
    tc.track_chunk.launches = 0
    cb.correlator_bank.launches = 0
    first_scan = tvt.vt_scan = FirstScan()
    try:
        vt_trk, vt_sol = stage("vt_ekf_s", lambda: rx.vt_position(
            n_ms=VT_MS, ct_n_ms=CT_MS, init_pos_ecef=usr))
    finally:
        tvt.vt_scan = first_scan.scan
    bank_launches = cb.correlator_bank.launches
    if tc.track_chunk.launches != 0:
        raise AssertionError("vt_position tracked CT again instead of "
                             "loading its artifact")
    graph_res = vt_graph_vs_eager(first_scan)
    if with_profile:
        profile_vt(first_scan)
    del first_scan
    kf_res = legacy_filter(rx, usr)
    exp = export_and_reload(
        rx, os.path.join(workdir, "mat"), dict(n_ms=CT_MS, init_pos_ecef=usr),
        dict(n_ms=VT_MS, ct_n_ms=CT_MS, init_pos_ecef=usr))
    exp.pop("pdi_rows")
    evidence("export_mat", path="phase 3", **exp)

    missing = sorted(set(PRNS) - set(int(p) for p in acq.sv))
    if missing:
        raise AssertionError(f"acquisition missed PRNs {missing}: {acq.sv}")
    if len(usable) < 4:
        raise AssertionError(f"only {len(usable)} usable SVs: {usable}")
    if eph_rec.corr.shape != (EPH_MS, len(acq.sv), 3, 2) or \
            ct_rec.corr.shape != (CT_MS, len(usable), 3, 2):
        raise AssertionError("unexpected record shapes")
    for rec in (eph_rec, ct_rec):
        if not all(np.isfinite(getattr(rec, f)).all()
                   for f in ("corr", "code_freq", "carr_freq", "rem_chip")):
            raise AssertionError("non-finite tracking records")
    err = np.linalg.norm(nav.usr_pos - usr, axis=1)
    if len(err) == 0 or not np.all(np.isfinite(nav.usr_pos)):
        raise AssertionError("no finite WLS fixes")
    med = float(np.median(err))
    if med >= WLS_GATE_M:
        raise AssertionError(f"WLS median error {med:.1f} m >= {WLS_GATE_M}")
    expect = -(-EPH_MS // 1000) + -(-CT_MS // 1000)   # one per chunk
    if launches != expect:
        raise AssertionError(f"track_chunk launched {launches} times, "
                             f"expected {expect} (one per chunk)")
    if bank_launches != VT_MS:
        raise AssertionError(f"correlator_bank launched {bank_launches} "
                             f"times, expected {VT_MS} (one per ms)")
    n_vt = len(usable)
    if vt_trk.corr.shape != (VT_MS, n_vt, 3, 2) or \
            vt_sol.usr_pos.shape != (VT_MS, 3) or \
            vt_sol.kalman_gain.shape != (VT_MS, 8, 2 * n_vt):
        raise AssertionError("unexpected VT record shapes")
    for obj in (vt_trk, vt_sol):
        for name, arr in vars(obj).items():
            if not np.all(np.isfinite(arr)):
                raise AssertionError(f"non-finite VT output: {name}")
    n_valid = vt_sol.valid[VT_SETTLE_MS:].sum(axis=1)
    if n_valid.min() < 4:
        raise AssertionError(f"VT gate kept {n_valid.min()} channels")
    vt_err = np.linalg.norm(vt_sol.usr_pos - usr, axis=1)[VT_SETTLE_MS:]
    vt_med = float(np.median(vt_err))
    if vt_med >= WLS_GATE_M:
        raise AssertionError(f"VT median error {vt_med:.1f} m >= "
                             f"{WLS_GATE_M}")
    stages["ct_kf_s"] = kf_res["stage_s"]
    stages["export_mat_s"] = exp["export_s"]
    res = dict(
        capture_s=CAPTURE_MS / 1000, synth_s=gen_s, stages=stages,
        acquired=[int(p) for p in acq.sv],
        snr_db=[round(float(s), 2) for s in acq.snr_db],
        usable_svs=[int(p) for p in usable], wls_epochs=int(len(err)),
        wls_median_err_m=med, wls_max_err_m=float(np.max(err)),
        track_chunk_launches=launches,
        vt_ms=VT_MS, vt_channels=n_vt, vt_median_err_m=vt_med,
        vt_max_err_m=float(np.max(vt_err)),
        vt_min_valid_channels=int(n_valid.min()),
        vt_ms_per_step=stages["vt_ekf_s"] / VT_MS * 1e3,
        vt_eager_ms_per_step=graph_res["eager_ms_per_step"],
        correlator_bank_launches=bank_launches,
        eph_tracking_capture_samples_per_s=EPH_MS * S
        / stages["eph_tracking_s"],
        eph_tracking_channel_samples_per_s=EPH_MS * S * len(acq.sv)
        / stages["eph_tracking_s"])
    evidence("main_path", **res)
    return res, dict(src=src, usr=usr, eph=rx.decode()[0],
                     usable=[int(p) for p in usable], eph_rec=eph_rec,
                     eph_tracking_s=stages["eph_tracking_s"])


def restart_offsets_chips(rec, sw_rows) -> list:
    """Per channel, how far phase (c) of the eph schedule restarts from
    where phase (b) stood at its switch row [chips]: the re-based pointer
    (trackingCT.m:403) drops the code-Doppler drift of the 1 ms phases."""
    out = []
    for ch, sw in enumerate(sw_rows):
        rebased = rec.absolute_sample[sw, ch] - rec.num_sample[sw, ch]
        out.append(round(float(
            (rebased - rec.absolute_sample[sw - 1, ch]) * 1.023e6 / FS), 3))
    return out


def reference_schedule_1000(dev: torch.device, workdir: str,
                            main: dict) -> None:
    """The eph schedule at the reference's own 1000 + 38000 ms (what the
    41 s capture holds), for the record: restart offsets and what decodes.
    No gate: after 1000 ms some channels restart beyond the discriminator's
    reach."""
    cfg = dataclasses.replace(
        cfg_e2e(), file=FileConfig(name="e2e58ref1000", skip_ms=0),
        track=TrackConfig(ms_eph_1ms=1000, ms_eph_10ms=38000))
    rx = Receiver(cfg, main["src"], artifact_dir=workdir, device=dev)
    rec = rx.track_for_eph_reference()
    acq = rx.acquisition()
    cnt = [detect_bit_transition(rec.p_i[:1000, ch])
           for ch in range(len(acq.sv))]
    eph, _ = rx.decode(start_offset_ms=DECODE_OFFSET_MS)
    evidence("reference_schedule_1000", prns=[int(p) for p in acq.sv],
             countinx=cnt,
             restart_offset_chips=restart_offsets_chips(
                 rec, [1000 + c for c in cnt]),
             usable_svs=[int(p) for p in rx.usable_svs()],
             first_tow={int(p): (e.tow[0] if e.tow else None)
                        for p, e in eph.items()})


def phase_reference_schedules(dev: torch.device, workdir: str,
                              main: dict) -> dict:
    """The reference's 10 ms schedules at full width on phase 3's capture,
    through a second Receiver that shares nothing with the first but the
    samples: acquisition → track_for_eph_reference → decode →
    usable_svs → ct_position with the per-channel pdi 1 → 10 ms switch."""
    cfg = dataclasses.replace(
        cfg_e2e(), file=FileConfig(name="e2e58ref", skip_ms=0),
        track=TrackConfig(ms_eph_1ms=REF_1MS, ms_eph_10ms=REF_10MS,
                          ct_pdi_switch_ms=PDI_SWITCH_MS))
    S = cfg.signal.samples_per_ms
    usr = main["usr"]
    rx = Receiver(cfg, main["src"], artifact_dir=workdir, device=dev)
    stages = {}

    def stage(name, fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t
        return out

    zero_launches()
    acq = stage("acquisition_s", rx.acquisition)
    rec = stage("eph_reference_s", lambda: rx.track_for_eph_reference(
        min_transition_index=REF_MIN_TRANSITION))
    eph_counts = kernel_launches()
    eph, _ = stage("decode_s",
                   lambda: rx.decode(start_offset_ms=DECODE_OFFSET_MS))
    usable = stage("usable_svs_s", rx.usable_svs)
    ct_rec, nav = stage("ct_switch_wls_s", lambda: rx.ct_position(
        n_ms=REF_CT_ROWS, init_pos_ecef=usr))
    chunk_launches, windows_launches, bank_launches = kernel_launches()

    n_ch = len(acq.sv)
    if sorted(int(p) for p in acq.sv) != sorted(PRNS):
        raise AssertionError(f"acquisition found {acq.sv}, expected {PRNS}")
    # the schedule's own countinx, from its phase (a)/(b) prefix
    cnt = np.array([detect_bit_transition(rec.p_i[:REF_1MS, ch],
                                          min_index=REF_MIN_TRANSITION)
                    for ch in range(n_ch)])
    t_max = REF_1MS + int(cnt.max()) + REF_10MS
    if rec.corr.shape != (t_max, n_ch, 3, 2):
        raise AssertionError(f"eph record {rec.corr.shape}, expected "
                             f"{(t_max, n_ch, 3, 2)}")
    for ch in range(n_ch):
        sw = REF_1MS + int(cnt[ch])
        for f in ("corr", "num_sample", "absolute_sample"):
            tail = getattr(rec, f)[sw:sw + REF_10MS, ch]
            runs = tail.reshape(REF_10MS // 10, 10, *tail.shape[1:])
            if not np.array_equal(runs, runs[:, :1].repeat(10, 1)):
                raise AssertionError(f"channel {ch}: {f} past row {sw} is "
                                     "not 10 ms blocks replicated x10")
        if np.abs(rec.num_sample[sw:sw + REF_10MS, ch] - 10 * S).max() > 100 \
                or np.abs(rec.num_sample[:sw, ch] - S).max() > 10:
            raise AssertionError(f"channel {ch}: block lengths off")
    if [int(p) for p in usable] != main["usable"] \
            or len(usable) != len(PRNS):
        raise AssertionError(f"usable SVs {usable}, phase 3 had "
                             f"{main['usable']}")
    # every decoded field equal to the 1 ms schedule's; the fields that
    # index record rows (where a subframe was found) are reported apart
    row_fields = ("sfb", "sfb1", "updatetime_ms")
    rows_equal = True
    for p in usable:
        a, b = dataclasses.asdict(eph[p]), dataclasses.asdict(main["eph"][p])
        diff = [k for k in a if k not in row_fields and a[k] != b[k]]
        if diff:
            raise AssertionError(f"PRN {p}: ephemeris fields {diff} differ "
                                 "from the 1 ms schedule's")
        rows_equal &= all(a[k] == b[k] for k in row_fields)
    # the CT stage: pdi 1 then 10 per channel, read back from the blocks
    chans = [acq.channel_index(p) for p in usable]
    sw = PDI_SWITCH_MS + rx.countinx()[chans]
    pdi_rows = np.where(np.abs(ct_rec.num_sample - S) < 100, 1, 10)
    rows = np.arange(REF_CT_ROWS)[:, None]
    if ct_rec.corr.shape != (REF_CT_ROWS, len(usable), 3, 2) or \
            not np.array_equal(pdi_rows, np.where(rows < sw[None, :], 1, 10)) \
            or np.abs(ct_rec.num_sample - pdi_rows * S).max() > 100:
        raise AssertionError("CT record is not pdi 1 then 10 per channel")
    for r in (rec, ct_rec):
        if not all(np.isfinite(getattr(r, f)).all()
                   for f in ("corr", "code_freq", "carr_freq", "rem_chip")):
            raise AssertionError("non-finite tracking records")
    err = np.linalg.norm(nav.usr_pos - usr, axis=1)
    if len(err) == 0 or not np.all(np.isfinite(nav.usr_pos)):
        raise AssertionError("no finite WLS fixes")
    med = float(np.median(err))
    if med >= WLS_GATE_M:
        raise AssertionError(f"WLS median error {med:.1f} m >= {WLS_GATE_M}")
    # launches: one track_chunk per chunk of the 1 ms phases, one windows
    # bank per block of 10 ms, the fetching bank never
    chunks = lambda n_ms: -(-n_ms // 1000)
    want_eph = (chunks(REF_1MS) + chunks(REF_1MS + int(cnt.max())),
                REF_10MS // 10, 0)
    want_all = (want_eph[0] + chunks(int(sw.max())),
                want_eph[1] + REF_CT_ROWS - int(sw.min()), 0)
    if eph_counts != want_eph or \
            (chunk_launches, windows_launches, bank_launches) != want_all:
        raise AssertionError(
            f"launches (track_chunk, windows bank, fetching bank): eph stage "
            f"{eph_counts}, expected {want_eph}; whole path "
            f"{(chunk_launches, windows_launches, bank_launches)}, expected "
            f"{want_all}")
    n10_blocks = want_all[1]
    res = dict(
        stages=stages, countinx_eph=cnt.tolist(),
        restart_offset_chips=restart_offsets_chips(
            rec, [REF_1MS + int(c) for c in cnt]),
        countinx_ct=(sw - PDI_SWITCH_MS).tolist(),
        eph_rows=t_max, usable_svs=[int(p) for p in usable],
        ephemerides_equal_phase3=True,
        subframe_rows_equal_phase3=bool(rows_equal), wls_epochs=int(len(err)),
        wls_median_err_m=med, wls_max_err_m=float(np.max(err)),
        track_chunk_launches=chunk_launches,
        correlator_bank_windows_launches=windows_launches,
        correlator_bank_launches=bank_launches,
        eph_10ms_ms_per_block=stages["eph_reference_s"] / (REF_10MS // 10)
        * 1e3,
        blocks_of_10ms=n10_blocks)
    evidence("reference_schedules", **res)
    # the switched CT stage as the reference's tckRstCT_10ms_* file
    exp = export_and_reload(rx, os.path.join(workdir, "mat"),
                            dict(n_ms=REF_CT_ROWS, init_pos_ecef=usr), None)
    if exp["pdi_tag_ms"] != 10 or not np.array_equal(exp.pop("pdi_rows"),
                                                     pdi_rows):
        raise AssertionError("export_mat: the switched CT record is not "
                             "tagged 10 ms or its pdi rows differ")
    evidence("export_mat", path="phase 4", **exp)
    return res


class ChunkCalls:
    """Stands in for `tracking.track_chunk` while a stage runs and keeps
    the arguments of every call (the resident capture, the chunk start,
    the state, the code tables, the spec, the block count)."""

    def __init__(self):
        self.real, self.calls = tracking.track_chunk, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.real(*args)


class TimedUpload:
    """Stands in for `time_segments.upload_capture` and times each call."""

    def __init__(self):
        self.real, self.walls = ts.upload_capture, []

    def __call__(self, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.real(*args, **kw)
        torch.cuda.synchronize()
        self.walls.append(time.perf_counter() - t0)
        return out


def _end_state_differs(a, b) -> list:
    return [f for f in a._fields if not torch.equal(getattr(a, f),
                                                    getattr(b, f))]


def phase_time_segments(dev: torch.device, workdir: str, main: dict) -> dict:
    """The eph stage in SEGMENTS time segments (overlap-save, 400 ms halo)
    on phase 3's capture, through a Receiver of its own: the capture is
    uploaded to the card once, and every chunk's track_chunk launch reads
    it in place for all 8 × SEGMENTS channels.  Gates: the launches, the
    last chunk (which reads past pair 2^31) equal bit for bit between the
    kernel and its plain version, the stitched record against phase 3's
    serial one (tests/test_time_segments.py's gates, the alignment in
    chips), then decode → 8 ephemerides equal to phase 3's and the WLS
    fixes of ct_position(3000)."""
    cfg = cfg_e2e()
    S = cfg.signal.samples_per_ms
    usr, serial = main["usr"], main["eph_rec"]
    rx = Receiver(cfg, main["src"], artifact_dir=workdir, device=dev)
    stages = {}

    def stage(name, fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t
        return out

    acq = stage("acquisition_s", rx.acquisition)
    n_ch = len(acq.sv)
    chunks, upload = ChunkCalls(), TimedUpload()
    tracking.track_chunk, ts.upload_capture = chunks, upload
    zero_launches()
    try:
        rec = stage("eph_segmented_s", lambda: rx.track_for_eph(
            n_ms=EPH_MS, n_segments=SEGMENTS))
    finally:
        tracking.track_chunk, ts.upload_capture = chunks.real, upload.real
    eph_counts = kernel_launches()
    seg_ms = -(-EPH_MS // SEGMENTS)
    want = (-(-(seg_ms + SEGMENT_HALO_MS) // 1000), 0, 0)
    width = {int(c[2].ptr.shape[0]) for c in chunks.calls}
    if eph_counts != want or len(upload.walls) != 1 \
            or width != {n_ch * SEGMENTS}:
        raise AssertionError(
            f"segmented eph stage: launches (track_chunk, windows bank, "
            f"fetching bank) {eph_counts}, expected {want}; uploads "
            f"{len(upload.walls)}; channels per launch {width}")
    resident = chunks.calls[0][0]
    if any(c[0] is not resident or c[1] != 0 for c in chunks.calls) \
            or resident.shape[0] != main["src"].n_samples:
        raise AssertionError("a chunk did not read the resident capture "
                             "from sample 0")

    # the last chunk again from the state the kernel left after the one
    # before: kernel against plain, every field and the end state
    raw, start, st, chips, spec, nb = chunks.calls[-1]
    lo, hi = int(st.ptr.min()), int(st.ptr.max()) + nb * S
    if hi <= PAIR_2_31:
        raise AssertionError(f"the last chunk ends at pair {hi}, before 2^31")
    out, end = tc.track_chunk(raw, start, st, chips, spec, nb)
    ref, end_ref = tc.track_chunk_reference(raw, start, st, chips, spec, nb)
    tc.raise_on_fault(out)
    tc.raise_on_fault(ref)
    differs = differing_fields(out, ref) + _end_state_differs(end, end_ref)
    if differs or int(out["absolute_sample"].max()) <= PAIR_2_31:
        raise AssertionError(f"last chunk past pair 2^31: kernel and plain "
                             f"differ in {differs}")
    last = dict(blocks=nb, first_pointer=lo, last_pointer=int(st.ptr.max()),
                last_block_end=int(out["absolute_sample"].max()),
                reads_past_pair_2_31=True, bitwise=True,
                max_abs_err=float((out["corr"] - ref["corr"]).abs().max()))
    del out, ref, end, end_ref

    # B1 at this width: one 1000-block chunk from the segments' start
    raw, start, st0, chips, spec, nb = chunks.calls[0]
    out, _ = tc.track_chunk(raw, start, st0, chips, spec, nb)
    b1 = dict(channels=int(st0.ptr.shape[0]), blocks=nb,
              cluster=tc.cluster_size(
                  int(st0.ptr.shape[0]),
                  torch.cuda.get_device_properties(dev).multi_processor_count),
              kernel_ms=timed_ms(lambda: tc.track_chunk(
                  raw, start, st0, chips, spec, nb), 3))
    b1.update(chunk_bound(st0, out, raw, chips, spec))
    del chunks, raw, resident, out, st, st0
    torch.cuda.empty_cache()

    # the stitched record against phase 3's serial one
    if rec.corr.shape != serial.corr.shape or \
            rec.corr.shape != (EPH_MS, n_ch, 3, 2):
        raise AssertionError(f"segmented record {rec.corr.shape}, serial "
                             f"{serial.corr.shape}")
    agree = float(np.mean(np.sign(rec.p_i[300:]) == np.sign(serial.p_i[300:])))
    dcarr = np.abs(rec.carr_freq[300:] - serial.carr_freq[300:])
    dchips = float(np.max(np.abs(rec.absolute_sample[300:]
                                 - serial.absolute_sample[300:]))
                   * cfg.signal.code_freq_basis / FS)
    # every segment locked: prompt over quadrature in each one's rows
    power = [float(np.abs(rec.p_i[a:b]).mean() / np.abs(rec.p_q[a:b]).mean())
             for a, b in ((max(q * seg_ms, 300), (q + 1) * seg_ms)
                          for q in range(SEGMENTS))]
    against = dict(prompt_sign_agreement=agree,
                   carr_freq_median_hz=float(np.median(dcarr)),
                   carr_freq_p99_hz=float(np.percentile(dcarr, 99)),
                   absolute_sample_max_chips=dchips,
                   absolute_sample_bound_chips=SEG_ALIGN_CHIPS,
                   prompt_over_quadrature_min=min(power))
    if not (agree > 0.999 and against["carr_freq_median_hz"] < 1.0
            and against["carr_freq_p99_hz"] < 10.0
            and dchips < SEG_ALIGN_CHIPS and min(power) > 3.0):
        raise AssertionError(f"segmented record against the serial one: "
                             f"{against}")

    zero_launches()
    eph, _ = stage("decode_s",
                   lambda: rx.decode(start_offset_ms=DECODE_OFFSET_MS))
    usable = stage("usable_svs_s", rx.usable_svs)
    _, nav = stage("ct_wls_s", lambda: rx.ct_position(n_ms=CT_MS,
                                                      init_pos_ecef=usr))
    ct_counts = kernel_launches()
    if [int(p) for p in usable] != main["usable"] \
            or len(usable) != len(PRNS):
        raise AssertionError(f"usable SVs {usable}, phase 3 had "
                             f"{main['usable']}")
    row_fields = ("sfb", "sfb1", "updatetime_ms")
    rows_equal = True
    for p in usable:
        a, b = dataclasses.asdict(eph[p]), dataclasses.asdict(main["eph"][p])
        diff = [k for k in a if k not in row_fields and a[k] != b[k]]
        if diff:
            raise AssertionError(f"PRN {p}: ephemeris fields {diff} differ "
                                 "from the serial stage's")
        rows_equal &= all(a[k] == b[k] for k in row_fields)
    err = np.linalg.norm(nav.usr_pos - usr, axis=1)
    med = float(np.median(err)) if len(err) else float("inf")
    if not np.all(np.isfinite(nav.usr_pos)) or med >= WLS_GATE_M \
            or ct_counts != (-(-CT_MS // 1000), 0, 0):
        raise AssertionError(f"after the segmented stage: WLS median "
                             f"{med:.1f} m, CT launches {ct_counts}")
    res = dict(
        segments=SEGMENTS, halo_ms=SEGMENT_HALO_MS, seg_ms=seg_ms,
        channels=n_ch * SEGMENTS, stages=stages, upload_s=upload.walls[0],
        upload_gb=main["src"].n_samples * 2 / 1e9,
        serial_eph_tracking_s=main["eph_tracking_s"],
        track_chunk_launches=eph_counts[0],
        correlator_bank_windows_launches=eph_counts[1],
        correlator_bank_launches=eph_counts[2], last_chunk=last,
        track_chunk_64=b1, against_serial=against,
        usable_svs=[int(p) for p in usable], ephemerides_equal_phase3=True,
        subframe_rows_equal_phase3=bool(rows_equal),
        ct_track_chunk_launches=ct_counts[0], wls_epochs=int(len(err)),
        wls_median_err_m=med)
    evidence("time_segments", **res)
    return res


def synthesize_capture(dev: torch.device, path: str, cfg: ReceiverConfig,
                       usr: np.ndarray, ephs: list, amp_scale: float,
                       noise_std: float, dc=None) -> float:
    """A CLI_MS capture of the e2e scenario's 8 SVs at the front end of
    `cfg` (int8 or int16 by its data_precision), seen from `usr` from
    CLI_TOW0 on, synthesized on the card straight into the file `path`.
    With `dc` (I, Q) the front end's DC offset is added to the samples on
    the card before they are quantized, as tests/test_urban_fullrate.py
    adds it (the synthesizer has no DC argument, nor has the JAX
    package's).  Returns the wall seconds."""
    gs = GeometrySignal(
        cfg, [GeometrySV(prn=p, eph=e, amplitude=amp_scale * a)
              for p, e, a in zip(PRNS, ephs, AMPS)],
        usr, CLI_TOW0, clk_bias_s=CLK_BIAS_S, clk_drift_sps=CLK_DRIFT_SPS,
        atmosphere=True, iono_alpha=cfg.cmn.iono_alpha,
        iono_beta=cfg.cmn.iono_beta, doy=cfg.cmn.day_of_year, device=dev)
    t0 = time.perf_counter()
    dtype = np.int8 if cfg.file.data_precision == 1 else np.int16
    out = np.memmap(path, dtype=dtype, mode="w+",
                    shape=(2 * CLI_MS * cfg.signal.samples_per_ms,))
    if dc is None:
        gs.synthesize(CLI_MS, noise_std=noise_std, seed=13, out=out)
    else:
        n = 2 * 1000 * cfg.signal.samples_per_ms      # values a second
        for ms in range(0, CLI_MS, 1000):
            iq = gs.generate_ms(ms, 1000, noise_std=noise_std, seed=13)
            out[ms // 1000 * n:(ms // 1000 + 1) * n] = quantize_iq(
                iq + complex(*dc), dtype)
    out.flush()
    del out
    return time.perf_counter() - t0


TABLE_HEAD = "PRN   SNR[dB]  Doppler[Hz]  FineDoppler[Hz]  CodeDelay[smp]"
TABLE_ROW = re.compile(r"^\s*(\d+)\s+(-?[\d.]+)\s+(-?[\d.]+)\s+(-?[\d.]+)"
                       r"\s+(\d+)$")


def acquisition_rows(lines: list) -> list:
    """The rows (PRN, SNR, Doppler, fine Doppler, code delay, as strings)
    of the acquisition table the command prints in `lines`."""
    rows = []
    for line in lines[lines.index(TABLE_HEAD) + 1:]:
        m = TABLE_ROW.match(line)
        if not m:
            break
        rows.append(m.groups())
    return rows


def run_command(path: str, preset: str, res_dir: str, ocfg: ReceiverConfig,
                usr: np.ndarray) -> dict:
    """`python -m gps_sdr_tpu_torch.cli <path> --preset <preset> --ct-ms
    CLI_CT_ROWS --vt-ms CLI_VT_MS --no-plots --out <res_dir>` in a process of
    its own, `ocfg` the preset's configuration.  Gates: exit code 0, the 8
    PRNs in its acquisition table, ≥ 4 usable SVs, WLS and VT medians
    < 120 m as it prints them and from its `.mat` files against `usr`, every
    file of the `.mat` set read back through io/matref at the preset's bytes
    a sample, and the kernel launches it prints all above 0."""
    argv = [sys.executable, "-m", "gps_sdr_tpu_torch.cli", path, "--preset",
            preset, "--ct-ms", str(CLI_CT_ROWS), "--vt-ms", str(CLI_VT_MS),
            "--no-plots", "--out", res_dir]
    t0 = time.perf_counter()
    r = subprocess.run(argv, capture_output=True, text=True, timeout=900,
                       cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"the command exited {r.returncode}:\n"
                             f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    rows = acquisition_rows(r.stdout.splitlines())
    acquired = [int(row[0]) for row in rows]
    usable = re.search(r"usable SVs \(complete healthy ephemeris\): "
                       r"\[([\d, ]*)\]", r.stdout)
    usable = [int(p) for p in usable.group(1).split(",")] if usable else []
    printed = dict(
        wls=re.search(r"WLS: (\d+) epochs, median error vs configured truth "
                      r"([\d.]+) m", r.stdout),
        vt=re.search(r"VT/EKF: (\d+) ms, median error ([\d.]+) m", r.stdout),
        launches=re.search(r"kernel launches: track_chunk (\d+), "
                           r"correlator_bank_windows (\d+), "
                           r"correlator_bank (\d+)", r.stdout))
    if sorted(acquired) != sorted(PRNS) or len(usable) < 4 \
            or not all(printed.values()):
        raise AssertionError(f"the command printed:\n{r.stdout}")
    launches = [int(x) for x in printed["launches"].groups()]

    # the .mat set, read back through io/matref
    name, skip = ocfg.file.name, ocfg.file.skip_ms
    bps, S = ocfg.file.bytes_per_sample, ocfg.signal.samples_per_ms
    tag = "10ms" if ocfg.track.ct_pdi_switch_ms else "1ms"
    mat = os.path.join(res_dir, "mat")
    want = sorted([f"nAcquired_{name}_{skip}.mat", f"eph_{name}.mat",
                   f"sbf_{name}.mat", f"tckRstCT_{tag}_{name}.mat",
                   f"navSolCT_{tag}_{name}.mat", f"tckRstVT_{name}_updated.mat",
                   f"navSolVT_{name}_updated.mat"])
    if sorted(os.listdir(mat)) != want:
        raise AssertionError(f"the command wrote {sorted(os.listdir(mat))}, "
                             f"expected {want}")
    f = lambda n: os.path.join(mat, n)
    na = matref.load_nacquired(f(f"nAcquired_{name}_{skip}.mat"))
    eph = matref.load_eph(f(f"eph_{name}.mat"))
    nav1 = matref.load_sbf(f(f"sbf_{name}.mat"))["nav1"]
    ct_rec, pdi = matref.load_tck_records(f(f"tckRstCT_{tag}_{name}.mat"),
                                          usable, bytes_per_sample=bps,
                                          samples_per_ms=S)
    nav = matref.load_navsol(f(f"navSolCT_{tag}_{name}.mat"))
    vt_trk, _ = matref.load_vt_records(f(f"tckRstVT_{name}_updated.mat"),
                                       usable, bytes_per_sample=bps)
    vt = matref.load_navsol_vt(f(f"navSolVT_{name}_updated.mat"))
    wls_err = np.linalg.norm(nav.usr_pos - usr, axis=1)
    vt_err = np.linalg.norm(vt["usrPos"] - usr, axis=1)
    res = dict(
        command=" ".join(["python -m gps_sdr_tpu_torch.cli", "<capture>"]
                         + argv[4:-1] + ["<dir>"]),
        capture_ms=CLI_MS, capture_gb=os.path.getsize(path) / 1e9,
        command_s=wall, rc=r.returncode, acquired=acquired,
        fine_doppler_hz=[float(row[3]) for row in rows],
        snr_db=[float(row[1]) for row in rows], usable_svs=usable,
        printed_wls_median_m=float(printed["wls"].group(2)),
        printed_vt_median_m=float(printed["vt"].group(2)),
        wls_epochs=int(len(wls_err)), wls_median_err_m=float(
            np.median(wls_err)), vt_ms=int(vt_err.shape[0]),
        vt_median_err_m=float(np.median(vt_err)),
        mat_files=want, bytes_per_sample=bps,
        ct_rows=int(ct_rec.corr.shape[0]),
        ct_pdi_ms=sorted(set(int(x) for x in np.unique(pdi))),
        eph_decoded=sorted(int(p) for p, e in eph.items() if e.tow),
        nacquired_sv=[int(x) for x in na["sv"]],
        vt_record_rows=int(vt_trk.corr.shape[0]),
        launches=dict(track_chunk=launches[0],
                      correlator_bank_windows=launches[1],
                      correlator_bank=launches[2]))
    if not (res["wls_median_err_m"] < WLS_GATE_M
            and res["vt_median_err_m"] < WLS_GATE_M
            and res["printed_wls_median_m"] < WLS_GATE_M
            and res["printed_vt_median_m"] < WLS_GATE_M
            and set(usable) <= set(nav1)
            and res["nacquired_sv"] == usable
            and res["vt_record_rows"] == CLI_VT_MS
            and res["ct_rows"] == CLI_CT_ROWS and min(launches) > 0):
        raise AssertionError(f"the command's results: {res}")
    return res


def phase_cli(dev: torch.device, workdir: str, ephs: list) -> dict:
    """The command line as a user runs it: a CLI_MS capture of the e2e
    scenario synthesized on the card straight into a file, then
    `python -m gps_sdr_tpu_torch.cli <file> --preset opensky ...` in a
    process of its own, held by `run_command`'s gates."""
    cfg = dataclasses.replace(cfg_e2e(), file=FileConfig(name="cli",
                                                         skip_ms=0))
    # what the command runs under: the preset's file and solution settings,
    # the e2e front end (the same 58 MHz and IF as the preset's); the
    # receiver sits at the preset's configured truth (102 m from the e2e
    # scenario's position), so the medians the command prints are errors
    ocfg = dataclasses.replace(opensky_config(), signal=cfg.signal)
    usr = llh2xyz(np.asarray(ocfg.solu.truth_llh)).numpy()
    path = os.path.join(workdir, "capture.bin")
    synth_s = synthesize_capture(dev, path, cfg, usr, ephs, AMP_SCALE,
                                 NOISE_STD)
    res_dir = os.path.join(workdir, "out")
    res = dict(synth_to_file_s=synth_s,
               **run_command(path, "opensky", res_dir, ocfg, usr))
    evidence("cli", **res)
    return res, dict(path=path, artifacts=os.path.join(res_dir, "artifacts"))


def _urban_kernels(dev: torch.device, ucfg: ReceiverConfig, src,
                   art: str) -> dict:
    """The three kernels at the urban shape (26 000 samples a ms, int16, DC
    removal on) on the command's capture, from its acquisition: each
    against its plain version on the same inputs on the card, every field
    bit for bit, with its time, the plain version's and its bound.  B1 over
    a 1000-block E/P/L chunk and a 300-block 25-tap chunk (records and end
    state); from the state after the 1000 blocks B3 over 10 ms windows at 3
    and 25 taps (`_windows_case`: also against B2 over the same samples),
    and B2 over one 1 ms block at 3 taps (`_bank_case`: split, so the DC
    kernel runs first, and on one CTA per channel)."""
    fs, S = ucfg.signal.fs, ucfg.signal.samples_per_ms
    name, skip = ucfg.file.name, ucfg.file.skip_ms
    acq = np.load(os.path.join(art, f"acquired_{name}_{skip}.npz"))
    prns = [int(p) for p in acq["sv"]]
    chips = chip_tables(prns, dev)
    stager = DeviceStager(dev)
    state = init_track_state(ucfg, acq["code_delay"], acq["fine_freq_hz"],
                             dev)
    res = dict(channels=len(prns))
    for kind, n_steps in (("epl", 1000), ("pos_multicorr", 300)):
        spec = getattr(TrackParams, kind)(ucfg).chunk_spec(ucfg)
        if not spec.remove_dc:
            raise AssertionError("int16 tracking without DC removal")
        start = int(state.ptr.min())
        raw = stager.stage(src.read_iq_values(
            start, int(state.ptr.max()) - start
            + spec.chunk_samples(n_steps)))
        out, end = tc.track_chunk(raw, start, state, chips, spec, n_steps)
        ref, ref_end = tc.track_chunk_reference(raw, start, state, chips,
                                                spec, n_steps)
        tc.raise_on_fault(out)
        tc.raise_on_fault(ref)
        m = dict(blocks=n_steps, taps=len(spec.taps),
                 differing=differing_fields(out, ref) + [
                     f"state.{f}" for f in _end_state_differs(end, ref_end)],
                 max_abs_err=float((out["corr"] - ref["corr"]).abs().max()),
                 kernel_ms=timed_ms(lambda: tc.track_chunk(
                     raw, start, state, chips, spec, n_steps), 3),
                 plain_ms=timed_ms(lambda: tc.track_chunk_reference(
                     raw, start, state, chips, spec, n_steps), 1),
                 **chunk_bound(state, out, raw, chips, spec))
        if m["differing"]:
            raise AssertionError(f"track_chunk at the urban shape ({kind}) "
                                 f"differs from plain: {m}")
        res[f"track_chunk_{kind}"] = m
        if kind == "epl":
            st = end
    i64 = torch.int64
    start = int(st.ptr.min()) - S
    raw = stager.stage(src.read_iq_values(start, 14 * S))
    jitter = torch.tensor([(i % 5) - 2 for i in range(len(prns))],
                          dtype=i64, device=dev)

    def locked(pdi):
        """The tracked state's NCO words, blocks of `pdi` ms ± 2 samples."""
        return dict(
            ptr=st.ptr, rem_chip=st.rem_chip, code_freq=st.code_freq,
            phase_fp=st.phase_fp.to(i64),
            carr_fp=torch.round(st.carr_freq / fs * tc.Q32).to(i64),
            num=torch.ceil((1023.0 * pdi - st.rem_chip)
                           / (st.code_freq / fs)).to(i64) + jitter)

    def blk_of(pdi):
        return -(-(pdi * S + 256) // 128) * 128

    # the bounds' scale: the tracked state's prompt magnitude (the gate here
    # is bit for bit)
    nco, epl = locked(1), VTParams().taps
    p, _ = cb.correlator_bank_reference(
        raw, nco["ptr"] - start, *(nco[k] for k in (
            "rem_chip", "code_freq", "phase_fp", "carr_fp", "num")), chips,
        cb.tap_offsets_fp(epl, dev), fs, blk_of(1))
    scale = float(torch.hypot(p[:, 1, 0], p[:, 1, 1]).mean())
    for label, taps in (("epl3", TrackParams.epl(ucfg).taps),
                        ("ct25", TrackParams.pos_multicorr(ucfg).taps)):
        nco, blk = locked(10), blk_of(10)
        m = _windows_case(raw, start, nco, chips, taps, blk, True, scale, fs)
        args = m.pop("args")
        m.pop("cut"), m.pop("out")
        plan = cb.WindowsPlan(chips, args[7], fs, blk, True)
        call = tuple(t.contiguous() for t in args[:6])
        m.update(taps=len(taps), blk=blk,
                 n_split=cb.default_split(len(prns), blk),
                 kernel_ms=timed_graph_ms(lambda: plan(*call), 10),
                 plain_ms=timed_ms(
                     lambda: cb.correlator_bank_windows_reference(*args), 3),
                 **bank_bound(raw, nco["ptr"], nco["num"], chips, len(taps),
                              True, windows=True))
        if not m["bitwise"]:
            raise AssertionError(f"correlator_bank_windows at the urban "
                                 f"shape ({label}): {m}")
        res[f"correlator_bank_windows_{label}_10ms"] = m
    nco, blk = locked(1), blk_of(1)
    m = _bank_case(raw, start, nco, chips, epl, blk, True, scale, fs)
    args, plan, words = m.pop("args"), m.pop("plan"), m.pop("words")
    one = cb.BankPlan(raw, chips, args[8], fs, blk, True, n_split=1)
    m.update(taps=3, blk=blk, n_split=cb.default_split(len(prns), blk),
             kernel_ms=timed_graph_ms(lambda: plan(*words), 10),
             kernel_1cta_ms=timed_graph_ms(lambda: one(*words), 10),
             plain_ms=timed_ms(
                 lambda: cb.correlator_bank_reference(*args), 3),
             **bank_bound(raw, nco["ptr"], nco["num"], chips, 3, True))
    if not m["bitwise"]:
        raise AssertionError(f"correlator_bank at the urban shape: {m}")
    res["correlator_bank_epl3_1ms"] = m
    return res


def phase_urban(dev: torch.device, workdir: str, ephs: list,
                smi: str) -> dict:
    """The Urban front end end to end: a CLI_MS capture of the e2e
    scenario's 8 SVs at the `urban` preset's front end (26 MHz, int16, zero
    IF, so the geometry's Dopplers come with both signs) at phase 6's C/N0
    (amplitudes ×√(58/26) for the lower rate, amplitudes and noise
    ×URBAN_GAIN for the int16 range), the DC offset URBAN_DC added to every
    pair, the receiver at the preset's configured truth, synthesized on the
    card into a file; then `python -m gps_sdr_tpu_torch.cli <file> --preset
    urban ...` in a process of its own, held by `run_command`'s gates and
    negative fine Dopplers among the acquired.  Then, in this process, the
    three kernels at this shape against their plain versions
    (`_urban_kernels`), the capture uploaded to the card as int16 and read
    back, and the VT stage run again from the command's CT
    artifacts with FirstScan in place: its records against the command's,
    and 200 ms of its vt_scan (DC removal on) eager against replayed
    (`vt_graph_vs_eager`)."""
    ucfg = urban_config()
    usr = llh2xyz(np.asarray(ucfg.solu.truth_llh)).numpy()
    path = os.path.join(workdir, "capture.bin")
    synth_s = synthesize_capture(
        dev, path, ucfg, usr, ephs,
        AMP_SCALE * math.sqrt(FS / ucfg.signal.fs) * URBAN_GAIN,
        NOISE_STD * URBAN_GAIN, URBAN_DC)
    res_dir = os.path.join(workdir, "out")
    res = dict(synth_to_file_s=synth_s, dc_offset=list(URBAN_DC),
               **run_command(path, "urban", res_dir, ucfg, usr))
    if min(res["fine_doppler_hz"]) >= 0 or max(res["fine_doppler_hz"]) <= 0:
        raise AssertionError(f"zero IF: fine Dopplers of one sign only: "
                             f"{res['fine_doppler_hz']}")
    art = os.path.join(res_dir, "artifacts")
    src = IFSampleSource(path, ucfg.file)
    res["kernels"] = _urban_kernels(dev, ucfg, src, art)
    # the capture held on the card as int16 (io/ifdata.upload_capture, what
    # the time-segmented eph stage reads): rows equal to the file's
    t0 = time.perf_counter()
    resident = upload_capture(src, dev)
    upload_s = time.perf_counter() - t0
    S, n = ucfg.signal.samples_per_ms, src.n_samples
    res["upload"] = dict(
        s=upload_s, dtype=str(resident.dtype), rows=int(resident.shape[0]),
        rows_equal=all(torch.equal(resident[a:a + S].cpu(), torch.from_numpy(
            src.read_iq_values(a, S))) for a in (0, n // 2 + 7, n - S)))
    del resident
    if not (res["upload"]["rows_equal"] and res["upload"]["rows"] == n
            and res["upload"]["dtype"] == "torch.int16"):
        raise AssertionError(f"the int16 capture on the card: {res['upload']}")

    # the VT stage again in this process, from a copy of the command's
    # artifacts without its VT result
    rx_dir = os.path.join(workdir, "rx")
    shutil.copytree(art, rx_dir,
                    ignore=shutil.ignore_patterns("navvt2_*"))
    rx = Receiver(ucfg, src, artifact_dir=rx_dir, device=dev)
    first = tvt.vt_scan = FirstScan()
    try:
        trk, sol = rx.vt_position(n_ms=CLI_VT_MS, ct_n_ms=CLI_CT_ROWS)
    finally:
        tvt.vt_scan = first.scan
    if not first.args[7].remove_dc:
        raise AssertionError("the int16 VT stage runs without DC removal")
    cmd_trk, cmd_sol = Receiver(ucfg, src, artifact_dir=art,
                                device=dev).vt_position(
        n_ms=CLI_VT_MS, ct_n_ms=CLI_CT_ROWS)
    res["vt_again_equals_command"] = bool(
        np.array_equal(sol.usr_pos, cmd_sol.usr_pos)
        and np.array_equal(trk.corr, cmd_trk.corr))
    res["vt_graph_vs_eager"] = vt_graph_vs_eager(first, path="urban")
    res["device"] = smi
    evidence("urban", **res)
    return res


def phase_multi_process(workdir: str, cli_files: dict) -> dict:
    """A world of RANKS processes (gloo) over the command's capture at full
    width, both on the one card: the `receiver` leg against the command's
    own artifacts and the `ingest` leg against the single-process segmented
    run (parallel/distributed.py says what each holds).  Gates: every
    rank's legs ok, B1, B2 and B3 launched by every rank's Receiver, B1 by
    every rank's ingest, each rank reading < 62 % of the file."""
    cfg = opensky_config(cli_files["path"])   # as the command builds it
    acq = np.load(os.path.join(
        cli_files["artifacts"],
        f"acquired_{cfg.file.name}_{cfg.file.skip_ms}.npz"))
    t0 = time.perf_counter()
    res = pdist.launch(
        legs=("receiver", "ingest"), n_processes=RANKS, device=None,
        timeout_s=600, work_dir=workdir, receiver=dict(
            cfg=cfg, capture=cli_files["path"],
            artifact_dir=os.path.join(workdir, "rx"),
            ref_dir=cli_files["artifacts"], ct_kw=dict(n_ms=CLI_CT_ROWS),
            vt_kw=dict(n_ms=CLI_VT_MS, ct_n_ms=CLI_CT_ROWS)),
        ingest=dict(cfg=cfg, capture=cli_files["path"],
                    prns=[int(p) for p in acq["sv"]],
                    delays=acq["code_delay"], fine=acq["fine_freq_hz"],
                    n_ms=EPH_MS, segments=SEGMENTS,
                    halo_ms=SEGMENT_HALO_MS))
    wall = time.perf_counter() - t0
    ranks = []
    for rank in range(RANKS):
        r = res[rank]
        rx, ing = r["receiver"], r["ingest"]
        ranks.append(dict(
            rank=rank, device=r["device"], device_name=r.get("device_name"),
            receiver_ok=rx["ok"], launches=rx["launches"],
            stage_s=rx["stage_s"], gathers=rx["gathers"],
            vt_scan_ms_per_step=rx["vt_scan_ms_per_step"],
            vt_stage_ms_per_ms=rx["vt_stage_ms_per_ms"], vt_step=rx["vt_step"],
            channels=rx["channels"], acquired=rx["acquired"],
            acquisition_equal=rx["acquisition_equal"],
            eph_record_equal=rx["eph_record_equal"],
            ephemerides_equal=rx["ephemerides_equal"],
            ct_record_equal=rx["ct_record_equal"], wls=rx["wls"],
            vt_vs_command=rx["vt_vs_reference"],
            vt_vs_single_same_handoff=rx["vt_vs_single_same_handoff"],
            receiver_leg_s=rx["wall_s"], ingest_ok=ing["ok"],
            ingest_launches=ing["launches"], ingest_segments=ing["segments"],
            read_fraction=ing["read_fraction"], read_s=ing["read_s"],
            ingest_track_s=ing["track_s"], ingest_leg_s=ing["wall_s"]))
    out = dict(ranks_n=RANKS, backend=res[0]["backend"], wall_s=wall,
               ranks=ranks)
    evidence("multi_process", **out)
    for r in ranks:
        if not (r["receiver_ok"] and r["ingest_ok"]
                and min(r["launches"].values()) > 0
                and r["ingest_launches"]["track_chunk"] > 0
                and r["read_fraction"] < 0.62
                and r["device"].startswith("cuda")):
            raise AssertionError(f"phase 7, rank {r['rank']}: {r}")
    return out


LAUNCH_LINE = (r"kernel launches, rank (\d+): track_chunk (\d+), "
               r"correlator_bank_windows (\d+), correlator_bank (\d+)")


def phase_cli_world(workdir: str, cli_files: dict, cli_res: dict) -> dict:
    """The command line under a torchrun world of RANKS ranks sharing the
    card (gloo), cold (its own --out and --artifacts), over phase 6's file
    with phase 6's arguments.  Gates: exit code 0; the table, the usable
    SVs and the WLS and VT lines printed once; the same PRNs and usable SVs
    as phase 6; the .mat set held against phase 6's
    (pdist.compare_mat_exports); each rank's launch line with B1, B3 and B2
    above 0."""
    out = os.path.join(workdir, "out")
    args = [cli_files["path"], "--preset", "opensky", "--ct-ms",
            str(CLI_CT_ROWS), "--vt-ms", str(CLI_VT_MS), "--no-plots",
            "--dist-backend", "gloo", "--dist-timeout", "600"]
    argv = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(RANKS), "-m", "gps_sdr_tpu_torch.cli"]
            + args + ["--out", out, "--artifacts",
                      os.path.join(out, "artifacts")])
    # the host's 8 cores split between the ranks (torchrun would give 1)
    env = dict(os.environ, PYTHONPATH=ROOT, GLOO_SOCKET_IFNAME="lo",
               OMP_NUM_THREADS=str(8 // RANKS))
    t0 = time.perf_counter()
    r = subprocess.run(argv, capture_output=True, text=True, timeout=900,
                       cwd=ROOT, env=env)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"the command's world exited {r.returncode}:\n"
                             f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    lines = r.stdout.splitlines()
    once = {k: sum(l.startswith(k) for l in lines)
            for k in (TABLE_HEAD, "usable SVs", "WLS: ", "VT/EKF: ")}
    acquired = [int(row[0]) for row in acquisition_rows(lines)]
    usable = re.search(r"usable SVs \(complete healthy ephemeris\): "
                       r"\[([\d, ]*)\]", r.stdout)
    usable = [int(p) for p in usable.group(1).split(",")] if usable else []
    ranks = {int(m[0]): dict(track_chunk=int(m[1]),
                             correlator_bank_windows=int(m[2]),
                             correlator_bank=int(m[3]))
             for m in re.findall(LAUNCH_LINE, r.stdout)}
    mat = pdist.compare_mat_exports(
        os.path.join(out, "mat"),
        os.path.join(os.path.dirname(cli_files["artifacts"]), "mat"))
    res = dict(
        command=" ".join(["python -m torch.distributed.run --standalone "
                          f"--nproc-per-node {RANKS} -m gps_sdr_tpu_torch.cli",
                          "<capture>"] + args[1:] + ["--out", "<dir>"]),
        ranks_n=RANKS, wall_s=wall, rc=r.returncode, printed_once=once,
        acquired=acquired, usable_svs=usable,
        wls_line=next(l for l in lines if l.startswith("WLS: ")),
        vt_line=next(l for l in lines if l.startswith("VT/EKF: ")),
        mat_files=mat["files"], mat_differ=mat["differ"],
        mat_outside=mat["outside"], launches_by_rank=ranks)
    evidence("cli_world", **res)
    if not (all(v == 1 for v in once.values())
            and acquired == cli_res["acquired"]
            and usable == cli_res["usable_svs"]
            and mat["ok"] and len(mat["files"]) == 7
            and sorted(ranks) == list(range(RANKS))
            and all(min(c.values()) > 0 for c in ranks.values())):
        raise AssertionError(f"phase 8: {res}\n{r.stdout[-3000:]}")
    return res


def phase_results(dev: torch.device, workdir: str, smi: str) -> dict:
    """The results record (python -m gps_sdr_tpu_torch.results --no-plots)
    in a process of its own, its scaling probe at 1 and 2 ranks on the
    card.  Gates: the scenario's 5 PRNs among those acquired and exactly
    those 5 usable, WLS and VT medians under WLS_GATE_M, RESULTS.md with
    the card and its power limit at its head and the scaling table filled
    for 1 and 2 ranks, B1 and B2 launched.  A noise peak of the capture may
    cross the 12 dB threshold too (the card's draw gives PRN 32 at
    12.09 dB, which decodes nothing), so the acquisition is also held
    against a witness: the same capture written again on the card (the same
    seeded draw) and acquired by the plain version on the CPU must give the
    same PRNs and code delays and SNRs within 1e-3 dB
    (tests/test_torch_slice.py's bound)."""
    out = os.path.join(workdir, "results_torch")
    argv = [sys.executable, "-m", "gps_sdr_tpu_torch.results", out,
            "--no-plots", "--scaling-ranks", "1,2"]
    t0 = time.perf_counter()
    r = subprocess.run(argv, capture_output=True, text=True, timeout=900,
                       cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"the results command exited {r.returncode}:\n"
                             f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    with open(os.path.join(out, "RESULTS.md")) as f:
        text = f.read()
    rows = {int(m[0]): m[1] for m in re.findall(
        r"^\| (\d+) \| (.*) \|$", text, re.M)}
    res = dict(command="python -m gps_sdr_tpu_torch.results <dir> "
                       "--no-plots --scaling-ranks 1,2", wall_s=wall,
               **{k: v for k, v in rec.items() if k != "out_dir"},
               scaling_rows=rows, files=sorted(os.listdir(out)))
    # the witness: the record's capture again, acquired on the CPU
    cap = os.path.join(workdir, "capture.bin")
    src = scenario.write_capture(cap, scenario.geometry_signal(
        scenario.TOW0, device=dev))
    wit = run_acquisition(src, scenario.CFG, device="cpu")
    os.remove(cap)
    res["witness_cpu"] = dict(
        acquired=[int(p) for p in wit.sv],
        snr_db=[float(x) for x in wit.snr_db],
        code_delay=[int(x) for x in wit.code_delay])
    evidence("results", **res)
    want = sorted(scenario.SCN_PRNS)
    if not (res["witness_cpu"]["acquired"] == rec["acquired"]
            and res["witness_cpu"]["code_delay"] == rec["acquired_delay"]
            and np.allclose(res["witness_cpu"]["snr_db"],
                            rec["acquired_snr_db"], rtol=0, atol=1e-3)
            and set(want) <= set(rec["acquired"])
            and sorted(rec["usable"]) == want
            and rec["wls_median_m"] < WLS_GATE_M
            and rec["vt_median_m"] < WLS_GATE_M
            and f"- Device: {smi}" in text.splitlines()
            and sorted(rows) == [1, 2]
            and all(len(row.split("|")) == 8 for row in rows.values())
            and rec["launches"]["track_chunk"] > 0
            and rec["launches"]["correlator_bank"] > 0):
        raise AssertionError(f"phase 9: {res}\n{text}")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs a GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device_and_build()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ephs = scenario.visible_constellation(len(PRNS), truth_llh=TRUTH_LLH)
    kvp, shared = phase_kernel_vs_plain(dev)
    bank = phase_bank_vs_plain(dev, shared)
    win = phase_windows_vs_plain(dev, shared)
    phase_both_trackers(dev, shared)
    del shared
    workdirs = [tempfile.mkdtemp(prefix="chip_smoke_",
                                 dir=os.path.join(ROOT, "build"))
                for _ in range(9)]
    try:
        main_res, main_out = phase_main_path(dev, workdirs[0],
                                             "--profile-vt" in sys.argv[1:])
        ref_res = phase_reference_schedules(dev, workdirs[1], main_out)
        if "--ref-1000" in sys.argv[1:]:
            reference_schedule_1000(dev, workdirs[2], main_out)
        seg_res = phase_time_segments(dev, workdirs[3], main_out)
        # the 4.76 GB capture goes before the command line's is made
        del main_out
        gc.collect()
        cli_res, cli_files = phase_cli(dev, workdirs[4], ephs)
        # the ranks share the card: the parent's cached blocks go first
        gc.collect()
        torch.cuda.empty_cache()
        mp_res = phase_multi_process(workdirs[5], cli_files)
        cw_res = phase_cli_world(workdirs[6], cli_files, cli_res)
        # phase 6's 5.45 GB capture goes before the urban one is made
        shutil.rmtree(workdirs[4], ignore_errors=True)
        urban_res = phase_urban(dev, workdirs[8], ephs, smi)
        res_res = phase_results(dev, workdirs[7], smi)
    finally:
        for d in workdirs:
            shutil.rmtree(d, ignore_errors=True)
    head = bank["main_shape"]
    whead = win["main_shape"]
    evidence("vt_bank_share", bank_kernel_ms=head["kernel_ms"],
             launches=main_res["correlator_bank_launches"],
             vt_ekf_s=main_res["stages"]["vt_ekf_s"],
             share=head["kernel_ms"] * 1e-3
             * main_res["correlator_bank_launches"]
             / main_res["stages"]["vt_ekf_s"])
    evidence("script", wall_s=time.perf_counter() - t_start)
    # no single PyTorch call computes any of the three: library_ms is null.
    # `launches` of a kernel is the count over the path that runs it: the
    # 1 ms scalar path and the VT path of phase 3, the 10 ms schedules of
    # phase 4; `launches_by_path` adds the time-segmented eph stage, the
    # command line (counted by the command's own process) and each rank of
    # phase 7 (counted by the rank's process: its Receiver, then its ingest),
    # each rank of the command's world (phase 8, printed by rank 0), the
    # results record (phase 9, counted by its process) and the command under
    # the urban preset (phase 10, counted by its process); `urban_shape` is
    # the kernel against its plain version at 26 MHz int16 with DC removal
    cli_launches = cli_res["launches"]
    urban_launches = urban_res["launches"]
    uk = urban_res["kernels"]

    def urban_shape(m):
        return {k: m[k] for k in ("max_abs_err", "kernel_ms", "plain_ms",
                                  "bound_ms", "bound_by")}

    def ranks_of(name):
        return [r["launches"][name] + r["ingest_launches"][name]
                for r in mp_res["ranks"]]

    def world_of(name):
        return [cw_res["launches_by_rank"][r][name] for r in range(RANKS)]

    print(json.dumps({"kernels": [{
        "name": "track_chunk", "route": "cuda",
        "source": "gps_sdr_tpu_torch/csrc/track_chunk.cu",
        "replaces": "gps_sdr_tpu/ops/pallas_track.py:285",
        "launches": main_res["track_chunk_launches"],
        "max_abs_err": max(kvp["epl"]["corr_abs"],
                           kvp["pos_multicorr"]["corr_abs"]),
        "ms": kvp["epl"]["kernel_ms"], "plain_ms": kvp["epl"]["plain_ms"],
        "bound_ms": kvp["epl"]["bound_ms"],
        "bound_by": kvp["epl"]["bound_by"], "library_ms": None,
        "launches_by_path": {
            "main_path": main_res["track_chunk_launches"],
            "reference_schedules": ref_res["track_chunk_launches"],
            "time_segments": seg_res["track_chunk_launches"],
            "cli": cli_launches["track_chunk"],
            "multi_process_ranks": ranks_of("track_chunk"),
            "cli_world_ranks": world_of("track_chunk"),
            "results": res_res["launches"]["track_chunk"],
            "urban": urban_launches["track_chunk"]},
        "urban_shape": {"epl_1000": urban_shape(uk["track_chunk_epl"]),
                        "taps25_300": urban_shape(
                            uk["track_chunk_pos_multicorr"])},
        "time_segments_64ch": seg_res["track_chunk_64"]}, {
        "name": "correlator_bank", "route": "cuda",
        "source": "gps_sdr_tpu_torch/csrc/corr_bank.cu",
        "replaces": "gps_sdr_tpu/ops/pallas_track.py:428",
        "launches": main_res["correlator_bank_launches"],
        "max_abs_err": bank["max_abs_err"],
        "ms": head["kernel_ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None, "launches_by_path": {
            "main_path": main_res["correlator_bank_launches"],
            "cli": cli_launches["correlator_bank"],
            "multi_process_ranks": ranks_of("correlator_bank"),
            "cli_world_ranks": world_of("correlator_bank"),
            "results": res_res["launches"]["correlator_bank"],
            "urban": urban_launches["correlator_bank"]},
        "urban_shape": {"epl3_1ms_dc": urban_shape(
            uk["correlator_bank_epl3_1ms"])}}, {
        "name": "correlator_bank_windows", "route": "cuda",
        "source": "gps_sdr_tpu_torch/csrc/corr_bank.cu",
        "replaces": "gps_sdr_tpu/ops/pallas_correlator.py:122",
        "launches": ref_res["correlator_bank_windows_launches"],
        "max_abs_err": win["max_abs_err"],
        "ms": whead["kernel_ms"], "plain_ms": whead["plain_ms"],
        "bound_ms": whead["bound_ms"], "bound_by": whead["bound_by"],
        "library_ms": None, "launches_by_path": {
            "reference_schedules": ref_res["correlator_bank_windows_launches"],
            "cli": cli_launches["correlator_bank_windows"],
            "multi_process_ranks": ranks_of("correlator_bank_windows"),
            "cli_world_ranks": world_of("correlator_bank_windows"),
            "results": res_res["launches"]["correlator_bank_windows"],
            "urban": urban_launches["correlator_bank_windows"]},
        "urban_shape": {
            "epl3_10ms_dc": urban_shape(
                uk["correlator_bank_windows_epl3_10ms"]),
            "ct25_10ms_dc": urban_shape(
                uk["correlator_bank_windows_ct25_10ms"])}}]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
