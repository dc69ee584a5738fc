"""The port's results record: the counterpart of the JAX package's
`make_results.py`.

    python -m gps_sdr_tpu_torch.results [OUT] [--device cpu] [--no-plots]
        [--reference DIR] [--scaling-ranks 1,2]

Runs the synthetic-geometry scenario (`io/scenario.py`: 5 SVs, real LNAV
frames, transmit-time geometry, iono/tropo, receiver clock bias and drift)
through the staged `Receiver` on one device (the card unless `--device`
says otherwise) and writes `OUT/RESULTS.md` (default `results_torch/`,
never `results/`, which is the JAX package's committed record) with:

- the device it ran on, the command and the commit;
- the acquisition table and the positioning accuracy against the truth
  (WLS from CT epoch 2 on, VT from ms 500 on: median, p95, max; the clock
  drift estimates);
- the plots (Tasks 1-5, the channel dashboards, the ACF waterfall and
  animation of a 25-tap run), or the statement that none were written
  (`--no-plots`; the ephemeris CSV is written either way);
- the replay of the reference's own Opensky records through the WLS stage
  (`--reference DIR`), or why that section is left out;
- the multi-device scaling probe (`parallel/distributed`'s `scaling` leg);
- the legacy filter's host epoch loop at the reference's 1 ms cadence.

The capture and the stage artifacts live in a temporary directory that is
removed at the end, so every run tracks from scratch.  Without
`--no-plots` and without matplotlib the command raises ImportError before
any stage runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

from gps_sdr_tpu_torch.geo.coords import llh2xyz
from gps_sdr_tpu_torch.io import scenario
from gps_sdr_tpu_torch.pipeline import Receiver
from gps_sdr_tpu_torch.tracking import TrackParams
from gps_sdr_tpu_torch.utils.device import resolve_device
from gps_sdr_tpu_torch.utils.metrics import (export_ephemeris_table,
                                             format_acquisition_table)

DEFAULT_OUT = "results_torch"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reference's Opensky records the replay reads (make_results.py:216-230)
REFERENCE_FILES = ("tckRstCT_10ms_Opensky.mat", "eph_Opensky_90.mat",
                   "sbf_Opensky_90.mat", "navSolCT_10ms_Opensky.mat")
PLOT_FILES = (
    ("task1_acquisition.png", "Plot_task_1.m"),
    ("task2_tracking.png", "Plot_task_2.m / TrackingPlot.m"),
    ("task3_ephemeris.png", "Plot_task_3.m"),
    ("task4_wls.png", "Plot_task_4.m"),
    ("task5_ekf.png", "Plot_task_5.m"),
    ("channels_dashboard.png", "TrackingPlot3.m (per-SV panels)"),
    ("vt_channels.png", "TrackingPlot_vt.m (channels + nav)"),
    ("acf_evolution.png", "CalculateFeatures.m ACF waterfall"),
    ("correlation_outputs.gif", "CalculateFeatures.m:299-319 animated ACF"))
WLS_FROM = 2        # accuracy rows: WLS from CT epoch 2 on (make_results.py)


@dataclasses.dataclass(frozen=True)
class Sizes:
    """How much of the scenario the record runs: make_results.py's
    lengths (ms) by default, and the scaling probe's problem
    (bench.py's: 8192 samples a block, 200 tracking steps)."""

    capture_ms: int = scenario.DURATION_MS
    tow0: float = scenario.TOW0
    eph_ms: int = scenario.DURATION_MS - 200
    decode_offset_ms: int = 200
    ct_ms: int = 4000
    vt_ms: int = 3000
    multicorr_ms: int = 1500
    kf_ms: int = 3000
    vt_from: int = 500          # accuracy rows: VT ms from here on
    scaling_samples: int = 8192
    scaling_steps: int = 200


def device_line(device: torch.device) -> str:
    """The device as the record's head names it: the card's name and power
    limit as nvidia-smi gives them, or "CPU"."""
    if device.type == "cpu":
        return "CPU"
    index = device.index if device.index is not None else 0
    smi = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip()


def commit_line() -> str:
    """The commit of the tree the record was made from, or why there is
    none to name."""
    try:
        head = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                              capture_output=True, text=True, check=True)
        dirty = subprocess.run(["git", "status", "--porcelain"], cwd=ROOT,
                               capture_output=True, text=True, check=True)
    except (OSError, subprocess.CalledProcessError):
        return "not recorded: the tree it ran from is not a git checkout"
    return head.stdout.strip() + (" with uncommitted changes"
                                  if dirty.stdout.strip() else "")


def _stats(err: np.ndarray) -> tuple:
    return (len(err), float(np.median(err)), float(np.percentile(err, 95)),
            float(err.max()))


def main(out_dir: str = DEFAULT_OUT, device=None, plots: bool = True,
         reference_dir: Optional[str] = None,
         scaling_ranks: Optional[Sequence[int]] = None,
         sizes: Sizes = Sizes(),
         seed_artifacts: Optional[str] = None) -> dict:
    """Write the record into `out_dir` and return its numbers.

    `device`: the card when None.  `plots`: False writes no PNG or GIF and
    says so in RESULTS.md; True needs matplotlib (ImportError before any
    stage runs without it).  `reference_dir`: the reference's directory
    holding REFERENCE_FILES for the replay section.  `scaling_ranks`: the
    world sizes of the scaling probe (when None: 1, 2 and 4 on the CPU; 1
    and 2 on a card, which the ranks then share).
    `seed_artifacts`: a directory whose files are copied into the fresh
    artifact directory before any stage runs (a capture too short to decode
    gets its decode stage that way)."""
    device = resolve_device(device)
    if plots:
        import matplotlib  # noqa: F401  (raises here, before any stage)
    ranks = tuple(scaling_ranks
                  or ((1, 2, 4) if device.type == "cpu" else (1, 2)))
    command = " ".join(
        ["python -m gps_sdr_tpu_torch.results", out_dir]
        + (["--device", str(device)] if device.type == "cpu" else [])
        + ([] if plots else ["--no-plots"])
        + (["--reference", reference_dir] if reference_dir else [])
        + ["--scaling-ranks", ",".join(str(d) for d in ranks)])
    if sizes != Sizes():
        command += f" (called from Python with {sizes})"
    os.makedirs(out_dir, exist_ok=True)
    work = tempfile.mkdtemp(prefix="gps_sdr_torch_results_")
    try:
        art = os.path.join(work, "artifacts")
        if seed_artifacts:
            shutil.copytree(seed_artifacts, art)
        return _record(out_dir, device, plots, reference_dir, ranks, sizes,
                       command, work, art)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _record(out_dir, device, plots, reference_dir, ranks, sizes, command,
            work, art) -> dict:
    from gps_sdr_tpu_torch.ops import corr_bank, track_chunk

    cfg = scenario.CFG
    launches = (track_chunk.track_chunk, corr_bank.correlator_bank_windows,
                corr_bank.correlator_bank)
    before = [k.launches for k in launches]
    t0 = time.perf_counter()
    gs = scenario.geometry_signal(sizes.tow0, device=device)
    src = scenario.write_capture(os.path.join(work, "capture.bin"), gs,
                                 sizes.capture_ms)
    rx = Receiver(cfg, src, artifact_dir=art, device=device)
    rx.track_for_eph(n_ms=sizes.eph_ms)
    eph, _ = rx.decode(start_offset_ms=sizes.decode_offset_ms)
    truth = llh2xyz(np.asarray(scenario.TRUTH_LLH)).numpy()
    prns = rx.usable_svs()
    # VT hands off from the record's own CT stage (make_results.py's VT
    # tracks a second, 3000 ms CT stage of its own for it)
    ct_kw = dict(n_ms=sizes.ct_ms)
    vt_kw = dict(n_ms=sizes.vt_ms, ct_n_ms=sizes.ct_ms)
    if plots:
        rx.report(out_dir, ct_kw=ct_kw, vt_kw=vt_kw)
    else:
        export_ephemeris_table(
            eph, os.path.join(out_dir, "task3_ephemeris.csv"), prns)

    # the ACF artifacts (ACF/CalculateFeatures.m) from a 25-tap run
    mc_rec, _ = rx.ct_position(n_ms=sizes.multicorr_ms, multicorr=True)
    if plots:
        from gps_sdr_tpu_torch.analysis import plots as plot
        taps = TrackParams.pos_multicorr(cfg).taps
        plot.plot_acf_evolution(mc_rec.corr, taps, prns,
                                os.path.join(out_dir, "acf_evolution.png"))
        plot.save_acf_animation(
            mc_rec.corr, taps, prn=prns[0], channel=0,
            rem_chip=mc_rec.rem_chip, start_ms=sizes.multicorr_ms * 2 // 3,
            n_frames=20,
            out_path=os.path.join(out_dir, "correlation_outputs.gif"))

    acq = rx.acquisition()
    _, nav = rx.ct_position(**ct_kw)
    _, vt_sol = rx.vt_position(**vt_kw)
    wls_err = np.linalg.norm(nav.usr_pos[WLS_FROM:] - truth, axis=1)
    vt_err = np.linalg.norm(vt_sol.usr_pos[sizes.vt_from:] - truth, axis=1)
    stages_s = time.perf_counter() - t0

    dev_line = device_line(device)
    lines = head_lines(dev_line, command)
    lines += [
        "## Acquisition", "```",
        format_acquisition_table(acq, cfg.signal.f_if), "```", "",
        "## Positioning accuracy vs surveyed truth", "",
        "| Solution | epochs | median 3-D err | p95 | max |",
        "|---|---|---|---|---|",
        "| WLS (CT) | {} | {:.1f} m | {:.1f} m | {:.1f} m |".format(
            *_stats(wls_err)),
        "| EKF (VT) | {} | {:.1f} m | {:.1f} m | {:.1f} m |".format(
            *_stats(vt_err)), "",
        "WLS clock drift estimate: "
        f"{np.median(nav.clk_drift_ms[WLS_FROM:]):+.2f} m/s (truth "
        "−c·2e-9 = −0.60 m/s, WLS sign convention);",
        "VT clock drift state: "
        f"{np.median(vt_sol.clk_drift_ms[sizes.vt_from:]):+.2f} m/s (VT "
        "sign convention, receiver/vt.py).", "",
        f"WLS from CT epoch {WLS_FROM} of a {sizes.ct_ms} ms CT "
        f"stage; VT from ms {sizes.vt_from} of {sizes.vt_ms} ms, handed "
        "off by that CT stage.", ""]
    lines += plot_lines(plots)
    lines += golden_replay_results(out_dir, reference_dir, plots)
    # on cards each rank takes its own (parallel/mesh.rank_device)
    lines += scaling_results("cpu" if device.type == "cpu" else None, ranks,
                             sizes.scaling_samples, sizes.scaling_steps)
    host, ms_per_epoch, kf_epochs = host_epoch_results(rx, truth,
                                                       sizes.kf_ms)
    lines += host
    with open(os.path.join(out_dir, "RESULTS.md"), "w") as f:
        f.write("\n".join(lines))
    counts = [k.launches - b for k, b in zip(launches, before)]
    return dict(
        out_dir=out_dir, device=dev_line,
        acquired=[int(p) for p in acq.sv],
        acquired_snr_db=[float(x) for x in acq.snr_db],
        acquired_delay=[int(x) for x in acq.code_delay],
        usable=[int(p) for p in prns],
        wls_epochs=int(len(wls_err)), wls_median_m=float(np.median(wls_err)),
        vt_ms=int(len(vt_err)), vt_median_m=float(np.median(vt_err)),
        stages_s=stages_s, host_epoch_ms=ms_per_epoch, kf_epochs=kf_epochs,
        launches=dict(zip(("track_chunk", "correlator_bank_windows",
                           "correlator_bank"), counts)))


def head_lines(dev_line: str, command: str) -> list:
    """The head of RESULTS.md: what ran, where (`device_line`'s words),
    from which tree."""
    return [
        "# Results — synthetic-geometry scenario, on the PyTorch/CUDA port",
        "",
        f"- Device: {dev_line}",
        f"- Command: `{command}`",
        f"- Commit: {commit_line()}",
        "",
        "The capture is the scenario of `gps_sdr_tpu_torch/io/scenario.py`",
        "(the port's copy of `tests/scenario.py`: 5 SVs, real LNAV frames,",
        "transmit-time geometry, Klobuchar/UNB3 atmosphere, receiver clock",
        "bias 0.5 ms and drift 2 ppb, 5 MHz front end, int8 IQ), synthesized",
        "by the port on the device above.  Its noise comes from a seeded",
        "`torch.Generator`, so its bytes differ from the JAX package's",
        "capture of the same scenario and this record is not the same",
        "draw as `results/RESULTS.md`.  Every time below was taken on the",
        "device above and its host.",
        ""]


def plot_lines(plots: bool) -> list:
    """The plots section: the files and their reference equivalents, or
    the statement that none were written."""
    if not plots:
        return ["## Plots", "",
                "No plots were written: the record was made with "
                "`--no-plots`.",
                "The decoded-ephemeris table `task3_ephemeris.csv` "
                "(Task_3_table.m) is written all the same.", ""]
    return (["## Plots", "", "| File | Reference equivalent |", "|---|---|"]
            + [f"| {f} | {ref} |" for f, ref in PLOT_FILES]
            + ["| task3_ephemeris.csv | Task_3_table.m |", ""])


def golden_replay_results(out_dir: str, reference_dir: Optional[str],
                          plots: bool = True) -> list:
    """The real-data record: the reference's shipped Opensky tracked records
    replayed through the port's WLS stage (`receiver/ct.run_ct_positioning`
    with the replay options, the files read by `io/matref`), and with
    `plots` its WLS solution and channel dashboard in `opensky_golden/`.
    Without `reference_dir`, or without its files, the section says why it
    is left out."""
    title = "## Real-data replay: the reference's Opensky production run"
    if not reference_dir:
        return [title, "", "Left out: no reference directory was given "
                "(`--reference DIR`, the directory holding "
                + ", ".join(f"`{f}`" for f in REFERENCE_FILES) + ").", ""]
    missing = [f for f in REFERENCE_FILES
               if not os.path.exists(os.path.join(reference_dir, f))]
    if missing:
        return [title, "", f"Left out: `{reference_dir}` lacks "
                + ", ".join(f"`{f}`" for f in missing) + ".", ""]
    from gps_sdr_tpu_torch.config import ReceiverConfig, SolutionConfig
    from gps_sdr_tpu_torch.io import matref
    from gps_sdr_tpu_torch.receiver.ct import run_ct_positioning

    ref = reference_dir
    prns = [3, 16, 22, 26, 31]
    rec, pdi = matref.load_tck_records(
        os.path.join(ref, "tckRstCT_10ms_Opensky.mat"), prns)
    eph = matref.load_eph(os.path.join(ref, "eph_Opensky_90.mat"))
    sbf = matref.load_sbf(os.path.join(ref, "sbf_Opensky_90.mat"))
    nav_ref = matref.load_navsol(
        os.path.join(ref, "navSolCT_10ms_Opensky.mat"))
    cfg = ReceiverConfig(solu=SolutionConfig(mask_snr_db=0.0))
    tow1 = np.array([eph[p].tow[0] for p in prns])
    nav1 = np.array([sbf["nav1"][p] for p in prns])
    sfb1 = np.array([eph[p].sfb[0] for p in prns])
    cur = matref.reconstruct_meas_start(rec, pdi, nav_ref, tow1, nav1,
                                        sfb1, cfg.signal.fs)
    truth = llh2xyz(np.asarray(cfg.solu.truth_llh)).numpy()
    nav = run_ct_positioning(
        rec, cfg, prns, eph, sbf, truth, pdi_ms_per_block=pdi,
        meas_start_sample=float(np.median(cur)),
        local_time_advance_s=0.04, doppler_at_fire_row=True)
    if plots:
        from gps_sdr_tpu_torch.analysis import plots as plot
        sub = os.path.join(out_dir, "opensky_golden")
        os.makedirs(sub, exist_ok=True)
        plot.plot_wls_solution(nav, truth, os.path.join(sub, "wls_replay.png"))
        plot.plot_channel_dashboard(rec, prns,
                                    os.path.join(sub, "ct_channels.png"))
    err = np.linalg.norm(nav.usr_pos - truth, axis=1)
    n_rep, n_ref = len(nav.local_time), len(nav_ref.local_time)
    if n_rep != n_ref:
        return [title, "", f"**EPOCH-COUNT MISMATCH**: the replay produced "
                f"{n_rep} epochs against the reference's {n_ref}: "
                "investigate before trusting this record.", ""]
    dref = np.linalg.norm(nav.usr_pos - nav_ref.usr_pos, axis=1)
    return [
        title, "",
        "The reference's shipped `tckRstCT_10ms_Opensky.mat` tracked "
        "records replayed through the port's WLS stage"
        + (" (`opensky_golden/` plots):" if plots else ":"), "",
        f"- {n_rep}/{n_ref} epochs reproduced; max position difference "
        f"against the reference's own `navSolCT` fixes: {dref.max():.2e} m",
        f"- accuracy against the surveyed antenna: median "
        f"{np.median(err):.1f} m, p95 {np.percentile(err, 95):.1f} m", ""]


def scaling_results(device=None, ranks: Sequence[int] = (1, 2),
                    samples: int = 8192, steps: int = 200,
                    timeout_s: int = 600) -> list:
    """The multi-device scaling section: for each world size D in `ranks`,
    `parallel/distributed.launch`'s `scaling` leg (the acquisition grid over
    2·D PRNs of `samples` a block, `steps` blocks of 2·D channels through
    `track_chunk`) timed unsharded in one process and sharded over D ranks
    (gloo), each on `device` (None: each rank's card).  The median of the
    leg's timed calls with [min, max]; efficiency = t_unsharded /
    t_sharded, raw and clipped at 1.0.  A failed leg raises."""
    from gps_sdr_tpu_torch.parallel import distributed as pdist

    on_cpu = device is not None and torch.device(device).type == "cpu"
    rows = []
    for d in ranks:
        with tempfile.TemporaryDirectory(prefix="gps_sdr_torch_scaling_") \
                as work:
            res = pdist.launch(legs=("scaling",), n_processes=d,
                               device=device, timeout_s=timeout_s,
                               work_dir=work, scaling=dict(samples=samples,
                                                           steps=steps))
        r = res[0]["scaling"]
        cells = [str(d)]
        for what in ("acq", "track"):
            un, sh = r[f"{what}_unsharded_s"], r[f"{what}_sharded_s"]
            eff = float(np.median(un) / np.median(sh))
            cells += [f"{np.median(un):.4g} [{min(un):.4g}, {max(un):.4g}]",
                      f"{np.median(sh):.4g} [{min(sh):.4g}, {max(sh):.4g}]",
                      f"{eff:.3f}", f"{min(eff, 1.0):.3f}"]
        rows.append("| " + " | ".join(cells) + " |")
    if on_cpu:
        setting = (
            "Each rank is a process on the CPU with "
            f"{pdist.RANK_THREADS} torch threads (gloo); the unsharded side "
            "is one process with D × that many, so both sides use the same "
            "cores and an efficiency of 1.0 means the sharding (the "
            "slices and the gathers through gloo) loses nothing against "
            "PyTorch's own threading of the same work.")
    else:
        setting = (
            "The D ranks share the one card (gloo, each collective through "
            "the host): these numbers measure contention for one card and "
            "the cost of the host round trips, not scaling.  NCCL over one "
            "card a rank waits for a machine that has several.")
    return [
        "## Multi-device scaling (the sharded stages of `parallel/`)", "",
        "The same 2·D-PRN acquisition grid "
        f"({pdist.SCALING_BLOCKS} blocks of {samples} samples, "
        f"{pdist.SCALING_FREQS} Doppler bins) and {steps} blocks of "
        "2·D-channel tracking at 1.023 MHz (`track_chunk`) run unsharded "
        "in one process, then sharded over a world of D ranks "
        "(`parallel/distributed.py`, leg `scaling`).  Seconds per call: "
        f"the median of {pdist.SCALING_REPS} with [min, max]; efficiency "
        "= t_unsharded / t_sharded, raw and clipped at 1.0.", "",
        setting, "",
        "| D | acquisition unsharded s | sharded s | efficiency | clipped "
        "| tracking unsharded s | sharded s | efficiency | clipped |",
        "|---|---|---|---|---|---|---|---|---|",
        *rows, ""]


def host_epoch_results(rx: Receiver, truth: np.ndarray, n_ms: int = 3000
                       ) -> tuple:
    """The legacy per-ms filter's host epoch loop
    (`ct_position_kf(epoch_ms=1)`, trackingCT_POS.m's native cadence) from
    a start 137 m off the truth, timed with its tracking: (section lines,
    ms per epoch, epochs).  `rx` must not hold this stage's artifact yet, or the
    time is that of loading it."""
    t0 = time.perf_counter()
    _, nav = rx.ct_position_kf(n_ms=n_ms, epoch_ms=1,
                               init_pos_ecef=truth
                               + np.array([100.0, 50.0, -80.0]))
    wall = time.perf_counter() - t0
    n_ep = len(nav.clk_bias_m)
    err = np.linalg.norm(nav.usr_pos - truth, axis=1)
    per = wall / n_ep * 1e3
    return [
        "## Host epoch loop: the legacy filter at 1 ms", "",
        "`ct_position_kf(epoch_ms=1)`, the legacy position filter "
        "(trackingCT_POS.m) at its native cadence of one epoch a tracked "
        f"ms, {n_ms} ms tracked through `track_chunk`: {n_ep} epochs in "
        f"{wall:.2f} s, {per:.2f} ms an epoch, tracking included; median "
        f"error {np.median(err):.1f} m.  The epochs run on the host in "
        "float64 PyTorch and NumPy, eagerly.", ""], per, n_ep


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m gps_sdr_tpu_torch.results",
        description="Write the port's results record (the counterpart of "
                    "make_results.py)")
    ap.add_argument("out", nargs="?", default=DEFAULT_OUT,
                    help=f"output directory (default {DEFAULT_OUT}/)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for "
                         "the CPU)")
    ap.add_argument("--no-plots", action="store_true",
                    help="write no PNG or GIF (they need matplotlib)")
    ap.add_argument("--reference", default=None, metavar="DIR",
                    help="the reference's directory with its Opensky .mat "
                         "records, for the replay section")
    ap.add_argument("--scaling-ranks", default=None,
                    help="comma-separated world sizes of the scaling probe "
                         "(default 1,2,4 on the CPU, 1,2 on a card)")
    return ap


def cli_main(argv=None) -> int:
    import json

    args = parser().parse_args(argv)
    ranks = (None if args.scaling_ranks is None else
             [int(d) for d in args.scaling_ranks.split(",")])
    out = main(args.out, device=args.device, plots=not args.no_plots,
               reference_dir=args.reference, scaling_ranks=ranks)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(cli_main())
