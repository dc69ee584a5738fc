"""SDR_main.m on the port: the staged receiver as one command.

    python -m gps_sdr_tpu_torch.cli CAPTURE [options]
    gps-sdr-torch CAPTURE [options]          (the installed script)

The reference's main script (`SDR_main.m`) runs acquisition → ephemeris
tracking → nav decode → usable-SV filter → CT/WLS positioning →
(optionally) VT/EKF positioning, checkpointing every stage.  This is the
same sequence on the PyTorch/CUDA port, with the arguments of the JAX
package's `examples/sdr_main.py` but two: `--device` (default: the CUDA
card; `--device cpu` for the CPU) in place of `--cpu`, and `--no-plots`,
which skips the plots (they need matplotlib).  Stage artifacts checkpoint to
`--artifacts` (default `<out>/artifacts`; re-running resumes, delete the
directory for a cold run); results are written as reference-schema `.mat`
files to `<out>/mat` and as the Task 1-5 plots to `<out>/plots`.

    # the reference's Opensky run (SDR_main.m with initParameters.m
    # defaults), on the card:
    python -m gps_sdr_tpu_torch.cli --preset opensky /path/to/Opensky.bin \\
        --out results_opensky

    # any capture with explicit front-end parameters, on the CPU:
    python -m gps_sdr_tpu_torch.cli capture.bin --fs 5e6 --f-if 1.25e6 \\
        --iq-bytes 1 --ct-ms 8500 --vt-ms 1000 --device cpu --out sdr_out

The CT stage needs the first decoded subframe inside its record: `decode`
looks for it from 3000 ms of the eph record on, so `--ct-ms` must reach
past that subframe's row (a switched CT record, `--preset opensky`, counts
rows).

Under `torchrun` (WORLD_SIZE > 1 in the environment) the command joins the
world before any stage runs and `Receiver(mesh="auto")` shards every stage
over the ranks: acquisition over PRNs, tracking and vector tracking over
channels, each WLS epoch's normal equations reduced.  Each rank takes its
own card (`parallel/mesh.rank_device`), or the CPU with `--device cpu`.
Rank 0 alone prints and writes files; it prints one `kernel launches` line
per rank.  `--dist-backend` is nccl on cards (one card per rank) and gloo
with `--device cpu`; gloo also lets ranks share a card.

    # one rank per card, on a node with 4 cards:
    torchrun --standalone --nproc-per-node 4 -m gps_sdr_tpu_torch.cli \
        --preset opensky /path/to/Opensky.bin --out results_opensky

    # two ranks on the CPU:
    torchrun --standalone --nproc-per-node 2 -m gps_sdr_tpu_torch.cli \
        capture.bin --fs 5e6 --f-if 1.25e6 --ct-ms 8500 --vt-ms 1000 \
        --device cpu --dist-backend gloo --out sdr_out
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from gps_sdr_tpu_torch.config import (FileConfig, ReceiverConfig,
                                      SignalConfig, opensky_config,
                                      urban_config)
from gps_sdr_tpu_torch.geo.coords import llh2xyz
from gps_sdr_tpu_torch.io.ifdata import IFSampleSource
from gps_sdr_tpu_torch.pipeline import Receiver
from gps_sdr_tpu_torch.utils.metrics import format_acquisition_table


def build_config(args) -> ReceiverConfig:
    """The receiver configuration of the parsed arguments: a preset, or the
    front end given by --fs / --f-if / --iq-bytes / --name; --skip-ms
    overrides the skip of either."""
    if args.preset == "opensky":
        cfg = opensky_config(args.capture)
    elif args.preset == "urban":
        cfg = urban_config(args.capture)
    else:
        cfg = ReceiverConfig(
            file=FileConfig(path=args.capture, name=args.name,
                            skip_ms=args.skip_ms or 0,
                            data_precision=args.iq_bytes),
            signal=SignalConfig(f_if=args.f_if, fs=args.fs))
    if args.skip_ms is not None:
        cfg = cfg.replace(
            file=dataclasses.replace(cfg.file, skip_ms=args.skip_ms))
    return cfg


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="gps-sdr-torch",
        description="Full GNSS SDR run (SDR_main.m equivalent) on the "
                    "PyTorch/CUDA receiver")
    ap.add_argument("capture", help="raw IF capture file (interleaved IQ)")
    ap.add_argument("--preset", choices=("opensky", "urban", "none"),
                    default="none")
    ap.add_argument("--fs", type=float, default=58e6,
                    help="sampling rate [Hz] (ignored with a preset)")
    ap.add_argument("--f-if", type=float, default=4.58e6,
                    help="intermediate frequency [Hz]")
    ap.add_argument("--iq-bytes", type=int, default=1, choices=(1, 2),
                    help="bytes per I/Q component (int8 or int16)")
    ap.add_argument("--skip-ms", type=int, default=None,
                    help="skip this many ms of capture before acquisition")
    ap.add_argument("--name", default="capture",
                    help="artifact-name stem (ignored with a preset)")
    ap.add_argument("--out", default="sdr_out",
                    help="output directory (plots + .mat exports)")
    ap.add_argument("--artifacts", default=None,
                    help="stage-checkpoint directory "
                         "(default: <out>/artifacts)")
    ap.add_argument("--ct-ms", type=int, default=None,
                    help="CT positioning length (track.ms_ct_pos)")
    ap.add_argument("--vt-ms", type=int, default=None,
                    help="VT positioning length (track.ms_vt)")
    ap.add_argument("--no-vt", action="store_true",
                    help="stop after the WLS stage (cmn.vtEnable=0)")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card; "
                         "'cpu' for the CPU)")
    ap.add_argument("--no-plots", action="store_true",
                    help="skip the Task 1-5 plots (they need matplotlib)")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                    help="collective backend under torchrun (default: nccl "
                         "on cards, gloo with --device cpu)")
    ap.add_argument("--dist-timeout", type=float, default=1800.0,
                    help="seconds a rank waits for the others under "
                         "torchrun before the world is ended")
    return ap


def join_world(args) -> bool:
    """Join the world torchrun describes in the environment (WORLD_SIZE >
    1, with RANK, LOCAL_WORLD_SIZE and the rendezvous address); False, and
    nothing done, without one.  Raises before joining where the world
    cannot run as asked: a device other than cpu (each rank takes its own
    card), nccl on the CPU, or nccl with more ranks on this node than
    cards."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    if args.device not in (None, "cpu"):
        raise ValueError(
            f"--device {args.device} in a world of ranks: each rank takes "
            "its own card; leave --device out, or pass --device cpu")
    backend = args.dist_backend or ("gloo" if args.device == "cpu"
                                    else "nccl")
    if backend == "nccl" and args.device == "cpu":
        raise ValueError("--dist-backend nccl runs on cards; with --device "
                         "cpu pass --dist-backend gloo")
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_WORLD_SIZE",
                                   os.environ["WORLD_SIZE"]))
        cards = torch.cuda.device_count()
        if local > cards:
            raise RuntimeError(
                f"{local} ranks on this node and {cards} CUDA cards: nccl "
                "needs a card per rank; pass --dist-backend gloo to share "
                "cards (or run on the CPU with --device cpu)")
    dist.init_process_group(
        backend, timeout=datetime.timedelta(seconds=args.dist_timeout))
    return True


def launch_lines(rx: Receiver) -> list:
    """The `kernel launches` lines: this process's counts, or in a world
    one line per rank (each rank's counts, gathered)."""
    from gps_sdr_tpu_torch.ops import corr_bank, track_chunk

    counts = [track_chunk.track_chunk.launches,
              corr_bank.correlator_bank_windows.launches,
              corr_bank.correlator_bank.launches]
    fmt = ("track_chunk {}, correlator_bank_windows {}, "
           "correlator_bank {}")
    if rx.mesh is None:
        return [f"kernel launches: {fmt.format(*counts)}"]
    every = rx.mesh.all_gather_rows(
        torch.tensor([counts], dtype=torch.int64, device=rx.device))
    return [f"kernel launches, rank {r}: {fmt.format(*row)}"
            for r, row in enumerate(every.tolist())]


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    joined = join_world(args)
    try:
        return run(args)
    finally:
        if joined:
            dist.destroy_process_group()


def run(args) -> int:
    """The stages of the command, after `main` has joined any world."""
    cfg = build_config(args)
    src = IFSampleSource(args.capture, cfg.file)
    art = args.artifacts or os.path.join(args.out, "artifacts")
    rx = Receiver(cfg, src, artifact_dir=art, device=args.device)
    # rank 0 of a world prints; the other ranks run the same stages quietly
    quiet = rx.mesh is not None and rx.mesh.rank != 0
    print_ = (lambda *a, **k: None) if quiet else print

    acq = rx.acquisition()
    print_(format_acquisition_table(acq, cfg.signal.f_if))
    rx.track_for_eph_reference()        # the reference's 3-phase schedule
    rx.decode()
    svs = rx.usable_svs()
    print_(f"usable SVs (complete healthy ephemeris): {svs}")

    truth = llh2xyz(np.asarray(cfg.solu.truth_llh)).numpy()
    ct_kw = {} if args.ct_ms is None else dict(n_ms=args.ct_ms)
    _, nav = rx.ct_position(**ct_kw)
    err = np.linalg.norm(nav.usr_pos - truth, axis=1)
    print_(f"WLS: {len(nav.local_time)} epochs, "
           f"median error vs configured truth {np.median(err):.1f} m, "
           f"LLH {nav.usr_pos_llh[-1][0]:.6f} {nav.usr_pos_llh[-1][1]:.6f}")

    vt_kw = None
    if not args.no_vt and cfg.cmn.vt_enable:
        vt_kw = {} if args.vt_ms is None else dict(n_ms=args.vt_ms)
        if args.ct_ms is not None:
            vt_kw["ct_n_ms"] = args.ct_ms
        _, sol = rx.vt_position(**vt_kw)
        verr = np.linalg.norm(sol.usr_pos - truth, axis=1)
        print_(f"VT/EKF: {len(sol.local_time)} ms, "
               f"median error {np.median(verr):.1f} m")

    os.makedirs(args.out, exist_ok=True)
    rx.export_mat(os.path.join(args.out, "mat"), ct_kw=ct_kw,
                  vt=vt_kw is not None, vt_kw=vt_kw)
    if not args.no_plots:
        rx.report(os.path.join(args.out, "plots"), vt=vt_kw is not None,
                  ct_kw=ct_kw, vt_kw=vt_kw)
    if rx.device.type == "cuda" or rx.mesh is not None:
        for line in launch_lines(rx):
            print_(line)
    print_(f"artifacts: {art}\nexports:   {args.out}/mat")
    if not args.no_plots:
        print_(f"plots:     {args.out}/plots")
    return 0


if __name__ == "__main__":
    sys.exit(main())
