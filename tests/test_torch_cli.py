"""The port's command line (`python -m gps_sdr_tpu_torch.cli`, the
SDR_main.m sequence) against the JAX package's `examples/sdr_main.py`, on the
CPU.

- `build_config` equals the JAX script's (loaded with importlib; the
  script is not edited) for every preset, with and without --skip-ms;
- the option set is the JAX script's with `--cpu` replaced by `--device`,
  and `--no-plots` and the torchrun world's `--dist-backend` and
  `--dist-timeout` added;
- a subprocess run with `--device cpu` over a capture of its own: the
  scenario constellation (5 SVs, transmit-time geometry + atmosphere) for
  41.2 s at 2.5 MHz, synthesized by the port into pytest's tmp directory
  (never `.cache/`), started 2 s before the scenario's TOW so that the
  first subframe `decode` finds from 3000 ms on lies at ~3.07 s, inside a
  3600 ms CT stage.  It runs the reference's 3-phase eph schedule (1000 +
  40 000 ms), decode, CT-POS (25 taps) + WLS, VT (300 ms), the `.mat` set
  and the plots; each `.mat` equals what an in-process Receiver's
  `export_mat` writes for the same arguments from the command's
  artifacts; a second run resumes from them.
"""

import dataclasses
import importlib.util
import io
import os
import re
import shutil
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from gps_sdr_tpu_torch import cli
from gps_sdr_tpu_torch.config import FileConfig, ReceiverConfig, SignalConfig
from gps_sdr_tpu_torch.geo.coords import llh2xyz
from gps_sdr_tpu_torch.io.ifdata import IFSampleSource
from gps_sdr_tpu_torch.io.synthetic import GeometrySignal, GeometrySV
from gps_sdr_tpu_torch.pipeline import Receiver
import scenario as sc

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS, F_IF = 2.5e6, 0.6e6
CAPTURE_MS, CT_MS, VT_MS, NAME = 41200, 3600, 300, "cli"
TOW0 = sc.TOW0 - 2.0
WLS_GATE_M = 120.0
MAT_FILES = sorted([f"nAcquired_{NAME}_0.mat", f"eph_{NAME}.mat",
                    f"sbf_{NAME}.mat", f"tckRstCT_1ms_{NAME}.mat",
                    f"navSolCT_1ms_{NAME}.mat",
                    f"tckRstVT_{NAME}_updated.mat",
                    f"navSolVT_{NAME}_updated.mat"])
PLOT_FILES = sorted(["task1_acquisition.png", "task2_tracking.png",
                     "task3_ephemeris.png", "task4_wls.png", "task5_ekf.png",
                     "channels_dashboard.png", "vt_channels.png",
                     "task3_ephemeris.csv"])


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_sdr_main", os.path.join(ROOT, "examples", "sdr_main.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("skip", [None, 1234])
@pytest.mark.parametrize("preset", ["opensky", "urban", "none"])
def test_build_config_equals_jax_script(preset, skip):
    argv = ["cap.bin", "--preset", preset, "--fs", "5e6", "--f-if", "1.25e6",
            "--iq-bytes", "2", "--name", "scn"]
    if skip is not None:
        argv += ["--skip-ms", str(skip)]
    args = cli.parser().parse_args(argv)
    want = dataclasses.asdict(_jax_script().build_config(args))
    got = dataclasses.asdict(cli.build_config(args))
    assert got == want
    assert got["file"]["path"] == "cap.bin"
    if skip is not None:
        assert got["file"]["skip_ms"] == skip


def _options(run_help) -> set:
    out = io.StringIO()
    with redirect_stdout(out), pytest.raises(SystemExit):
        run_help()
    return set(re.findall(r"(--[a-z][a-z-]*)", out.getvalue()))


def test_options_are_the_jax_scripts(monkeypatch):
    mod = _jax_script()
    monkeypatch.setattr(sys, "argv", ["sdr_main.py", "--help"])
    jax_opts = _options(mod.main)
    port_opts = _options(lambda: cli.main(["--help"]))
    assert "--cpu" in jax_opts and "--preset" in jax_opts
    assert port_opts == (jax_opts - {"--cpu"}) | {
        "--device", "--no-plots", "--dist-backend", "--dist-timeout"}


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the machine without a card")
def test_cli_defaults_to_the_card(tmp_path):
    """Without --device the command runs on the card, and where there is
    none it fails saying so, before any stage runs."""
    cap = tmp_path / "x.bin"
    np.zeros(2 * 2500 * 100, np.int8).tofile(cap)
    r = subprocess.run(
        [sys.executable, "-m", "gps_sdr_tpu_torch.cli", str(cap), "--fs",
         "2.5e6", "--out", str(tmp_path / "out")], capture_output=True,
        text=True, timeout=300, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode != 0 and 'device="cpu"' in r.stderr, r.stderr
    assert not (tmp_path / "out" / "artifacts").exists() or not os.listdir(
        tmp_path / "out" / "artifacts")


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli")
    cfg = ReceiverConfig(file=FileConfig(name=NAME, skip_ms=0),
                         signal=SignalConfig(f_if=F_IF, fs=FS))
    usr = llh2xyz(np.asarray(sc.TRUTH_LLH)).numpy()
    gs = GeometrySignal(
        cfg, [GeometrySV(prn=p, eph=e, amplitude=a) for p, e, a in zip(
            sc.SCN_PRNS, sc.visible_constellation(len(sc.SCN_PRNS)),
            sc.AMPLITUDES)],
        usr, TOW0, clk_bias_s=sc.CLK_BIAS_S, clk_drift_sps=sc.CLK_DRIFT_SPS,
        atmosphere=True, iono_alpha=cfg.cmn.iono_alpha,
        iono_beta=cfg.cmn.iono_beta, doy=cfg.cmn.day_of_year, device="cpu")
    path = str(root / "capture.bin")
    out = np.memmap(path, dtype=np.int8, mode="w+",
                    shape=(2 * CAPTURE_MS * cfg.signal.samples_per_ms,))
    gs.synthesize(CAPTURE_MS, noise_std=sc.NOISE_STD, seed=11, out=out)
    out.flush()
    del out
    return dict(root=root, path=path, usr=usr)


def _argv(capture, out):
    return [capture["path"], "--fs", str(FS), "--f-if", str(F_IF),
            "--iq-bytes", "1", "--name", NAME, "--ct-ms", str(CT_MS),
            "--vt-ms", str(VT_MS), "--device", "cpu", "--out", out]


def _run(argv):
    return subprocess.run(
        [sys.executable, "-m", "gps_sdr_tpu_torch.cli"] + argv,
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT))


@pytest.fixture(scope="module")
def command(capture):
    out = str(capture["root"] / "out")
    r = _run(_argv(capture, out))
    return dict(r=r, out=out)


def _medians(stdout):
    wls = re.search(r"WLS: (\d+) epochs, median error vs configured truth "
                    r"([\d.]+) m, LLH ([\d.-]+) ([\d.-]+)", stdout)
    vt = re.search(r"VT/EKF: (\d+) ms, median error ([\d.]+) m", stdout)
    return wls, vt


def test_command_runs_every_stage(command):
    r, out = command["r"], command["out"]
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    lines = r.stdout.splitlines()
    head = lines.index(
        "PRN   SNR[dB]  Doppler[Hz]  FineDoppler[Hz]  CodeDelay[smp]")
    prns = [int(l.split()[0]) for l in lines[head + 1:head + 6]]
    assert sorted(prns) == sorted(sc.SCN_PRNS)
    usable = re.search(r"usable SVs \(complete healthy ephemeris\): "
                       r"\[([\d, ]*)\]", r.stdout)
    assert usable and len(usable.group(1).split(",")) >= 4, r.stdout
    wls, vt = _medians(r.stdout)
    assert wls and float(wls.group(2)) < WLS_GATE_M, r.stdout
    assert abs(float(wls.group(3)) - 22.3284) < 0.01
    assert vt and int(vt.group(1)) == VT_MS
    assert float(vt.group(2)) < WLS_GATE_M, r.stdout
    assert lines[-3:] == [f"artifacts: {out}/artifacts",
                          f"exports:   {out}/mat", f"plots:     {out}/plots"]
    assert "kernel launches" not in r.stdout      # counted on the card only


def test_command_writes_the_mat_set_and_plots(command):
    out = command["out"]
    assert sorted(os.listdir(os.path.join(out, "mat"))) == MAT_FILES
    plots = os.path.join(out, "plots")
    assert sorted(os.listdir(plots)) == PLOT_FILES
    for f in PLOT_FILES:
        assert os.path.getsize(os.path.join(plots, f)) > (
            10_000 if f.endswith(".png") else 100), f


def _assert_mat_equal(a, b, where):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype.names == b.dtype.names and a.shape == b.shape, where
    if a.dtype.names:
        for name in a.dtype.names:
            for i in np.ndindex(a.shape):
                _assert_mat_equal(a[i][name], b[i][name], f"{where}.{name}")
    elif a.dtype == object:
        for i in np.ndindex(a.shape):
            _assert_mat_equal(a[i], b[i], f"{where}{i}")
    else:
        assert a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)


def test_mat_files_equal_in_process_export(command, capture, tmp_path,
                                           monkeypatch):
    """A Receiver of the command's configuration over a copy of its
    artifacts exports, for the same ct/vt arguments, the same variables in
    every file, and tracks nothing to do it."""
    import scipy.io as sio

    from gps_sdr_tpu_torch import pipeline
    art = str(tmp_path / "artifacts")
    shutil.copytree(os.path.join(command["out"], "artifacts"), art)
    monkeypatch.setattr(pipeline, "run_tracking", None)
    args = cli.parser().parse_args(_argv(capture, "unused"))
    cfg = cli.build_config(args)
    rx = Receiver(cfg, IFSampleSource(capture["path"], cfg.file),
                  artifact_dir=art, device="cpu")
    mat = str(tmp_path / "mat")
    rx.export_mat(mat, ct_kw=dict(n_ms=CT_MS), vt=True,
                  vt_kw=dict(n_ms=VT_MS, ct_n_ms=CT_MS))
    assert sorted(os.listdir(mat)) == MAT_FILES
    for name in MAT_FILES:
        a = sio.loadmat(os.path.join(command["out"], "mat", name))
        b = sio.loadmat(os.path.join(mat, name))
        keys = sorted(k for k in a if not k.startswith("__"))
        assert keys and keys == sorted(k for k in b if not k.startswith("__"))
        for k in keys:
            _assert_mat_equal(a[k], b[k], f"{name}:{k}")


def test_command_tracks_ct_once(command):
    """The VT stage reuses the CT stage's artifact: one CT record, one
    eph record, one VT result."""
    files = sorted(os.listdir(os.path.join(command["out"], "artifacts")))
    assert len([f for f in files if f.startswith("tckct_")]) == 1, files
    assert len([f for f in files if f.startswith("tckeph_ref_")]) == 1
    assert len([f for f in files if f.startswith("navvt2_")]) == 1


def test_command_resumes_from_its_artifacts(command, capture):
    """Run again on the same output directory: the stages are served from
    their artifacts and print the same results."""
    r = _run(_argv(capture, command["out"]))
    assert r.returncode == 0, r.stderr
    assert r.stdout == command["r"].stdout


def test_pyproject_installs_either_package_and_the_command():
    """numpy is the one core dependency; each package's stack is an extra
    (`pip install .[jax]` for the JAX package), and the command line is an
    installed script."""
    import tomllib
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        project = tomllib.load(f)["project"]
    assert project["dependencies"] == ["numpy"]
    extras = project["optional-dependencies"]
    assert extras["jax"] == ["jax"]
    assert {"torch", "scipy"} <= set(extras["torch"])
    assert {"matplotlib", "pillow"} <= set(extras["plots"])
    assert project["scripts"] == {"gps-sdr-torch": "gps_sdr_tpu_torch.cli:main"}
