"""The port's command line under a torchrun world, on the CPU (gloo).

`python -m torch.distributed.run --standalone --nproc-per-node N` starts N
ranks of `gps_sdr_tpu_torch.cli` (each through a small wrapper that runs
the module as `-m` does and logs every file the rank opens for writing
under the output directory), N = 2 and 3 (3 pads the 5 channels), over a
capture of `tests/test_torch_cli.py`'s kind: the scenario's 5 SVs for
41.2 s at 2.5 MHz, synthesized by the port into pytest's tmp directory
(never `.cache/`), started 2 s before the scenario's TOW.

The single-process command runs first, from scratch.  To keep the worlds
cheap, each world's `--artifacts` is seeded with a copy of its acquisition
and eph-stage artifacts (the table, the eph record, the ephemerides);
CT-POS (25 taps) with its WLS epochs, VT and the export then run sharded.
What a world must show:
- exit code 0; the acquisition table, usable SVs, WLS and VT lines printed
  once, equal to the single process's; one `kernel launches` line per rank
  (all 0 on the CPU, where the wrappers run their plain versions);
- the `.mat` set equal to the single process's
  (`parallel/distributed.compare_mat_exports`: the records exact, the WLS
  fixes within 1e-6 m, VT within tests/test_mesh_pipeline.py's split);
- only rank 0 wrote files.
And without a world: `join_world` joins none; with one it refuses nccl
with more ranks than cards and an explicit `--device cuda:K`, before
joining.
"""

import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from gps_sdr_tpu_torch import cli
from gps_sdr_tpu_torch.config import FileConfig, ReceiverConfig, SignalConfig
from gps_sdr_tpu_torch.io import scenario as scn
from gps_sdr_tpu_torch.parallel.distributed import compare_mat_exports

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS, F_IF = 2.5e6, 0.6e6
CAPTURE_MS, CT_MS, VT_MS, NAME = 41200, 3600, 300, "cliw"
WORLDS = (2, 3)
RUN_TIMEOUT_S = 300
TABLE_HEAD = "PRN   SNR[dB]  Doppler[Hz]  FineDoppler[Hz]  CodeDelay[smp]"
# the acquisition and eph-stage artifacts a world is seeded with
SEEDED = re.compile(rf"(acquired_|tckeph_ref_|eph_){NAME}.*")

# runs the command as `python -m gps_sdr_tpu_torch.cli` does, after noting
# every path under the output directory that this rank opens for writing
_WRAPPER = """
import builtins, os, runpy, sys
watch = os.path.realpath(sys.argv[1])
log = open(os.path.join(sys.argv[2], "writes_" + os.environ["RANK"]), "w")
real_open, real_os_open = builtins.open, os.open

def note(path):
    p = os.path.realpath(os.fspath(path))
    if p.startswith(watch + os.sep):
        log.write(p + "\\n")
        log.flush()

def open_(file, mode="r", *a, **k):
    if not isinstance(file, int) and any(c in mode for c in "wax+"):
        note(file)
    return real_open(file, mode, *a, **k)

def os_open(path, flags, *a, **k):
    if flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT):
        note(path)
    return real_os_open(path, flags, *a, **k)

builtins.open, os.open = open_, os_open
sys.argv = ["gps_sdr_tpu_torch.cli"] + sys.argv[3:]
runpy.run_module("gps_sdr_tpu_torch.cli", run_name="__main__",
                 alter_sys=True)
"""


def _env():
    return dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2",
                GLOO_SOCKET_IFNAME="lo")


def _argv(capture, out, artifacts=None):
    return [capture, "--fs", str(FS), "--f-if", str(F_IF), "--iq-bytes", "1",
            "--name", NAME, "--ct-ms", str(CT_MS), "--vt-ms", str(VT_MS),
            "--no-plots", "--out", out] + (
                ["--artifacts", artifacts] if artifacts else [])


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """The capture and the single-process command's run on it."""
    root = tmp_path_factory.mktemp("torch_cli_world")
    cfg = ReceiverConfig(file=FileConfig(name=NAME, skip_ms=0),
                         signal=SignalConfig(f_if=F_IF, fs=FS))
    path = str(root / "capture.bin")
    scn.write_capture(path, scn.geometry_signal(scn.TOW0 - 2.0, cfg, "cpu"),
                      CAPTURE_MS)
    out = str(root / "single")
    r = subprocess.run(
        [sys.executable, "-m", "gps_sdr_tpu_torch.cli"]
        + _argv(path, out) + ["--device", "cpu"], capture_output=True,
        text=True, timeout=RUN_TIMEOUT_S, cwd=ROOT, env=_env())
    assert r.returncode == 0, f"{r.stdout}\n{r.stderr}"
    return dict(root=root, path=path, out=out, r=r)


def _run_world(n, capture, out, artifacts, log_dir, extra=()):
    wrapper = os.path.join(log_dir, "wrapper.py")
    with open(wrapper, "w") as f:
        f.write(_WRAPPER)
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(n), wrapper, out, log_dir]
        + _argv(capture, out, artifacts) + list(extra),
        capture_output=True, text=True, timeout=RUN_TIMEOUT_S, cwd=ROOT,
        env=_env())


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"{n}ranks")
def world(request, single, tmp_path_factory):
    n = request.param
    root = tmp_path_factory.mktemp(f"world{n}")
    out, art = str(root / "out"), str(root / "out" / "artifacts")
    os.makedirs(art)
    src = os.path.join(single["out"], "artifacts")
    seeded = [f for f in os.listdir(src) if SEEDED.fullmatch(f)]
    for f in seeded:
        shutil.copy(os.path.join(src, f), art)
    logs = str(root / "logs")
    os.makedirs(logs)
    r = _run_world(n, single["path"], out, art, logs,
                   ("--device", "cpu", "--dist-backend", "gloo",
                    "--dist-timeout", "240"))
    return dict(n=n, r=r, out=out, art=art, logs=logs, seeded=seeded)


def _lines(stdout):
    return stdout.splitlines()


def test_seeded_artifacts_are_the_early_stages(world):
    assert sorted(re.sub(r"_.*", "", f) for f in world["seeded"]) == [
        "acquired", "eph", "tckeph"], world["seeded"]


def test_world_prints_each_result_once(world, single):
    r = world["r"]
    assert r.returncode == 0, f"{r.stdout}\n{r.stderr[-4000:]}"
    lines, ref = _lines(r.stdout), _lines(single["r"].stdout)
    assert lines.count(TABLE_HEAD) == 1
    head = lines.index(TABLE_HEAD)
    assert lines[head:head + 6] == ref[head:head + 6]
    for prefix in ("usable SVs", "WLS: ", "VT/EKF: "):
        got = [l for l in lines if l.startswith(prefix)]
        want = [l for l in ref if l.startswith(prefix)]
        assert len(got) == 1 and got == want, (prefix, got, want)
    assert lines[-2:] == [f"artifacts: {world['art']}",
                          f"exports:   {world['out']}/mat"]


def test_world_prints_one_launch_line_per_rank(world):
    got = re.findall(r"^kernel launches, rank (\d+): track_chunk (\d+), "
                     r"correlator_bank_windows (\d+), correlator_bank "
                     r"(\d+)$", world["r"].stdout, re.M)
    assert [int(g[0]) for g in got] == list(range(world["n"]))
    # the CPU runs the plain versions, which launch nothing
    assert all(g[1:] == ("0", "0", "0") for g in got)
    assert "kernel launches: " not in world["r"].stdout


def test_world_mat_set_equals_single_process(world, single):
    res = compare_mat_exports(os.path.join(world["out"], "mat"),
                              os.path.join(single["out"], "mat"))
    assert res["same_files"] and len(res["files"]) == 7, res
    assert res["ok"], res
    # the stages that ran sharded agree where they must be exact
    for f in res["files"]:
        if f.startswith(("tckRstCT", "nAcquired", "eph", "sbf")):
            assert f not in res["differ"], res


def test_only_rank_0_writes(world):
    """Rank 0 wrote the CT/VT artifacts and the .mat set; no other rank
    opened a file under the output directory for writing."""
    def written(rank):
        with open(os.path.join(world["logs"], f"writes_{rank}")) as f:
            return {os.path.basename(p) for p in f.read().split()}

    assert world["r"].returncode == 0
    zero = written(0)
    assert {f for f in os.listdir(os.path.join(world["out"], "mat"))} <= zero
    assert any(f.startswith("tckct_") for f in zero), zero
    assert any(f.startswith("navvt2_") for f in zero), zero
    for rank in range(1, world["n"]):
        assert written(rank) == set(), (rank, written(rank))


def test_no_world_without_torchrun(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    args = cli.parser().parse_args(["cap.bin", "--device", "cpu"])
    assert cli.join_world(args) is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert cli.join_world(args) is False
    assert not torch.distributed.is_initialized()


def _world_env(monkeypatch, size, local):
    for k, v in dict(WORLD_SIZE=size, LOCAL_WORLD_SIZE=local, RANK=0,
                     LOCAL_RANK=0, MASTER_ADDR="localhost",
                     MASTER_PORT=1).items():
        monkeypatch.setenv(k, str(v))


def test_nccl_with_more_ranks_than_cards_raises(monkeypatch, tmp_path):
    """nccl needs a card per rank: a node with more ranks than cards, and
    the CPU, are refused before the world is joined, naming the gloo
    backend; nothing switches the backend behind the caller's back."""
    local = max(2, torch.cuda.device_count() + 1)
    _world_env(monkeypatch, local, local)
    for extra in ([], ["--dist-backend", "nccl"]):
        with pytest.raises(RuntimeError, match="--dist-backend gloo"):
            cli.main([str(tmp_path / "cap.bin"), "--out",
                      str(tmp_path / "out")] + extra)
    with pytest.raises(ValueError, match="--dist-backend gloo"):
        cli.main([str(tmp_path / "cap.bin"), "--device", "cpu",
                  "--dist-backend", "nccl", "--out", str(tmp_path / "out")])
    assert not torch.distributed.is_initialized()
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("device", ["cuda:0", "cuda:1", "cuda"])
def test_explicit_card_in_a_world_raises(monkeypatch, tmp_path, device):
    """Each rank takes its own card: --device naming one is refused in a
    world of more than one rank, before the world is joined."""
    _world_env(monkeypatch, 2, 2)
    with pytest.raises(ValueError, match="each rank takes its own card"):
        cli.main([str(tmp_path / "cap.bin"), "--device", device,
                  "--dist-backend", "gloo", "--out", str(tmp_path / "out")])
    assert not torch.distributed.is_initialized()
    assert not (tmp_path / "out").exists()


@pytest.mark.gpu
def test_cuda_two_ranks_share_the_card(single, tmp_path):
    """On the card: the command in a world of 2 ranks sharing it (gloo),
    cold, against the single-process command on the card: the .mat set
    within the tolerances above, B1, B3 and B2 launched by each rank.  Run
    on the card with
        python -m pytest --noconftest -p no:cacheprovider -m gpu \\
            tests/test_torch_cli_world.py
    """
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    one = str(tmp_path / "one")
    r = subprocess.run(
        [sys.executable, "-m", "gps_sdr_tpu_torch.cli"]
        + _argv(single["path"], one), capture_output=True, text=True,
        timeout=RUN_TIMEOUT_S, cwd=ROOT, env=_env())
    assert r.returncode == 0, f"{r.stdout}\n{r.stderr}"
    logs = str(tmp_path / "logs")
    os.makedirs(logs)
    w = _run_world(2, single["path"], str(tmp_path / "two"), None, logs,
                   ("--dist-backend", "gloo"))
    assert w.returncode == 0, f"{w.stdout}\n{w.stderr[-4000:]}"
    res = compare_mat_exports(str(tmp_path / "two" / "mat"),
                              os.path.join(one, "mat"))
    assert res["ok"], res
    got = re.findall(r"^kernel launches, rank \d+: track_chunk (\d+), "
                     r"correlator_bank_windows (\d+), correlator_bank "
                     r"(\d+)$", w.stdout, re.M)
    assert len(got) == 2
    assert all(int(c) > 0 for g in got for c in g), got
