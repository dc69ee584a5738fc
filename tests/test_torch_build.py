"""`ops/_build.build_library` when several processes start cold together,
as the ranks of a world do: each source is compiled once, the others wait
for its lock and load what was built.  No nvcc is needed: a stub compiler
under a `CUDA_HOME` of the test's own counts its runs, sleeps, and writes
the output file it is given."""

import os
import stat
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_STUB = """#!{python}
import sys, time
args = sys.argv[1:]
with open({count!r}, "a") as f:
    f.write(args[-1] + "\\n")
time.sleep(1.5)
with open(args[args.index("-o") + 1], "wb") as f:
    f.write(b"stub library")
"""

_BUILD = """
import sys
from pathlib import Path
from gps_sdr_tpu_torch.ops import _build
names = sys.argv[2].split(",")
for name, (path, _, _) in _build.build_all(names, Path(sys.argv[1])).items():
    print(name, path)
"""


def _stub_home(tmp_path):
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    count = tmp_path / "compiles.txt"
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(_STUB.format(python=sys.executable, count=str(count)))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    return home, count


@pytest.mark.parametrize("n_procs,names", [
    (2, ["track_chunk"]), (3, ["track_chunk", "corr_bank"])])
def test_concurrent_cold_builds_compile_each_source_once(tmp_path, n_procs,
                                                         names):
    home, count = _stub_home(tmp_path)
    build = tmp_path / "build"
    env = dict(os.environ, CUDA_HOME=str(home), PYTHONPATH=ROOT,
               OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILD, str(build), ",".join(names)], env=env,
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(n_procs)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        outs.append(sorted(out.split("\n")))
    # every process got the same library of each source
    assert all(o == outs[0] for o in outs)
    libs = [line.split()[1] for line in outs[0] if line]
    assert len(libs) == len(names) and all(os.path.exists(p) for p in libs)
    # and each source was compiled once
    compiled = count.read_text().split()
    assert sorted(os.path.basename(c) for c in compiled) == sorted(
        f"{n}.cu" for n in names)


def test_warm_build_runs_no_compiler(tmp_path):
    """A library of the same sources already in the build directory is
    loaded as it is: the compiler does not run again."""
    home, count = _stub_home(tmp_path)
    env = dict(os.environ, CUDA_HOME=str(home), PYTHONPATH=ROOT,
               OMP_NUM_THREADS="2")
    for _ in range(2):
        r = subprocess.run([sys.executable, "-c", _BUILD,
                            str(tmp_path / "build"), "track_chunk"],
                           env=env, cwd=ROOT, capture_output=True, text=True,
                           timeout=120)
        assert r.returncode == 0, r.stderr
    assert len(count.read_text().split()) == 1
