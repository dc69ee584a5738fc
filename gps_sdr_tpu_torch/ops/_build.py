"""Build of the package's CUDA sources with nvcc, at first use.

Each `csrc/<name>.cu` becomes `build/<name>-<hash>.so`, a shared library
with a plain C entry point that its wrapper loads with ctypes.  The hash
covers the source and every header under `csrc/`, so an edit rebuilds.
Nothing here runs at import: a machine without nvcc imports the package
and fails only when a kernel is asked for.  Processes that start together
(the ranks of a world) compile each source once: the first takes the
source's lock file in the build directory and compiles, the others wait on
it and load what it built.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"     # the toolkit's default prefix
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (set CUDA_HOME)")


def build_library(name: str, build_dir: Path = BUILD_DIR
                  ) -> Tuple[Path, str, float]:
    """Compile `csrc/<name>.cu` for sm_90a into `build_dir` (skipped when a
    library of the same sources is already there, or another process built
    it while this one waited for the source's lock).  Returns (library
    path, compiler log, seconds spent compiling)."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    build_dir = Path(build_dir)
    out = build_dir / f"{name}-{digest.hexdigest()[:12]}.so"
    if out.exists():
        return out, "", 0.0
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)      # released when `lock` closes
        if out.exists():
            return out, "", 0.0
        return _compile(name, src, out, build_dir)


def _compile(name: str, src: Path, out: Path, build_dir: Path
             ) -> Tuple[Path, str, float]:
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    # -fmad=false: no a*b+c contraction, so a kernel rounds every operation
    # where its plain version does (see csrc/nco_common.cuh)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-fmad=false", "-shared", "-Xcompiler",
           "-fPIC", "-Xptxas", "-v", "-o", tmp, str(src)]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n" + res.stdout
                               + res.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, res.stdout + res.stderr, time.perf_counter() - t0


def build_all(names: Sequence[str], build_dir: Path = BUILD_DIR
              ) -> Dict[str, Tuple[Path, str, float]]:
    """`build_library` for every name, the compilers started together."""
    with ThreadPoolExecutor(len(names)) as pool:
        futures = {n: pool.submit(build_library, n, build_dir) for n in names}
        return {n: f.result() for n, f in futures.items()}
