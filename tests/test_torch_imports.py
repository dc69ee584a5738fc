"""The port imports without JAX: every module of gps_sdr_tpu_torch is
imported in a fresh interpreter, which must end with no `jax` (nor the JAX
package) in sys.modules; nor scipy, matplotlib or PIL, which the `.mat`
and plotting functions import when they are called."""

import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import gps_sdr_tpu_torch
names = [m.name for m in pkgutil.walk_packages(gps_sdr_tpu_torch.__path__,
                                               "gps_sdr_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "gps_sdr_tpu."))
             or m == "gps_sdr_tpu"
             or m.split(".")[0] in ("scipy", "matplotlib", "PIL"))
print(len(names), ",".join(bad))
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1) if " " in out.stdout.strip() \
        else (out.stdout.strip(), "")
    assert int(n) >= 39, out.stdout
    assert bad == "", f"port pulled in {bad}"


@pytest.mark.parametrize("module", [
    "gps_sdr_tpu_torch.ops.corr_bank", "gps_sdr_tpu_torch.ops._build",
    "gps_sdr_tpu_torch.receiver.vt", "gps_sdr_tpu_torch.utils.device",
    "gps_sdr_tpu_torch.receiver.ct_legacy",
    "gps_sdr_tpu_torch.positioning.relpr", "gps_sdr_tpu_torch.io.matref",
    "gps_sdr_tpu_torch.analysis", "gps_sdr_tpu_torch.analysis.acf",
    "gps_sdr_tpu_torch.analysis.multipath",
    "gps_sdr_tpu_torch.analysis.plots", "gps_sdr_tpu_torch.cli",
    "gps_sdr_tpu_torch.parallel", "gps_sdr_tpu_torch.parallel.time_segments",
    "gps_sdr_tpu_torch.parallel.mesh", "gps_sdr_tpu_torch.parallel.acquisition",
    "gps_sdr_tpu_torch.parallel.tracking", "gps_sdr_tpu_torch.parallel.epoch",
    "gps_sdr_tpu_torch.parallel.vt",
    "gps_sdr_tpu_torch.parallel.distributed", "gps_sdr_tpu_torch.results",
    "gps_sdr_tpu_torch.io.scenario"])
def test_walk_reaches_module(module):
    """The walk above covers the modules of the later slices (vector
    tracking; the legacy filter, `.mat` in and out, analysis; the command
    line and time-segmented tracking; the mesh of ranks and its sharded
    stages; the results record and its scenario)."""
    import pkgutil

    import gps_sdr_tpu_torch
    names = {m.name for m in pkgutil.walk_packages(
        gps_sdr_tpu_torch.__path__, "gps_sdr_tpu_torch.")}
    assert module in names


def test_default_device_is_the_card_or_an_error():
    """`device=None` means the CUDA card: on a machine without one,
    `resolve_device(None)` and the entry points built on it raise and say
    how to ask for the CPU; they never return the CPU silently."""
    import torch

    from gps_sdr_tpu_torch.tracking import chip_tables
    from gps_sdr_tpu_torch.utils.device import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")).type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device(None)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        chip_tables([1, 2])


@pytest.mark.parametrize("path", ["gps_sdr_tpu_torch", "chip_smoke.py"])
def test_no_jax_import_in_source(path):
    """No source line of the port or of chip_smoke.py imports JAX or the
    JAX package."""
    full = os.path.join(ROOT, path)
    files = ([full] if full.endswith(".py") else
             [os.path.join(d, f) for d, _, fs in os.walk(full) for f in fs
              if f.endswith(".py")])
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|gps_sdr_tpu)(\.|\s|$)")
    for fname in files:
        with open(fname) as fh:
            for ln, line in enumerate(fh, 1):
                assert not pat.match(line), f"{fname}:{ln}: {line.strip()}"
