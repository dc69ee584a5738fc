"""What the benchmark may load: nothing of JAX or of the JAX package
anywhere under sdrbench/ (top-level names compared whole, since the
port's name begins with the JAX package's), and in the reference and the
frozen copies nothing of the program either; no file of the benchmark
reads the repository's own measuring scripts."""

import ast
import os
import subprocess
import sys

from conftest import ROOT

BENCH = os.path.join(ROOT, "sdrbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "gps_sdr_tpu"}
PLAIN = ("reference.py", "roofline.py", "sky.py", "frozen", "outputs")


def sources():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_and_no_jax_package():
    for path in sources():
        found = set(top_level_imports(path)) & FORBIDDEN
        assert not found, (path, found)


def test_reference_imports_nothing_of_the_program():
    for path in sources():
        rel = os.path.relpath(path, BENCH)
        if rel.startswith(PLAIN):
            assert "gps_sdr_tpu_torch" not in set(top_level_imports(path)), \
                rel


def test_no_measuring_script_of_the_repository_is_read():
    for path in sources():
        with open(path) as f:
            text = f.read()
        for name in ("bench.py", "chip_smoke", "kernel_ablation"):
            assert f"import {name.split('.')[0]}" not in text, (path, name)
            assert f"open(\"{name}" not in text


def test_a_run_loads_no_forbidden_module():
    """The harness, a reader of every metric and every output kind,
    imported in a process of their own: no JAX, no JAX package in
    sys.modules."""
    code = ("import sys, os; sys.path.insert(0, %r)\n"
            "from sdrbench import harness, judge, launches, trace\n"
            "import gps_sdr_tpu_torch.pipeline\n"
            "m = harness.manifest()\n"
            "[harness.load_reader(x['name']) for x in m['end_to_end'] + "
            "m['per_layer']]\n"
            "[harness.load_output(f[:-3]) for f in os.listdir("
            "os.path.join(harness.HERE, 'outputs')) if f.endswith('.py')]\n"
            "print(harness.forbidden_modules())" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "sdrbench/run.py", "--workload", "opensky.eph_ref",
         "--seed", "2147483999", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "no CUDA device" in out.stderr


def test_a_module_loaded_after_the_window_refuses_the_result():
    """A module of JAX that a reader or the judge loads once the window
    has closed: run.py prints no result and names it."""
    code = ("import sys, types, importlib.util; sys.path.insert(0, %r)\n"
            "from sdrbench import harness\n"
            "def run_cell(*a, **kw):\n"
            "    sys.modules['jaxlib'] = types.ModuleType('jaxlib')\n"
            "    return dict(line={'correct': True}, checks=[])\n"
            "harness.run_cell = run_cell\n"
            "spec = importlib.util.spec_from_file_location(\n"
            "    'run', %r)\n"
            "run = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(run)\n"
            "sys.exit(run.main(['--workload', 'opensky.vt', '--seed', '1',\n"
            "                   '--seconds', '1']))"
            % (ROOT, os.path.join(BENCH, "run.py")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode not in (0, None)
    assert "{" not in out.stdout
    assert "jaxlib" in out.stderr
