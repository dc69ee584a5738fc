"""A configuration, a traffic mix, a metric and an output kind added as
files, with their entries in the manifest, are found by the harness
without an edit to any file that is already there; the cell then runs
(on the CPU, at a tiny size) and reports its metrics."""

import json
import os
import shutil
import time

import pytest
from conftest import ROOT

from sdrbench import harness

TINY = {"config": {"receiver": {"signal": {"fs": 2.5e6, "f_if": 0.6e6},
                                "track": {"ms_eph_10ms": 1000}},
                   "sky": {"amp_scale": 0.09 * 4.8}, "capture_ms": 3500},
        "mix": {"check_blocks": 4}}


def snapshot(root):
    """The bytes of every file under the copy's sdrbench/, by path."""
    return {os.path.relpath(os.path.join(d, f), root): open(
        os.path.join(d, f), "rb").read()
        for d, _, fs in os.walk(os.path.join(root, "sdrbench")) for f in fs
        if "__pycache__" not in d}


def test_a_dummy_cell_is_found_by_name(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "sdrbench"),
                    os.path.join(root, "sdrbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = snapshot(root)
    man = harness.manifest(ROOT)
    # the new files
    with open(os.path.join(ROOT, "sdrbench", "configs", "opensky.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "dummy"
    with open(os.path.join(root, "sdrbench", "configs", "dummy.json"),
              "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(ROOT, "sdrbench", "traffic", "eph_ref.json")) as f:
        mix = json.load(f)
    with open(os.path.join(root, "sdrbench", "traffic", "dummy_mix.json"),
              "w") as f:
        json.dump(mix, f)
    with open(os.path.join(root, "sdrbench", "metrics", "dummy.passes.py"),
              "w") as f:
        f.write("def read(ctx):\n    return len(ctx.passes)\n")
    # the new entries
    man["configs"].append(dict(man["configs"][0], name="dummy",
                               file="sdrbench/configs/dummy.json"))
    man["workloads"].append({"name": "dummy.dummy_mix", "config": "dummy",
                             "traffic": "dummy_mix", "chips": 1,
                             "why": "a test's cell"})
    for m in man["end_to_end"]:
        if m["name"] == "track_x_realtime":
            m["workloads"].append("dummy.dummy_mix")
    man["per_layer"].append({"name": "dummy.passes", "unit": "passes",
                             "better": "higher", "source": "host_clock",
                             "layer": "harness", "moves": "track_x_realtime",
                             "workloads": ["dummy.dummy_mix"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)

    res = harness.run_cell("dummy.dummy_mix", 2 ** 31 + 77, 0.0, True,
                           time.perf_counter(), device="cpu", overrides=TINY,
                           root=root)
    assert res["line"]["metrics"]["dummy.passes"]["value"] == 1.0
    res = harness.run_cell("dummy.dummy_mix", 2 ** 31 + 77, 0.0, False,
                           time.perf_counter(), device="cpu", overrides=TINY,
                           root=root)
    assert set(res["line"]["metrics"]) == {"track_x_realtime", "setup_s"}
    after = snapshot(root)
    assert all(after[k] == v for k, v in before.items())


DUMMY_KIND = '''"""A test's output kind: a tracking pass's block lengths,
its rows counted as steps, judged by nothing."""

import numpy as np

from sdrbench import reference as ref


def keep(out):
    return {"num_sample": np.asarray(out.num_sample)}


def covered_samples(rec, acq_ptr):
    return 0


def steps(rec):
    return int(rec["num_sample"].shape[0])


def judge(case, recs, rng, n_sample, dtype=np.float64):
    return [ref.Gaps() for _ in recs]


def launches(ctx, rec):
    return {}
'''


def test_an_output_kind_is_found_by_name(tmp_path):
    """A kind added as `outputs/<kind>.py`, with a mix and a cell that
    name it, runs with no other file of the benchmark changed."""
    root = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "sdrbench"),
                    os.path.join(root, "sdrbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = snapshot(root)
    with open(os.path.join(root, "sdrbench", "outputs", "dummy_kind.py"),
              "w") as f:
        f.write(DUMMY_KIND)
    with open(os.path.join(ROOT, "sdrbench", "traffic", "eph_ref.json")) as f:
        mix = json.load(f)
    mix.update(output="dummy_kind", limits={},
               **{"pass": ["track_for_eph", {"n_ms": 1200}]})
    with open(os.path.join(root, "sdrbench", "traffic", "dummy_kind.json"),
              "w") as f:
        json.dump(mix, f)
    man = harness.manifest(ROOT)
    man["workloads"].append({"name": "opensky.dummy_kind",
                             "config": "opensky", "traffic": "dummy_kind",
                             "chips": 1, "why": "a test's cell"})
    for m in man["end_to_end"]:
        if m["name"] == "vt_step_ms":
            m["workloads"].append("opensky.dummy_kind")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)

    res = harness.run_cell("opensky.dummy_kind", 2 ** 31 + 78, 0.0, False,
                           time.perf_counter(), device="cpu", overrides=TINY,
                           root=root)
    line = res["line"]
    assert line["correct"]
    assert set(line["metrics"]) == {"vt_step_ms", "setup_s"}
    assert line["metrics"]["vt_step_ms"]["value"] > 0
    after = snapshot(root)
    assert all(after[k] == v for k, v in before.items())


def test_an_unknown_output_kind_names_its_file():
    with pytest.raises(ValueError, match=r"outputs[/\\]no_such_kind\.py"):
        harness.Run("opensky.eph_ref", 1, device="cpu",
                    overrides={"mix": {"output": "no_such_kind"}})
