"""BENCHMARK.json against the rules it keeps: keys, names, units,
lengths, bounds, the run length's budget, and every file a name leads
to."""

import json
import math
import os
import re
from types import SimpleNamespace

import pytest

from conftest import ROOT

from sdrbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def man():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        text = f.read()
    assert len(text.encode()) <= 64 * 1024
    return json.loads(text)


def line_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert man["command"] == ["python3", "sdrbench/run.py"]
    assert all(line_ok(w) for w in man["command"])
    assert 1 <= len(man["paths"]) <= 16
    for p in man["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
        assert not p.endswith("_torch")


def test_run_seconds_fits_24_cells(man):
    rs = man["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units(man):
    groups = ("configs", "workloads", "end_to_end", "per_layer")
    for g in groups:
        names = [e["name"] for e in man[g]]
        assert len(names) == len(set(names)), g
        for n in names:
            assert NAME.match(n), n
    metrics = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_entry_keys(man):
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line_ok(c["source"]) and line_ok(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert line_ok(w["why"]) and w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert line_ok(m["layer"])


def test_bounds(man):
    for m in man["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
    setup = [m for m in man["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and "workloads" not in setup[0]


def test_cells(man):
    configs = {c["name"] for c in man["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in man["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert configs == {w["config"] for w in man["workloads"]}
    four = sum(w["chips"] == 4 for w in man["workloads"])
    assert four <= max(1, len(man["workloads"]) // 4)
    cells = {w["name"] for w in man["workloads"]}
    for m in man["end_to_end"] + man["per_layer"]:
        assert set(m.get("workloads", [])) <= cells


def reports(man, cell):
    return {m["name"] for m in man["end_to_end"]
            if cell in m.get("workloads", [cell])}


def test_every_cell_reports_enough(man):
    for w in man["workloads"]:
        e2e = reports(man, w["name"])
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = [m for m in man["per_layer"]
                 if w["name"] in m.get("workloads", [w["name"]])]
        assert layer, w["name"]


def test_moves_is_reported_by_each_listed_cell(man):
    e2e = {m["name"] for m in man["end_to_end"]}
    for m in man["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", [w["name"] for w in
                                        man["workloads"]]):
            assert m["moves"] in reports(man, cell), (m["name"], cell)


def test_one_layer_name_per_layer(man):
    layers = {m["layer"] for m in man["per_layer"]}
    with open(os.path.join(ROOT, "PERF.md")) as f:
        perf = f.read()
    for layer in layers:
        assert f"`{layer}`" in perf, layer


def test_files_named_by_the_manifest(man):
    bench = os.path.join(ROOT, "sdrbench")
    for c in man["configs"]:
        path = os.path.join(ROOT, c["file"])
        assert c["file"].startswith("sdrbench/") and os.path.isfile(path)
        with open(path) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    assert len({c["file"] for c in man["configs"]}) == len(man["configs"])
    for w in man["workloads"]:
        with open(os.path.join(bench, "traffic", w["traffic"] + ".json")) \
                as f:
            mix = json.load(f)
        assert mix["limits"]
        # the mix's output kind is a file, and its tracker one that kind
        # knows
        conf = harness.by_name(man["configs"], w["config"])
        kind = harness.load_output(mix["output"])
        kind.tracker(SimpleNamespace(mix=mix, cfg=harness.load_json(
            os.path.join(ROOT, conf["file"]))))
    for m in man["end_to_end"] + man["per_layer"]:
        assert os.path.isfile(os.path.join(bench, "metrics",
                                           m["name"] + ".py")), m["name"]


def test_no_width_is_reduced(man):
    widths = re.compile(r"(_dim|_rank)$|hidden|intermediate|head|width")
    for c in man["configs"]:
        assert not any(widths.search(k) for k in c["reduced"])


def test_limits_are_finite(man):
    for w in man["workloads"]:
        with open(os.path.join(ROOT, "sdrbench", "traffic",
                               w["traffic"] + ".json")) as f:
            for n, lim in json.load(f)["limits"].items():
                assert NAME.match(n) and math.isfinite(lim) and lim >= 0
