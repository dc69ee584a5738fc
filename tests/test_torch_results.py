"""The port's results record (`python -m gps_sdr_tpu_torch.results`, the
counterpart of `make_results.py`) on the CPU.

- The port's scenario (`gps_sdr_tpu_torch/io/scenario.py`) against
  `tests/scenario.py`: every constant, the configuration and the picked
  constellation equal (`build_scenario_source` is never called here, so the
  shared `.cache` is not touched).
- `scaling_results` in worlds of 1 and 2 ranks at a small size: a filled
  table; and a leg that fails raises instead of dropping the section.
- `golden_replay_results` without the reference's files: the section says
  why it is left out.
- `host_epoch_results` on a small Receiver: the legacy filter at 1 ms.
- `main` end to end at a small size, without and with plots: every section
  of RESULTS.md, the files of each, the numbers it returns; without
  matplotlib, plots asked for raise before any stage runs.
- The same numbers from the JAX package's `Receiver`, driven over the
  port-written capture as `make_results.py` drives it (with the same
  decoded ephemerides): the acquisition, the WLS and VT medians within
  tests/test_torch_slice.py's bounds for two receivers on one capture, and
  the legacy filter's epoch count exact.

The small record's capture is 2 s of the scenario at 5 MHz, started 0.7 s
after its TOW so that a subframe starts 0.3 s in.  A 2 s capture cannot be
decoded, so its decode stage is seeded from the synthesizer's own bits
(`tests/test_torch_distributed.py`'s `_decode_artifact`).
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

import scenario as jax_scenario
from gps_sdr_tpu_torch import results
from gps_sdr_tpu_torch.geo.coords import llh2xyz
from gps_sdr_tpu_torch.io import scenario as scn
from gps_sdr_tpu_torch.pipeline import Receiver
from test_torch_distributed import _decode_artifact

torch.set_num_threads(2)

SMALL = results.Sizes(capture_ms=2000, tow0=scn.TOW0 + 0.7, eph_ms=1000,
                      decode_offset_ms=0, ct_ms=620, vt_ms=250,
                      multicorr_ms=500, kf_ms=500, vt_from=100,
                      scaling_samples=1024, scaling_steps=20)
WLS_GATE_M = 120.0
SECTIONS = ("## Acquisition", "## Positioning accuracy vs surveyed truth",
            "## Plots", "## Real-data replay", "## Multi-device scaling",
            "## Host epoch loop")


@pytest.mark.parametrize("name", [
    "TOW0", "WEEK", "TRUTH_LLH", "BASE_EPH", "SCN_PRNS", "CLK_BIAS_S",
    "CLK_DRIFT_SPS", "NOISE_STD", "AMPLITUDES", "DURATION_MS"])
def test_scenario_constants_equal_the_jax_scenario(name):
    assert getattr(scn, name) == getattr(jax_scenario, name)


def test_scenario_config_equals_the_jax_scenario():
    assert dataclasses.asdict(scn.CFG) == dataclasses.asdict(
        jax_scenario.CFG)


@pytest.mark.parametrize("n_sv", [5, 8])
def test_visible_constellation_equals_the_jax_scenario(n_sv):
    assert scn.visible_constellation(n_sv) == \
        jax_scenario.visible_constellation(n_sv)


def _table(lines):
    """{D: cells} of the scaling section's table rows."""
    rows = [l for l in lines if re.match(r"\| \d+ \|", l)]
    return {int(r.split("|")[1]): [c.strip() for c in r.split("|")[2:-1]]
            for r in rows}


def test_scaling_results_fills_its_table():
    lines = results.scaling_results(device="cpu", ranks=(1, 2),
                                    samples=1024, steps=20, timeout_s=240)
    assert lines[0].startswith("## Multi-device scaling")
    table = _table(lines)
    assert sorted(table) == [1, 2]
    for d, cells in table.items():
        assert len(cells) == 8
        for c in (cells[0], cells[1], cells[4], cells[5]):
            med, lo, hi = map(float, re.findall(r"[\d.e+-]+", c))
            assert 0 < lo <= med <= hi, (d, c)
        for raw, clipped in ((cells[2], cells[3]), (cells[6], cells[7])):
            assert float(clipped) == pytest.approx(min(float(raw), 1.0),
                                                   abs=1e-3)
    assert any("same cores" in l for l in lines)


def test_scaling_results_raises_when_a_leg_fails():
    """The JAX probe returns {} on any error and its section disappears;
    the port's raises (here: a negative step count, which the tracker
    refuses inside every rank)."""
    with pytest.raises(RuntimeError, match="distributed launch failed"):
        results.scaling_results(device="cpu", ranks=(2,), samples=1024,
                                steps=-1, timeout_s=240)


def test_golden_replay_left_out_with_its_reason(tmp_path):
    lines = results.golden_replay_results(str(tmp_path / "out"), None)
    assert lines[0].startswith("## Real-data replay")
    assert "no reference directory was given" in lines[2]
    lines = results.golden_replay_results(str(tmp_path / "out"),
                                          str(tmp_path))
    assert "lacks" in lines[2]
    for f in results.REFERENCE_FILES:
        assert f in lines[2]
    assert not (tmp_path / "out").exists()


@pytest.fixture(scope="module")
def seed(tmp_path_factory):
    """The small capture's decode stage (and its acquisition), made once."""
    root = tmp_path_factory.mktemp("torch_results")
    gs = scn.geometry_signal(SMALL.tow0, device="cpu")
    src = scn.write_capture(str(root / "capture.bin"), gs, SMALL.capture_ms)
    art = str(root / "seed")
    rx = Receiver(scn.CFG, src, artifact_dir=art, device="cpu")
    rx._save_pickle(f"eph_{scn.CFG.file.name}.pkl",
                    _decode_artifact(gs, scn.CFG, rx.acquisition()))
    return dict(root=root, src=src, art=art,
                path=str(root / "capture.bin"))


def test_host_epoch_results_on_a_small_receiver(seed, tmp_path):
    import shutil

    art = str(tmp_path / "art")
    shutil.copytree(seed["art"], art)
    rx = Receiver(scn.CFG, seed["src"], artifact_dir=art, device="cpu")
    truth = llh2xyz(np.asarray(scn.TRUTH_LLH)).numpy()
    lines, per, epochs = results.host_epoch_results(rx, truth, n_ms=500)
    assert lines[0].startswith("## Host epoch loop")
    n_ep = int(re.search(r"(\d+) epochs in", lines[2]).group(1))
    assert 0 < n_ep <= 500 and per > 0 and epochs == n_ep
    med = float(re.search(r"median error ([\d.]+) m", lines[2]).group(1))
    assert med < WLS_GATE_M


@pytest.fixture(scope="module", params=[False, True],
                ids=["no_plots", "plots"])
def record(request, seed):
    plots = request.param
    out = str(seed["root"] / f"out_{'plots' if plots else 'no_plots'}")
    res = results.main(out, device="cpu", plots=plots, scaling_ranks=(1,),
                       sizes=SMALL, seed_artifacts=seed["art"])
    with open(os.path.join(out, "RESULTS.md")) as f:
        text = f.read()
    return dict(plots=plots, out=out, res=res, text=text)


def test_record_has_every_section(record):
    lines = record["text"].splitlines()
    assert lines[0].startswith("# Results")
    assert "- Device: CPU" in lines
    assert any(l.startswith("- Command: `python -m gps_sdr_tpu_torch.results")
               for l in lines)
    assert any(l.startswith("- Commit: ") for l in lines)
    at = [next(i for i, l in enumerate(lines) if l.startswith(s))
          for s in SECTIONS]
    assert at == sorted(at)
    assert sorted(_table(lines)) == [1]
    assert "TPU" not in record["text"]


def test_record_numbers(record):
    res = record["res"]
    assert res["acquired"] == list(scn.SCN_PRNS)
    assert res["usable"] == list(scn.SCN_PRNS)
    assert res["wls_median_m"] < WLS_GATE_M
    assert res["vt_median_m"] < WLS_GATE_M
    assert res["vt_ms"] == SMALL.vt_ms - SMALL.vt_from
    assert res["device"] == "CPU"
    # the plain versions run on the CPU: nothing is launched
    assert set(res["launches"].values()) == {0}
    text = record["text"]
    wls = re.search(r"\| WLS \(CT\) \| (\d+) \| ([\d.]+) m", text)
    assert int(wls.group(1)) == res["wls_epochs"]
    assert float(wls.group(2)) == pytest.approx(res["wls_median_m"],
                                                abs=0.05)


def test_record_files(record):
    files = set(os.listdir(record["out"]))
    assert "task3_ephemeris.csv" in files and "RESULTS.md" in files
    pictures = {f for f in files if f.endswith((".png", ".gif"))}
    if record["plots"]:
        assert pictures == {f for f, _ in results.PLOT_FILES}
        assert "No plots were written" not in record["text"]
    else:
        assert pictures == set()
        assert "No plots were written" in record["text"]


def test_plots_without_matplotlib_raise_before_any_stage(monkeypatch,
                                                         tmp_path):
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        results.main(str(tmp_path / "out"), device="cpu", plots=True)
    assert not (tmp_path / "out").exists()


@pytest.fixture(scope="module")
def jax_numbers(seed, tmp_path_factory):
    """The JAX Receiver over the port-written capture, as make_results.py
    drives it (its decode stage seeded with the port's ephemerides, made
    JAX records): acquisition, CT/WLS, VT handed off by that CT length,
    and the legacy filter at 1 ms from the same 137 m start."""
    import pickle

    from gps_sdr_tpu.io.ifdata import IFSampleSource as JSource
    from gps_sdr_tpu.navdecode import EphemerisRecord as JRecord
    from gps_sdr_tpu.pipeline import Receiver as JReceiver

    cfg = jax_scenario.CFG
    art = tmp_path_factory.mktemp("torch_results_jax")
    stem = f"eph_{cfg.file.name}.pkl"
    eph, sbf = Receiver(scn.CFG, seed["src"], artifact_dir=seed["art"],
                        device="cpu")._load_pickle(stem)
    jeph = {p: JRecord(**{k: getattr(r, k)
                          for k in JRecord.__dataclass_fields__})
            for p, r in eph.items()}
    with open(art / stem, "wb") as f:
        pickle.dump((jeph, sbf), f)
    rx = JReceiver(cfg, JSource(seed["path"], cfg.file),
                   artifact_dir=str(art), mesh=None)
    truth = llh2xyz(np.asarray(scn.TRUTH_LLH)).numpy()
    acq = rx.acquisition()
    _, nav = rx.ct_position(n_ms=SMALL.ct_ms)
    _, vt = rx.vt_position(n_ms=SMALL.vt_ms, ct_n_ms=SMALL.ct_ms)
    _, kf = rx.ct_position_kf(n_ms=SMALL.kf_ms, epoch_ms=1,
                              init_pos_ecef=truth
                              + np.array([100.0, 50.0, -80.0]))
    wls_err = np.linalg.norm(
        np.asarray(nav.usr_pos)[results.WLS_FROM:] - truth, axis=1)
    vt_err = np.linalg.norm(
        np.asarray(vt.usr_pos)[SMALL.vt_from:] - truth, axis=1)
    return dict(acquired=[int(p) for p in acq.sv],
                acquired_snr_db=np.asarray(acq.snr_db, np.float64),
                usable=[int(p) for p in rx.usable_svs()],
                wls_epochs=len(wls_err), wls_median_m=np.median(wls_err),
                vt_ms=len(vt_err), vt_median_m=np.median(vt_err),
                kf_epochs=len(kf.clk_bias_m))


def test_record_numbers_match_the_jax_receiver(record, jax_numbers):
    """results.py's numbers against make_results.py's computation on the
    same capture.  The two receivers track the same bytes up to float32
    summation order, so their loops may split onto equally valid noise
    paths (tests/test_torch_slice.py's docstring): the acquisition within
    1e-3 dB, the WLS medians within 1 m and the VT medians within 10 m
    (that file's bounds), the epoch counts exact."""
    res, j = record["res"], jax_numbers
    print(f"record vs JAX Receiver: WLS {res['wls_median_m']:.3f} / "
          f"{j['wls_median_m']:.3f} m, VT {res['vt_median_m']:.3f} / "
          f"{j['vt_median_m']:.3f} m, KF {res['kf_epochs']} / "
          f"{j['kf_epochs']} epochs")
    assert res["acquired"] == j["acquired"]
    np.testing.assert_allclose(res["acquired_snr_db"], j["acquired_snr_db"],
                               rtol=0, atol=1e-3)
    assert res["usable"] == j["usable"]
    assert res["wls_epochs"] == j["wls_epochs"]
    assert abs(res["wls_median_m"] - j["wls_median_m"]) < 1.0, (res, j)
    assert res["vt_ms"] == j["vt_ms"]
    assert abs(res["vt_median_m"] - j["vt_median_m"]) < 10.0, (res, j)
    assert res["kf_epochs"] == j["kf_epochs"]
