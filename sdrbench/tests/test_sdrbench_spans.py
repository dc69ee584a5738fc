"""The span readers (`sdrbench/spans.py`, the `program_span` metrics):
idle time put down exactly to the innermost main-thread span on a
hand-made trace, self time, the unspanned share, nothing read where the
program recorded no span; then a tiny traced CPU run of each mix kind,
in which every span metric the manifest lists for the cell reads a
number."""

import time
from types import SimpleNamespace

import numpy as np
import pytest

from sdrbench import harness, spans
from sdrbench.trace import Trace

from gps_sdr_tpu_torch.utils.spans import Span

SEED = 2 ** 31 + 203
MAIN, OTHER = 1, 2


class Event:
    """A kineto event as `Trace` reads it."""

    def __init__(self, name, a, b, cuda=True):
        self._v = (name, a, b, "DeviceType.CUDA" if cuda else "CPU")

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def device_type(self):
        return self._v[3]


def hand_made():
    """Window [-10, 100] ns; the card busy in [5, 15], [35, 50] and
    [75, 78]; a stage with a chunk, a scan with a capture in it, and a
    save on the main thread; a read on another thread over the whole
    window."""
    trace = Trace([Event("k", 5, 15), Event("Memcpy HtoD", 35, 50),
                   Event("k", 75, 78), Event("aten::add", 0, 3, cuda=False)],
                  1e-7, -10, 100)
    found = [Span(3, "vt.capture", 25, 30, 2, MAIN, 8),
             Span(2, "vt.scan", 20, 40, 1, MAIN, 10),
             Span(1, "tracking.chunk", 10, 60, 0, MAIN, 10),
             Span(5, "io.read", -5, 100, None, OTHER, 100),
             Span(4, "stage.save", 70, 80, 0, MAIN, 0),
             Span(0, "stage.x", 0, 100, None, MAIN, 0)]
    return trace, spans.PassSpans(found, trace.t0_ns, trace.t1_ns)


def test_idle_goes_to_the_innermost_main_thread_span():
    trace, sp = hand_made()
    by_name = {("none" if s is None else s.name): ns
               for s, ns in sp.idle_by_span(trace.intervals()).items()}
    assert by_name == {"none": 10, "stage.x": 35, "tracking.chunk": 15,
                       "vt.scan": 10, "vt.capture": 5, "stage.save": 7}
    idle = (trace.t1_ns - trace.t0_ns) - trace.busy_s() * 1e9
    assert sum(by_name.values()) == pytest.approx(idle)


def test_unspanned_share_self_time_and_roots(capsys):
    trace, sp = hand_made()
    assert sp.unspanned_pct(trace.intervals()) == pytest.approx(
        100.0 * 45 / 82)
    line = capsys.readouterr().err.strip()
    assert line.startswith("sdrbench: idle by span: stage.x 3.5e-08")
    assert [s.id for s in sp.roots] == [0]
    assert sp.self_s("vt.scan") == pytest.approx(15e-9)
    assert sp.total("vt.scan") == (pytest.approx(20e-9), 10)
    assert sp.roots_outside("tracking.chunk") == pytest.approx(50e-9)
    assert sp.roots_outside("vt.scan") == pytest.approx(80e-9)
    assert sp.named("io.read") == []          # another thread's


def test_no_stage_span_reads_nothing():
    """A program that records no span (one older than its spans), a cell
    of the other kind, an untraced window: every reader gives None."""
    trace, _ = hand_made()
    man = harness.manifest()
    names = [m["name"] for m in man["per_layer"]
             if m["source"] == "program_span"]
    assert len(names) == 10
    for kind, t in (("track", trace), ("vt", trace), ("track", None)):
        ctx = SimpleNamespace(trace=t, mix={"output": kind}, covered_s=1.0,
                              steps=10, untraced_s=1.0)
        for name in names:
            assert harness.load_reader(name)(ctx) is None, name


TINY = {"config": {"receiver": {"signal": {"fs": 2.5e6, "f_if": 0.6e6},
                                "track": {"ms_eph_10ms": 2000}},
                   "sky": {"amp_scale": 0.09 * 4.8}, "capture_ms": 3500},
        "mix": {"check_blocks": 24, "limits": {"acq_code_chips": 1.5}}}
TINY_VT = {"config": {"receiver": {"signal": {"fs": 2.5e6, "f_if": 0.6e6}},
                      "sky": {"amp_scale": 0.09 * 4.8}},
           "mix": {"check_blocks": 24, "limits": {"acq_code_chips": 1.5},
                   "pass": ["vt_position", {"n_ms": 1200,
                                            "ct_n_ms": 3300}]}}


@pytest.mark.parametrize("cell, over", [("opensky.eph_ref", TINY),
                                        ("opensky.vt", TINY_VT)])
def test_a_traced_run_reads_every_span_metric(cell, over):
    run = harness.Run(cell, SEED, device="cpu", overrides=over)
    try:
        run.setup(time.perf_counter())
        run.window(0.0, True)
    finally:
        run.close()
    line = run.line(run.judge(), 0.0)
    listed = [m["name"] for m in harness.cell_metrics(run.man, cell, True)
              if m["source"] == "program_span"]
    assert len(listed) == (6 if cell.endswith("eph_ref") else 4)
    for name in listed:
        v = line["metrics"][name]["value"]
        assert np.isfinite(v) and v >= 0, name
    got = {n: line["metrics"][n]["value"] for n in listed}
    for name in ("device.idle_unspanned_pct.track",
                 "device.idle_unspanned_pct.vt"):
        if name in got:
            assert got[name] <= 100.0
    assert line["correct"], line["checks"]
