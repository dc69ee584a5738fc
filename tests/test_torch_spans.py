"""The port's spans (`gps_sdr_tpu_torch/utils/spans.py`), on the CPU.

Spans record only while a torch profiler session is active, in the
program's own memory and on the host's realtime clock; they add no event
to the profiler's trace.  A tiny `run_tracking` at pdi 1 and at pdi 10
(two SVs at 2.5 MHz, three chunks each) and a tiny `run_vector_tracking`
(the port-only scene of tests/test_torch_vt.py, eager on the CPU) are
traced, and the tree of spans they leave is held to the table of sites:
names, parents, threads and the work each span covers.
"""

import threading
import time
from functools import partial

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gps_sdr_tpu_torch import tracking as ttrack
from gps_sdr_tpu_torch.config import (FileConfig, ReceiverConfig,
                                      SignalConfig)
from gps_sdr_tpu_torch.io.ifdata import (ChunkFeed, ChunkPrefetcher,
                                         DeviceStager, IFSampleSource,
                                         upload_capture)
from gps_sdr_tpu_torch.io.synthetic import (SyntheticSV, generate_if_samples,
                                            quantize_iq)
from gps_sdr_tpu_torch.ops.track_chunk import ChunkWindow
from gps_sdr_tpu_torch.parallel.mesh import Mesh
from gps_sdr_tpu_torch.utils import spans

torch.set_num_threads(2)

FS, F_IF = 2.5e6, 0.6e6
SVS = [SyntheticSV(prn=7, amplitude=3.0, doppler_hz=1234.5,
                   code_delay_samples=800.0),
       SyntheticSV(prn=21, amplitude=2.5, doppler_hz=-2500.25,
                   code_delay_samples=1345.0)]
CHUNK_MS = 40


@pytest.fixture(scope="module")
def scene():
    cfg = ReceiverConfig(file=FileConfig(name="spans", skip_ms=0),
                         signal=SignalConfig(f_if=F_IF, fs=FS))
    sig = cfg.signal
    S = sig.samples_per_ms
    values = quantize_iq(generate_if_samples(cfg, SVS, 520, noise_std=4.0,
                                             seed=3, device="cpu"))
    delays, fine = [], []
    for sv in SVS:
        f_code = sig.code_freq_basis * (1 + sv.doppler_hz / sig.fc)
        epoch = sv.code_delay_samples % (1023 / f_code * FS)
        delays.append(int(round((S - epoch) % S)))
        fine.append(F_IF + sv.doppler_hz + 3.0)
    src = IFSampleSource.from_array(values, cfg.file)
    state = ttrack.init_track_state(cfg, delays, fine, "cpu")
    return dict(cfg=cfg, src=src, state=state, prns=[sv.prn for sv in SVS])


def traced(fn):
    """`fn()` under a CPU profiler session; its result, the spans that
    started meanwhile, the profiler and the realtime clock read before
    and after."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.time_ns()
        out = fn()
        t1 = time.time_ns()
    return out, spans.recorded(t0, t1), prof, t0, t1


def track(scene, pdi_ms, n_ms):
    params = ttrack.TrackParams.epl(scene["cfg"], pdi_ms=pdi_ms)
    return ttrack.run_tracking(scene["src"], scene["cfg"], scene["prns"],
                               scene["state"], params, n_ms,
                               chunk_ms=CHUNK_MS)


def by_id(found):
    return {s.id: s for s in found}


def test_no_profiler_no_spans(scene):
    """Without a profiler session `span` is the shared no-op, whatever
    its arguments, takes an `n` it forgets, and nothing is recorded."""
    assert spans.span("a") is spans.span("b", 7) is spans.OFF
    t0 = time.time_ns()
    with spans.span("tracking.chunk", 3) as sp:
        sp.n = 5
    assert sp.n == 0
    track(scene, 1, 2 * CHUNK_MS)
    assert spans.recorded(t0, time.time_ns()) == []


@pytest.mark.parametrize("pdi_ms, n_ms", [(1, 3 * CHUNK_MS),
                                          (10, 3 * CHUNK_MS)])
def test_run_tracking_records_the_tree(scene, pdi_ms, n_ms):
    """The chunk loop's tree: each `tracking.chunk` covers its blocks and
    holds one `io.fetch`, `io.stage`, tracker span and `tracking.records`
    of the same blocks; the prefetch thread's `io.read`s have no parent;
    the first chunk's fetch misses and reads inside `io.fetch`; every
    span lies inside the clock reads taken around the run."""
    (rec, _), found, _, t0, t1 = traced(lambda: track(scene, pdi_ms, n_ms))
    blocks = n_ms // pdi_ms
    assert rec.num_sample.shape[0] == blocks
    assert_chunk_tree(found, blocks, pdi_ms, t0, t1)


def assert_chunk_tree(found, blocks, pdi_ms, t0, t1):
    """The tree of `test_run_tracking_records_the_tree`, with no span of
    the card's graph route (`tracking.capture`, `tracking.replay`)."""
    ids, main = by_id(found), threading.get_ident()
    assert not [s for s in found
                if s.name in ("tracking.capture", "tracking.replay")]
    for s in found:
        assert t0 <= s.start_ns <= s.end_ns <= t1
    chunks = [s for s in found if s.name == "tracking.chunk"]
    assert [c.n for c in chunks] == [blocks // 3] * 3
    assert all(c.parent is None and c.thread == main for c in chunks)
    tracker = "tracking.scan" if pdi_ms > 2 else "tracking.track_chunk"
    for c in chunks:
        kids = sorted((s for s in found if s.parent == c.id),
                      key=lambda s: s.start_ns)
        assert [k.name for k in kids] == ["io.fetch", "io.stage", tracker,
                                          "tracking.records"]
        assert kids[2].n == kids[3].n == c.n
        assert all(c.start_ns <= k.start_ns and k.end_ns <= c.end_ns
                   for k in kids)
    reads = [s for s in found if s.name == "io.read"]
    inside = [r for r in reads if r.parent is not None]
    assert len(inside) == 1 and ids[inside[0].parent].name == "io.fetch"
    assert inside[0].thread == main
    ahead = [r for r in reads if r.parent is None]
    assert len(ahead) == 2 and all(r.thread != main for r in ahead)
    fetches = [s for s in found if s.name == "io.fetch"]
    assert all(r.n >= f.n for r, f in zip(ahead, fetches[1:]))
    stages = [s for s in found if s.name == "io.stage"]
    assert all(st.n == 2 * f.n for st, f in zip(stages, fetches))  # int8 IQ


class TwoRanks(Mesh):
    """A mesh of two ranks in one process, this one rank 0: every gather
    hands back this rank's part twice (the sharded route's spans, not its
    results)."""

    def _gather(self, t):
        x = t.contiguous()
        return [x, x]


def test_mesh_route_records_no_graph_span(scene):
    """`run_tracking` over a mesh at pdi 10, the route the card keeps
    eager (its collectives cannot be captured): the chunk tree of the
    unsharded route, and no `tracking.capture` or `tracking.replay`."""
    mesh = TwoRanks(group=None, rank=0, size=2, device=torch.device("cpu"),
                    backend="gloo")
    params = ttrack.TrackParams.epl(scene["cfg"], pdi_ms=10)
    (rec, _), found, _, t0, t1 = traced(lambda: ttrack.run_tracking(
        scene["src"], scene["cfg"], scene["prns"], scene["state"], params,
        3 * CHUNK_MS, chunk_ms=CHUNK_MS, mesh=mesh))
    assert rec.num_sample.shape == (3 * CHUNK_MS // 10, 2)
    assert_chunk_tree(found, 3 * CHUNK_MS // 10, 10, t0, t1)


@pytest.mark.gpu
def test_graph_route_spans_on_the_card(scene):
    """On the card, pdi 10 over three chunks: the same chunk tree, and
    inside each `tracking.scan` one `tracking.replay` of its blocks, the
    first chunk's preceded by the one `tracking.capture`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    state = ttrack.TrackState(*(t.cuda() for t in scene["state"]))
    params = ttrack.TrackParams.epl(scene["cfg"], pdi_ms=10)
    (rec, _), found, _, t0, t1 = traced(lambda: ttrack.run_tracking(
        scene["src"], scene["cfg"], scene["prns"], state, params,
        3 * CHUNK_MS, chunk_ms=CHUNK_MS))
    assert rec.num_sample.shape == (3 * CHUNK_MS // 10, 2)
    graph = [s for s in found
             if s.name in ("tracking.capture", "tracking.replay")]
    assert_chunk_tree([s for s in found if s not in graph],
                      3 * CHUNK_MS // 10, 10, t0, t1)
    scans = [s for s in found if s.name == "tracking.scan"]
    kids = [[(k.name, k.n) for k in sorted(graph, key=lambda k: k.start_ns)
             if k.parent == sc.id] for sc in scans]
    per = CHUNK_MS // 10
    assert kids == [[("tracking.capture", per), ("tracking.replay", per)],
                    [("tracking.replay", per)], [("tracking.replay", per)]]


@pytest.fixture
def submissions(monkeypatch):
    """Every read `ChunkPrefetcher` submits, as (ns, thread, start, n),
    stamped as it is submitted."""
    stamps = []
    submit = ChunkPrefetcher._submit

    def stamped(self, start, n):
        stamps.append((time.time_ns(), threading.get_ident(), start, n))
        submit(self, start, n)

    monkeypatch.setattr(ChunkPrefetcher, "_submit", stamped)
    return stamps


def served_ahead(found, stamps, chunk_name, tracker):
    """The order of one chunked call: chunk k's fetch submits chunk k+1's
    read, from the main thread, before chunk k's tracker span starts, and
    the last chunk's submits none; only the first fetch reads inline."""
    main = threading.get_ident()
    chunks = [s for s in found if s.name == chunk_name]
    fetches = sorted((s for s in found if s.name == "io.fetch"),
                     key=lambda s: s.start_ns)
    trackers = sorted((s for s in found if s.name == tracker),
                      key=lambda s: s.start_ns)
    assert len(chunks) == len(fetches) == len(trackers) == 3
    assert len(stamps) == 2 and all(th == main for _, th, _, _ in stamps)
    for (t, _, _, n), f, tr, f_next in zip(stamps, fetches, trackers,
                                           fetches[1:]):
        assert f.start_ns <= t <= f.end_ns <= tr.start_ns
        assert n >= f_next.n
    assert fetches[-1].end_ns <= trackers[-1].start_ns
    inside = [r for r in found if r.name == "io.read"
              and r.parent is not None]
    assert len(inside) == 1 and inside[0].parent == fetches[0].id
    ahead = [r for r in found if r.name == "io.read" and r.parent is None]
    assert len(ahead) == 2 and all(r.thread != main for r in ahead)
    assert all(r.start_ns >= t for r, (t, _, _, _) in zip(
        sorted(ahead, key=lambda s: s.start_ns), stamps))


@pytest.mark.parametrize("pdi_ms", [1, 10])
def test_run_tracking_reads_ahead_of_the_tracker(scene, submissions, pdi_ms):
    """Over three chunks the next chunk's read is submitted inside the
    current chunk's `io.fetch`, before its tracker span starts, and each
    later fetch is served from it; the records and the end state equal a
    one-chunk run's bit for bit."""
    n_ms = 3 * CHUNK_MS
    (rec, st), found, _, _, _ = traced(lambda: track(scene, pdi_ms, n_ms))
    tracker = "tracking.scan" if pdi_ms > 2 else "tracking.track_chunk"
    served_ahead(found, submissions, "tracking.chunk", tracker)
    del submissions[:]
    params = ttrack.TrackParams.epl(scene["cfg"], pdi_ms=pdi_ms)
    one, st1 = ttrack.run_tracking(scene["src"], scene["cfg"],
                                   scene["prns"], scene["state"], params,
                                   n_ms, chunk_ms=n_ms)
    assert submissions == []
    for f in ttrack._REC_FIELDS:
        np.testing.assert_array_equal(getattr(rec, f), getattr(one, f),
                                      err_msg=f)
    for a, b in zip(st, st1):
        assert torch.equal(a, b)


@pytest.mark.parametrize("route", [
    "array", pytest.param("pinned", marks=pytest.mark.gpu)])
def test_chunk_prefetcher_reads_the_next_window_ahead(scene, route):
    """`fetch` with a next window returns what a fetch without one
    returns and leaves that window's read running on the prefetch thread;
    the next fetch inside it is served from it; a fetch outside it reads
    inline; `close` waits for a read still pending.  A read into an array
    of its own (the CPU's feed) leaves a view holding its samples after
    later fetches, and so does the view of the read before it.  A read
    into the two-buffer `PinnedRing` of a `DeviceStager` (the card's
    feed, `DeviceStager.read`) holds a view until the next fetch, whose
    read fills its buffer again for the fetch after next, and only once
    the copy queued from it (held back here behind a sleep on the
    stream) has read it whole."""
    src = scene["src"]
    read_into = src.read_iq_values
    if route == "pinned":
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        stager = DeviceStager("cuda")
        read_into = partial(stager.read, src)
    gate, started = threading.Event(), threading.Semaphore(0)
    calls, main = [], threading.get_ident()

    def read(start, n):
        calls.append((start, n, threading.get_ident() == main))
        if threading.get_ident() != main:
            started.release()
            assert gate.wait(timeout=30)
        return read_into(start, n)

    pf = ChunkPrefetcher(read)
    plain = pf.fetch(100, 50)
    if route == "pinned":        # its buffer is filled again below
        plain = np.array(plain)
    a = pf.fetch(100, 50, then=(140, 60))
    assert started.acquire(timeout=30)      # running, held at the gate
    np.testing.assert_array_equal(a, plain)
    np.testing.assert_array_equal(a, src.read_iq_values(100, 50))
    assert calls == [(100, 50, True), (100, 50, True), (140, 60, False)]
    if route == "pinned":
        torch.cuda._sleep(200_000_000)
        sent = stager.stage(a)
    gate.set()
    b = pf.fetch(150, 40, then=(185, 30))
    np.testing.assert_array_equal(b, src.read_iq_values(150, 40))
    assert started.acquire(timeout=30)
    if route == "array":
        np.testing.assert_array_equal(a, plain)
    assert calls[3:] == [(185, 30, False)]
    c = pf.fetch(300, 10)
    np.testing.assert_array_equal(c, src.read_iq_values(300, 10))
    assert calls[4:] == [(300, 10, True)]
    if route == "array":
        np.testing.assert_array_equal(a, plain)
    else:
        assert torch.equal(sent.cpu(), torch.from_numpy(plain))
        np.testing.assert_array_equal(a[:30], src.read_iq_values(185, 30))

    gate.clear()
    pf.fetch(0, 10, then=(20, 10))
    assert started.acquire(timeout=30)
    closer = threading.Thread(target=pf.close)
    closer.start()
    closer.join(timeout=0.2)
    assert closer.is_alive()
    gate.set()
    closer.join(timeout=30)
    assert not closer.is_alive() and calls[-1] == (20, 10, False)


class _Reads:
    """A capture that records every read of it as (start, n), into an
    array of its own (`read_iq_values`) or into the caller's
    (`read_iq_into`, as the card's feed reads into its pinned ring)."""

    def __init__(self, src):
        self.src, self.cfg, self.n_samples = src, src.cfg, src.n_samples
        self.reads = []

    def read_iq_values(self, start, n):
        self.reads.append((start, n))
        return self.src.read_iq_values(start, n)

    def read_iq_into(self, start, out):
        self.reads.append((start, out.shape[0]))
        self.src.read_iq_into(start, out)


# the block window at 2.5 MHz (2500 samples a ms): pdi·S + 256 up to 128
_BLK = {1: 2816, 10: 25344}


@pytest.mark.parametrize("case", ["ct", "vt", "last", "resident"])
def test_chunk_feed_windows_and_reads_ahead(scene, submissions, case):
    """`ChunkFeed.next` for two chunks: the window from the first pointer
    to the last plus the need of `nb` blocks (one block window and 64
    samples past them), read inline; the next chunk's read submitted from
    2 ms before where the first pointer will be, over the spread, the
    next need and 2 ms each side, and the second chunk served from it with
    no other read; a last chunk reads nothing ahead; a resident capture is
    every chunk from sample 0, with no read at all.  At 10 ms blocks (the
    eph stage's `ChunkSpec`) and at the VT scan's 1 ms."""
    cfg, S = scene["cfg"], scene["cfg"].signal.samples_per_ms
    if case == "vt":
        from gps_sdr_tpu_torch.receiver.vt import VTParams
        window = ChunkWindow(S, VTParams().pdi_ms)
    else:
        window = ttrack.TrackParams.epl(cfg, pdi_ms=10).chunk_spec(cfg).window
    pdi = window.pdi_ms
    assert window.blk == _BLK[pdi]
    src = _Reads(scene["src"])
    resident = (upload_capture(scene["src"], "cpu") if case == "resident"
                else None)
    nb = CHUNK_MS // pdi
    nb_next = 0 if case == "last" else nb
    ptr = scene["state"].ptr + torch.tensor([0, 37])
    lo, hi = int(ptr.min()), int(ptr.max())
    feed = ChunkFeed(src, "cpu", window, resident)
    assert feed.slack == 4 * S
    try:
        raw, start = feed.next(ptr, nb, nb_next)
        if case == "resident":
            again = feed.next(ptr + nb * pdi * S, nb, 0)
            assert raw is resident and start == 0
            assert again[0] is resident and again[1] == 0
            assert src.reads == [] and submissions == []
            return
        need = hi - lo + nb * pdi * S + _BLK[pdi] + 64
        assert start == lo and raw.shape == (need, 2)
        assert torch.equal(raw, torch.from_numpy(
            scene["src"].read_iq_values(lo, need)))
        ahead = [(lo + nb * pdi * S - 2 * S, need + 4 * S)]
        if case == "last":
            assert submissions == [] and src.reads == [(lo, need)]
            return
        assert [(a, n) for _, _, a, n in submissions] == ahead
        moved = ptr + nb * pdi * S + torch.tensor([-9, 14])
        raw2, start2 = feed.next(moved, nb, 0)
    finally:
        feed.close()
    lo2, hi2 = int(moved.min()), int(moved.max())
    need2 = hi2 - lo2 + nb * pdi * S + _BLK[pdi] + 64
    assert start2 == lo2 and torch.equal(raw2, torch.from_numpy(
        scene["src"].read_iq_values(lo2, need2)))
    assert src.reads == [(lo, need)] + ahead and len(submissions) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("precision", [1, 2])
def test_cuda_chunk_feed_reads_into_the_pinned_ring(monkeypatch, precision):
    """On the card, `ChunkFeed` over an int8 and an int16 IQ capture, six
    chunks of 10 ms blocks: the first read inline, full chunks served
    from the read ahead, a read-ahead miss (the pointers jump past the
    margin) read inline, a short last chunk.  Every read goes through
    `read_iq_into` over the windows of `test_chunk_feed_windows_and_
    reads_ahead`; every chunk reaches `stage` as a view of a pinned
    buffer, of two buffers in all, and is sent from there under one
    `io.pinned` span of its bytes inside its `io.stage`; every staged
    chunk equals `read_iq_values` of its window bit for bit.  A copy held
    back on the stream (a sleep queued before chunk 3 is staged) holds
    back the refill of its buffer: the read of chunk 5 waits on the
    prefetch thread under `io.ring_wait`, and chunk 3 arrives whole."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dtype = np.int8 if precision == 1 else np.int16
    info = np.iinfo(dtype)
    fcfg = FileConfig(name="ring", skip_ms=0, data_precision=precision)
    S = 2500
    values = np.random.default_rng(precision).integers(
        info.min, info.max, size=2 * 1200 * S, endpoint=True, dtype=dtype)
    base = IFSampleSource.from_array(values, fcfg)
    src = _Reads(base)
    window = ChunkWindow(S, 10)
    nb, short = 4, 2
    feed = ChunkFeed(src, "cuda", window)
    margin = feed.slack // 2
    staged = []
    stage = DeviceStager.stage

    def recorded(self, values):
        staged.append((values.untyped_storage().data_ptr(),
                       values.is_pinned(), values.nbytes))
        return stage(self, values)

    monkeypatch.setattr(DeviceStager, "stage", recorded)
    ptr = torch.tensor([300 * S, 300 * S + 37], dtype=torch.int64)
    # (pointer move before the chunk, blocks, blocks of the next)
    plan = [(0, nb, nb), (nb * window.step + 11, nb, nb),
            (nb * window.step + 50 * S, nb, nb),
            (nb * window.step - 7, nb, nb), (nb * window.step, nb, short),
            (nb * window.step + 3, short, 0)]
    windows, ahead, got = [], [], []
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.time_ns()
        try:
            for k, (move, n, n_next) in enumerate(plan):
                ptr = ptr + move
                lo, hi = int(ptr.min()), int(ptr.max())
                windows.append((lo, hi - lo + window.need(n)))
                if n_next:
                    ahead.append((lo + n * window.step - margin,
                                  hi - lo + window.need(n_next) + feed.slack))
                if k == 3:
                    torch.cuda._sleep(500_000_000)
                raw, start = feed.next(ptr, n, n_next)
                assert start == lo and raw.device.type == "cuda"
                got.append(raw)
        finally:
            feed.close()
        torch.cuda.synchronize()
        found = spans.recorded(t0, time.time_ns())
    # inline: the first chunk and the miss (chunk 2); the rest served from
    # the read ahead the chunk before submitted
    assert src.reads == [windows[0], ahead[0], ahead[1], windows[2]] + ahead[2:]
    for raw, (lo, n) in zip(got, windows):
        assert raw.dtype == torch.from_numpy(values[:0]).dtype
        assert torch.equal(raw.cpu(), torch.from_numpy(
            base.read_iq_values(lo, n))), lo
    assert all(p for _, p, _ in staged)
    assert len({a for a, _, _ in staged}) == 2
    ids = by_id(found)
    stages = sorted((s for s in found if s.name == "io.stage"),
                    key=lambda s: s.start_ns)
    pinned = sorted((s for s in found if s.name == "io.pinned"),
                    key=lambda s: s.start_ns)
    assert len(stages) == len(pinned) == len(plan)
    assert all(ids[p.parent].name == "io.stage" for p in pinned)
    assert [p.n for p in pinned] == [s.n for s in stages] == [
        b for _, _, b in staged] == [r.nbytes for r in got]
    main = threading.get_ident()
    waits = [s for s in found if s.name == "io.ring_wait"
             and s.thread != main and s.end_ns - s.start_ns > 50_000_000]
    assert len(waits) == 1 and ids[waits[0].parent].name == "io.read"


def test_spans_stay_out_of_the_profilers_trace(scene):
    """No span name is among the profiler's own events: spans never
    become `record_function` ranges, whose device-side annotations a
    reader of the trace would count as kernels."""
    _, found, prof, _, _ = traced(lambda: track(scene, 10, 2 * CHUNK_MS))
    names = {s.name for s in found}
    assert {"tracking.chunk", "tracking.scan", "io.fetch"} <= names
    events = {e.name() for e in prof.profiler.kineto_results.events()}
    assert events and not names & events


def test_nested_spans_and_their_parents():
    """Parents follow the enclosing span on the same thread; another
    thread's spans start a stack of their own; `n` set inside a span is
    what it records."""
    def worker():
        with spans.span("inner.thread", 2):
            pass

    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.time_ns()
        with spans.span("outer") as outer:
            with spans.span("middle", 1):
                with spans.span("leaf") as leaf:
                    leaf.n = 9
            th = threading.Thread(target=worker)
            th.start()
            th.join(timeout=30)
        assert not th.is_alive()
        found = {s.name: s for s in spans.recorded(t0, time.time_ns())}
    assert found["outer"].parent is None and outer.id == found["outer"].id
    assert found["middle"].parent == found["outer"].id
    assert found["leaf"].parent == found["middle"].id
    assert found["leaf"].n == 9 and found["middle"].n == 1
    assert found["inner.thread"].parent is None
    assert found["inner.thread"].thread != found["outer"].thread


def test_run_vector_tracking_records_its_spans():
    """A tiny VT run, eager on the CPU: one `vt.chunk` a chunk holding
    `io.fetch`, `io.stage`, `vt.scan` (n the chunk's steps) and
    `vt.records`, then one `vt.solutions` over all steps; no graph is
    captured on the CPU."""
    from test_torch_vt import F_IF as VT_IF
    from test_torch_vt import FS as VT_FS
    from test_torch_vt import _STATIC_LLH, _static_scene

    from gps_sdr_tpu_torch.geo.coords import llh2xyz
    from gps_sdr_tpu_torch.receiver import vt as tvt

    n_ms, chunk = 50, 20
    raw, state, args = _static_scene(torch.device("cpu"), n_ms + 10)
    cfg = ReceiverConfig(file=FileConfig(name="spans", skip_ms=0),
                         signal=SignalConfig(f_if=VT_IF, fs=VT_FS))
    src = IFSampleSource.from_array(raw.numpy().reshape(-1), cfg.file)
    usr = llh2xyz(np.asarray(_STATIC_LLH)).numpy()
    prns = [3, 7, 16, 22, 27]

    (trk, _, _), found, _, _, _ = traced(lambda: tvt.run_vector_tracking(
        src, cfg, prns, args["eph"], state, args["params"], n_ms, usr,
        chunk_ms=chunk))
    assert trk.num_sample.shape[0] == n_ms
    chunks = [s for s in found if s.name == "vt.chunk"]
    assert [c.n for c in chunks] == [20, 20, 10]
    for c in chunks:
        kids = sorted((s for s in found if s.parent == c.id),
                      key=lambda s: s.start_ns)
        assert [k.name for k in kids] == ["io.fetch", "io.stage", "vt.scan",
                                          "vt.records"]
        assert kids[2].n == kids[3].n == c.n
    (sol,) = [s for s in found if s.name == "vt.solutions"]
    assert sol.n == n_ms and sol.parent is None
    assert not [s for s in found if s.name == "vt.capture"]


def test_run_vector_tracking_reads_ahead_of_the_scan(submissions):
    """A tiny VT run over three chunks submits each next chunk's read
    inside the current chunk's `io.fetch`, before its `vt.scan` starts,
    and serves each later fetch from it; with a Kepler cadence that
    divides the chunk, its records and solutions equal a one-chunk run's
    bit for bit."""
    import dataclasses

    from test_torch_vt import F_IF as VT_IF
    from test_torch_vt import FS as VT_FS
    from test_torch_vt import _STATIC_LLH, _static_scene

    from gps_sdr_tpu_torch.geo.coords import llh2xyz
    from gps_sdr_tpu_torch.receiver import vt as tvt

    n_ms, chunk = 60, 20
    raw, state, args = _static_scene(torch.device("cpu"), n_ms + 10)
    params = dataclasses.replace(args["params"], kepler_update_ms=chunk)
    cfg = ReceiverConfig(file=FileConfig(name="spans", skip_ms=0),
                         signal=SignalConfig(f_if=VT_IF, fs=VT_FS))
    src = IFSampleSource.from_array(raw.numpy().reshape(-1), cfg.file)
    usr = llh2xyz(np.asarray(_STATIC_LLH)).numpy()

    def run(chunk_ms):
        return tvt.run_vector_tracking(src, cfg, [3, 7, 16, 22, 27],
                                       args["eph"], state, params, n_ms,
                                       usr, chunk_ms=chunk_ms)

    (trk, sol, _), found, _, _, _ = traced(lambda: run(chunk))
    served_ahead(found, submissions, "vt.chunk", "vt.scan")
    trk1, sol1, _ = run(n_ms)
    for got, want in ((trk, trk1), (sol, sol1)):
        for f, v in vars(want).items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(getattr(got, f), v, err_msg=f)


def test_receiver_stages_record_their_spans(scene, tmp_path):
    """A stage is a span `stage.<entry>` holding the stages it calls, its
    loads, its chunks and its save; a second Receiver over the same
    directory loads the record inside its stage span."""
    from gps_sdr_tpu_torch.pipeline import Receiver

    cfg, st = scene["cfg"], scene["state"]
    S = cfg.signal.samples_per_ms
    delays = (S - st.ptr.numpy() + 1).astype(np.int64)
    fine = st.carr_freq.numpy()
    np.savez(tmp_path / f"acquired_{cfg.file.name}_0.npz",
             sv=np.asarray(scene["prns"]), snr_db=np.full(2, 20.0),
             doppler_hz=fine - F_IF, code_delay=delays, fine_freq_hz=fine)

    def stage():
        rx = Receiver(cfg, scene["src"], artifact_dir=str(tmp_path),
                      device="cpu", mesh=None)
        return rx.track_for_eph(n_ms=2 * CHUNK_MS, chunk_ms=CHUNK_MS)

    rec, found, _, _, _ = traced(stage)
    assert rec.num_sample.shape[0] == 2 * CHUNK_MS
    (root,) = [s for s in found if s.parent is None
               and s.thread == threading.get_ident()]
    assert root.name == "stage.track_for_eph"
    ids = by_id(found)
    kids = sorted((s for s in found if s.parent == root.id),
                  key=lambda s: s.start_ns)
    assert [k.name for k in kids] == ["stage.acquisition", "tracking.chunk",
                                      "tracking.chunk", "stage.save"]
    (load,) = [s for s in found if s.name == "stage.load"]
    assert ids[load.parent].name == "stage.acquisition"

    again, found, _, _, _ = traced(stage)
    np.testing.assert_array_equal(again.corr, rec.corr)
    assert [(s.name, s.parent) for s in found] == [
        ("stage.load", found[1].id), ("stage.track_for_eph", None)]


def test_ct_position_records_its_spans(tmp_path):
    """`stage.ct_position` holds its tracking chunks, `ct.gate` (n the
    record's rows) and `ct.epochs` (n the epochs solved, one a fix), and
    `ct.epochs` one `ct.geometry` and one `ct.solve` an epoch, each solve
    after its geometry; the records and the fixes equal those of a run
    without a profiler bit for bit.  Tests/scenario.py's five SVs at
    2.5 MHz, started 0.3 s before a subframe, the decode made from the
    synthesizer's bits (tests/test_torch_distributed.py's rule)."""
    import dataclasses
    import shutil

    from test_torch_distributed import _decode_artifact

    from gps_sdr_tpu_torch.config import CommonConfig, SolutionConfig
    from gps_sdr_tpu_torch.io import scenario as sc
    from gps_sdr_tpu_torch.pipeline import Receiver

    n_ms, chunk = 620, 310
    cfg = ReceiverConfig(file=FileConfig(name="ctspans", skip_ms=0),
                         signal=SignalConfig(f_if=F_IF, fs=FS),
                         solu=SolutionConfig(truth_llh=sc.TRUTH_LLH),
                         cmn=CommonConfig(multicorr_ct=False))
    gs = sc.geometry_signal(sc.TOW0 + 0.7, cfg, device="cpu")
    src = sc.write_capture(str(tmp_path / "capture.bin"), gs, 700)
    seeded = Receiver(cfg, src, artifact_dir=str(tmp_path / "on"),
                      device="cpu", mesh=None)
    seeded._save_pickle(f"eph_{cfg.file.name}.pkl",
                        _decode_artifact(gs, cfg, seeded.acquisition()))
    shutil.copytree(tmp_path / "on", tmp_path / "off")

    def stage(where):
        rx = Receiver(cfg, src, artifact_dir=str(tmp_path / where),
                      device="cpu", mesh=None)
        return rx.ct_position(n_ms=n_ms, chunk_ms=chunk)

    (rec, nav), found, _, _, _ = traced(lambda: stage("on"))
    main = threading.get_ident()
    (root,) = [s for s in found if s.parent is None and s.thread == main]
    assert root.name == "stage.ct_position"
    kids = [s.name for s in sorted((s for s in found if s.parent == root.id),
                                   key=lambda s: s.start_ns)]
    assert kids.count("tracking.chunk") == n_ms // chunk
    assert kids.index("ct.gate") < kids.index("ct.epochs")
    (gate,) = [s for s in found if s.name == "ct.gate"]
    (epochs,) = [s for s in found if s.name == "ct.epochs"]
    assert gate.n == n_ms and gate.parent == root.id
    assert epochs.n == len(nav.usr_pos) > 0
    inner = sorted((s for s in found if s.parent == epochs.id),
                   key=lambda s: s.start_ns)
    assert [s.name for s in inner] == ["ct.geometry", "ct.solve"] * epochs.n
    assert all(s.n == nav.valid.shape[1] for s in inner)
    assert all(epochs.start_ns <= s.start_ns and s.end_ns <= epochs.end_ns
               for s in inner)

    rec_off, nav_off = stage("off")
    for f in ttrack._REC_FIELDS:
        np.testing.assert_array_equal(getattr(rec, f), getattr(rec_off, f),
                                      err_msg=f)
    for f in dataclasses.fields(nav):
        np.testing.assert_array_equal(getattr(nav, f.name),
                                      getattr(nav_off, f.name),
                                      err_msg=f.name)
