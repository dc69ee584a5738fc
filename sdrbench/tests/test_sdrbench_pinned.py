"""`io.pinned_pct` on hand-made spans: 100 where every staged chunk went
to the card from the pinned buffer its read filled, the share of the
bytes where only some did, nothing on a pass without the span, on a `vt`
or `ct` pass, or untraced."""

from types import SimpleNamespace

import pytest

from sdrbench import harness
from sdrbench.trace import Trace

from gps_sdr_tpu_torch.utils.spans import Span

MAIN = 1


def ctx_of(chunks, kind="track", traced=True):
    """A traced pass of `chunks` [(staged bytes, pinned bytes or None)],
    each a `tracking.chunk` with its `io.stage` (and `io.pinned` inside
    it), under one stage span."""
    found, t, ids = [], 0, iter(range(1, 1 << 20))
    for staged, pinned in chunks:
        c, st = next(ids), next(ids)
        found.append(Span(c, "tracking.chunk", t, t + 10, 0, MAIN, 100))
        found.append(Span(st, "io.stage", t + 1, t + 9, c, MAIN, staged))
        if pinned is not None:
            found.append(Span(next(ids), "io.pinned", t + 2, t + 8, st,
                              MAIN, pinned))
        t += 10
    found.append(Span(0, "stage.track_for_eph_reference", 0, t, None, MAIN,
                      0))
    trace = Trace([], 1e-9 * t, 0, t) if traced else None
    ctx = SimpleNamespace(trace=trace, mix={"output": kind}, covered_s=1.0)
    return ctx, found


@pytest.fixture
def reader(monkeypatch):
    from sdrbench import spans

    def read(ctx, found):
        monkeypatch.setattr(spans, "_read", lambda c: spans.PassSpans(
            found, c.trace.t0_ns, c.trace.t1_ns))
        return harness.load_reader("io.pinned_pct")(ctx)

    return read


def test_every_chunk_pinned_reads_100(reader):
    b = 116_000_000
    ctx, found = ctx_of([(b, b)] * 40)
    assert reader(ctx, found) == 100.0


def test_a_share_of_the_bytes_pinned(reader):
    # two chunks sent from their read's buffer, one copied in first
    ctx, found = ctx_of([(300, 300), (300, 300), (400, None)])
    assert reader(ctx, found) == pytest.approx(60.0)


def test_nothing_without_the_span(reader):
    ctx, found = ctx_of([(300, None)] * 3)
    assert reader(ctx, found) is None


@pytest.mark.parametrize("kind", ["vt", "ct"])
def test_nothing_on_another_kind_of_pass(reader, kind):
    ctx, found = ctx_of([(300, 300)], kind=kind)
    assert reader(ctx, found) is None


def test_nothing_untraced():
    ctx, _ = ctx_of([(300, 300)], traced=False)
    assert harness.load_reader("io.pinned_pct")(ctx) is None
