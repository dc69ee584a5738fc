"""`tracking.replay_pct` on hand-made spans: 100 where every block under
`tracking.scan` was replayed, the share where only some were, nothing on
a pass without the graph route, on a `vt` or `ct` pass, or untraced."""

from types import SimpleNamespace

import pytest

from sdrbench import harness
from sdrbench.trace import Trace

from gps_sdr_tpu_torch.utils.spans import Span

MAIN = 1


def ctx_of(chunks, kind="track", traced=True):
    """A traced pass of `chunks` [(scan blocks, capture n or None, replay
    n or None)], each a `tracking.chunk` with its `tracking.scan` (and the
    graph route's spans inside it), under one stage span."""
    found, t, ids = [], 0, iter(range(1, 1 << 20))
    for blocks, cap, rep in chunks:
        c, sc = next(ids), next(ids)
        found.append(Span(c, "tracking.chunk", t, t + 10, 0, MAIN, blocks))
        found.append(Span(sc, "tracking.scan", t + 1, t + 9, c, MAIN,
                          blocks))
        if cap is not None:
            found.append(Span(next(ids), "tracking.capture", t + 2, t + 4,
                              sc, MAIN, cap))
        if rep is not None:
            found.append(Span(next(ids), "tracking.replay", t + 5, t + 8,
                              sc, MAIN, rep))
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
        return harness.load_reader("tracking.replay_pct")(ctx)

    return read


def test_every_block_replayed_reads_100(reader):
    ctx, found = ctx_of([(100, 100, 100)] + [(100, None, 100)] * 39)
    assert reader(ctx, found) == 100.0


def test_a_share_replayed(reader):
    # three full chunks replayed, a short last one eager
    ctx, found = ctx_of([(5, 5, 5), (5, None, 5), (5, None, 5),
                         (2, None, None)])
    assert reader(ctx, found) == pytest.approx(100.0 * 15 / 17)


def test_nothing_without_the_graph_route(reader):
    ctx, found = ctx_of([(100, None, None)] * 3)
    assert reader(ctx, found) is None


@pytest.mark.parametrize("kind", ["vt", "ct"])
def test_nothing_on_another_kind_of_pass(reader, kind):
    ctx, found = ctx_of([(100, 100, 100)], kind=kind)
    assert reader(ctx, found) is None


def test_nothing_untraced():
    ctx, _ = ctx_of([(100, 100, 100)], traced=False)
    assert harness.load_reader("tracking.replay_pct")(ctx) is None
