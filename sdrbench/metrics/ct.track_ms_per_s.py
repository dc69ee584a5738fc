"""ct.track_ms_per_s: the traced CT-POS pass's `tracking.chunk` time (the
chunks' fetch, staging, B1's issue and the records' wait) per second of
capture it covered, in ms."""

from sdrbench.spans import load


def read(ctx):
    sp = load(ctx, "ct")
    if sp is None or not ctx.covered_s or not sp.named("tracking.chunk"):
        return None
    return sp.total("tracking.chunk")[0] * 1e3 / ctx.covered_s
