"""tracking.replay_pct: blocks of the traced tracking pass that ran as a
replay of a captured CUDA graph (the n of its `tracking.replay` spans)
over the blocks under `tracking.scan`, in percent.  A program that
records no `tracking.replay` span (one without the graph route) reads
nothing."""

from sdrbench.spans import load


def read(ctx):
    sp = load(ctx, "track")
    if sp is None or not sp.named("tracking.replay"):
        return None
    blocks = sp.total("tracking.scan")[1]
    return 100.0 * sp.total("tracking.replay")[1] / blocks if blocks else None
