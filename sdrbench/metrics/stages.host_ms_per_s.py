"""stages.host_ms_per_s: the traced tracking pass's root stage span less
its `tracking.chunk` spans (the merge, the save, the loop state taken
from the records, countinx) per second of capture it covered, in ms."""

from sdrbench.spans import load


def read(ctx):
    sp = load(ctx, "track")
    if sp is None or not ctx.covered_s:
        return None
    return sp.roots_outside("tracking.chunk") * 1e3 / ctx.covered_s
