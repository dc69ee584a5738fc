"""tracking.scan_us_per_block: `tracking.scan` time in the traced
tracking pass over the blocks it tracked: the host's issue of one 10 ms
block of `track_scan`, in us."""

from sdrbench.spans import load


def read(ctx):
    sp = load(ctx, "track")
    if sp is None:
        return None
    s, blocks = sp.total("tracking.scan")
    return s * 1e6 / blocks if blocks else None
