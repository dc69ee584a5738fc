"""tracking.wait_ms_per_s: `tracking.records` time in the traced tracking
pass (the host's wait for the card to drain a chunk, then the records'
copy back) per second of capture it covered, in ms."""

from sdrbench.spans import per_capture_s


def read(ctx):
    return per_capture_s(ctx, "tracking.records")
