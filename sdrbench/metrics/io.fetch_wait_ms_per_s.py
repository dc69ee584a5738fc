"""io.fetch_wait_ms_per_s: main-thread `io.fetch` time in the traced
tracking pass (the wait for the pending read, or the read on a miss)
per second of capture it covered, in ms."""

from sdrbench.spans import per_capture_s


def read(ctx):
    return per_capture_s(ctx, "io.fetch")
