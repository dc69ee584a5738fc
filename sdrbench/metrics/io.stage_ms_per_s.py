"""io.stage_ms_per_s: `io.stage` time in the traced tracking pass (the
copy into pinned memory and the host-to-device issue) per second of
capture it covered, in ms."""

from sdrbench.spans import per_capture_s


def read(ctx):
    return per_capture_s(ctx, "io.stage")
