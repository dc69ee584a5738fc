"""b1.roofline_pct: the least time the card could take for the traced
pass's track_chunk launches (roofline.chunk_bound of each, from the
pass's records) over the time the profiler gave those launches, in
percent."""

from sdrbench.launches import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "b1")
