"""device.idle_pct.ct: share of the traced CT-POS pass in which the card
ran no kernel and no copy (the profiler's device intervals merged), in
percent."""

from sdrbench.launches import idle_pct


def read(ctx):
    return idle_pct(ctx, "ct")
