"""device.idle_unspanned_pct.vt: share of the card's idle time in the
traced VT pass during which the main thread's innermost open span was
the root stage span or none, in percent."""

from sdrbench.spans import load


def read(ctx):
    sp = load(ctx, "vt")
    return None if sp is None else sp.unspanned_pct(ctx.trace.intervals())
