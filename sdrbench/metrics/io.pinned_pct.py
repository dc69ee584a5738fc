"""io.pinned_pct: bytes of the traced tracking pass that went to the card
straight from the pinned buffer their read filled (the n of the
`io.pinned` spans) over the bytes staged (the n of `io.stage`), in
percent.  A program that records no `io.pinned` span (one that copies
each chunk into pinned memory on the main thread) reads nothing."""

from sdrbench.spans import load


def read(ctx):
    sp = load(ctx, "track")
    if sp is None or not sp.named("io.pinned"):
        return None
    staged = sp.total("io.stage")[1]
    return 100.0 * sp.total("io.pinned")[1] / staged if staged else None
