"""ct.outside_ms_per_s: the traced CT-POS pass's root stage span less its
`tracking.chunk` and `ct.epochs` spans (the artifacts' loads, the
validity gate, the saves) per second of capture it covered, in ms.  A
program without `ct.epochs` reads nothing: its root would count the
epochs too."""

from sdrbench.spans import load


def read(ctx):
    sp = load(ctx, "ct")
    if sp is None or not ctx.covered_s or not sp.named("ct.epochs"):
        return None
    return ((sp.roots_outside("tracking.chunk") - sp.total("ct.epochs")[0])
            * 1e3 / ctx.covered_s)
