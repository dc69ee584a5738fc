"""ct.wls_us_per_epoch: the traced CT-POS pass's `ct.epochs` time (the WLS
epochs: transmit times, SV states, atmosphere, the LS fixes) over the
epochs it solved, in us.  A program without the span reads nothing."""

from sdrbench.spans import load


def read(ctx):
    sp = load(ctx, "ct")
    if sp is None:
        return None
    s, epochs = sp.total("ct.epochs")
    return s * 1e6 / epochs if epochs else None
