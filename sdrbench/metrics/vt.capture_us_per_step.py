"""vt.capture_us_per_step: `vt.capture` time in the traced VT pass (the
CUDA graphs captured) per 1 ms VT step, in us."""

from sdrbench.spans import load, per_step_us


def read(ctx):
    sp = load(ctx, "vt")
    if sp is None or not sp.named("vt.scan"):
        return None
    return per_step_us(ctx, sp.total("vt.capture")[0])
