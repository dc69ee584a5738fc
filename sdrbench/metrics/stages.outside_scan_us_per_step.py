"""stages.outside_scan_us_per_step: the traced VT pass's root stage span
less its `vt.scan` spans (artifact loads and saves, fetch, staging, the
records' wait, the solutions) per 1 ms VT step, in us."""

from sdrbench.spans import load, per_step_us


def read(ctx):
    sp = load(ctx, "vt")
    if sp is None or not sp.named("vt.scan"):
        return None
    return per_step_us(ctx, sp.roots_outside("vt.scan"))
