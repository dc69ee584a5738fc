"""vt_step_ms: the window's wall milliseconds over the 1 ms VT steps its
whole passes completed, everything the stage does outside vt_scan
included, host clock."""


def read(ctx):
    if ctx.steps <= 0:
        return None
    return ctx.window_s * 1e3 / ctx.steps
