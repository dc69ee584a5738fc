"""track_x_realtime: seconds of capture the window's passes covered (from
the acquisition pointer to the last sample each pass's stage read, once a
pass) over the wall seconds of the window, host clock."""


def read(ctx):
    if ctx.covered_s <= 0:
        return None
    return ctx.covered_s / ctx.window_s
