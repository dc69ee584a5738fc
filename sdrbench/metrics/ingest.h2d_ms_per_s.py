"""ingest.h2d_ms_per_s: device milliseconds of host-to-device copies in
the traced tracking pass per second of capture it covered."""


def read(ctx):
    if ctx.trace is None or ctx.mix["output"] != "track" or not ctx.covered_s:
        return None
    s, n = ctx.trace.copy_s(r"HtoD")
    return s * 1e3 / ctx.covered_s if n else None
