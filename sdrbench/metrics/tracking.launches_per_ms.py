"""tracking.launches_per_ms: kernels the card ran in the traced tracking
pass (the profiler's kernel records) per ms of capture the pass
covered."""


def read(ctx):
    if ctx.trace is None or ctx.mix["output"] != "track" or not ctx.covered_s:
        return None
    if not ctx.trace.kernels:
        return None
    return len(ctx.trace.kernels) / (ctx.covered_s * 1e3)
