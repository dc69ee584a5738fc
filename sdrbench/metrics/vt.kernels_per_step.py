"""vt.kernels_per_step: kernels the card ran in the traced VT pass,
those replayed from CUDA graphs included, per 1 ms VT step."""


def read(ctx):
    if ctx.trace is None or ctx.mix["output"] != "vt" or not ctx.steps:
        return None
    if not ctx.trace.kernels:
        return None
    return len(ctx.trace.kernels) / ctx.steps
