"""vt.issue_us_per_step: `vt.scan` self time in the traced VT pass (its
`vt.capture` children left out: the host's issue of replays and eager
steps) per 1 ms VT step, in us."""

from sdrbench.spans import load, per_step_us


def read(ctx):
    sp = load(ctx, "vt")
    if sp is None or not sp.named("vt.scan"):
        return None
    return per_step_us(ctx, sp.self_s("vt.scan"))
