"""setup_s: launch to the first timed pass (import, the kernels loaded from
the checkout's build/ cache or built there, the capture synthesized, the
mix's set-up stages, one warm-up pass), host clock."""


def read(ctx):
    return ctx.setup_s
