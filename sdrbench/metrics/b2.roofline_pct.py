"""b2.roofline_pct: the least time the card could take for the traced VT
pass's fetching-bank launches (roofline.bank_bound of each step, from
the pass's records) over the time the profiler gave corr_bank_kernel and,
with DC removal, corr_bank_dc_kernel, in percent."""

from sdrbench.launches import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "b2")
