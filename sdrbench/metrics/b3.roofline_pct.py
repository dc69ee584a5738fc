"""b3.roofline_pct: the least time the card could take for the traced
pass's windows-bank launches (roofline.bank_bound over windows, from the
pass's 10 ms records) over the time the profiler gave
corr_bank_windows_kernel and, with DC removal, corr_bank_dc_kernel, in
percent."""

from sdrbench.launches import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "b3")
