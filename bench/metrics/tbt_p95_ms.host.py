"""95th percentile of the interactive tier's gaps between consecutive
output tokens, in ms, over the window's part that ran before the profiler
started (``Run.host_end``; the whole window in an untraced run): gaps
that end there, and the open gap of a request of the tier still decoding
at that instant, counted to it (``Run.tbt_gaps``)."""
from nbench.records import pct


def read(run):
    return pct([g * 1e3 for g in run.tbt_gaps(run.host_end)], 95)
