"""95th percentile of every gap between consecutive output tokens of the
interactive tier that ends inside the window, in ms; a gap still open at
the close (a request of the tier mid-decode) counts with its length so
far."""
from nbench.records import pct


def read(run):
    gaps = []
    for r in run.reqs:
        if not r.interactive or not r.tokens:
            continue
        ts = [t for t in r.tokens if t < run.t_close]
        gaps += [b - a for a, b in zip(ts, ts[1:]) if b >= run.t_open]
        if ts and len(ts) < r.decode_len:
            gaps.append(run.t_close - ts[-1])
    return pct([g * 1e3 for g in gaps], 95)
