"""The 95th percentile of the intervals between consecutive presents in
the window, over every frame of it."""

from benchmark.stats import percentile


def read(rec):
    p = percentile(rec["intervals_s"], 95)
    return None if p is None else p * 1e3
