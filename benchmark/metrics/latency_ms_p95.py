"""The 95th percentile over every frame presented in the window of the
time from the harness filling the frame's scene to its image reaching the
present target."""

from benchmark.stats import percentile


def read(rec):
    p = percentile(rec["latencies_s"], 95)
    return None if p is None else p * 1e3
