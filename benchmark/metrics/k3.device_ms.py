"""``visibility_kernel``'s device time a frame in the profiled frames."""

from benchmark.tracing import op_seconds


def read(rec):
    tr = rec["trace"]
    s = op_seconds(tr, "visibility_kernel")
    return s / tr["frames"] * 1e3 if s and tr["frames"] else None
