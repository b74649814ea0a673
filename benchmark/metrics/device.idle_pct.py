"""The share of the profiled span in which no kernel or copy ran on the
card: one less the union of the device intervals over the span."""


def read(rec):
    tr = rec["trace"]
    if not tr["span_s"]:
        return None
    return (1.0 - tr["busy_s"] / tr["span_s"]) * 100.0
