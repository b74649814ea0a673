"""Statistics of the end-to-end metrics."""

from __future__ import annotations

import math


def percentile(values, q: float):
    """The q-th percentile with linear interpolation between the two
    nearest ranks (numpy's default), over every value; None when empty."""
    v = sorted(values)
    if not v:
        return None
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
