"""Live narrow triangles binning placed a frame: the program's
``bin.live`` counter (the ``bin_demand`` field of each frame's stats
vector) over its ``bin.reported`` counter (one a reported frame), both
totals over the traced block; None where the program counts neither.

In the cells that do not report ``frame.host_ms``, whose reader opens the
program's recorder, this reader opens it, as that one does
(``benchmark/spans.py``); ``binning.entries`` reads what it records."""

from benchmark import spans

spans.start()
CAPTURE, capture, after = spans.CAPTURE, spans.capture, spans.after


def read(rec):
    sp = rec.get("spans")
    counters = sp["counters"] if sp else {}
    n = counters.get("bin.reported")
    if not n or "bin.live" not in counters:
        return None
    return counters["bin.live"] / n
