"""Entries binning placed a frame, dense and spill (the live rows of the
entry table that the visibility kernel walks): the program's
``bin.entries`` counter (the ``entry_demand`` field of each frame's stats
vector) over its ``bin.reported`` counter, both totals over the traced
block (``binning.live_tris`` opens the recorder); None where the program
counts neither."""


def read(rec):
    sp = rec.get("spans")
    counters = sp["counters"] if sp else {}
    n = counters.get("bin.reported")
    if not n or "bin.entries" not in counters:
        return None
    return counters["bin.entries"] / n
