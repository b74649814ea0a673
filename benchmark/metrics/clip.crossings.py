"""Near-plane crossers a frame: the mean of the ``clip_crossings`` field of
each window frame's stats vector, as the window reports it."""


def read(rec):
    c = rec["crossings"]
    return sum(c) / len(c) if c else None
