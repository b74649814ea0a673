"""Host time a frame in the program's ``bin.spill`` span (binning's emit
of the spill levels' slots), over the window's unprofiled frames."""

from benchmark import spans


def read(rec):
    return spans.per_frame_ms(rec, "bin.spill")
