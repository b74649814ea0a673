"""Host time a frame in the program's ``ui.read`` span (the UI pass's one
synchronizing read of its triangles' boxes), over the window's unprofiled
frames."""

from benchmark import spans


def read(rec):
    return spans.per_frame_ms(rec, "ui.read")
