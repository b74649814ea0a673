"""Host time a frame in the program's ``present.fence_wait`` span (the
wait on a recycled frame's fence before its image is presented), over the
window's unprofiled frames."""

from benchmark import spans


def read(rec):
    return spans.per_frame_ms(rec, "present.fence_wait")
