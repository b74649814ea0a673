"""Host time a frame in the program's ``frame`` span (``RenderWindow.render``
from its first line to its return), over the window's unprofiled frames.

This reader, present in every cell, opens the program's recorder for the
run and reduces its records into ``rec["spans"]`` (``benchmark/spans.py``);
the other span and counter readers read what it put there."""

from benchmark import spans

spans.start()
CAPTURE, capture, after = spans.CAPTURE, spans.capture, spans.after


def read(rec):
    return spans.per_frame_ms(rec, "frame")
