"""The share of the profiled span in which the card ran no kernel or copy
while the host was inside no ``ty::frame`` range (the application's work
between frames, the slices' own edges)."""


def read(rec):
    sp = rec.get("spans")
    if not sp or sp["idle_outside_frame_s"] is None \
            or not sp["profiled_span_s"]:
        return None
    return sp["idle_outside_frame_s"] / sp["profiled_span_s"] * 100.0
