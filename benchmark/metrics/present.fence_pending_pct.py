"""The share of the frames presented in the window's unprofiled frames
whose fence had not passed when the window came to present them (the
program's ``present.fence_pending`` counter over the frames its
``present`` spans carry)."""


def read(rec):
    sp = rec.get("spans")
    if not sp or not sp["presented"]:
        return None
    return sp["fence_pending"] / sp["presented"] * 100.0
