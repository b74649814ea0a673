"""The measured window (host clock) over the frames presented in it."""


def read(rec):
    if not rec["frames"]:
        return None
    return rec["window_s"] / rec["frames"] * 1e3
