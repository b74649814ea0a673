"""Device time a frame under ``stage::shade_visibility`` in the profiled
frames."""


def read(rec):
    tr = rec["trace"]
    s = tr["stage_device_s"].get("shade_visibility")
    return s / tr["frames"] * 1e3 if s and tr["frames"] else None
