"""Device time a frame of the kernels and copies under
``stage::bin_triangles`` in the profiled frames."""


def read(rec):
    tr = rec["trace"]
    s = tr["stage_device_s"].get("bin_triangles")
    return s / tr["frames"] * 1e3 if s and tr["frames"] else None
