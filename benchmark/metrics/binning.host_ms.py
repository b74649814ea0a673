"""Host time a frame in ``passes.bin_triangles``, over the window's
unprofiled frames."""


def read(rec):
    if not rec["host_frames"]:
        return None
    return rec["stage_host_s"].get("bin_triangles", 0.0) \
        / rec["host_frames"] * 1e3
