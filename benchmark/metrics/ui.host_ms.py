"""Host time a frame in ``forward.ui_pass`` (the UI overlay), over the
window's unprofiled frames."""


def read(rec):
    s = rec["stage_host_s"].get("ui_pass")
    if not s or not rec["host_frames"]:
        return None
    return s / rec["host_frames"] * 1e3
