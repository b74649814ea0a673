"""Host time a frame in ``ForwardRenderingFunction.build_frame_inputs``
(the frame plan and its inputs), over the window's unprofiled frames."""


def read(rec):
    if not rec["host_frames"]:
        return None
    return rec["stage_host_s"].get("build_frame_inputs", 0.0) \
        / rec["host_frames"] * 1e3
