"""UIPipeline — the 2D overlay pipeline object
(ref: src/pipeline/ui_pipeline.rs:29-136).

Bundle of the UI PipelineState plus shader semantics:

* vertex stage: pixel-points -> NDC via ``2*p/screen_size - 1``, z = 0
  (ref: src/pipeline/glsl/ui.vert:16-18, rendering/passes.py::ui_points_to_clip);
  the 8-byte screen-size push constant becomes a per-frame scalar pair
* fragment stage: ``outColor = inColor * texture(font_texture, uv)``
  (ref: src/pipeline/glsl/ui.frag:10, ops/raster_exact.py vertex-color path)

The port's own copy of ``tyleri_tpu/pipeline/ui_pipeline.py``, which it
never imports; ``tests/test_torch_vendored.py`` holds the two together.
"""

from __future__ import annotations

from tyleri_tpu_torch.pipeline.state import PipelineState, UI_PIPELINE_STATE

PUSH_CONSTANT_BYTES = 8  # vec2 screen size in points (ref :53-63)


class UIPipeline:
    def __init__(self, state: PipelineState = UI_PIPELINE_STATE):
        self.state = state

    @property
    def push_constant_bytes(self) -> int:
        return PUSH_CONSTANT_BYTES
