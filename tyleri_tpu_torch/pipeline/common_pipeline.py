"""CommonPipeline — the 3D mesh pipeline object
(ref: src/pipeline/common_pipeline.rs:31-139).

A Vulkan pipeline bundles shaders + fixed-function state; here the bundle is
the PipelineState (blend/depth/raster) plus the shader semantics implemented
by the kernels:

* vertex stage: ``clip = projection @ view_x_model @ [pos, 1]`` with the
  128-byte push constant replaced by per-draw MVP matrices
  (ref: src/pipeline/glsl/common_pipeline.vert:16-19,
  ops/setup.py::transform_mesh_corners)
* fragment stage: texture fetch verbatim, no lighting
  (ref: src/pipeline/glsl/common_pipeline.frag:11-12, ops/shade.py)

The port's own copy of ``tyleri_tpu/pipeline/common_pipeline.py``, which it
never imports; ``tests/test_torch_vendored.py`` holds the two together.
"""

from __future__ import annotations

from tyleri_tpu_torch.pipeline.state import MESH_PIPELINE_STATE, PipelineState

PUSH_CONSTANT_BYTES = 128  # two mat4: view_x_model + projection (ref :60-62)


class CommonPipeline:
    def __init__(self, state: PipelineState = MESH_PIPELINE_STATE):
        self.state = state

    @property
    def push_constant_bytes(self) -> int:
        return PUSH_CONSTANT_BYTES
