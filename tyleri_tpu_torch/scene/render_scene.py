"""RenderScene + per-frame resources (ref: src/render_scene.rs).

The reference splits per-frame state into Present/Record/Render resources
(semaphores / fence+command buffers / UI buffers+cameras, ref:
render_scene.rs:23-116).  On TPU the semaphore/fence machinery is the
window's frame ring (tyleri_tpu_torch.window); what remains scene-side is
``RenderResources``: the immediate-mode camera list and UI geometry, rebuilt
every frame and cleared on recycle (ref: render_window.rs:206,
render_scene.rs:108-116).

The port's own copy of ``tyleri_tpu/scene/render_scene.py``, which it
never imports; ``tests/test_torch_vendored.py`` holds the two together.
"""

from __future__ import annotations

from tyleri_tpu_torch.resource.arenas import VariableLengthBuffer
from tyleri_tpu_torch.scene.camera import Camera
from tyleri_tpu_torch.scene.ui import add_ui_to_resources

import numpy as np

UI_VERTICES_INIT_SIZE = 2048  # ref: render_scene.rs:20
UI_INDICES_INIT_SIZE = 1024   # ref: render_scene.rs:21


class RenderResources:
    def __init__(self):
        self.ui_vertices = VariableLengthBuffer((8,), np.float32, UI_VERTICES_INIT_SIZE)
        self.ui_indices = VariableLengthBuffer((), np.uint32, UI_INDICES_INIT_SIZE)
        self.cameras: list[Camera] = []
        self.ui = []

    def clear(self) -> None:
        """Reset for reuse (ref: render_scene.rs:108-116 asserts exclusive
        ownership then clears; Python's GC model makes the assert moot)."""
        self.cameras.clear()
        self.ui.clear()
        self.ui_vertices.clear()
        self.ui_indices.clear()


class RenderScene:
    def __init__(self):
        self.render_resources = RenderResources()

    def add_camera(self, camera: Camera) -> None:
        self.render_resources.cameras.append(camera)

    def add_ui(self, raw_data) -> None:
        """raw_data: [(ui_vertices, indices, texture), ...]
        (ref: ui.rs:51-84; see scene/ui.py for the rebuild/clear quirk)."""
        add_ui_to_resources(self.render_resources, raw_data)

    def clear(self) -> None:
        self.render_resources.clear()
