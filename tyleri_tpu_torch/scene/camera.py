"""Camera (ref: src/render_objects/camera.rs).

Field-for-field mirror: view matrix (identity default), z_near 0.1 /
z_far 100 / fov 45 degrees (ref: camera.rs:21-30), per-camera viewport +
scissor, and the owned mesh list.  Projection is glam's ``perspective_rh``
with [0,1] depth (ref: camera.rs:40-47).

The port's own copy of ``tyleri_tpu/scene/camera.py``, which it
never imports; ``tests/test_torch_vendored.py`` holds the two together.
"""

from __future__ import annotations

import numpy as np

from tyleri_tpu_torch.scene.parallel_group import ParallelGroup
from tyleri_tpu_torch.utils import math3d
from tyleri_tpu_torch.utils.math3d import Rect2D, Viewport


class Camera:
    def __init__(self):
        self.view_matrix = np.eye(4, dtype=np.float32)
        self.z_near = 0.1
        self.z_far = 100.0
        self.fov = 45.0  # degrees, as in the reference
        self.viewport = Viewport()
        self.scissor = Rect2D()
        self.mesh_renderers = []
        # Optional directional light (scene.light.DirectionalLight).  None
        # (the default) = the reference's unlit fragment path; set -> the
        # whole camera pass shades Blinn-Phong (BASELINE config 3).
        self.light = None

    def eye_position(self) -> np.ndarray:
        """World-space camera position (inverse view translation)."""
        v = np.asarray(self.view_matrix, np.float64)
        return (-v[:3, :3].T @ v[:3, 3]).astype(np.float32)

    def get_projection_matrix(self) -> np.ndarray:
        return np.asarray(
            math3d.perspective_rh(
                np.radians(self.fov),
                self.viewport.width / self.viewport.height,
                self.z_near,
                self.z_far,
            ),
            np.float32,
        )

    def get_and_order_meshes(self, num_groups: int) -> ParallelGroup:
        """Round-robin partition (front-to-back ordering is a TODO in the
        reference too — camera.rs:32-39). Used by the sort-last parallel
        renderer; the single-chip path consumes mesh_renderers directly."""
        group = ParallelGroup(num_groups)
        for m in self.mesh_renderers:
            group.push(m)
        return group
