"""MeshRenderer — one draw item (ref: src/render_objects/mesh_renderer.rs).

Carries the two arena suballocations (vertices/indices with offset/len — the
bindless handles consumed at draw time, ref: mesh_renderer.rs:72-78), the
texture descriptor (a TextureArena slot), and the model matrix pushed as the
MVP constant (ref: mesh_renderer.rs:18-22,52-64 — 128-byte push constant of
view_x_model + projection).

The port's own copy of ``tyleri_tpu/scene/mesh_renderer.py``, which it
never imports; ``tests/test_torch_vendored.py`` holds the two together.
"""

from __future__ import annotations

import numpy as np


class MeshRenderer:
    def __init__(self, vertices, indices, texture, model=None):
        """vertices: StaticVertices, indices: StaticIndices (arena handles),
        texture: StaticTexture (ref: mesh_renderer.rs:33-44)."""
        self.vertices = vertices
        self.indices = indices
        self.texture = texture
        self.model = np.asarray(
            model if model is not None else np.eye(4), np.float32
        ).reshape(4, 4)

    @property
    def triangle_count(self) -> int:
        return self.indices.len // 3
