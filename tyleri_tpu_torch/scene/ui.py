"""UI overlay elements (ref: src/render_objects/ui.rs).

``UIElement`` carries offsets into the per-scene UI vertex/index buffers +
the font-texture descriptor (ref: ui.rs:15-43). ``RenderScene.add_ui`` takes
``RawUIData = [(ui_vertices, indices, texture), ...]``, appends everything
into the host-visible variable-length buffers and records offsets
(ref: ui.rs:45-84).  Reference quirk preserved: a non-empty call rebuilds
the element list, an empty call clears it (ref: ui.rs:57-59).

The port's own copy of ``tyleri_tpu/scene/ui.py``, which it
never imports; ``tests/test_torch_vendored.py`` holds the two together.
"""

from __future__ import annotations

import numpy as np

from tyleri_tpu_torch.api.vertex import UIVertex


class UIElement:
    def __init__(self, vertex_offset: int, index_offset: int, index_len: int, texture):
        self.vertex_offset = vertex_offset
        self.index_offset = index_offset
        self.index_len = index_len
        self.texture = texture


def add_ui_to_resources(resources, raw_data) -> None:
    """Shared implementation for RenderScene.add_ui (resources is a
    RenderResources). raw_data: [(vertices, indices, texture), ...] where
    vertices is an [N, 8] float array / list of UIVertex and indices a u32
    list relative to the element's vertex_offset."""
    resources.ui.clear()
    resources.ui_vertices.clear()
    resources.ui_indices.clear()
    if not raw_data:
        return
    total_v = 0
    total_i = 0
    packed = []
    for verts, indices, texture in raw_data:
        v = verts if isinstance(verts, np.ndarray) else UIVertex.pack(verts)
        v = np.asarray(v, np.float32).reshape(-1, UIVertex.FLOATS)
        i = np.asarray(indices, np.uint32).reshape(-1)
        packed.append((v, i, texture))
        total_v += len(v)
        total_i += len(i)
    # single expand covering the batch (ref sums sizes first, ui.rs:60-67)
    resources.ui_vertices.expand_to(total_v)
    resources.ui_indices.expand_to(total_i)
    for v, i, texture in packed:
        voff = resources.ui_vertices.write(v)
        ioff = resources.ui_indices.write(i)
        resources.ui.append(UIElement(voff, ioff, len(i), texture))
