"""The numpy oracle (``tyleri_tpu.testing.oracle``) applied to a whole
recorded scene, for holding the port's frames to the Vulkan raster rules.

``scene_oracle_u8`` rasterizes every camera's draws in submission order,
in f64, from the device's numpy staging arrays, and returns the presented
u8 image.  It applies the pipeline's blend once per pixel, to the fragment
that survives the depth test, as the visibility path does.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tyleri_tpu.pipeline.state import BlendState
from tyleri_tpu.testing import oracle

CLEAR_COLOR = (0.0, 0.0, 0.0, 0.0)


def _texture(arena, slot: int) -> np.ndarray:
    off, w, h = arena._offsets[slot], arena._widths[slot], arena._heights[slot]
    return np.asarray(arena._texels[off:off + w * h], np.float64).reshape(
        h, w, 4)


def scene_oracle_u8(render_device, render_resources, mesh_state,
                    resolution) -> np.ndarray:
    """u8 [H, W, 4] oracle image of one recorded frame (unlit, no UI), as
    presented with opaque composite alpha."""
    W, H = resolution
    alloc = render_device.memory_allocator
    pos = alloc.static_vertices_buffer.staging("pos")
    uvs = alloc.static_vertices_buffer.staging("uv")
    idx = alloc.static_indices_buffer.staging("idx")
    color = np.zeros((H, W, 4), np.float64)
    color[:] = CLEAR_COLOR
    depth = np.ones((H, W), np.float64)
    covered = np.zeros((H, W), bool)
    state = dataclasses.replace(mesh_state, blend=BlendState(enable=False))

    def hook(y0, x0, passed, _frag):
        h, w = passed.shape
        covered[y0:y0 + h, x0:x0 + w] |= passed

    for cam in render_resources.cameras:
        view_proj = (np.asarray(cam.get_projection_matrix(), np.float64)
                     @ np.asarray(cam.view_matrix, np.float64))
        for mesh in cam.mesh_renderers:
            i = idx[mesh.indices.offset:mesh.indices.offset
                    + mesh.indices.len].astype(np.int64)
            i = i + mesh.vertices.offset
            mvp = view_proj @ np.asarray(mesh.model, np.float64)
            oracle.rasterize(
                color, depth, oracle.make_mesh_clip(pos, i, mvp),
                uvs[i.reshape(-1, 3)], state, cam.viewport, cam.scissor,
                texture=_texture(alloc.texture_arena, mesh.texture.slot),
                survivor_hook=hook)
    clear = np.broadcast_to(np.asarray(CLEAR_COLOR, np.float64), color.shape)
    color = np.where(covered[..., None],
                     oracle.blend(mesh_state.blend, color, clear), clear)
    u8 = np.clip(np.round(color * 255.0), 0, 255).astype(np.uint8)
    u8[..., 3] = 255
    return u8


def mismatch_fraction(got_u8: np.ndarray, want_u8: np.ndarray) -> float:
    """Share of pixels whose u8 values differ in any channel (the golden
    budget's per-pixel test: any u8 step exceeds its 2e-3 tolerance)."""
    return float((got_u8 != want_u8).any(axis=-1).mean())
