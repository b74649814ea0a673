"""The numpy oracle (``testing/oracle.py``) applied to a whole
recorded scene, for holding the port's frames to the Vulkan raster rules.

``scene_oracle_u8`` rasterizes every camera's draws in submission order,
in f64, from the device's numpy staging arrays, and returns the presented
u8 image.  Two blend semantics:

* ``sequential=True``: every fragment that passes the depth test blends
  over the framebuffer in draw order, as the reference's pipeline does
  (common_pipeline.rs:117-131).  Peel2 is exact against it wherever a
  pixel has at most two surviving fragments;
* ``sequential=False``: the blend is applied once per pixel, to the
  fragment that survives the depth test, as the single-layer visibility
  path does.

Cameras with a DirectionalLight shade Blinn-Phong, with world-space corner
normals (the ``nrm`` staging through each draw's inverse-transpose model
rotation), the light, the inverse view-projection and the eye.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tyleri_tpu_torch.pipeline.state import BlendState
from tyleri_tpu_torch.testing import oracle

CLEAR_COLOR = (0.0, 0.0, 0.0, 0.0)


def _texture(arena, slot: int) -> np.ndarray:
    off, w, h = arena._offsets[slot], arena._widths[slot], arena._heights[slot]
    return np.asarray(arena._texels[off:off + w * h], np.float64).reshape(
        h, w, 4)


def scene_oracle_u8(render_device, render_resources, mesh_state,
                    resolution, *, sequential: bool = False) -> np.ndarray:
    """u8 [H, W, 4] oracle image of one recorded frame (no UI), as
    presented with opaque composite alpha."""
    W, H = resolution
    alloc = render_device.memory_allocator
    pos = alloc.static_vertices_buffer.staging("pos")
    uvs = alloc.static_vertices_buffer.staging("uv")
    nrm = alloc.static_vertices_buffer.staging("nrm")
    idx = alloc.static_indices_buffer.staging("idx")
    color = np.zeros((H, W, 4), np.float64)
    color[:] = CLEAR_COLOR
    depth = np.ones((H, W), np.float64)
    covered = np.zeros((H, W), bool)
    state, hook = mesh_state, None
    if not sequential:
        state = dataclasses.replace(mesh_state, blend=BlendState(enable=False))

        def hook(y0, x0, passed, _frag):
            h, w = passed.shape
            covered[y0:y0 + h, x0:x0 + w] |= passed

    for cam in render_resources.cameras:
        view_proj = (np.asarray(cam.get_projection_matrix(), np.float64)
                     @ np.asarray(cam.view_matrix, np.float64))
        light = getattr(cam, "light", None)
        for mesh in cam.mesh_renderers:
            i = idx[mesh.indices.offset:mesh.indices.offset
                    + mesh.indices.len].astype(np.int64)
            i = i + mesh.vertices.offset
            model = np.asarray(mesh.model, np.float64)
            lit = {}
            if light is not None:
                nm = np.linalg.inv(model[:3, :3]).T
                lit = dict(
                    normals=np.asarray(nrm, np.float64)[i.reshape(-1, 3)]
                    @ nm.T,
                    light=light, inv_vp=np.linalg.inv(view_proj),
                    eye=cam.eye_position())
            oracle.rasterize(
                color, depth, oracle.make_mesh_clip(pos, i, view_proj @ model),
                uvs[i.reshape(-1, 3)], state, cam.viewport, cam.scissor,
                texture=_texture(alloc.texture_arena, mesh.texture.slot),
                survivor_hook=hook, **lit)
    if not sequential:
        clear = np.broadcast_to(np.asarray(CLEAR_COLOR, np.float64),
                                color.shape)
        color = np.where(covered[..., None],
                         oracle.blend(mesh_state.blend, color, clear), clear)
    u8 = np.clip(np.round(color * 255.0), 0, 255).astype(np.uint8)
    u8[..., 3] = 255
    return u8


def mismatch_fraction(got_u8: np.ndarray, want_u8: np.ndarray,
                      tol: int = 0) -> float:
    """Share of pixels where any u8 channel differs by more than ``tol``
    (0: the golden budget's per-pixel test, whose 2e-3 tolerance is below
    one u8 step; 1: more than 1 u8 off, the lit golden tolerance of 6e-3
    and the blend-deviation measure)."""
    d = np.abs(got_u8.astype(np.int16) - want_u8.astype(np.int16))
    return float((d > tol).any(axis=-1).mean())
