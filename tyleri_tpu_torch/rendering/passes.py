"""The mesh pass: setup -> near clip -> binning -> visibility -> shade
(counterpart of ``tyleri_tpu/rendering/passes.py``).

Two entries, as in the JAX package:

* ``mesh_pass_fused`` (unlit frames): the K1+K2 kernel sets up every
  triangle and flags near-plane crossers; with near clipping on, only the
  flagged rows are re-transformed, clipped and set up again in PyTorch and
  spliced back (``_fused_clip_subset``);
* ``mesh_pass`` (lit frames): clip-space triangles from the per-frame
  vertex stage, the near clip or cull with the world normals riding the
  attribute slot, setup in PyTorch, and the normal/w planes as extra rows.

Both then bin, resolve visibility and shade.  The K3 kernel resolves the
depth states it supports (test and write with LESS or LESS_OR_EQUAL); every
other state takes the reference's last-passing resolve
(``ops/visibility.py::rasterize_visibility_last_passing``), chosen from the
pipeline state before anything launches.  With ``RasterPlan.peel2`` K3
also returns layer 2, the depth-record holder just before each pixel's
winner drew, which is shaded into the framebuffer first, then the winner
over it: the last two steps of the reference's per-fragment blend chain.

Exact mode (``RasterPlan.exact``) draws ``mesh_pass``'s triangles one by
one through ``ops/raster_exact.py``, as ``ui_pass`` draws the UI overlay.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from tyleri_tpu_torch.pipeline.state import PipelineState
from tyleri_tpu_torch.ops.binning import bin_triangles
from tyleri_tpu_torch.ops.clip import (
    clip_work_set,
    compact_slots,
    near_clip_triangles,
    near_cull_triangles,
)
from tyleri_tpu_torch.ops.raster_cuda import rasterize_visibility
from tyleri_tpu_torch.ops.raster_exact import rasterize_exact
from tyleri_tpu_torch.ops.setup import TriangleSetup, setup_triangles
from tyleri_tpu_torch.ops.setup_cuda import fused_setup
from tyleri_tpu_torch.ops.shade import shade_visibility
from tyleri_tpu_torch.ops.visibility import (
    k3_supports,
    rasterize_visibility_last_passing,
)
from tyleri_tpu_torch.utils.profiling import span


def _cdiv(a, b):
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class RasterPlan:
    """Static capacities and shapes of the raster pipeline.  Capacities are
    plan parameters; overflow is reported, and the frame loop re-plans
    (rendering/forward.py)."""

    fb_w: int
    fb_h: int
    tile_w: int = 16           # powers of two: setup shifts by them
    tile_h: int = 16
    entry_cap: int = 1 << 16
    max_tiles_per_tri: int = 32
    broad_cap: int = 64
    chunk: int = 64            # entry rows K3 stages in shared memory
    clip_cap: int = 256        # extra rows for near-plane splits
    spill_cap: int = 1 << 16   # binning's spill list (tiles 2.. of a tri)
    spill_level_caps: tuple = ()  # learned per-level cap fit
    valid_cap: int = 0         # dense slots for live narrow triangles
    near_clip: bool = True     # False: cull crossers and report them
    peel2: bool = False        # two-layer blend (K3 carries layer 2)
    exact: bool = False        # ordered per-fragment drawing (parity mode)
    # sampler anisotropy: above 1, the deferred shade takes this many
    # bilinear taps along each pixel's footprint (exact mode stays bilinear)
    aniso_taps: int = 0

    @property
    def grid_w(self) -> int:
        return _cdiv(self.fb_w, self.tile_w)

    @property
    def grid_h(self) -> int:
        return _cdiv(self.fb_h, self.tile_h)

    @staticmethod
    def for_scene(fb_w: int, fb_h: int, tri_capacity: int, **kw
                  ) -> "RasterPlan":
        return RasterPlan(fb_w=fb_w, fb_h=fb_h,
                          entry_cap=max(1024, 2 * tri_capacity), **kw)


def setup_dims(plan: RasterPlan) -> dict:
    return dict(tile_w=plan.tile_w, tile_h=plan.tile_h,
                grid_w=plan.grid_w, grid_h=plan.grid_h)


class PassStats(NamedTuple):
    """Per-pass validation counters (i32 device scalars)."""

    bin_overflow: torch.Tensor    # entries dropped in binning
    tile_overflow: torch.Tensor   # always 0: tiles stream whole segments
    clip_overflow: torch.Tensor   # near-plane crossers beyond clip_cap
    clip_crossings: torch.Tensor  # near-plane crossings observed
    bin_demand: torch.Tensor      # live narrow triangles (pre-cap)
    entry_demand: torch.Tensor    # live placed entries
    spill_demand: torch.Tensor    # i32 [L] per-spill-level demand


def _fused_clip_subset(su, crossed, clip_tables, mvps, viewport, scissor,
                       state: PipelineState, clip_cap: int, dims):
    """Hybrid near clip: re-run transform -> clip -> setup for the rows the
    kernel flagged as crossers and splice them into its table.  The
    rewritten half overwrites the parent row, the quad's second half goes
    to one of ``clip_cap`` appended rows, and both keep the parent's draw
    order.  Crossers beyond ``clip_cap`` stay culled and are reported."""
    corners, tri_draw, tri_tex = clip_tables
    N = su.channels.shape[0]
    X = int(clip_cap)
    src, live, n_cross = compact_slots(crossed, X)
    sub = corners[src]                               # [X, 3, 5]
    tex = torch.where(live, tri_tex[src], torch.full_like(tri_tex[src], -1))
    m = mvps[torch.clamp(tri_draw[src].long(), 0, mvps.shape[0] - 1)]

    # the kernel's multiply-add chain, so the subset's inside/outside
    # decisions agree with its crossing flags bit for bit
    def tform(p):
        x, y, z = p[:, 0], p[:, 1], p[:, 2]
        return torch.stack(
            [((m[:, 4 * j] * x + m[:, 4 * j + 1] * y) + m[:, 4 * j + 2] * z)
             + m[:, 4 * j + 3] for j in range(4)], dim=-1)

    cr0 = torch.stack([tform(sub[:, k, :3]) for k in range(3)], dim=1)
    main_c, main_u, extra_c, extra_u, nin = clip_work_set(cr0, sub[..., 3:5])
    order = src.to(torch.int32)
    su_sub = setup_triangles(
        torch.cat([main_c, extra_c]), torch.cat([main_u, extra_u]),
        torch.cat([tex, tex]),
        torch.cat([live & (nin > 0), live & (nin == 2)]),
        viewport, scissor, order=torch.cat([order, order]),
        cull_mode=state.raster.cull_mode, front_face=state.raster.front_face,
        **dims)

    # splice: live slots overwrite their parent row, extras append; dead
    # slots write to one scratch row past the end, which is cut off
    rows = torch.where(live, src, torch.full_like(src, N + X))

    def splice(table, sub_table):
        out = torch.cat([table, sub_table[X:], sub_table[:1]])
        out[rows] = sub_table[:X]
        return out[:N + X]

    su = TriangleSetup(
        valid=splice(su.valid, su_sub.valid),
        channels=splice(su.channels, su_sub.channels),
        tile_lo=splice(su.tile_lo, su_sub.tile_lo),
        tile_hi=splice(su.tile_hi, su_sub.tile_hi),
    )
    return su, torch.clamp(n_cross - X, min=0).to(torch.int32)


def mesh_pass_fused(plan: RasterPlan, state: PipelineState, color, depth,
                    corners, tri_draw, tri_tex, tri_valid, mvps, cam_valid,
                    viewport, scissor, texels, tex_offset, tex_width,
                    tex_height, draw_mod=None):
    """One camera's mesh pass.  corners f32 [T, 3, 5] (cached table),
    tri_draw/tri_tex i32 [T], tri_valid bool [T], mvps f32 [D, 16];
    viewport/scissor on the host; ``draw_mod`` = (n, i) draws only the
    triangles whose draw % n == i (a mesh device's share).  Returns (color,
    depth, PassStats, order_map)."""
    dims = setup_dims(plan)
    # the kernel masks before it flags crossers, so the re-clip below sees
    # only this device's crossers and needs no mask of its own
    with span("setup"):
        su, crossings, crossed = fused_setup(
            corners, tri_draw, tri_tex, tri_valid, mvps, cam_valid, viewport,
            scissor, cull_mode=state.raster.cull_mode,
            front_face=state.raster.front_face, draw_mod=draw_mod, **dims)
    if not plan.near_clip:
        # cull mode: crossers were dropped and counted (crossings), which
        # re-enables clipping for the next frame
        clip_overflow = torch.zeros_like(crossings)
    elif plan.clip_cap > 0:
        with span("clip"):
            su, clip_overflow = _fused_clip_subset(
                su, crossed, (corners, tri_draw, tri_tex), mvps, viewport,
                scissor, state, plan.clip_cap, dims)
    else:
        clip_overflow = crossings   # no split rows: every crosser is lost
    return _raster_binned(plan, state, color, depth, su, scissor, texels,
                          tex_offset, tex_width, tex_height,
                          clip_overflow=clip_overflow,
                          clip_crossings=crossings)


def mesh_pass(plan: RasterPlan, state: PipelineState, color, depth, clip,
              uv, tex_id, tri_valid, viewport, scissor, texels, tex_offset,
              tex_width, tex_height, normals=None, lit_params=None):
    """One camera's mesh pass from clip-space triangles (lit frames and
    exact mode).  clip f32 [T, 3, 4], uv f32 [T, 3, 2], tex_id i32 [T],
    tri_valid bool [T]; normals f32 [T, 3, 3] world-space corner normals
    and lit_params = (light [12], inv_vp [4, 4], eye [3]) on the host.
    Returns (color, depth, PassStats, order_map); the order map is None in
    exact mode, which has no visibility buffer."""
    lit = normals is not None and lit_params is not None
    if lit and plan.exact:
        raise NotImplementedError(
            "lit shading is a visibility-path feature; exact mode renders "
            "unlit (the reference's fragment path)")
    # normals ride the uv slot through the near clip (its rotate/lerp is
    # shape-agnostic on the attribute axis)
    attrs = torch.cat([uv, normals], dim=-1) if lit else uv
    clip_fn = near_clip_triangles if plan.near_clip else near_cull_triangles
    with span("clip"):
        ct = clip_fn(clip, attrs, tex_id, tri_valid, extra_cap=plan.clip_cap)
    if plan.exact:
        with span("raster"):
            color, depth = rasterize_exact(
                color, depth, ct.clip, ct.uv, ct.tex_id, ct.valid, viewport,
                scissor, texels, tex_offset, tex_width, tex_height,
                state=state, order=ct.order)
        zero = torch.zeros((), dtype=torch.int32, device=color.device)
        return (color, depth,
                PassStats(zero, zero, ct.overflow, ct.crossings, zero, zero,
                          torch.zeros((0,), dtype=torch.int32,
                                      device=color.device)),
                None)
    dims = setup_dims(plan)
    with span("setup"):
        su = setup_triangles(ct.clip, ct.uv[..., :2], ct.tex_id, ct.valid,
                             viewport, scissor, order=ct.order,
                             cull_mode=state.raster.cull_mode,
                             front_face=state.raster.front_face, **dims)
    extra = None
    if lit:
        # world-normal/w planes per (post-clip) triangle: plane-evaluating
        # n_k / w, then multiplying by w per pixel, is the perspective-
        # correct normal interpolation (Vulkan 27.7)
        w = ct.clip[..., 3]
        iw = torch.where(torch.abs(w) > 1e-12, 1.0 / w, torch.zeros_like(w))
        nw_iw = ct.uv[..., 2:5] * iw[..., None]          # [T, 3 corners, 3]
        lam = su.lam                                     # [T, 3 corners, 3]
        planes = torch.stack([
            (nw_iw[:, 0, k, None] * lam[:, 0] + nw_iw[:, 1, k, None]
             * lam[:, 1]) + nw_iw[:, 2, k, None] * lam[:, 2]
            for k in range(3)], dim=1)                   # [T, 3, 3]
        extra = torch.cat([planes.reshape(-1, 9),
                           planes.new_zeros((planes.shape[0], 3))], dim=1)
    return _raster_binned(plan, state, color, depth, su, scissor, texels,
                          tex_offset, tex_width, tex_height,
                          clip_overflow=ct.overflow,
                          clip_crossings=ct.crossings, extra=extra,
                          lit_params=lit_params if lit else None,
                          viewport=viewport)


def _raster_binned(plan: RasterPlan, state: PipelineState, color, depth, su,
                   scissor, texels, tex_offset, tex_width, tex_height, *,
                   clip_overflow, clip_crossings, extra=None,
                   lit_params=None, viewport=None):
    binned = bin_triangles(
        su, extra, grid_w=plan.grid_w, grid_h=plan.grid_h,
        entry_cap=plan.entry_cap, max_tiles_per_tri=plan.max_tiles_per_tri,
        broad_cap=plan.broad_cap, spill_cap=plan.spill_cap,
        valid_cap=plan.valid_cap, spill_level_caps=plan.spill_level_caps)
    kw = dict(fb_w=plan.fb_w, fb_h=plan.fb_h, depth_state=state.depth,
              **setup_dims(plan))
    # the resolve follows the depth state (the reference's _use_pallas,
    # passes.py:170-196); peel2 is K3's, off on the other route
    k3 = k3_supports(state.depth)
    peel2 = plan.peel2 and k3
    with span("raster"):
        if k3:
            vis = rasterize_visibility(binned, depth, scissor,
                                       chunk=plan.chunk, peel2=peel2, **kw)
        else:
            vis = rasterize_visibility_last_passing(binned, depth, scissor,
                                                    **kw)
    layers = list(vis) if peel2 else [vis]   # (vis, vis2)
    vis = layers[0]
    lit = None
    if lit_params is not None:
        light, inv_vp, eye = lit_params
        nw_planes = torch.cat([binned.entry_extra, binned.broad_extra])
        lit = (nw_planes, light, inv_vp, eye, viewport)
    # layer 2 blends into the incoming framebuffer first, the winner over it
    for layer in reversed(layers):
        with span("shade"):
            color = shade_visibility(layer, texels, tex_offset, tex_width,
                                     tex_height, state.blend, color, lit=lit,
                                     aniso_taps=plan.aniso_taps)
    pass_order = torch.where(vis.owner >= 0, vis.order,
                             torch.full_like(vis.order, -1.0))
    stats = PassStats(binned.overflow, torch.zeros_like(binned.overflow),
                      clip_overflow, clip_crossings, binned.dense_demand,
                      binned.num_entries, binned.level_demand)
    return color, vis.depth, stats, pass_order


def ui_pass(state: PipelineState, color, depth, ui_clip, ui_uv, ui_color,
            ui_tex, ui_valid, viewport, scissor, texels, tex_offset,
            tex_width, tex_height):
    """The UI overlay: ordered exact rasterization with vertex colors.
    ui_clip f32 [U, 3, 4], ui_uv f32 [U, 3, 2], ui_color f32 [U, 3, 4],
    ui_tex i32 [U], ui_valid bool [U].  Returns (color, depth).

    The reference records the UI before any mesh, with depth test and
    write at z = 0 (ref: forward_rendering/mod.rs:291-296, ui.vert:16-18),
    so UI pixels occlude the mesh fragments behind them.  The caller skips
    the pass when the frame has no UI (FramePlan.has_ui)."""
    return rasterize_exact(
        color, depth, ui_clip, ui_uv, ui_tex, ui_valid, viewport, scissor,
        texels, tex_offset, tex_width, tex_height, state=state,
        with_vertex_color=True, vertex_color=ui_color,
        # UI quads are small: tight windows bound each one's cost
        window=64)


def ui_points_to_clip(ui_pos_points, screen_size_points):
    """The UI vertex shader (ref: src/pipeline/glsl/ui.vert:16-18):
    clip = (2 p / screen_size - 1, 0, 1); [..., 2] points -> [..., 4]."""
    p = torch.as_tensor(ui_pos_points, dtype=torch.float32)
    sw, sh = (float(v) for v in screen_size_points)
    x = 2.0 * p[..., 0] / sw - 1.0
    y = 2.0 * p[..., 1] / sh - 1.0
    return torch.stack([x, y, torch.zeros_like(x), torch.ones_like(x)],
                       dim=-1)
