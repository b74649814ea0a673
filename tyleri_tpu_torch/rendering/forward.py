"""ForwardRenderingFunction — the forward render path (counterpart of
``tyleri_tpu/rendering/forward.py``; ref:
src/rendering_function/forward_rendering/mod.rs).

Per frame: clear (color [0,0,0,0], depth 1.0 — mod.rs:218-229), then one
mesh pass per camera (rendering/passes.py): unlit frames take the fused
setup kernel (``mesh_pass_fused``), lit frames (a camera with a
DirectionalLight) the clip-space path with world normals (``mesh_pass``).
Capacities are plan values that grow on reported overflow and shrink to
fitted demand after clean frames (``note_overflow``).  Eager PyTorch has
no compile step, so a plan change costs nothing beyond the next frame's
allocations.

The blend-parity policy (``_apply_blend_parity``) turns on the two-layer
blend (peel2) for blending scenes of at most BLEND_PARITY_PEEL2_MAX_TRIS
triangles, as the JAX package does wherever its kernel runs.

Not ported yet (each raises NotImplementedError): the UI overlay, exact
mode, anisotropic sampling and multi-device rendering.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tyleri_tpu_torch.device import debug
from tyleri_tpu_torch.pipeline.common_pipeline import CommonPipeline
from tyleri_tpu_torch.ops.binning import spill_rows
from tyleri_tpu_torch.ops.setup import (
    build_triangle_table,
    transform_corner_table,
)
from tyleri_tpu_torch.ops.visibility import k3_supports
from tyleri_tpu_torch.rendering.function import Frame
from tyleri_tpu_torch.rendering.passes import (
    RasterPlan,
    mesh_pass,
    mesh_pass_fused,
)
from tyleri_tpu_torch.resource.arenas import geometry_tensors
from tyleri_tpu_torch.resource.textures import texture_tensors

CLEAR_COLOR = (0.0, 0.0, 0.0, 0.0)  # ref: mod.rs:218-223
CLEAR_DEPTH = 1.0                   # ref: mod.rs:224-229
_GRANULE = 1 << 16

# "auto" blend policy: above this many triangles the single-survivor blend
# ships and the deviation is reported (the JAX package's threshold: at
# config-5 scale two layers still leave many pixels off).
BLEND_PARITY_PEEL2_MAX_TRIS = 1 << 18


def _next_pow2(n: int, floor: int) -> int:
    v = floor
    while v < n:
        v *= 2
    return v


def _cap_growth(n: int, granule: int, floor: int) -> int:
    """Monotone growth: pow2 below ``granule``, then granule steps."""
    if n <= granule:
        return _next_pow2(n, floor)
    return max(floor, -(-n // granule) * granule)


def _fit(demand: int, mult: float, granule: int) -> int:
    return -(-int(demand * mult) // granule) * granule


@dataclasses.dataclass(frozen=True)
class FramePlan:
    """Capacities of one frame."""

    raster: RasterPlan
    cam_cap: int = 1
    draw_cap: int = 16
    tri_cap: int = 1 << 12
    lit: bool = False   # Blinn-Phong: some camera has a DirectionalLight


def quantize_unorm8(color: torch.Tensor, opaque: bool) -> torch.Tensor:
    """UNORM8 presentation store, round half to even; OPAQUE forces alpha
    255 (the mesh pipeline writes alpha 0)."""
    u8 = torch.clamp(torch.round(color * 255.0), 0, 255).to(torch.uint8)
    if opaque:
        u8[..., 3] = 255
    return u8


def world_normals(corner_nrm, tri_draw, models):
    """World-space corner normals [T, 3, 3]: corner_nrm [T, 3, 3] through
    the inverse-transpose of each draw's model rotation (models f32
    [D, 4, 4]), computed in f32 on the device."""
    nm = torch.linalg.inv_ex(models[:, :3, :3]).inverse   # [D, 3, 3]
    m = nm[tri_draw.long()][:, None]                      # [T, 1, 3, 3]
    # (nm^T n)_j = sum_k n_k nm[k, j], as f32 products and sums
    return torch.stack([
        (corner_nrm[..., 0] * m[..., 0, j] + corner_nrm[..., 1] * m[..., 1, j])
        + corner_nrm[..., 2] * m[..., 2, j] for j in range(3)], dim=-1)


def frame_body(plan: FramePlan, mesh_state, texels, tex_offset, tex_width,
               tex_height, clear_color, cam_valid, viewports, scissors, mvps,
               corners, tri_draw, tri_valid0, tri_tex, corner_nrm=None,
               models=None, lights=None, inv_vps=None, eyes=None) -> Frame:
    """One frame: clear -> one mesh pass per live camera.

    cam_valid bool [C], viewports f32 [C, 6] and scissors i32 [C, 4] are
    host arrays; mvps f32 [C, D, 16] and the cached triangle tables
    (corners [C, T, 3, 5], tri_draw/tri_tex i32 [C, T], tri_valid0 bool
    [C, T]) live on the device.  Lit frames add the corner normals
    [C, T, 3, 3] and the models f32 [C, D, 4, 4] on the device, and the
    lights f32 [C, 12], inverse view-projections [C, 4, 4] and eyes [C, 3]
    on the host."""
    dev = corners.device
    H, W = plan.raster.fb_h, plan.raster.fb_w
    color = torch.empty((H, W, 4), dtype=torch.float32, device=dev)
    for i, c in enumerate(clear_color):   # fills: no host->device copy
        color[..., i] = c
    depth = torch.full((H, W), CLEAR_DEPTH, dtype=torch.float32, device=dev)
    order = torch.full((H, W), -1.0, dtype=torch.float32, device=dev)
    # camera-pass order stride: pass orders are table rows in
    # [0, tri_cap + clip_cap)
    span = float(plan.tri_cap + plan.raster.clip_cap + 1)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    bin_of = tile_of = clip_of = clip_x = bin_dem = entry_dem = zero
    spill_dem = None
    for c in range(plan.cam_cap):
        if not cam_valid[c]:
            continue
        if plan.lit:
            clip, uv = transform_corner_table(corners[c], tri_draw[c],
                                              mvps[c])
            color, depth, st, pass_order = mesh_pass(
                plan.raster, mesh_state, color, depth, clip, uv, tri_tex[c],
                tri_valid0[c], viewports[c], scissors[c], texels, tex_offset,
                tex_width, tex_height,
                normals=world_normals(corner_nrm[c], tri_draw[c], models[c]),
                lit_params=(lights[c], inv_vps[c], eyes[c]))
        else:
            color, depth, st, pass_order = mesh_pass_fused(
                plan.raster, mesh_state, color, depth, corners[c],
                tri_draw[c], tri_tex[c], tri_valid0[c], mvps[c], True,
                viewports[c], scissors[c], texels, tex_offset, tex_width,
                tex_height)
        order = torch.where(pass_order >= 0.0, c * span + pass_order + 1.0,
                            order)
        bin_of = bin_of + st.bin_overflow
        tile_of = tile_of + st.tile_overflow
        clip_of = clip_of + st.clip_overflow
        clip_x = clip_x + st.clip_crossings
        bin_dem = torch.maximum(bin_dem, st.bin_demand)
        entry_dem = torch.maximum(entry_dem, st.entry_demand)
        spill_dem = (st.spill_demand if spill_dem is None
                     else torch.maximum(spill_dem, st.spill_demand))
    if spill_dem is None:
        spill_dem = torch.zeros((0,), dtype=torch.int32, device=dev)
    return Frame(color=color, depth=depth, bin_overflow=bin_of,
                 tile_overflow=tile_of, order=order, clip_overflow=clip_of,
                 clip_crossings=clip_x, bin_demand=bin_dem,
                 entry_demand=entry_dem, spill_demand=spill_dem)


class ForwardRenderingFunction:
    """The only RenderingFunction, as in the reference (mod.rs:46-50)."""

    def __init__(self, render_device, swapchain, *, exact: bool = False,
                 blend_parity: str = "auto"):
        if blend_parity not in ("auto", "fast", "peel2", "exact"):
            raise ValueError(f"unsupported blend_parity {blend_parity!r}")
        if exact or blend_parity == "exact":
            raise NotImplementedError(
                "exact mode (ordered per-fragment rasterization) is not "
                "ported yet")
        self.render_device = render_device
        self.blend_parity = blend_parity
        self._blend_parity_warned = False
        w, h = swapchain.resolution
        state = CommonPipeline().state
        self.mesh_state = dataclasses.replace(
            state, depth=dataclasses.replace(
                state.depth, format=render_device.depth_format))
        raster = RasterPlan.for_scene(w, h, 1 << 12)
        if blend_parity == "peel2":
            raster = dataclasses.replace(raster, peel2=True)
        self.plan = FramePlan(raster=raster)
        # capacity feedback (the JAX package's discipline): spill headroom
        # doubles on bin overflow; the near clip turns off after a
        # crossing-free streak and back on at the first crossing (with
        # exponential backoff); valid_cap and the entry / spill-level fits
        # shrink to 1.25x demand after clean frames (stage 1) and to 1.10x
        # after a streak tighten_mult times longer (stage 2); any bin
        # overflow resets the fits and doubles their thresholds
        self._spill_headroom = 0.2
        self._clip_clean_frames = 0
        self._clip_disable_after = 16
        self._valid_demand = 0
        self._valid_clean_frames = 0
        self._valid_shrink_after = 4
        self._entry_demand = 0
        self._entry_clean_frames = 0
        self._entry_shrink_after = 4
        self._entry_fit = 0
        self._entry_tighten_mult = 4
        self._fit_stage = 0        # 0 learning, 1 at 1.25x, 2 at 1.10x
        self._spill_demand = None  # np [L] elementwise max
        self._spill_fit = ()
        self._tri_table_cache = None

    def resize(self, resolution) -> None:
        """Re-target to a new framebuffer size; learned capacities stay."""
        w, h = resolution
        self.plan = dataclasses.replace(
            self.plan, raster=dataclasses.replace(
                self.plan.raster, fb_w=int(w), fb_h=int(h)))

    def _apply_blend_parity(self, raster: RasterPlan, n_tris: int
                            ) -> RasterPlan:
        """The reference blends every overlapping mesh fragment in
        submission order (common_pipeline.rs:117-131); the visibility path
        blends the final survivor, and peel2 also the survivor before it
        (exact wherever a pixel has at most two).  "auto" engages peel2 up
        to BLEND_PARITY_PEEL2_MAX_TRIS triangles, where K3 supports the
        depth state; above it, or pinned "fast", the single layer ships
        and the deviation is reported once.  "peel2" pins it on."""
        if self.blend_parity == "peel2" or not self.mesh_state.blend.enable:
            return raster
        effective = (self.blend_parity == "auto"
                     and n_tris <= BLEND_PARITY_PEEL2_MAX_TRIS
                     and k3_supports(self.mesh_state.depth))
        if not effective and not self._blend_parity_warned:
            self._blend_parity_warned = True
            self.render_device.debug_messenger.emit(
                debug.Severity.WARNING,
                "blend-order-deviation",
                "order-dependent color blend on the visibility path: only "
                "the final visible fragment is blended; overlapping "
                "fragments that each pass the depth test would accumulate "
                "differently (peel2 adds two-layer sequential blending; "
                "exact mode, not ported yet, gives full per-fragment "
                "parity)",
                debug.MessageType.PERFORMANCE,
            )
        return dataclasses.replace(raster, peel2=effective)

    def _grow_plan(self, n_cams: int, n_draws: int, n_tris: int,
                   lit: bool) -> None:
        p = self.plan
        tri_cap = _cap_growth(n_tris, _GRANULE, p.tri_cap)
        spill_cap = _cap_growth(int(self._spill_headroom * n_tris), _GRANULE,
                                p.raster.spill_cap)
        grew = tri_cap > p.tri_cap
        # new geometry invalidates every learned fit
        valid_cap = 0 if grew else p.raster.valid_cap
        if grew:
            self._entry_fit = 0
            self._entry_demand = 0
            self._entry_clean_frames = 0
            self._fit_stage = 0
            self._spill_fit = ()
            self._spill_demand = None
        vbase = tri_cap + p.raster.clip_cap
        if valid_cap:
            vbase = min(valid_cap, vbase)
        entry_cap = vbase + spill_rows(spill_cap, p.raster.max_tiles_per_tri,
                                       self._spill_fit)
        if self._entry_fit:
            # dead rows sort last: a fit that truncates live entries is
            # reported as bin overflow, which resets it
            entry_cap = min(entry_cap, max(self._entry_fit, _GRANULE))
        raster = dataclasses.replace(
            p.raster, entry_cap=entry_cap, spill_cap=spill_cap,
            valid_cap=valid_cap, spill_level_caps=self._spill_fit)
        raster = self._apply_blend_parity(raster, n_tris)
        new = FramePlan(raster=raster, cam_cap=max(n_cams, p.cam_cap),
                        draw_cap=_next_pow2(n_draws, p.draw_cap),
                        tri_cap=tri_cap, lit=lit)
        if new != p:
            self.plan = new

    def note_overflow(self, bin_overflow: int, tile_overflow: int,
                      clip_overflow: int = 0, clip_crossings: int = 0,
                      bin_demand: int = 0, entry_demand: int = 0,
                      spill_demand=None, n_frames: int = 1) -> None:
        """Occupancy feedback from the frame loop; ``n_frames`` is how many
        frames the (aggregated) report covers."""
        n_frames = max(1, int(n_frames))
        if bin_overflow > 0:
            # the counter conflates valid_cap, spill-level and broad-list
            # truncation: grow or reset all three
            self._spill_headroom = min(self._spill_headroom * 2.0, 6.0)
            if self.plan.raster.valid_cap:
                self._valid_shrink_after = min(self._valid_shrink_after * 2,
                                               512)
            self._valid_demand = 0
            self._valid_clean_frames = 0
            if self._entry_fit or self._spill_fit:
                self._entry_shrink_after = min(self._entry_shrink_after * 2,
                                               512)
            self._entry_fit = 0
            self._entry_demand = 0
            self._entry_clean_frames = 0
            self._fit_stage = 0
            self._spill_fit = ()
            self._spill_demand = None
            r = self.plan.raster
            # the broad list is in device memory (no ceiling but the table)
            broad_cap = min(r.broad_cap * 4,
                            max(self.plan.tri_cap + r.clip_cap, r.broad_cap))
            self.plan = dataclasses.replace(
                self.plan, raster=dataclasses.replace(
                    r, broad_cap=broad_cap, valid_cap=0))
        elif bin_demand > 0:
            self._valid_demand = max(self._valid_demand, int(bin_demand))
            self._valid_clean_frames += n_frames
            p = self.plan
            if (self._valid_clean_frames >= self._valid_shrink_after
                    and not p.raster.valid_cap):
                cand = _fit(self._valid_demand, 1.25, _GRANULE)
                if cand <= p.tri_cap + p.raster.clip_cap - _GRANULE:
                    self.plan = dataclasses.replace(
                        p, raster=dataclasses.replace(p.raster,
                                                      valid_cap=cand))
        if bin_overflow <= 0 and entry_demand > 0:
            # demands from overflowing frames are undercounts: never learned
            self._entry_demand = max(self._entry_demand, int(entry_demand))
            if spill_demand is not None and len(spill_demand):
                d = np.asarray(spill_demand, dtype=np.int64)
                self._spill_demand = (d if self._spill_demand is None
                                      else np.maximum(self._spill_demand, d))
            self._entry_clean_frames += n_frames
            if (self._fit_stage == 0
                    and self._entry_clean_frames >= self._entry_shrink_after):
                self._fit_stage = 1
                cand = _fit(self._entry_demand, 1.25, _GRANULE)
                if cand <= self.plan.raster.entry_cap - _GRANULE:
                    self._entry_fit = cand
                if self._spill_demand is not None:
                    self._spill_fit = tuple(
                        max(_fit(d, 1.25, 512), 512)
                        for d in self._spill_demand)
            elif (self._fit_stage == 1 and self._entry_tighten_mult
                  and self._entry_clean_frames
                  >= self._entry_tighten_mult * self._entry_shrink_after):
                # stage 2 applies even when stage 1 found no room to fit
                self._fit_stage = 2
                cand = _fit(self._entry_demand, 1.10, _GRANULE)
                if cand < (self._entry_fit or self.plan.raster.entry_cap):
                    self._entry_fit = cand
                if self._spill_demand is not None:
                    self._spill_fit = tuple(
                        max(_fit(d, 1.10, 512), 512)
                        for d in self._spill_demand)
        p = self.plan
        if clip_overflow > 0 and p.raster.near_clip:
            new_cap = min(max(p.raster.clip_cap * 4,
                              _next_pow2(p.raster.clip_cap + clip_overflow,
                                         256)),
                          _next_pow2(p.tri_cap, 256))
            self.plan = dataclasses.replace(
                p, raster=dataclasses.replace(p.raster, clip_cap=new_cap))
        elif not p.raster.near_clip and (clip_overflow > 0
                                         or clip_crossings > 0):
            # cull mode saw crossings: clip again from the next frame and
            # back off the disable threshold
            self.plan = dataclasses.replace(
                p, raster=dataclasses.replace(p.raster, near_clip=True))
            self._clip_disable_after = min(
                max(self._clip_disable_after, 1) * 4, 512)
            self._clip_clean_frames = 0
        # clip skip: after a crossing-free streak, cull instead of clip
        if self.plan.raster.near_clip and self._clip_disable_after > 0:
            if clip_crossings == 0 and clip_overflow == 0:
                self._clip_clean_frames += n_frames
                if self._clip_clean_frames >= self._clip_disable_after:
                    self.plan = dataclasses.replace(
                        self.plan, raster=dataclasses.replace(
                            self.plan.raster, near_clip=False))
                    self._clip_clean_frames = 0
            else:
                self._clip_clean_frames = 0

    def record(self, render_device, render_resources, scale_factor,
               window_size) -> Frame:
        """Record one frame; the returned tensors are still computing."""
        inputs = self.build_frame_inputs(render_device, render_resources,
                                         scale_factor, window_size)
        return frame_body(self.plan, self.mesh_state, *inputs)

    def build_frame_inputs(self, render_device, render_resources,
                           scale_factor, window_size):
        """Grow the plan, then assemble the frame's inputs: host arrays for
        per-camera state, device tensors for textures, MVPs and the cached
        triangle tables; for lit frames also the models (device), the
        lights, inverse view-projections and eyes (host)."""
        if render_resources.ui and render_resources.ui_indices.len > 0:
            raise NotImplementedError("the UI overlay is not ported yet")
        cams = render_resources.cameras
        lit = any(getattr(c, "light", None) is not None for c in cams)
        n_draws = max((len(c.mesh_renderers) for c in cams), default=0)
        n_tris = max((sum(m.triangle_count for m in c.mesh_renderers)
                      for c in cams), default=0)
        self._grow_plan(max(len(cams), 1), max(n_draws, 1), max(n_tris, 1),
                        lit)
        plan = self.plan
        dev = render_device.device
        texels, toff, tw, th = texture_tensors(
            render_device.memory_allocator.texture_arena, dev)

        C, D = plan.cam_cap, plan.draw_cap
        cam_valid = np.zeros((C,), bool)
        viewports = np.zeros((C, 6), np.float32)
        viewports[:, 2:4] = 1.0
        scissors = np.zeros((C, 4), np.int32)
        mvps = np.tile(np.eye(4, dtype=np.float32).reshape(16), (C, D, 1))
        models = np.tile(np.eye(4, dtype=np.float32), (C, D, 1, 1))
        lights = np.zeros((C, 12), np.float32)
        inv_vps = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
        eyes = np.zeros((C, 3), np.float32)
        cam_sigs = []
        for ci, cam in enumerate(cams):
            cam_valid[ci] = True
            vp = cam.viewport
            viewports[ci] = [vp.x, vp.y, vp.width, vp.height, vp.min_depth,
                             vp.max_depth]
            sc = cam.scissor
            scissors[ci] = [sc.x, sc.y, sc.width, sc.height]
            view_proj = np.zeros((4, 4), np.float32)
            view_proj[:] = cam.get_projection_matrix() @ cam.view_matrix
            if plan.lit:
                if cam.light is not None:
                    lights[ci] = cam.light.as_array()
                inv_vps[ci] = np.linalg.inv(
                    view_proj.astype(np.float64)).astype(np.float32)
                eyes[ci] = cam.eye_position()
            for di, mesh in enumerate(cam.mesh_renderers):
                models[ci, di] = mesh.model
                mvps[ci, di] = (view_proj.astype(np.float64)
                                @ np.asarray(mesh.model, np.float64)
                                ).astype(np.float32).reshape(16)
            cam_sigs.append(tuple(
                (m.indices.offset, m.indices.len, m.vertices.offset,
                 m.texture.slot) for m in cam.mesh_renderers))
        tables = self._triangle_tables(render_device, cams, cam_sigs, plan)

        def upload(a):
            t = torch.from_numpy(a)
            if dev.type == "cuda":
                # pinned, so the upload is queued without waiting on the
                # stream
                t = t.pin_memory()
            return t.to(dev, non_blocking=True)

        return (texels, toff, tw, th, CLEAR_COLOR, cam_valid, viewports,
                scissors, upload(mvps), *tables,
                upload(models) if plan.lit else None, lights, inv_vps, eyes)

    def _triangle_tables(self, render_device, cams, cam_sigs, plan):
        """Per-camera triangle tables [C, T, ...] (corners, draw, valid,
        tex, and the corner normals on lit frames, else None), rebuilt only
        when a draw list or the geometry arenas change."""
        alloc = render_device.memory_allocator
        key = (plan.cam_cap, plan.draw_cap, plan.tri_cap, plan.lit,
               tuple(cam_sigs),
               alloc.static_vertices_buffer.version,
               alloc.static_indices_buffer.version)
        cached = self._tri_table_cache
        if cached is not None and cached[0] == key:
            return cached[1]
        dev = render_device.device
        positions, uvs, normals, indices = geometry_tensors(alloc, dev)
        C, D, Tcap = plan.cam_cap, plan.draw_cap, plan.tri_cap
        per_cam = []
        for ci in range(C):
            meshes = cams[ci].mesh_renderers if ci < len(cams) else []
            first_index = np.zeros((D,), np.int64)
            vertex_offset = np.zeros((D,), np.int64)
            tri_base = np.zeros((D,), np.int64)
            tri_count = np.zeros((D,), np.int64)
            draw_tex = np.zeros((D,), np.int32)
            base = 0
            for di, mesh in enumerate(meshes):
                first_index[di] = mesh.indices.offset
                vertex_offset[di] = mesh.vertices.offset
                tri_base[di] = base
                tri_count[di] = mesh.triangle_count
                draw_tex[di] = mesh.texture.slot
                base += mesh.triangle_count
            # dead draw slots keep tri_base monotone, so padding triangles
            # map to a zero-count draw
            tri_base[len(meshes):] = base
            t = [torch.as_tensor(a).to(dev) for a in
                 (first_index, vertex_offset, tri_base, tri_count, draw_tex)]
            corner, draw, valid, nrm = build_triangle_table(
                positions, uvs, indices, *t[:4], tri_capacity=Tcap,
                normals=normals if plan.lit else None)
            per_cam.append((corner, draw, valid, t[4][draw.long()], nrm))
        tables = tuple(torch.stack([pc[k] for pc in per_cam]).contiguous()
                       for k in range(4))
        tables += (torch.stack([pc[4] for pc in per_cam]).contiguous()
                   if plan.lit else None,)
        self._tri_table_cache = (key, tables)
        return tables
