"""Exact-order rasterizer (counterpart of ``tyleri_tpu/ops/raster_exact.py``):
triangles drawn one after another in table order, each fragment tested
against the depth buffer as the previous triangles left it and blended over
the framebuffer, so draw-order blending, every compare op and interleaved
depth writes follow Vulkan's per-fragment rules.

The UI overlay draws through it (few, small triangles, with vertex colors)
and so does exact mode, the parity mode of the mesh pass.  On CUDA tensors
the draw is one launch of ``csrc/raster_exact.cu``, which reads setup's
rows on the card and makes no synchronizing read.  On CPU
tensors it is the kernel's plain version, the loop below: a few dozen
PyTorch operations per triangle and raster window, over the live triangles
that one read of their boxes to the host (the ``ui.read`` span) names.

Each triangle is drawn in ``window``-sized pieces of its pixel box.  A
piece at the framebuffer's edge is clamped inside it and then overlaps its
neighbour, so every piece draws only the pixels it owns (its logical
window), or a fragment would blend twice.  Plain tensor slices stand in for
the reference's dynamic slices.  The kernel visits the same pixels of each
triangle, the union of its windows (``_draw_regions``).
"""

from __future__ import annotations

import torch

from tyleri_tpu_torch import _build
from tyleri_tpu_torch.ops import setup as S
from tyleri_tpu_torch.ops.blend import apply_blend, apply_compare
from tyleri_tpu_torch.ops.depth import quantize_depth
from tyleri_tpu_torch.ops.sampling import sample_bilinear
from tyleri_tpu_torch.pipeline.state import (
    BlendFactor,
    BlendOp,
    CompareOp,
    DepthFormat,
    PipelineState,
    lookup,
)
from tyleri_tpu_torch.utils.profiling import count, span

# kernel launches since the last reset (main-path accounting)
launches = 0

# the kernel's codes for the pipeline state (csrc/raster_exact.cu's enums)
_COMPARE = {op: i for i, op in enumerate(
    (CompareOp.NEVER, CompareOp.LESS, CompareOp.EQUAL,
     CompareOp.LESS_OR_EQUAL, CompareOp.GREATER, CompareOp.NOT_EQUAL,
     CompareOp.GREATER_OR_EQUAL, CompareOp.ALWAYS))}
_FACTOR = {f: i for i, f in enumerate(
    (BlendFactor.ZERO, BlendFactor.ONE, BlendFactor.SRC_COLOR,
     BlendFactor.ONE_MINUS_SRC_COLOR, BlendFactor.DST_COLOR,
     BlendFactor.ONE_MINUS_DST_COLOR, BlendFactor.SRC_ALPHA,
     BlendFactor.ONE_MINUS_SRC_ALPHA, BlendFactor.DST_ALPHA,
     BlendFactor.ONE_MINUS_DST_ALPHA))}
_OP = {op: i for i, op in enumerate(
    (BlendOp.ADD, BlendOp.SUBTRACT, BlendOp.REVERSE_SUBTRACT, BlendOp.MIN,
     BlendOp.MAX))}


def reset_launches() -> None:
    global launches
    launches = 0


def _vertex_color_planes(vertex_color, clip, lam):
    """Perspective-correct vertex-color planes [T, 4, 3]: the (A, B, C) of
    each channel's c/w, in a fixed f32 order."""
    vcw = vertex_color * (1.0 / clip[..., 3])[..., None]      # [T, 3, 4]
    return ((vcw[:, 0, :, None] * lam[:, 0, None, :]
             + vcw[:, 1, :, None] * lam[:, 1, None, :])
            + vcw[:, 2, :, None] * lam[:, 2, None, :])


def _draw_regions(su, scissor, W: int, H: int, window: int):
    """i32 [T, 4]: for each triangle the pixels the loop of
    ``rasterize_exact`` visits, (x0, y0, x1, y1) with exclusive ends: the
    union of its raster windows (from its pixel box's first pixel, whole
    windows, so up to a window less one pixel past the box), or the whole
    framebuffer without windows, clipped to the scissor and the
    framebuffer; empty for a triangle it skips."""
    scx, scy, scw, sch = S.scissor_ints(scissor)
    if 0 < window <= W and window <= H:
        lo = su.tile_lo
        n = torch.div(su.tile_hi - lo, window, rounding_mode="floor") + 1
        end = lo + n * window
        x0, y0, x1, y1 = lo[:, 0], lo[:, 1], end[:, 0], end[:, 1]
    else:
        x0 = y0 = torch.zeros_like(su.tile_lo[:, 0])
        x1, y1 = x0 + W, x0 + H
    x0 = torch.clamp(x0, min=max(scx, 0))
    y0 = torch.clamp(y0, min=max(scy, 0))
    x1 = torch.clamp(x1, max=min(scx + scw, W))
    y1 = torch.clamp(y1, max=min(scy + sch, H))
    x1 = torch.where(su.valid, x1, torch.zeros_like(x1))
    return torch.stack([x0, y0, x1, y1], dim=1).to(torch.int32)


def kernel_launch(color, depth, su, vc_planes, scissor, texels, tex_offset,
                  tex_width, tex_height, state: PipelineState, window: int):
    """The draw of ``rasterize_exact`` as one launch of
    ``csrc/raster_exact.cu``, which reads setup's channel rows, the draw
    regions, the vertex-color planes and the texture tables where they lie.
    Checks the inputs and returns the launch: each call draws into color and
    depth in place, on the current stream (chip_smoke.py times it alone)."""
    H, W = depth.shape
    T = su.channels.shape[0]
    dev = depth.device
    regions = _draw_regions(su, scissor, W, H, window)
    vc = vc_planes.reshape(T, 12) if vc_planes is not None else None
    tables = [t.to(torch.int32) for t in (tex_offset, tex_width, tex_height)]
    slots = tables[0].shape[0]
    if slots == 0:
        raise ValueError("rasterize_exact: the texture tables are empty")
    checks = [("channels", su.channels, torch.float32, (T, S.NUM_CHANNELS)),
              ("texels", texels, torch.float32, (texels.shape[0], 16)),
              ("color", color, torch.float32, (H, W, 4)),
              ("depth", depth, torch.float32, (H, W))]
    checks += [(name, t, torch.int32, (slots,)) for name, t in
               zip(("tex_offset", "tex_width", "tex_height"), tables)]
    if vc is not None:
        checks.append(("vertex_color", vc, torch.float32, (T, 12)))
    for name, t, dt, shape in checks:
        if (t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous()
                or t.device != dev):
            raise ValueError(
                f"rasterize_exact: {name} must be a contiguous {dt} {shape} "
                f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    blend, dstate = state.blend, state.depth
    compare = (lookup(_COMPARE, dstate.compare_op) if dstate.test_enable
               else _COMPARE[CompareOp.ALWAYS])
    d16 = lookup({DepthFormat.D16_UNORM: 1, DepthFormat.D32_SFLOAT: 0},
                 dstate.format)
    mask = sum(1 << c for c, m in enumerate(blend.write_mask) if m)
    lib = _build.load()
    args = (
        su.channels.data_ptr(), regions.data_ptr(),
        vc.data_ptr() if vc is not None else None, T, texels.data_ptr(),
        *(t.data_ptr() for t in tables), slots,
        color.data_ptr(), depth.data_ptr(), W, H,
        compare, int(dstate.write_enable), d16,
        int(blend.enable), lookup(_FACTOR, blend.src_color),
        lookup(_FACTOR, blend.dst_color), lookup(_OP, blend.color_op),
        lookup(_FACTOR, blend.src_alpha), lookup(_FACTOR, blend.dst_alpha),
        lookup(_OP, blend.alpha_op), mask)

    def launch():
        global launches
        launches += 1
        count("ui.kernel")
        err = lib.ty_raster_exact(*args,
                                  torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "rasterize_exact")

    # the tensors whose pointers it passes live as long as the launch
    launch.tensors = dict(channels=su.channels, regions=regions, vc=vc,
                          texels=texels, tables=tables, color=color,
                          depth=depth)
    return launch


def rasterize_exact(color, depth, clip, uv, tex_id, tri_valid, viewport,
                    scissor, texels, tex_offset, tex_width, tex_height, *,
                    state: PipelineState, with_vertex_color: bool = False,
                    vertex_color=None, order=None, window: int = 256):
    """Draw the triangles in order.  color f32 [H, W, 4], depth f32 [H, W];
    clip f32 [T, 3, 4], uv f32 [T, 3, 2], tex_id i32 [T], tri_valid bool
    [T]; viewport and scissor on the host; vertex_color f32 [T, 3, 4] when
    ``with_vertex_color``; ``order`` overrides the draw-order channel (near
    clip splits).  Returns the new (color, depth)."""
    H, W = depth.shape
    T = clip.shape[0]
    dev = depth.device
    color, depth = color.clone(), depth.clone()
    # 1x1 tiles over the framebuffer: setup's tile box is the pixel box
    su = S.setup_triangles(
        clip, uv, tex_id, tri_valid, viewport, scissor, tile_w=1, tile_h=1,
        grid_w=max(W, 1), grid_h=max(H, 1), order=order,
        cull_mode=state.raster.cull_mode, front_face=state.raster.front_face)
    vc_planes = (_vertex_color_planes(vertex_color, clip, su.lam)
                 if with_vertex_color else None)
    if dev.type == "cuda":
        color, depth = color.contiguous(), depth.contiguous()
        kernel_launch(color, depth, su, vc_planes, scissor, texels,
                      tex_offset, tex_width, tex_height, state, window)()
        return color, depth
    if dev.type != "cpu":
        raise ValueError(f"rasterize_exact: unsupported device {dev}")
    use_window = 0 < window <= W and window <= H
    # rows E0, E1, TWOA, Z, INVW, UW, VW as (A, B, C) planes
    planes = su.channels[:, :S.CH_META].reshape(T, 7, 3)
    twoa = su.channels[:, S.CH_TWOA]
    meta = su.channels[:, S.CH_META].to(torch.int32)
    tid = meta & S.META_TEX_MASK
    tid_safe = torch.clamp(tid.long(), 0, tex_offset.shape[0] - 1)
    solid = (tex_width[tid_safe] == 1) & (tex_height[tid_safe] == 1)
    solid_rgba = texels[tex_offset.long()[tid_safe]][:, :4]
    # the pass's one synchronizing read: which triangles live, their pixel
    # boxes, top-left bits and solid textures, so the loop below visits
    # live triangles only
    rows = torch.cat([su.valid[:, None].to(torch.int32), su.tile_lo,
                      su.tile_hi, solid[:, None].to(torch.int32),
                      (meta >> S.META_TEX_BITS)[:, None]], dim=1)
    with span("ui.read"):
        host = rows.cpu().tolist()

    xc = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5)[None, :]
    yc = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5)[:, None]
    scx, scy, scw, sch = S.scissor_ints(scissor)
    fmt = state.depth.format

    def draw(t, tl, is_solid, oy, ox, rh, rw, own):
        """Triangle t over the region of rh x rw pixels at (oy, ox); only
        the pixels of ``own`` = (y0, y1, x0, x1), framebuffer coordinates,
        may take a fragment."""
        ys, xs = slice(oy, oy + rh), slice(ox, ox + rw)
        rc, rd = color[ys, xs], depth[ys, xs]
        y0, y1 = max(own[0], scy, oy), min(own[1], scy + sch, oy + rh)
        x0, x1 = max(own[2], scx, ox), min(own[3], scx + scw, ox + rw)
        if y0 >= y1 or x0 >= x1:
            return
        mask = torch.zeros((rh, rw), dtype=torch.bool, device=dev)
        mask[y0 - oy:y1 - oy, x0 - ox:x1 - ox] = True
        x, y = xc[:, xs], yc[ys]
        p = planes[t]
        ev = (p[:, 0, None, None] * x + p[:, 1, None, None] * y) \
            + p[:, 2, None, None]
        e0, e1, z = ev[0], ev[1], ev[3]
        e2 = (twoa[t] - e0) - e1
        cov = mask
        for e, bit in ((e0, 1), (e1, 2), (e2, 4)):
            cov = cov & ((e >= 0) if tl & bit else (e > 0))
        zq = quantize_depth(z, fmt)
        frag = cov & (z >= 0.0) & (z <= 1.0)
        if state.depth.test_enable:
            frag = frag & apply_compare(state.depth.compare_op, zq, rd)
        inv_w = ev[4]
        denom = torch.where(inv_w == 0, torch.ones_like(inv_w), inv_w)
        if is_solid:
            src = solid_rgba[t].expand(rh, rw, 4)
        else:
            # a one-element slot (a 0-d index tensor would read the host)
            src = sample_bilinear(texels, tex_offset, tex_width, tex_height,
                                  tid[t:t + 1], ev[5] / denom, ev[6] / denom)
        if with_vertex_color:
            vcp = vc_planes[t]                               # [4, 3]
            vcol = ((vcp[:, 0] * x[..., None] + vcp[:, 1] * y[..., None])
                    + vcp[:, 2]) / denom[..., None]
            src = src * vcol
        blended = apply_blend(state.blend, src, rc)
        color[ys, xs] = torch.where(frag[..., None], blended, rc)
        if state.depth.write_enable:
            depth[ys, xs] = torch.where(frag, zq, rd)

    for t, (valid, px0, py0, px1, py1, is_solid, tl) in enumerate(host):
        if not valid:
            continue
        if not use_window:
            draw(t, tl, is_solid, 0, 0, H, W, (0, H, 0, W))
            continue
        # window-sized pieces of the pixel box, each clamped inside the
        # framebuffer and owning only its logical window
        for gy0 in range(py0, py1 + 1, window):
            oy = min(max(gy0, 0), H - window)
            for gx0 in range(px0, px1 + 1, window):
                ox = min(max(gx0, 0), W - window)
                draw(t, tl, is_solid, oy, ox, window, window,
                     (gy0, gy0 + window, gx0, gx0 + window))
    return color, depth
