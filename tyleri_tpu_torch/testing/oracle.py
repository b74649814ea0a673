"""Numpy oracle rasterizer — ground truth for the kernels.

The reference's output is produced by Vulkan fixed-function rasterization; the
Rust toolchain and a Vulkan ICD are not available in this environment, so this
module re-implements the Vulkan rasterization rules the reference relies on,
in slow/obvious numpy (f64 internally), as the golden oracle for tests:

* primitive clipping against the clip volume (-w<=x,y<=w, 0<=z<=w) with
  linear attribute interpolation in clip space (Vulkan spec 27.4)
* viewport transform with y-down framebuffer coords, pixel centers at +0.5
* top-left fill rule (spec 28.9.1: "top edge or left edge")
* window-space-linear depth, D16_UNORM quantization, LESS_OR_EQUAL compare
  (ref: src/pipeline/common_pipeline.rs:107-116)
* perspective-correct attribute interpolation (1/w weighting)
* bilinear / mirrored-repeat texture sampling, no mips
  (ref sampler: src/render_device/builders.rs:300-320)
* full Vulkan blend factor/op semantics, draw-order sequential blending

This file is intentionally independent of torch: no code is shared with the
production kernels, so agreement between the two is meaningful evidence.

The port's own copy of ``tyleri_tpu/testing/oracle.py``, which it
never imports; ``tests/test_torch_vendored.py`` holds the two together.
"""

from __future__ import annotations

import numpy as np

from tyleri_tpu_torch.pipeline.state import (
    BlendFactor,
    BlendOp,
    CompareOp,
    CullMode,
    DepthFormat,
    FrontFace,
    PipelineState,
    lookup,
)
from tyleri_tpu_torch.utils.math3d import Rect2D, Viewport

_CLIP_PLANES = (
    # (coefficients a,b,c,d) for plane a*x + b*y + c*z + d*w >= 0
    (1.0, 0.0, 0.0, 1.0),   # x >= -w
    (-1.0, 0.0, 0.0, 1.0),  # x <= w
    (0.0, 1.0, 0.0, 1.0),   # y >= -w
    (0.0, -1.0, 0.0, 1.0),  # y <= w
    (0.0, 0.0, 1.0, 0.0),   # z >= 0
    (0.0, 0.0, -1.0, 1.0),  # z <= w
)


def clip_triangle(verts):
    """Sutherland-Hodgman clip of one triangle in clip space.

    ``verts`` is [3, K] (clip xyzw in columns 0:4, attributes after).
    Returns a list of [3, K] triangles (fan-triangulated polygon).
    """
    poly = [np.asarray(v, np.float64) for v in verts]
    for a, b, c, d in _CLIP_PLANES:
        if not poly:
            return []
        coeff = np.array([a, b, c, d])
        out = []
        n = len(poly)
        for i in range(n):
            cur, nxt = poly[i], poly[(i + 1) % n]
            dc = float(coeff @ cur[:4])
            dn = float(coeff @ nxt[:4])
            if dc >= 0.0:
                out.append(cur)
            if (dc >= 0.0) != (dn >= 0.0):
                t = dc / (dc - dn)
                out.append(cur + t * (nxt - cur))
        poly = out
    return [np.stack([poly[0], poly[i], poly[i + 1]]) for i in range(1, len(poly) - 1)]


def mirror_repeat(i, n):
    """GL/Vulkan MIRRORED_REPEAT addressing of integer texel index ``i``."""
    i = np.asarray(i)
    m = np.mod(i, 2 * n)
    return np.where(m >= n, 2 * n - 1 - m, m)


def sample_bilinear(texture, u, v):
    """Bilinear sample with mirrored-repeat addressing.

    ``texture`` is [h, w, 4] float in [0,1]; u/v arbitrary-shape arrays.
    Matches an unnormalized-coords=false, FILTER_LINEAR, MIRRORED_REPEAT
    Vulkan sampler with no mips.
    """
    h, w = texture.shape[:2]
    tu = np.asarray(u, np.float64) * w - 0.5
    tv = np.asarray(v, np.float64) * h - 0.5
    iu0 = np.floor(tu).astype(np.int64)
    iv0 = np.floor(tv).astype(np.int64)
    fu = (tu - iu0)[..., None]
    fv = (tv - iv0)[..., None]
    iu0m, iu1m = mirror_repeat(iu0, w), mirror_repeat(iu0 + 1, w)
    iv0m, iv1m = mirror_repeat(iv0, h), mirror_repeat(iv0 + 1, h)
    t00 = texture[iv0m, iu0m]
    t01 = texture[iv0m, iu1m]
    t10 = texture[iv1m, iu0m]
    t11 = texture[iv1m, iu1m]
    top = t00 * (1 - fu) + t01 * fu
    bot = t10 * (1 - fu) + t11 * fu
    return top * (1 - fv) + bot * fv


def _blend_factor(fac, s, d, sa, da):
    one = np.ones_like(s)
    return {
        BlendFactor.ZERO: np.zeros_like(s),
        BlendFactor.ONE: one,
        BlendFactor.SRC_COLOR: s,
        BlendFactor.ONE_MINUS_SRC_COLOR: 1 - s,
        BlendFactor.DST_COLOR: d,
        BlendFactor.ONE_MINUS_DST_COLOR: 1 - d,
        BlendFactor.SRC_ALPHA: sa * one,
        BlendFactor.ONE_MINUS_SRC_ALPHA: (1 - sa) * one,
        BlendFactor.DST_ALPHA: da * one,
        BlendFactor.ONE_MINUS_DST_ALPHA: (1 - da) * one,
    }[fac]


def _blend_op(op, a, b):
    return {
        BlendOp.ADD: a + b,
        BlendOp.SUBTRACT: a - b,
        BlendOp.REVERSE_SUBTRACT: b - a,
        BlendOp.MIN: np.minimum(a, b),
        BlendOp.MAX: np.maximum(a, b),
    }[op]


def blend(state, src, dst):
    """Sequential Vulkan blend of src over dst, both [..., 4] rgba."""
    if not state.enable:
        out = src.copy()
    else:
        sa, da = src[..., 3:4], dst[..., 3:4]
        if state.color_op in (BlendOp.MIN, BlendOp.MAX):
            rgb = _blend_op(state.color_op, src[..., :3], dst[..., :3])
        else:
            rgb = _blend_op(
                state.color_op,
                src[..., :3] * _blend_factor(state.src_color, src[..., :3], dst[..., :3], sa, da),
                dst[..., :3] * _blend_factor(state.dst_color, src[..., :3], dst[..., :3], sa, da),
            )
        if state.alpha_op in (BlendOp.MIN, BlendOp.MAX):
            a = _blend_op(state.alpha_op, sa, da)
        else:
            a = _blend_op(
                state.alpha_op,
                sa * _blend_factor(state.src_alpha, sa, da, sa, da),
                da * _blend_factor(state.dst_alpha, sa, da, sa, da),
            )
        out = np.concatenate([rgb, a], axis=-1)
    out = np.clip(out, 0.0, 1.0)
    mask = np.asarray(state.write_mask, bool)
    return np.where(mask, out, dst)


def _compare(op, new, old):
    return {
        CompareOp.NEVER: np.zeros_like(new, bool),
        CompareOp.ALWAYS: np.ones_like(new, bool),
        CompareOp.LESS: new < old,
        CompareOp.EQUAL: new == old,
        CompareOp.LESS_OR_EQUAL: new <= old,
        CompareOp.GREATER: new > old,
        CompareOp.NOT_EQUAL: new != old,
        CompareOp.GREATER_OR_EQUAL: new >= old,
    }[op]


def quantize_depth(z, fmt):
    z = np.clip(z, 0.0, 1.0)
    if lookup({DepthFormat.D16_UNORM: False, DepthFormat.D32_SFLOAT: True},
              fmt):
        return np.float32(z).astype(np.float64)
    return np.round(z * 65535.0) / 65535.0


def rasterize(
    color,
    depth,
    clip,
    uv,
    state: PipelineState,
    viewport: Viewport,
    scissor: Rect2D,
    texture=None,
    vertex_color=None,
    normals=None,   # optional [T, 3, 3] WORLD-space corner normals
    light=None,     # optional scene.light.DirectionalLight (Blinn-Phong)
    inv_vp=None,    # [4, 4] inverse view-projection (lit unproject)
    eye=None,       # [3] camera world position
    survivor_hook=None,  # optional instrumentation: called as
                         # hook(y0, x0, passed_mask, frag_rgba) for every
                         # depth-test-passing fragment region, BEFORE the
                         # blend — pixel output is unaffected (used by
                         # tools/kpeel_deviation.py to study k-layer
                         # truncated blend chains)
):
    """Rasterize triangles in draw order into ``color``/``depth`` (in place).

    color: [H, W, 4] f64 rgba, depth: [H, W] f64 (holding quantized values).
    clip: [T, 3, 4] clip-space positions; uv: [T, 3, 2].
    vertex_color: optional [T, 3, 4]; fragment = interp(vcolor) * tex(uv)
    (the UI fragment shader, ref: src/pipeline/glsl/ui.frag:10); with
    vertex_color=None fragment = tex(uv) (ref: common_pipeline.frag:11-12).
    ``texture=None`` acts as a 1x1 white texture.
    """
    H, W = depth.shape
    clip = np.asarray(clip, np.float64)
    uv = np.asarray(uv, np.float64)
    if texture is None:
        texture = np.ones((1, 1, 4), np.float64)
    sx0 = max(scissor.x, 0)
    sy0 = max(scissor.y, 0)
    sx1 = min(scissor.x + scissor.width, W)
    sy1 = min(scissor.y + scissor.height, H)
    if sx0 >= sx1 or sy0 >= sy1:
        return

    lit = None
    if normals is not None and light is not None:
        assert vertex_color is None, "lit + vertex color unsupported"
        lit = (np.asarray(light.as_array(), np.float64),
               np.asarray(inv_vp, np.float64),
               np.asarray(eye, np.float64))
    for t in range(clip.shape[0]):
        attrs = [uv[t]]  # each [3, k]
        if vertex_color is not None:
            attrs.append(np.asarray(vertex_color[t], np.float64))
        if lit is not None:
            attrs.append(np.asarray(normals[t], np.float64))
        packed = np.concatenate([clip[t]] + attrs, axis=1)  # [3, 4+k]
        for tri in clip_triangle(packed):
            _raster_one(
                color, depth, tri, state, viewport,
                (sx0, sy0, sx1, sy1), texture,
                has_vcolor=vertex_color is not None,
                lit=lit,
                survivor_hook=survivor_hook,
            )


def _raster_one(color, depth, tri, state, vp, sbox, texture, has_vcolor,
                lit=None, survivor_hook=None):
    xyzw = tri[:, :4]
    w = xyzw[:, 3]
    if np.any(w <= 0):  # clipped volume guarantees w>0 up to fp noise
        return
    ndc = xyzw[:, :3] / w[:, None]
    sx = (ndc[:, 0] * 0.5 + 0.5) * vp.width + vp.x
    sy = (ndc[:, 1] * 0.5 + 0.5) * vp.height + vp.y
    sz = vp.min_depth + ndc[:, 2] * (vp.max_depth - vp.min_depth)
    inv_w = 1.0 / w

    # Signed doubled area in y-down screen space.
    area2 = (sx[1] - sx[0]) * (sy[2] - sy[0]) - (sy[1] - sy[0]) * (sx[2] - sx[0])
    if area2 == 0.0:
        return
    # (cull front faces, cull back faces) of the cull mode
    cull_front, cull_back = lookup({
        CullMode.NONE: (False, False), CullMode.FRONT: (True, False),
        CullMode.BACK: (False, True), CullMode.FRONT_AND_BACK: (True, True),
    }, state.raster.cull_mode)
    if cull_front or cull_back:
        # Vulkan spec 28.8: orientation is decided by the shoelace signed area
        # in framebuffer (y-down) coords; positive area <=> counter-clockwise.
        # area2 above equals that shoelace sum.
        ccw_fb = area2 > 0
        is_front = ccw_fb == lookup({FrontFace.COUNTER_CLOCKWISE: True,
                                     FrontFace.CLOCKWISE: False},
                                    state.raster.front_face)
        if (cull_back and not is_front) or (cull_front and is_front):
            return

    sgn = 1.0 if area2 > 0 else -1.0

    sx0, sy0, sx1, sy1 = sbox
    x0 = max(int(np.floor(min(sx))), sx0)
    x1 = min(int(np.ceil(max(sx))) + 1, sx1)
    y0 = max(int(np.floor(min(sy))), sy0)
    y1 = min(int(np.ceil(max(sy))) + 1, sy1)
    if x0 >= x1 or y0 >= y1:
        return

    px, py = np.meshgrid(
        np.arange(x0, x1, dtype=np.float64) + 0.5,
        np.arange(y0, y1, dtype=np.float64) + 0.5,
    )

    # Edge i is opposite vertex i: edge0 = v1->v2, edge1 = v2->v0, edge2 = v0->v1.
    cov = np.ones(px.shape, bool)
    lam = []
    for i in range(3):
        a, b = (i + 1) % 3, (i + 2) % 3
        dx, dy = sx[b] - sx[a], sy[b] - sy[a]
        # E_i(p) = cross(b - a, p - a), scaled so interior is positive;
        # E_i(v_i) = 2*area, giving barycentric lambda_i = E_i / 2A.
        e = ((py - sy[a]) * dx - (px - sx[a]) * dy) * sgn
        # Top-left rule in y-down coords for interior-positive edges
        # (effective direction edx/edy accounts for the winding flip):
        # top edge: horizontal with interior below (edx > 0);
        # left edge: interior to the right (edy < 0).
        edx, edy = dx * sgn, dy * sgn
        top_left = (edy < 0) | ((edy == 0) & (edx > 0))
        cov &= np.where(top_left, e >= 0, e > 0)
        lam.append(e / (area2 * sgn))
    if not cov.any():
        return
    l0, l1, l2 = lam

    z = l0 * sz[0] + l1 * sz[1] + l2 * sz[2]
    in_range = (z >= 0.0) & (z <= 1.0)  # depth clamp disabled => z outside is discarded
    cov &= in_range
    if not cov.any():
        return
    zq = quantize_depth(z, state.depth.format)

    region_d = depth[y0:y1, x0:x1]
    if state.depth.test_enable:
        passed = cov & _compare(state.depth.compare_op, zq, region_d)
    else:
        passed = cov
    if not passed.any():
        return

    iw = l0 * inv_w[0] + l1 * inv_w[1] + l2 * inv_w[2]
    denom = np.where(iw == 0, 1.0, iw)
    att = tri[:, 4:]
    u = (l0 * att[0, 0] * inv_w[0] + l1 * att[1, 0] * inv_w[1] + l2 * att[2, 0] * inv_w[2]) / denom
    v = (l0 * att[0, 1] * inv_w[0] + l1 * att[1, 1] * inv_w[1] + l2 * att[2, 1] * inv_w[2]) / denom
    frag = sample_bilinear(texture, u, v)
    if lit is not None:
        # Blinn-Phong (scene/light.py model; mirrors ops/shade.py).  The
        # pipeline reconstructs position from the QUANTIZED depth buffer,
        # so the oracle unprojects zq as well.
        larr, inv_vp, eye = lit
        nc = att[:, 2:5]
        n = (
            l0[..., None] * nc[0] * inv_w[0]
            + l1[..., None] * nc[1] * inv_w[1]
            + l2[..., None] * nc[2] * inv_w[2]
        ) / denom[..., None]
        nn = np.linalg.norm(n, axis=-1, keepdims=True)
        n = n / np.where(nn == 0, 1.0, nn)
        yy, xx = np.mgrid[y0:y1, x0:x1]
        ndc_x = ((xx + 0.5) - vp.x) / vp.width * 2.0 - 1.0
        ndc_y = ((yy + 0.5) - vp.y) / vp.height * 2.0 - 1.0
        dspan = (vp.max_depth - vp.min_depth) or 1.0
        ndc_z = (zq - vp.min_depth) / dspan
        h4 = np.stack([ndc_x, ndc_y, ndc_z, np.ones_like(ndc_z)], axis=-1)
        wp = h4 @ inv_vp.T
        wdiv = np.where(wp[..., 3] == 0, 1.0, wp[..., 3])
        p_world = wp[..., :3] / wdiv[..., None]
        ldir = larr[:3]
        lcol = larr[3:6]
        ambient, spec_s, shin = larr[6], larr[7], larr[8]
        vvec = eye - p_world
        vn = np.linalg.norm(vvec, axis=-1, keepdims=True)
        vvec = vvec / np.where(vn == 0, 1.0, vn)
        hvec = ldir + vvec
        hn = np.linalg.norm(hvec, axis=-1, keepdims=True)
        hvec = hvec / np.where(hn == 0, 1.0, hn)
        ndl = np.maximum(np.sum(n * ldir, axis=-1), 0.0)
        ndh = np.maximum(np.sum(n * hvec, axis=-1), 0.0)
        spec = spec_s * ndh ** shin
        frag = frag.copy()
        frag[..., :3] = (frag[..., :3] * (ambient + lcol * ndl[..., None])
                         + lcol * spec[..., None])
    if has_vcolor:
        vc = att[:, 2:6]
        vcol = (
            l0[..., None] * vc[0] * inv_w[0]
            + l1[..., None] * vc[1] * inv_w[1]
            + l2[..., None] * vc[2] * inv_w[2]
        ) / denom[..., None]
        frag = frag * vcol

    if survivor_hook is not None:
        survivor_hook(y0, x0, passed, np.broadcast_to(frag, passed.shape + (4,)))
    region_c = color[y0:y1, x0:x1]
    blended = blend(state.blend, frag, region_c)
    region_c[passed] = blended[passed]
    if state.depth.write_enable:
        region_d[passed] = zq[passed]
    color[y0:y1, x0:x1] = region_c
    depth[y0:y1, x0:x1] = region_d


def make_mesh_clip(positions, indices, mvp):
    """Helper: gather triangle clip positions for a mesh draw.

    positions [N,3], indices [M] (M % 3 == 0), mvp [4,4] column-vector matrix.
    Returns clip [M/3, 3, 4].
    """
    positions = np.asarray(positions, np.float64)
    h = np.concatenate([positions, np.ones((len(positions), 1))], axis=1)
    clip = h @ np.asarray(mvp, np.float64).T
    return clip[np.asarray(indices).reshape(-1, 3)]


def make_ui_clip(ui_pos_points, indices, screen_size_points):
    """UI vertex shader analog (ref: src/pipeline/glsl/ui.vert:16-18):
    clip = (2*p/screen - 1, z=0, w=1)."""
    p = np.asarray(ui_pos_points, np.float64)
    sw, sh = screen_size_points
    clip = np.stack(
        [2 * p[:, 0] / sw - 1, 2 * p[:, 1] / sh - 1, np.zeros(len(p)), np.ones(len(p))],
        axis=1,
    )
    return clip[np.asarray(indices).reshape(-1, 3)]
