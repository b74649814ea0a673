"""Triangle transform + setup in plain PyTorch (counterpart of
``tyleri_tpu/ops/setup.py``).

Setup reduces every triangle to the plane equations the rasterizer
evaluates at pixel centers: two edge functions plus the doubled area (edge
2 is derived as ``(|2A| - e0) - e1``), window depth, 1/w, u/w and v/w.  The
row layout below (``CH_*``) is the contract between setup, binning, the
visibility resolve and shading, and is the same as the JAX package's.

Near-plane crossers are clipped upstream (``ops/clip.py``); this stage culls
any triangle with a corner at ``w <= W_EPS``.

Every expression keeps the JAX package's operation order, so the results
differ from it only where XLA contracts ``a * b + c`` into a fused
multiply-add on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Row layout of the [T, NUM_CHANNELS] plane table.  Plane rows hold
# (A, B, C) with value(x, y) = A*x + B*y + C at pixel centers.
CH_E0 = 0      # edge 0 (opposite vertex 0)
CH_E1 = 3      # edge 1
CH_TWOA = 6    # |2A| (edge 2 is derived); rows 7 and 8 are zero
CH_Z = 9       # window-space depth plane
CH_INVW = 12   # 1/w plane
CH_UW = 15     # u/w plane
CH_VW = 18     # v/w plane
CH_META = 21   # (top-left bits << META_TEX_BITS) | texture slot, exact in f32
CH_ORDER = 22  # draw order (depth-tie arbitration): an int32's bit pattern
CH_ZMIN = 23   # conservative window-z lower bound in D16 quanta
NUM_CHANNELS = 24

META_TEX_BITS = 18
META_TEX_MASK = (1 << META_TEX_BITS) - 1

W_EPS = 1e-6
# early-exit z-bound slack in D16 quanta (f32 plane-evaluation error plus
# half a quantum of D16 rounding); see _zmin_quantized
ZMIN_SLACK_Q = 66.0

# D16 quantization multiplies by the f32 reciprocal (the visibility kernels
# do, and XLA rewrites the JAX package's division by 65535 the same way)
INV_D16 = float(np.float32(1.0) / np.float32(65535.0))
# float -> int32 conversions clamp first, so out-of-range coordinates
# convert the same way on every backend (the clamp cannot change a tile
# bbox: scissor and grid bounds are far inside it)
INT_CLAMP = float(1 << 30)


class TriangleSetup(NamedTuple):
    """Per-triangle rasterization data, [T]-leading."""

    valid: torch.Tensor     # bool [T]
    channels: torch.Tensor  # f32 [T, NUM_CHANNELS]
    tile_lo: torch.Tensor   # i32 [T, 2] inclusive tile bbox (tx0, ty0)
    tile_hi: torch.Tensor   # i32 [T, 2] inclusive tile bbox (tx1, ty1)
    # f32 [T, 3, 3] barycentric planes, lam[t, i] = (A, B, C) of lambda_i,
    # for interpolating extra attributes (the lit path's normals); None on
    # the fused path, which has no such attributes
    lam: torch.Tensor = None


def encode_order(order: torch.Tensor) -> torch.Tensor:
    """Draw orders (integer values of any dtype) -> the f32 CH_ORDER slot,
    which carries each order's int32 bit pattern, so that orders stay exact
    past 2^24.  Orders below 2^23 are denormal patterns, which a flush to
    zero would merge: compare them only as ``decode_order`` gives them."""
    return order.to(torch.int32).view(torch.float32)


def decode_order(ch_order: torch.Tensor) -> torch.Tensor:
    """The CH_ORDER slot (f32 [...]) -> int32 draw orders."""
    return ch_order.view(torch.int32)


def viewport_floats(viewport) -> list[float]:
    """(x, y, w, h, min_depth, max_depth) as f32-exact python floats."""
    return [float(v) for v in np.asarray(viewport, np.float32).reshape(6)]


def scissor_ints(scissor) -> list[int]:
    return [int(v) for v in np.asarray(scissor, np.int64).reshape(4)]


def float_to_int(f: torch.Tensor) -> torch.Tensor:
    """f32 -> i32 with a clamp to +-2^30 (NaN converts to 0, as on CUDA)."""
    f = torch.nan_to_num(f, nan=0.0)
    return torch.clamp(f, -INT_CLAMP, INT_CLAMP).to(torch.int32)


def meta_pack(tex_id, topleft):
    """tex_id i32 [...], topleft f32 [..., 3] of 0/1 flags -> f32 META."""
    tl_bits = (topleft[..., 0] + 2.0 * topleft[..., 1]) + 4.0 * topleft[..., 2]
    texf = torch.clamp(tex_id, 0, META_TEX_MASK).to(torch.float32)
    return tl_bits * float(1 << META_TEX_BITS) + texf


def viewport_transform(clip, viewport):
    """Clip space -> window space; Vulkan y-down convention."""
    vx, vy, vw, vh, dmin, dmax = viewport_floats(viewport)
    dspan = float(np.float32(dmax) - np.float32(dmin))
    inv_w = torch.ones_like(clip[..., 3]) / clip[..., 3]
    ndc = clip[..., :3] * inv_w[..., None]
    sx = (ndc[..., 0] * 0.5 + 0.5) * vw + vx
    sy = (ndc[..., 1] * 0.5 + 0.5) * vh + vy
    sz = dmin + ndc[..., 2] * dspan
    return sx, sy, sz, inv_w


def cull_keep_mask(area2, cull_mode, front_face):
    """Vulkan cull test (spec 28.8) from the y-down signed area."""
    from tyleri_tpu_torch.pipeline.state import CullMode, FrontFace, lookup

    cull = lookup({None: None, CullMode.NONE: None, CullMode.BACK: "back",
                   CullMode.FRONT: "front",
                   CullMode.FRONT_AND_BACK: "both"}, cull_mode)
    if cull is None:
        return None
    if cull == "both":
        return torch.zeros(area2.shape, dtype=torch.bool, device=area2.device)
    ccw = lookup({None: True, FrontFace.COUNTER_CLOCKWISE: True,
                  FrontFace.CLOCKWISE: False}, front_face)
    is_front = (area2 > 0) == ccw
    return is_front if cull == "back" else ~is_front


def zmin_slack_bound(viewport):
    """Evaluation-domain extents of the z-min error bound: the viewport
    plus one tile of padding (tiles are <= 128 px)."""
    vx, vy, vw, vh, _, _ = (np.float32(v) for v in viewport_floats(viewport))
    fb_w = np.float32(np.abs(vx) + vw) + np.float32(128.0)
    fb_h = np.float32(np.abs(vy) + vh) + np.float32(128.0)
    return float(fb_w), float(fb_h)


def _zmin_quantized(sz0, sz1, sz2, zA, zB, zC, fb_w, fb_h):
    """Per-triangle lower bound of the rasterizer's quantized depth in D16
    quanta.  Window z is affine, so its minimum over the triangle is the
    corner minimum; f32 evaluation error is bounded by 8 ulp of the largest
    term, and D16 rounding moves a value by at most half a quantum.  Where
    that bound exceeds ZMIN_SLACK_Q, or the corner z leaves [0, 1], the
    bound is 0: such triangles sort first and are never skipped."""
    zmin = torch.minimum(torch.minimum(sz0, sz1), sz2)
    zmax = torch.maximum(torch.maximum(sz0, sz1), sz2)
    in_range = (zmin >= 0.0) & (zmax <= 1.0)
    err = (torch.abs(zA) * fb_w + torch.abs(zB) * fb_h + torch.abs(zC)) * (
        8.0 * 2.0 ** -24)
    safe = in_range & (err * 65535.0 < ZMIN_SLACK_Q)
    q = torch.clamp(torch.floor(zmin * 65535.0) - ZMIN_SLACK_Q, 0.0, 65535.0)
    return torch.where(safe, q, torch.zeros_like(q))


def triangle_planes(sx, sy, sz, iw, u, v, tri_valid, tex_id, order, viewport,
                    scissor, *, tile_w, tile_h, grid_w, grid_h, cull_mode,
                    front_face):
    """Plane setup from window-space corners (each argument [T, 3] except
    the per-triangle ones): the shared body of setup_triangles and of the
    fused kernel's plain version (ops/setup_cuda.py).  ``tri_valid`` must
    already hold the in-front test."""
    sx0, sx1, sx2 = sx.unbind(1)
    sy0, sy1, sy2 = sy.unbind(1)
    one = torch.ones_like(sx0)

    area2 = (sx1 - sx0) * (sy2 - sy0) - (sy1 - sy0) * (sx2 - sx0)
    nondeg = area2 != 0.0
    sgn = torch.where(area2 > 0, one, -one)
    inv_abs_area2 = sgn / torch.where(nondeg, area2, one)

    # edge i runs from a = (i+1)%3 to b = (i+2)%3
    ax, ay = (sx1, sx2, sx0), (sy1, sy2, sy0)
    bx, by = (sx2, sx0, sx1), (sy2, sy0, sy1)
    eA, eB, eC, tl = [], [], [], []
    for e in range(3):
        dx = bx[e] - ax[e]
        dy = by[e] - ay[e]
        eA.append(-dy * sgn)
        eB.append(dx * sgn)
        eC.append((ax[e] * dy - ay[e] * dx) * sgn)
        edx = dx * sgn
        edy = dy * sgn
        tl.append(((edy < 0) | ((edy == 0) & (edx > 0))).to(torch.float32))

    lamA = [eA[e] * inv_abs_area2 for e in range(3)]
    lamB = [eB[e] * inv_abs_area2 for e in range(3)]
    lamC = [eC[e] * inv_abs_area2 for e in range(3)]

    def attr_plane(vals):
        v0, v1, v2 = vals.unbind(1)
        return [(v0 * lam[0] + v1 * lam[1]) + v2 * lam[2]
                for lam in (lamA, lamB, lamC)]

    zA, zB, zC = attr_plane(sz)
    wP = attr_plane(iw)
    uP = attr_plane(u * iw)
    vP = attr_plane(v * iw)

    # tile bbox clamped to the scissor rect
    scx, scy, scw, sch = scissor_ints(scissor)
    px0 = torch.clamp(float_to_int(torch.floor(
        torch.minimum(torch.minimum(sx0, sx1), sx2) - 0.5)), min=scx)
    px1 = torch.clamp(float_to_int(torch.ceil(
        torch.maximum(torch.maximum(sx0, sx1), sx2) - 0.5)), max=scx + scw - 1)
    py0 = torch.clamp(float_to_int(torch.floor(
        torch.minimum(torch.minimum(sy0, sy1), sy2) - 0.5)), min=scy)
    py1 = torch.clamp(float_to_int(torch.ceil(
        torch.maximum(torch.maximum(sy0, sy1), sy2) - 0.5)), max=scy + sch - 1)

    def tile(p, size, n):
        return torch.clamp(torch.div(p, size, rounding_mode="floor"), 0, n - 1)

    tx0, tx1 = tile(px0, tile_w, grid_w), tile(px1, tile_w, grid_w)
    ty0, ty1 = tile(py0, tile_h, grid_h), tile(py1, tile_h, grid_h)
    on_screen = (px0 <= px1) & (py0 <= py1)

    valid = tri_valid & nondeg & on_screen
    keep = cull_keep_mask(area2, cull_mode, front_face)
    if keep is not None:
        valid = valid & keep

    fb_w, fb_h = zmin_slack_bound(viewport)
    zero = torch.zeros_like(area2)
    topleft = torch.stack(tl, dim=1)
    channels = torch.stack([
        eA[0], eB[0], eC[0],                     # CH_E0
        eA[1], eB[1], eC[1],                     # CH_E1
        area2 * sgn, zero, zero,                 # CH_TWOA
        zA, zB, zC,                              # CH_Z
        *wP, *uP, *vP,                           # CH_INVW, CH_UW, CH_VW
        meta_pack(tex_id, topleft),              # CH_META
        encode_order(order),                     # CH_ORDER
        _zmin_quantized(*sz.unbind(1), zA, zB, zC, fb_w, fb_h),  # CH_ZMIN
    ], dim=1)
    return TriangleSetup(
        valid=valid,
        channels=channels,
        tile_lo=torch.stack([tx0, ty0], dim=1),
        tile_hi=torch.stack([tx1, ty1], dim=1),
        lam=torch.stack([torch.stack(lam, dim=1)
                         for lam in (lamA, lamB, lamC)], dim=2),
    )


def setup_triangles(clip, uv, tex_id, tri_valid, viewport, scissor, *,
                    tile_w: int, tile_h: int, grid_w: int, grid_h: int,
                    order=None, cull_mode=None, front_face=None
                    ) -> TriangleSetup:
    """clip f32 [T, 3, 4], uv f32 [T, 3, 2], tex_id i32 [T], tri_valid bool
    [T]; viewport 6 floats and scissor 4 ints on the host.  ``order`` [T]
    (integer values, below 2^31) defaults to the row index (near-plane
    clipping passes the parent's)."""
    T = clip.shape[0]
    if order is None:
        order = torch.arange(T, dtype=torch.int32, device=clip.device)
    in_front = torch.all(clip[..., 3] > W_EPS, dim=1)
    safe_clip = torch.where(in_front[:, None, None], clip,
                            torch.ones_like(clip))
    sx, sy, sz, inv_w = viewport_transform(safe_clip, viewport)
    return triangle_planes(
        sx, sy, sz, inv_w, uv[..., 0], uv[..., 1], tri_valid & in_front,
        tex_id, order, viewport, scissor, tile_w=tile_w, tile_h=tile_h,
        grid_w=grid_w, grid_h=grid_h, cull_mode=cull_mode,
        front_face=front_face)


def build_triangle_table(positions, uvs, indices, first_index, vertex_offset,
                         tri_base, tri_count, *, tri_capacity: int,
                         normals=None):
    """Materialize the per-triangle corner table of a draw list (once per
    draw-list change; the per-frame vertex stage is matrix math only).

    Returns (corner f32 [Tcap, 3, 5] = pos + uv per corner, draw i32
    [Tcap], valid bool [Tcap], corner normals f32 [Tcap, 3, 3] or None).
    The normals are a table of their own, gathered only when ``normals``
    [V, 3] is given (lit frames), so the fused setup kernel's row-major
    [Tcap, 3, 5] table keeps its stride."""
    dev = positions.device
    D = first_index.shape[0]
    I = indices.shape[0]
    t = torch.arange(tri_capacity, dtype=torch.int64, device=dev)
    draw = torch.clamp(
        torch.searchsorted(tri_base.to(torch.int64), t, right=True) - 1,
        0, D - 1)
    local = t - tri_base[draw]
    in_draw = (local >= 0) & (local < tri_count[draw])
    i3 = (I // 3) * 3
    ipos = torch.clamp(first_index[draw] + 3 * local, 0, max(i3 - 3, 0))
    tri_idx = indices[:i3].to(torch.int64).reshape(-1, 3)[ipos // 3]
    vtx = torch.clamp(tri_idx + vertex_offset[draw][:, None], 0,
                      positions.shape[0] - 1)
    verts5 = torch.cat([positions, uvs], dim=1)
    corner_nrm = normals[vtx] if normals is not None else None
    return verts5[vtx], draw.to(torch.int32), in_draw, corner_nrm


def transform_corner_table(corner, draw, mvps):
    """Per-frame vertex stage: corner f32 [T, 3, 5], draw i32 [T], mvps f32
    [D, 16] (row-major 4x4) -> (clip [T, 3, 4], uv [T, 3, 2]), with the
    multiply-add chain ((m0*x + m1*y) + m2*z) + m3 of the setup kernel."""
    m = mvps.reshape(-1, 4, 4)[draw.long()]           # [T, 4, 4]
    x, y, z = corner[..., 0], corner[..., 1], corner[..., 2]   # [T, 3]
    rows = [((m[:, j, 0:1] * x + m[:, j, 1:2] * y) + m[:, j, 2:3] * z)
            + m[:, j, 3:4] for j in range(4)]
    return torch.stack(rows, dim=-1), corner[..., 3:5]
