"""K1+K2: fused vertex transform + near-plane cull + triangle setup
(counterpart of ``tyleri_tpu/ops/setup_pallas.py``).

``fused_setup`` runs the CUDA kernel ``csrc/fused_setup.cu`` on CUDA tensors
and the plain PyTorch version ``fused_setup_reference`` on CPU tensors.  Both
read the cached row-major corner table [T, 3, 5] and index ``mvps[draw]``
directly, so there is no draw-count limit and no field-major relayout.  The
kernel stages a block of corner rows in shared memory and writes the
block's channel rows back as one contiguous run; it also counts the
crossers, so the launch is the wrapper's only work on the card besides
zeroing that count.

Semantics: the draw mask (``draw_mod``), transform, then near-plane cull
with a per-triangle ``crossed`` flag (crossers are culled here;
rendering/passes.py re-clips them), then the plane setup of ops/setup.py.
Row ``t`` of the output carries draw order ``t``, masked or not, so a
mesh's composite compares global draw order.
"""

from __future__ import annotations

import torch

from tyleri_tpu_torch import _build
from tyleri_tpu_torch.ops import setup as S


def _cull_code(cull_mode, front_face):
    from tyleri_tpu_torch.pipeline.state import CullMode, FrontFace, lookup

    cull = lookup({None: 0, CullMode.NONE: 0, CullMode.BACK: 1,
                   CullMode.FRONT: 2, CullMode.FRONT_AND_BACK: 3}, cull_mode)
    return cull, int(lookup({None: True, FrontFace.COUNTER_CLOCKWISE: True,
                             FrontFace.CLOCKWISE: False}, front_face))


def _draw_mod(draw_mod) -> tuple[int, int]:
    n, i = (1, 0) if draw_mod is None else (int(v) for v in draw_mod)
    if n < 1 or not 0 <= i < n:
        raise ValueError(f"draw_mod must be (n, i) with 0 <= i < n, got "
                         f"{draw_mod}")
    return n, i


def fused_setup_reference(corners, tri_draw, tri_tex, tri_valid, mvps,
                          cam_valid, viewport, scissor, *, tile_w, tile_h,
                          grid_w, grid_h, cull_mode=None, front_face=None,
                          draw_mod=None):
    """Plain PyTorch version of the kernel, expression by expression.
    Returns (TriangleSetup, crossings i32 [], crossed bool [T])."""
    n, i = _draw_mod(draw_mod)
    T = corners.shape[0]
    D = mvps.shape[0]
    draw = tri_draw.long()
    draw_ok = (draw >= 0) & (draw < D)
    # the draw mask folds in before the crossing test: a masked crosser is
    # neither flagged nor counted
    valid0 = tri_valid & draw_ok & bool(cam_valid) & (draw % n == i)
    m = torch.where(draw_ok[:, None], mvps[torch.clamp(draw, 0, D - 1)],
                    torch.zeros_like(mvps[:1]))                # [T, 16]
    x, y, z = corners[..., 0], corners[..., 1], corners[..., 2]   # [T, 3]
    clip = torch.stack(
        [((m[:, 4 * j:4 * j + 1] * x + m[:, 4 * j + 1:4 * j + 2] * y)
          + m[:, 4 * j + 2:4 * j + 3] * z) + m[:, 4 * j + 3:4 * j + 4]
         for j in range(4)], dim=-1)                           # [T, 3, 4]

    n_in = (clip[..., 2] >= 0.0).to(torch.int32).sum(dim=1)
    crossed = valid0 & (n_in > 0) & (n_in < 3)
    valid0 = valid0 & (n_in == 3)

    in_front = torch.all(clip[..., 3] > S.W_EPS, dim=1)
    safe = torch.where(in_front[:, None, None], clip, torch.ones_like(clip))
    sx, sy, sz, iw = S.viewport_transform(safe, viewport)
    # padding rows carry tex -1 into META (as the TPU corner table does)
    tex = torch.where(tri_valid, tri_tex, torch.full_like(tri_tex, -1))
    order = torch.arange(T, dtype=torch.int32, device=corners.device)
    su = S.triangle_planes(
        sx, sy, sz, iw, corners[..., 3], corners[..., 4], valid0 & in_front,
        tex, order, viewport, scissor, tile_w=tile_w, tile_h=tile_h,
        grid_w=grid_w, grid_h=grid_h, cull_mode=cull_mode,
        front_face=front_face)._replace(lam=None)   # the kernel has none
    return su, crossed.to(torch.int32).sum().to(torch.int32), crossed


def fused_setup(corners, tri_draw, tri_tex, tri_valid, mvps, cam_valid,
                viewport, scissor, *, tile_w, tile_h, grid_w, grid_h,
                cull_mode=None, front_face=None, draw_mod=None):
    """corners f32 [T, 3, 5], tri_draw/tri_tex i32 [T], tri_valid bool [T],
    mvps f32 [D, 16] (row-major view_proj @ model), cam_valid bool (host);
    viewport 6 floats and scissor 4 ints on the host; ``draw_mod`` = (n, i)
    keeps only the rows whose draw % n == i (a device's round-robin share of
    the draws on a mesh), None keeps every row.  Row ``t`` keeps order
    ``t`` either way.

    Returns (TriangleSetup, crossings i32 [], crossed bool [T])."""
    if corners.device.type == "cpu":
        return fused_setup_reference(
            corners, tri_draw, tri_tex, tri_valid, mvps, cam_valid, viewport,
            scissor, tile_w=tile_w, tile_h=tile_h, grid_w=grid_w,
            grid_h=grid_h, cull_mode=cull_mode, front_face=front_face,
            draw_mod=draw_mod)
    if corners.device.type != "cuda":
        raise ValueError(f"fused_setup: unsupported device {corners.device}")
    if tile_w & (tile_w - 1) or tile_h & (tile_h - 1):
        raise ValueError("fused_setup needs power-of-two tiles")
    mod_n, mod_i = _draw_mod(draw_mod)
    T = corners.shape[0]
    D = mvps.shape[0]
    dev = corners.device
    _build.check_args("fused_setup", dev, (
        ("corners", corners, torch.float32, (T, 3, 5)),
        ("tri_draw", tri_draw, torch.int32, (T,)),
        ("tri_tex", tri_tex, torch.int32, (T,)),
        ("tri_valid", tri_valid, torch.bool, (T,)),
        ("mvps", mvps, torch.float32, (D, 16))))
    channels = torch.empty((T, S.NUM_CHANNELS), dtype=torch.float32,
                           device=dev)
    valid = torch.empty((T,), dtype=torch.bool, device=dev)
    crossed = torch.empty((T,), dtype=torch.bool, device=dev)
    tile_lo = torch.empty((T, 2), dtype=torch.int32, device=dev)
    tile_hi = torch.empty((T, 2), dtype=torch.int32, device=dev)
    # the kernel adds its crossers to this count, a warp at a time
    crossings = torch.zeros((), dtype=torch.int32, device=dev)
    su = S.TriangleSetup(valid=valid, channels=channels, tile_lo=tile_lo,
                         tile_hi=tile_hi)
    if T == 0:
        return su, crossings, crossed
    cull, ccw = _cull_code(cull_mode, front_face)
    _build.launcher("fused_setup", "ty_fused_setup", dev, (
        corners.data_ptr(), tri_draw.data_ptr(), tri_tex.data_ptr(),
        tri_valid.data_ptr(), mvps.data_ptr(), T, D, int(bool(cam_valid)),
        mod_n, mod_i,
        *S.viewport_floats(viewport), *S.scissor_ints(scissor),
        tile_w.bit_length() - 1, tile_h.bit_length() - 1, grid_w, grid_h,
        cull, ccw,
        channels.data_ptr(), valid.data_ptr(), tile_lo.data_ptr(),
        tile_hi.data_ptr(), crossed.data_ptr(), crossings.data_ptr()))()
    return su, crossings, crossed
