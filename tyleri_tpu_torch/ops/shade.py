"""Deferred shading of a visibility buffer (counterpart of
``tyleri_tpu/ops/shade.py``, bilinear sampling, unlit and lit).

The mesh fragment stage is a texture fetch (ref:
src/pipeline/glsl/common_pipeline.frag:11-12) followed by fixed-function
blending; the visibility pass already resolved the winner's u/w, v/w, 1/w
and texture slot per pixel, so shading is one texel-quad gather + blend.
Lit frames add Blinn-Phong (scene/light.py): the world normal from the
winner's normal/w planes, the world position by unprojecting the pixel at
its depth.  A sampler anisotropy above 1 (``aniso_taps``) takes that many
bilinear taps along each pixel's footprint, from UV derivatives by 2x2
quad differencing of the attribute maps.

The light, the inverse view-projection, the eye and the viewport are host
values: they enter as f32 scalars, so no host-to-device copy waits on the
stream, and every product and sum is an f32 operation in a fixed order
(no matrix product, so no TF32 on the card).
"""

from __future__ import annotations

import numpy as np
import torch

from tyleri_tpu_torch.pipeline.state import BlendState
from tyleri_tpu_torch.ops.blend import apply_blend
from tyleri_tpu_torch.ops.sampling import (
    quad_derivatives,
    sample_anisotropic,
    sample_bilinear,
)
from tyleri_tpu_torch.ops.setup import viewport_floats


def _floats(a, n: int) -> list[float]:
    """Host values as f32-exact python floats."""
    return [float(v) for v in np.asarray(a, np.float32).reshape(n)]


def _dot3(a, b) -> torch.Tensor:
    """Sum over the last axis of 3 of a * b (b a tensor or 3 floats)."""
    return (a[..., 0] * b[0] + a[..., 1] * b[1]) + a[..., 2] * b[2]


def _normalize(v: torch.Tensor) -> torch.Tensor:
    """v [..., 3] over its length; a zero vector stays zero."""
    n = torch.sqrt(_dot3(v, v.unbind(-1)))[..., None]
    return v / torch.where(n == 0, 1.0, n)


def blinn_phong(tex_rgba, n, p_world, light, eye):
    """The lit fragment model (scene/light.py docstring; the oracle
    implements the same).  ``n`` need not be normalized; a zero normal
    shades ambient-only.  light: the f32 [12] uniform row; eye: 3 floats."""
    lv = _floats(light, 12)
    l, lcol = lv[0:3], lv[3:6]
    ambient, spec_s, shin = lv[6], lv[7], lv[8]
    ex, ey, ez = _floats(eye, 3)
    n = _normalize(n)
    vvec = _normalize(torch.stack([ex - p_world[..., 0], ey - p_world[..., 1],
                                   ez - p_world[..., 2]], dim=-1))
    h = _normalize(torch.stack([l[k] + vvec[..., k] for k in range(3)],
                               dim=-1))
    ndl = torch.clamp(_dot3(n, l), min=0.0)
    ndh = torch.clamp(_dot3(n, h.unbind(-1)), min=0.0)
    spec = spec_s * ndh ** shin
    rgb = torch.stack([tex_rgba[..., k] * (ambient + lcol[k] * ndl)
                       + lcol[k] * spec for k in range(3)], dim=-1)
    return torch.cat([rgb, tex_rgba[..., 3:4]], dim=-1)


def unproject_window(owner_valid, depth, viewport, inv_vp, fb_w, fb_h):
    """Window (x+.5, y+.5, depth) -> world position [H, W, 3] via the
    inverse view-projection (the lit path's position reconstruction; no
    extra per-entry channels)."""
    dev = depth.device
    vx, vy, vw, vh, dmin, dmax = viewport_floats(viewport)
    xc = (torch.arange(fb_w, dtype=torch.float32, device=dev) + 0.5)[None, :]
    yc = (torch.arange(fb_h, dtype=torch.float32, device=dev) + 0.5)[:, None]
    ndc_x = ((xc - vx) / vw * 2.0 - 1.0).expand(fb_h, fb_w)
    ndc_y = ((yc - vy) / vh * 2.0 - 1.0).expand(fb_h, fb_w)
    dspan = 1.0 if dmax == dmin else float(np.float32(dmax)
                                             - np.float32(dmin))
    ndc_z = (depth - dmin) / dspan
    m = np.asarray(inv_vp, np.float32).reshape(4, 4)
    wpos = [((ndc_x * float(m[i, 0]) + ndc_y * float(m[i, 1]))
             + ndc_z * float(m[i, 2])) + float(m[i, 3]) for i in range(4)]
    w = torch.where(wpos[3] == 0, 1.0, wpos[3])
    return torch.stack([wpos[i] / w for i in range(3)], dim=-1)


def shade_visibility(vis, texels, tex_offset, tex_width, tex_height,
                     blend_state: BlendState, dst_color, lit=None,
                     aniso_taps: int = 0):
    """vis: VisibilityBuffer; texels f32 [cap, 16] quad arena;
    dst_color f32 [H, W, 4] -> blended color [H, W, 4].

    ``aniso_taps`` > 1 samples anisotropically: the quotient rule turns the
    quad derivatives of the u/w, v/w and 1/w maps into those of u and v.

    ``lit`` = (nw_planes f32 [E + B, 12], light [12], inv_vp [4, 4], eye
    [3], viewport [6]): nw_planes is concat(entry_extra, broad_extra), the
    normal/w planes indexed by the owner ids of K3 (broad owners start at
    E); the rest are host values."""
    valid = vis.owner >= 0
    denom = torch.where(vis.iw == 0, torch.ones_like(vis.iw), vis.iw)
    u = vis.uw / denom
    v = vis.vw / denom
    if aniso_taps and aniso_taps > 1:
        duw_dx, duw_dy = quad_derivatives(vis.uw)
        dvw_dx, dvw_dy = quad_derivatives(vis.vw)
        diw_dx, diw_dy = quad_derivatives(vis.iw)
        dudx = (duw_dx - u * diw_dx) / denom
        dudy = (duw_dy - u * diw_dy) / denom
        dvdx = (dvw_dx - v * diw_dx) / denom
        dvdy = (dvw_dy - v * diw_dy) / denom
        src = sample_anisotropic(
            texels, tex_offset, tex_width, tex_height, vis.tex, u, v,
            dudx, dvdx, dudy, dvdy, taps=int(aniso_taps))
    else:
        src = sample_bilinear(texels, tex_offset, tex_width, tex_height,
                              vis.tex, u, v)
    if lit is not None:
        nw_planes, light, inv_vp, eye, viewport = lit
        H, W = vis.owner.shape
        pl = nw_planes[torch.clamp(vis.owner.long(), 0,
                                   nw_planes.shape[0] - 1)]   # [H, W, 12]
        xc = (torch.arange(W, dtype=torch.float32, device=pl.device)
              + 0.5)[None, :]
        yc = (torch.arange(H, dtype=torch.float32, device=pl.device)
              + 0.5)[:, None]
        # interpolated world normal: plane-evaluate (n_k / w), then * w
        n = torch.stack([(pl[..., 3 * k] * xc + pl[..., 3 * k + 1] * yc)
                         + pl[..., 3 * k + 2] for k in range(3)],
                        dim=-1) / denom[..., None]
        p_world = unproject_window(valid, vis.depth, viewport, inv_vp, W, H)
        src = blinn_phong(src, n, p_world, light, eye)
    out = apply_blend(blend_state, src, dst_color)
    return torch.where(valid[..., None], out, dst_color)
