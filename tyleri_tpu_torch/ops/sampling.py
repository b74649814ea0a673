"""Texture sampling from the flat texel-quad arena (counterpart of
``tyleri_tpu/ops/sampling.py``): bilinear, and anisotropic with
derivatives from 2x2 fragment quads.

Every texture is a row-major slice of one texel arena plus per-slot
(offset, width, height); the sampler is linear with mirrored-repeat
addressing.  ``make_texel_quads`` stores each texel's 2x2 block in one
16-float row, so one gather serves all four bilinear taps; it is numpy, a
copy of the JAX package's, whose module imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def make_texel_quads(texels, offsets, widths, heights) -> np.ndarray:
    """[cap, 4] rgba -> [cap, 16] quad rows: the 2x2 texel block (i, i+1,
    i+w, i+w+1), the next-row half clamped to the same row at each
    texture's last row.  The mirror function is 1-Lipschitz, so adjacent
    taps land on neighboring-or-equal texels and one row serves all four."""
    texels = np.asarray(texels, np.float32)
    n = len(texels)
    nxt = np.concatenate([texels[1:], texels[-1:]], axis=0)
    pairs = np.concatenate([texels, nxt], axis=1)          # [cap, 8]
    row2 = np.arange(n, dtype=np.int64)
    for off, w, h in zip(offsets, widths, heights):
        end = min(off + w * h, n)
        idx = np.arange(off, end)
        local_row = (idx - off) // max(w, 1)
        row2[off:end] = np.minimum(np.where(local_row + 1 < h, idx + w, idx),
                                   n - 1)
    return np.concatenate([pairs, pairs[row2]], axis=1)     # [cap, 16]


def mirror_repeat(i, n):
    """MIRRORED_REPEAT addressing of integer texel coords."""
    m = torch.remainder(i, 2 * n)  # non-negative for n > 0
    return torch.where(m >= n, 2 * n - 1 - m, m)


def sample_bilinear(texel_quads, tex_offset, tex_width, tex_height, tex_id,
                    u, v):
    """texel_quads f32 [cap, 16]; tex_offset/width/height i32 [slots];
    tex_id i32 [...]; u, v f32 [...] -> rgba f32 [..., 4]."""
    tid = torch.clamp(tex_id.long(), 0, tex_offset.shape[0] - 1)
    off = tex_offset.long()[tid]
    w = torch.clamp(tex_width.long()[tid], min=1)
    h = torch.clamp(tex_height.long()[tid], min=1)

    tu = u * w.to(torch.float32) - 0.5
    tv = v * h.to(torch.float32) - 0.5
    iu0 = torch.floor(tu)
    iv0 = torch.floor(tv)
    fu = (tu - iu0)[..., None]
    fv = (tv - iv0)[..., None]
    iu0 = iu0.to(torch.int64)
    iv0 = iv0.to(torch.int64)

    iu0m = mirror_repeat(iu0, w)
    iu1m = mirror_repeat(iu0 + 1, w)
    iv0m = mirror_repeat(iv0, h)
    iv1m = mirror_repeat(iv0 + 1, h)
    bx = torch.minimum(iu0m, iu1m)
    by = torch.minimum(iv0m, iv1m)
    quad = texel_quads[off + by * w + bx]          # [..., 16] one gather
    row_lo, row_hi = quad[..., :8], quad[..., 8:]

    def row(yy):
        return torch.where((yy != by)[..., None], row_hi, row_lo)

    def tap(r, xx):
        return torch.where((xx != bx)[..., None], r[..., 4:8], r[..., :4])

    r0, r1 = row(iv0m), row(iv1m)
    top = tap(r0, iu0m) * (1.0 - fu) + tap(r0, iu1m) * fu
    bot = tap(r1, iu0m) * (1.0 - fu) + tap(r1, iu1m) * fu
    return top * (1.0 - fv) + bot * fv


def quad_derivatives(f: torch.Tensor):
    """GPU-style 2x2 fragment-quad derivatives (dFdx, dFdy) of f [H, W]:
    the four pixels of each screen-aligned quad share its forward
    differences; an odd last row or column replicates its edge."""
    H, W = f.shape[-2:]
    fp = f
    if W % 2:
        fp = torch.cat([fp, fp[:, -1:]], dim=1)
    if H % 2:
        fp = torch.cat([fp, fp[-1:]], dim=0)
    Hp, Wp = fp.shape
    q = fp.reshape(Hp // 2, 2, Wp // 2, 2)
    dx = (q[:, :, :, 1:2] - q[:, :, :, 0:1]).expand(q.shape)
    dy = (q[:, 1:2, :, :] - q[:, 0:1, :, :]).expand(q.shape)
    return (dx.reshape(Hp, Wp)[:H, :W], dy.reshape(Hp, Wp)[:H, :W])


def sample_anisotropic(texel_quads, tex_offset, tex_width, tex_height,
                       tex_id, u, v, dudx, dvdx, dudy, dvdy, *, taps: int):
    """``taps`` bilinear taps spread along the major axis of each pixel's
    texel-space footprint, averaged (the sampler's max_sampler_anisotropy,
    ref: builders.rs:300-320).  With no mip chain the spread is clamped to
    ``taps`` texels; a sub-texel footprint collapses onto the bilinear
    result."""
    tid = torch.clamp(tex_id.long(), 0, tex_offset.shape[0] - 1)
    w = torch.clamp(tex_width.long()[tid], min=1).to(torch.float32)
    h = torch.clamp(tex_height.long()[tid], min=1).to(torch.float32)
    lx = (dudx * w) ** 2 + (dvdx * h) ** 2
    ly = (dudy * w) ** 2 + (dvdy * h) ** 2
    use_x = lx >= ly
    mu = torch.where(use_x, dudx, dudy)
    mv = torch.where(use_x, dvdx, dvdy)
    lmaj = torch.sqrt(torch.maximum(lx, ly))
    scale = torch.where(lmaj > taps, taps / torch.clamp(lmaj, min=1e-30),
                        torch.ones_like(lmaj))
    mu = mu * scale
    mv = mv * scale
    acc = None
    for i in range(taps):
        t = (i + 0.5) / taps - 0.5
        s = sample_bilinear(texel_quads, tex_offset, tex_width, tex_height,
                            tex_id, u + mu * t, v + mv * t)
        acc = s if acc is None else acc + s
    return acc / taps
