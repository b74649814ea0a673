"""Deferred shading of a visibility buffer (counterpart of
``tyleri_tpu/ops/shade.py``, unlit bilinear path).

The mesh fragment stage is a texture fetch (ref:
src/pipeline/glsl/common_pipeline.frag:11-12) followed by fixed-function
blending; the visibility pass already resolved the winner's u/w, v/w, 1/w
and texture slot per pixel, so shading is one texel-quad gather + blend.
"""

from __future__ import annotations

import torch

from tyleri_tpu.pipeline.state import BlendState
from tyleri_tpu_torch.ops.blend import apply_blend
from tyleri_tpu_torch.ops.sampling import sample_bilinear


def shade_visibility(vis, texels, tex_offset, tex_width, tex_height,
                     blend_state: BlendState, dst_color):
    """vis: VisibilityBuffer; texels f32 [cap, 16] quad arena;
    dst_color f32 [H, W, 4] -> blended color [H, W, 4]."""
    valid = vis.owner >= 0
    denom = torch.where(vis.iw == 0, torch.ones_like(vis.iw), vis.iw)
    u = vis.uw / denom
    v = vis.vw / denom
    src = sample_bilinear(texels, tex_offset, tex_width, tex_height,
                          vis.tex, u, v)
    out = apply_blend(blend_state, src, dst_color)
    return torch.where(valid[..., None], out, dst_color)
