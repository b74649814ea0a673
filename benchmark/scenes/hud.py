"""A game's HUD: a panel of solid quads on a 1x1 white texture and rows of
glyph quads on a 16x16 texture, per-corner colors with alpha 0.5 to 1, in
window points (the renderer's UI overlay of 128 quads, 256 triangles).
The seed picks the glyph texture, the glyph sizes and the colors."""

from __future__ import annotations

import numpy as np

from benchmark.scene import Overlay


def _quads(rng, boxes):
    verts, idx = [], []
    for q, (x0, y0, x1, y1) in enumerate(boxes):
        for (x, y), uv in zip(((x0, y0), (x1, y0), (x1, y1), (x0, y1)),
                              ((0, 0), (1, 0), (1, 1), (0, 1))):
            verts.append([x, y, *uv, *rng.uniform(0.2, 1.0, 3),
                          rng.uniform(0.5, 1.0)])
        idx += [4 * q + k for k in (0, 1, 2, 0, 2, 3)]
    return np.asarray(verts, np.float32), np.asarray(idx, np.uint32)


def build(params: dict, seed: int) -> Overlay:
    rng = np.random.default_rng(seed)
    g = params["glyph_texture"]
    textures = [np.ones((1, 1, 4), np.float32),
                rng.random((g, g, 4), np.float32)]
    x0, y0 = params["origin"]
    pw, ph = params["panel"]
    cells = params["panel_cells"]
    cw, ch = pw / cells, ph / cells
    panel = [(x0 + cw * i, y0 + ch * j, x0 + cw * (i + 1) - 2,
              y0 + ch * (j + 1) - 2) for j in range(cells) for i in range(cells)]
    lo, hi = params["glyph_size"]
    per_row = params["glyphs_per_row"]
    glyphs = []
    for k in range(params["glyphs"]):
        w, h = rng.uniform(lo, hi, 2)
        gx = x0 + params["glyph_pitch"][0] * (k % per_row)
        gy = y0 + ph + params["glyph_gap"] + params["glyph_pitch"][1] * (
            k // per_row)
        glyphs.append((gx, gy, gx + w, gy + h))
    elements = [(*_quads(rng, panel), 0), (*_quads(rng, glyphs), 1)]
    return Overlay(elements, textures, params.get("scale_factor", 1.0))
