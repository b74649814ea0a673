"""An adversarial overdraw table for K3's peel2 and visit-counter variants.

Layer 2 of peel2 depends on the order in which a pixel's fragments arrive
(binning's z-sorted stream) against the order in which they were drawn
(CH_ORDER).  This table makes the two disagree everywhere: stacks of
patches at depths from a coarse set (exact depth ties) drawn in a random
permutation, small triangles scattered over the stacks, and one broad
triangle that every tile scans after its segment.
"""

from __future__ import annotations

import numpy as np
import torch

from tyleri_tpu_torch.ops import setup as S
from tyleri_tpu_torch.ops.binning import bin_triangles


def overdraw_clip(rng, n_stacks: int = 24, layers=(3, 7), n_small: int = 2000):
    """Clip-space triangles [T, 3, 4] (w = 1, identity view) and a draw
    order [T] that is a random permutation of the rows."""
    tris = []
    for _ in range(n_stacks):
        cx, cy = rng.uniform(-0.9, 0.9, 2)
        half = rng.uniform(0.05, 0.3)
        for z in rng.integers(1, 9, int(rng.integers(*layers))) / 9.0:
            x0, x1, y0, y1 = cx - half, cx + half, cy - half, cy + half
            tris.append([[x0, y0, z], [x1, y0, z], [x0, y1, z]])
            tris.append([[x1, y1, z], [x0, y1, z], [x1, y0, z]])
    center = rng.uniform(-1.05, 1.05, (n_small, 1, 2))
    xy = center + rng.uniform(0.01, 0.2, (n_small, 1, 1)) * rng.uniform(
        -1, 1, (n_small, 3, 2))
    z = np.where(rng.random((n_small, 1)) < 0.5,
                 rng.integers(1, 9, (n_small, 1)) / 9.0,
                 rng.uniform(0.0, 1.0, (n_small, 3)))
    small = np.concatenate([xy, np.broadcast_to(z, (n_small, 3))[..., None]],
                           axis=-1)
    broad = [[[-3.0, -3.0, 0.5], [3.0, -3.0, 0.5], [0.0, 3.0, 0.5]]]
    tri = np.concatenate([np.asarray(tris), small, np.asarray(broad)])
    clip = np.ones((len(tri), 3, 4), np.float32)
    clip[..., :3] = tri
    return clip, rng.permutation(len(tri)).astype(np.float32)


def overdraw_table(device, rng, W: int, H: int, tile=(16, 16)):
    """The binned table of ``overdraw_clip`` at W x H, and the K3 shape
    keywords (fb_w, fb_h, tile_w, tile_h, grid_w, grid_h)."""
    clip, order = overdraw_clip(rng)
    T = len(clip)
    uv = rng.random((T, 3, 2)).astype(np.float32)
    tex = rng.integers(0, 4, T).astype(np.int32)
    t = [torch.from_numpy(a).to(device) for a in (clip, uv, tex, order)]
    gw, gh = -(-W // tile[0]), -(-H // tile[1])
    su = S.setup_triangles(
        t[0], t[1], t[2], torch.ones(T, dtype=torch.bool, device=device),
        [0, 0, W, H, 0, 1], [0, 0, W, H], tile_w=tile[0], tile_h=tile[1],
        grid_w=gw, grid_h=gh, order=t[3])
    binned = bin_triangles(su, grid_w=gw, grid_h=gh, entry_cap=1 << 18,
                           max_tiles_per_tri=32, broad_cap=1024,
                           spill_cap=1 << 17)
    return binned, dict(fb_w=W, fb_h=H, tile_w=tile[0], tile_h=tile[1],
                        grid_w=gw, grid_h=gh)
