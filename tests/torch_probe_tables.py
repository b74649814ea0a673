"""Inputs for the P3 probe's tests (tools/exp_visibility.py): a random
entry table whose planes are exact in f32 whatever the order of
evaluation, and tile segments over a 256 x 48 frame; and P7's depth buffer
(tools/exp_fixed_grid.py) with hot blocks.

Edge coefficients are k/8 (|k| < 128) with offsets on the 1/16 grid,
depth coefficients on the 2^-20 grid, attribute planes k/8 and k/16; orders
take 64 values (many ties).  Segments are sorted by CH_ZMIN (as binning
sorts them), start off the chunk grid, some are empty, and the last ends
3 rows before the table's end, where the chunk clamp re-reads earlier rows
(or, skewed, two tiles hold most of the entries).
2 % of the entries cover a whole tile at depth 0.25 with a small CH_ZMIN,
so the early exit fires.
"""

from __future__ import annotations

import numpy as np

FB_W, FB_H = 256, 48
TILE_W = 128


def snapped_table(rng, E):
    tab = np.zeros((E, 24), np.float32)

    def k(scale, lim=127):
        return rng.integers(-lim, lim + 1, E) * scale

    px = rng.integers(0, FB_W, E) + 0.5
    py = rng.integers(0, FB_H, E) + 0.5
    for row in (0, 3):   # edge planes through a random pixel centre
        a, b = k(1 / 8), k(1 / 8)
        tab[:, row], tab[:, row + 1] = a, b
        tab[:, row + 2] = -(a * px + b * py) + k(1 / 16, 40)
    tab[:, 6] = rng.integers(0, 4000, E) / 16          # |2A|
    tab[:, 9], tab[:, 10] = k(2.0 ** -20), k(2.0 ** -20)
    tab[:, 11] = rng.integers(-50_000, 1_100_000, E) * 2.0 ** -20
    for row in (12, 15, 18):
        tab[:, row], tab[:, row + 1], tab[:, row + 2] = (
            k(1 / 8), k(1 / 8), k(1 / 16, 4000))
    tab[:, 21] = (rng.integers(0, 8, E) << 18) | rng.integers(0, 5, E)
    tab[:, 22] = rng.integers(0, 64, E)                 # many order ties
    tab[:, 23] = rng.integers(0, 65536, E)
    cover = rng.random(E) < 0.02     # whole-tile entries, shallow depth
    tab[cover, 0:6] = [0, 0, 4096, 0, 0, 4096]
    tab[cover, 6] = 3 * 4096
    tab[cover, 9:12] = [0, 0, 0.25]
    tab[cover, 23] = rng.integers(0, 4096, cover.sum())
    return tab


def segments(rng, ntiles, E, chunk=128):
    lens = rng.integers(0, 3 * chunk, ntiles) * (rng.random(ntiles) < 0.85)
    ts = np.concatenate([[37], 37 + np.cumsum(lens)])
    ts = np.minimum(ts, E - 3)   # the last segment ends near the table end
    return ts.astype(np.int32)


def skewed_segments(rng, ntiles, E):
    """A few tiles hold most entries (500 to 700 each against 0 to 40), in
    no order of length: the kernel's tile order launches them first."""
    lens = rng.integers(0, 41, ntiles)
    heavy = rng.choice(ntiles, min(2, ntiles), replace=False)
    lens[heavy] = rng.integers(500, 701, heavy.size)
    ts = np.concatenate([[37], 37 + np.cumsum(lens)])
    return np.minimum(ts, E - 3).astype(np.int32)


def zmin_sorted(tab, ts):
    tab = tab.copy()
    for s, e in zip(ts[:-1], ts[1:]):
        tab[s:e] = tab[s:e][np.argsort(tab[s:e, 23], kind="stable")]
    return tab


def inputs(seed, tile_h, E=1600, skew=False):
    """(table f32 [E, 24], tile starts i32, depth0 f32 [48, 256] of
    ones, grid_w, grid_h) for tiles of 128 x tile_h; ``skew``: the segments
    of ``skewed_segments``."""
    rng = np.random.default_rng(seed)
    grid_w, grid_h = -(-FB_W // TILE_W), -(-FB_H // tile_h)
    ts = (skewed_segments if skew else segments)(rng, grid_w * grid_h, E)
    tab = zmin_sorted(snapped_table(rng, E), ts)
    depth0 = np.ones((FB_H, FB_W), np.float32)
    return tab, ts, depth0, grid_w, grid_h


def packed_edge_segments(lane, E=1600):
    """Tile starts over E entries for 2 x 6 tiles of 128 x 16 (a 256 x 96
    frame), the first starting on lane ``lane`` of a packed row: segments
    that start and end on every lane, an empty one, some inside one row,
    long ones across windows, and a last one that runs to entry E, so that
    on a packed table without its pad rows its last window is clamped at
    cap - 130."""
    lens = [2, 0, 1, 3, 4, 139, 6, 262, 9, 133, 2]
    ts = np.concatenate([[200 + lane], 200 + lane + np.cumsum(lens), [E]])
    return ts.astype(np.int32)


def depth_with_hot_blocks(seed):
    """A D16-grid depth buffer with a few values above 2.0, so some blocks'
    max adds 1.0."""
    rng = np.random.default_rng(seed)
    d = (rng.integers(0, 65536, (1080, 1920)) / 65535.0).astype(np.float32)
    d[rng.integers(0, 1080, 12), rng.integers(0, 1920, 12)] = 2.5
    return d
