"""The plain version of K3, ``rasterize_visibility_reference``, against the
JAX package's visibility resolve: the Pallas kernel in interpret mode and
the XLA path, on the same binned table (built once by the JAX package and
handed to both).

The scenes are grid-snapped, as in tests/test_raster_pallas.py, so edge
functions and depths are exact in f32 whatever the evaluation order:
owner validity, depth, draw order and texture slot must be equal.  The
u/w, v/w and 1/w maps evaluate planes with random coefficients, where XLA
on the CPU contracts ``a * x + b`` into a fused multiply-add and PyTorch
does not: they must agree to 2 ulp of the sum of the plane's terms.

Owner ids are not compared: they index the entry table, whose order among
equal sort keys is not fixed.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tyleri_tpu.ops import binning as jbinning
from tyleri_tpu.ops import setup as jsetup
from tyleri_tpu.ops import visibility as jvis
from tyleri_tpu.ops.raster_pallas import rasterize_visibility_pallas
from tyleri_tpu.pipeline.state import CompareOp, DepthFormat, DepthState
from tyleri_tpu_torch.ops import raster_cuda
from tyleri_tpu_torch.ops import setup as tsetup
from tyleri_tpu_torch.ops.binning import BinnedEntries

FB_W, FB_H = 256, 32
TILE_W, TILE_H = 128, 8
GRID = dict(grid_w=FB_W // TILE_W, grid_h=FB_H // TILE_H)


def snapped_scene(rng, T=40, grid=16):
    """Random triangles on a coarse NDC grid at z in 1/64 steps, plus a
    screen-sized (broad) triangle and an exact duplicate of triangle 0 (a
    depth and coverage tie that draw order must arbitrate)."""
    xy = rng.integers(-grid - 2, grid + 3, size=(T, 3, 2)) / grid
    z = rng.integers(1, 63, size=(T,)) / 64.0
    clip = np.ones((T + 2, 3, 4), np.float32)
    clip[:T, :, :2] = xy
    clip[:T, :, 2] = z[:, None]
    clip[T] = [[-4, -4, 0.875, 1], [4, -4, 0.875, 1], [0, 4, 0.875, 1]]
    clip[T + 1] = clip[0]
    uv = rng.random((T + 2, 3, 2)).astype(np.float32)
    tex = rng.integers(0, 3, T + 2).astype(np.int32)
    return clip, uv, tex


def binned_table(clip, uv, tex, scissor):
    su = jsetup.setup_triangles(
        jnp.asarray(clip), jnp.asarray(uv), jnp.asarray(tex),
        jnp.ones((len(clip),), bool),
        jnp.asarray([0, 0, FB_W, FB_H, 0, 1], jnp.float32),
        jnp.asarray(scissor, jnp.int32), tile_w=TILE_W, tile_h=TILE_H, **GRID)
    return jbinning.bin_triangles(su, entry_cap=1024, max_tiles_per_tri=2,
                                  broad_cap=64, **GRID)


def to_torch(b) -> BinnedEntries:
    return BinnedEntries(**{
        f: torch.from_numpy(np.array(getattr(b, f)))
        for f in BinnedEntries._fields})


def depth_state(op, fmt=DepthFormat.D16_UNORM):
    return DepthState(test_enable=True, write_enable=True, compare_op=op,
                      format=fmt)


def assert_maps_match(got, want, binned, name):
    g_won = got.owner.numpy() >= 0
    w_won = np.asarray(want.owner) >= 0
    np.testing.assert_array_equal(g_won, w_won, f"{name}: owner valid")
    assert g_won.any()
    np.testing.assert_array_equal(got.depth.numpy(), np.asarray(want.depth),
                                  f"{name}: depth")
    np.testing.assert_array_equal(got.order.numpy(), np.asarray(want.order),
                                  f"{name}: order")
    np.testing.assert_array_equal(got.tex.numpy(), np.asarray(want.tex),
                                  f"{name}: tex")
    # the winner's plane terms bound the rounding of either evaluation
    ch = torch.cat([binned.entry_channels, binned.broad_channels]).numpy()
    ch = ch[np.maximum(got.owner.numpy(), 0)].astype(np.float64)
    y, x = np.mgrid[0:FB_H, 0:FB_W] + 0.5
    for m, row in (("uw", tsetup.CH_UW), ("vw", tsetup.CH_VW),
                   ("iw", tsetup.CH_INVW)):
        g, w = getattr(got, m).numpy(), np.asarray(getattr(want, m))
        terms = (np.abs(ch[..., row]) * x + np.abs(ch[..., row + 1]) * y
                 + np.abs(ch[..., row + 2]))
        tol = np.where(g_won, 2 * 2.0 ** -23 * terms, 0.0)
        assert (np.abs(g - w) <= tol).all(), f"{name}: {m}"


CASES = {
    "le": (CompareOp.LESS_OR_EQUAL, None, False),
    "less": (CompareOp.LESS, None, False),
    "le_scissor": (CompareOp.LESS_OR_EQUAL, (24, 5, 150, 20), False),
    "less_prior_depth": (CompareOp.LESS, None, True),
    "le_prior_depth": (CompareOp.LESS_OR_EQUAL, None, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_pallas_and_xla(case):
    op, sc, prior = CASES[case]
    rng = np.random.default_rng(31)
    clip, uv, tex = snapped_scene(rng)
    scissor = np.asarray(sc or (0, 0, FB_W, FB_H), np.int32)
    binned = binned_table(clip, uv, tex, scissor)
    depth0 = np.ones((FB_H, FB_W), np.float32)
    if prior:   # content already in the depth buffer, on the D16 grid
        depth0 = (rng.integers(0, 64, (FB_H, FB_W)) * 1024 / 65535.0
                  ).astype(np.float32)
    ds = depth_state(op)
    kw = dict(fb_w=FB_W, fb_h=FB_H, tile_w=TILE_W, tile_h=TILE_H, **GRID,
              depth_state=ds)
    want_pallas, _ = rasterize_visibility_pallas(
        binned, jnp.asarray(depth0), jnp.asarray(scissor), chunk=128,
        interpret=True, **kw)
    want_xla, _ = jvis.rasterize_visibility(
        binned, jnp.asarray(depth0), jnp.asarray(scissor), cap_per_tile=256,
        chunk=32, **kw)
    got = raster_cuda.rasterize_visibility(
        to_torch(binned), torch.from_numpy(depth0), scissor, **kw)
    assert raster_cuda.launches == 0  # CPU tensors take the plain version
    # narrow and broad entries, nothing dropped
    assert int(binned.num_broad) > 1 and int(binned.overflow) == 0
    tb = to_torch(binned)
    assert_maps_match(got, want_pallas, tb, "vs pallas")
    assert_maps_match(got, want_xla, tb, "vs xla")
