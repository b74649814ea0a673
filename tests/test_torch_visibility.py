"""The plain versions of K3 against the JAX package's visibility resolve:
the Pallas kernel in interpret mode and the XLA path, on the same binned
table (built once by the JAX package and handed to both).

``rasterize_visibility_reference`` (the base variant) against both;
``rasterize_visibility_stream_reference`` against the Pallas kernel with
peel2 (both layers) and with ``debug_counts`` (the per-tile visit counts),
and, with neither, against the base plain version.

The scenes are grid-snapped, as in tests/test_raster_pallas.py, so edge
functions and depths are exact in f32 whatever the evaluation order:
owner validity, depth, draw order and texture slot must be equal.  The
u/w, v/w and 1/w maps evaluate planes with random coefficients, where XLA
on the CPU contracts ``a * x + b`` into a fused multiply-add and PyTorch
does not: they must agree to 2 ulp of the sum of the plane's terms.

The base variant's owner ids are not compared with the XLA path's: they
index the entry table, whose order among equal sort keys is not fixed.  The
stream version and the Pallas kernel read one table, so their owner ids
must be equal, in both layers.
"""

import zlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tyleri_tpu.ops import binning as jbinning
from tyleri_tpu.ops import setup as jsetup
from tyleri_tpu.ops import visibility as jvis
from tyleri_tpu.ops.raster_pallas import rasterize_visibility_pallas
from tyleri_tpu.pipeline.state import CompareOp, DepthFormat, DepthState
from tyleri_tpu_torch import _build
from tyleri_tpu_torch.interop import from_jax
from tyleri_tpu_torch.ops import binning as tbinning
from tyleri_tpu_torch.ops import raster_cuda
from tyleri_tpu_torch.ops import setup as tsetup
from tyleri_tpu_torch.ops.binning import BinnedEntries
from tyleri_tpu_torch.ops.visibility import (
    rasterize_visibility_reference,
    rasterize_visibility_stream_reference,
)

from test_torch_setup import order_values, port_channels

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
    """The JAX package's binned table in the port's encoding."""
    out = {f: torch.from_numpy(np.array(getattr(b, f)))
           for f in BinnedEntries._fields if getattr(b, f) is not None}
    for f in ("entry_channels", "broad_channels"):
        out[f] = port_channels(out[f])
    return BinnedEntries(**out)


def depth_state(op, fmt=DepthFormat.D16_UNORM):
    return DepthState(test_enable=True, write_enable=True, compare_op=op,
                      format=fmt)


def port(kw):
    """The same keywords with the JAX depth state rebuilt with the port's
    classes."""
    return dict(kw, depth_state=from_jax(kw["depth_state"]))


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
    _build.reset_launches()
    got = raster_cuda.rasterize_visibility(
        to_torch(binned), torch.from_numpy(depth0), scissor, **port(kw))
    assert not _build.launches  # CPU tensors take the plain version
    # narrow and broad entries, nothing dropped
    assert int(binned.num_broad) > 1 and int(binned.overflow) == 0
    tb = to_torch(binned)
    assert_maps_match(got, want_pallas, tb, "vs pallas")
    assert_maps_match(got, want_xla, tb, "vs xla")


def test_wrapper_rejects_peel2_with_counts():
    """As raster_pallas.py:567-568: the two variants do not compose."""
    rng = np.random.default_rng(31)
    binned = to_torch(binned_table(*snapped_scene(rng),
                                   np.asarray((0, 0, FB_W, FB_H), np.int32)))
    kw = dict(fb_w=FB_W, fb_h=FB_H, tile_w=TILE_W, tile_h=TILE_H, **GRID,
              depth_state=depth_state(CompareOp.LESS_OR_EQUAL), peel2=True,
              counts=True)
    depth0 = torch.ones((FB_H, FB_W))
    for fn in (raster_cuda.rasterize_visibility,
               rasterize_visibility_stream_reference):
        with pytest.raises(ValueError):
            fn(binned, depth0, (0, 0, FB_W, FB_H), **port(kw))


@pytest.mark.parametrize("case", sorted(CASES))
def test_stream_reference_without_peel2_equals_packed(case):
    """The two plain versions resolve the same maps, owner ids included."""
    op, sc, prior = CASES[case]
    rng = np.random.default_rng(31)
    clip, uv, tex = snapped_scene(rng)
    scissor = np.asarray(sc or (0, 0, FB_W, FB_H), np.int32)
    binned = to_torch(binned_table(clip, uv, tex, scissor))
    depth0 = torch.ones((FB_H, FB_W))
    if prior:
        depth0 = torch.from_numpy((rng.integers(0, 64, (FB_H, FB_W)) * 1024
                                   / 65535.0).astype(np.float32))
    kw = dict(fb_w=FB_W, fb_h=FB_H, tile_w=TILE_W, tile_h=TILE_H, **GRID,
              depth_state=depth_state(op))
    got = rasterize_visibility_stream_reference(binned, depth0, scissor,
                                                **port(kw))
    want = rasterize_visibility_reference(binned, depth0, scissor,
                                          **port(kw))
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def layers_scene(zs):
    """A full-cover quad (two triangles) per z, drawn in list order
    (tests/test_raster_pallas.py:494-506)."""
    T = 2 * len(zs)
    clip = np.ones((T, 3, 4), np.float32)
    for i, z in enumerate(zs):
        for j, tri in enumerate([[[-2, -2], [4, -2], [-2, 4]],
                                 [[4, 4], [-2, 4], [4, -2]]]):
            clip[2 * i + j, :, :2] = tri
            clip[2 * i + j, :, 2] = z
    return clip


def peel2_case(name):
    """(clip, uv, tex, scissor, compare op, depth0) of one overdraw case of
    tests/test_raster_pallas.py:459-638, or of the snapped scene."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    op = CompareOp.LESS_OR_EQUAL
    scissor, depth0 = (0, 0, FB_W, FB_H), np.ones((FB_H, FB_W), np.float32)
    if name.startswith("snapped_"):
        op, sc, prior = CASES[name[len("snapped_"):]]
        clip, uv, tex = snapped_scene(np.random.default_rng(31))
        scissor = sc or scissor
        if prior:
            depth0 = (rng.integers(0, 64, (FB_H, FB_W)) * 1024
                      / 65535.0).astype(np.float32)
    else:
        if name == "prior_record":     # layer 2 is mid, not 'between'
            zs = [0.5, 0.3, 0.4]
        elif name == "nonsurvivors":   # far drawn after near never blends
            zs = [0.3, 0.7]
        elif name == "back_to_front":  # every fragment survives
            zs = [0.9, 0.6, 0.3, 0.1]
        elif name == "exit_bound":     # see below
            zs = []
        else:                          # random layers, ties, LE and LESS
            k = int(name[len("permutation"):])
            op = CompareOp.LESS_OR_EQUAL if k % 2 else CompareOp.LESS
            zs = np.round(rng.uniform(0.05, 0.95, int(rng.integers(3, 7))), 3)
            i, j = rng.choice(len(zs), 2, replace=False)
            zs[j] = zs[i]
        clip = layers_scene(list(zs))
        if name == "exit_bound":       # far triangles, two quads drawn last
            far = np.ones((96, 3, 4), np.float32)
            far[..., :2] = rng.uniform(-1, 1, (96, 3, 2)) * 0.9
            far[..., 2] = 0.9
            clip = np.concatenate([far, layers_scene([0.5, 0.1])])
        uv = rng.random((len(clip), 3, 2)).astype(np.float32)
        tex = rng.integers(0, 3, len(clip)).astype(np.int32)
    return clip, uv, tex, np.asarray(scissor, np.int32), op, depth0


PEEL2_CASES = (["prior_record", "nonsurvivors", "back_to_front",
                "exit_bound"] + [f"permutation{k}" for k in range(6)]
               + [f"snapped_{c}" for c in sorted(CASES)])


def assert_layer_matches(got, want, binned, name):
    """Owner ids, depth, order and tex equal; u/w, v/w, 1/w within 2 ulp
    of the plane terms where the layer has an owner, equal where it was
    never written.  A gated layer-2 slot (owner -1 at a recorded depth)
    keeps the attributes of a former winner, which no shade reads."""
    for f in ("owner", "depth", "order", "tex"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      f"{name}: {f}")
    owner = got.owner.numpy()
    unset = (owner < 0) & (got.order.numpy() < 0)
    ch = torch.cat([binned.entry_channels, binned.broad_channels]).numpy()
    ch = ch[np.maximum(owner, 0)].astype(np.float64)
    y, x = np.mgrid[0:FB_H, 0:FB_W] + 0.5
    for m, row in (("uw", tsetup.CH_UW), ("vw", tsetup.CH_VW),
                   ("iw", tsetup.CH_INVW)):
        g, w = getattr(got, m).numpy(), np.asarray(getattr(want, m))
        terms = (np.abs(ch[..., row]) * x + np.abs(ch[..., row + 1]) * y
                 + np.abs(ch[..., row + 2]))
        bad = np.where(owner >= 0, np.abs(g - w) > 2 * 2.0 ** -23 * terms,
                       unset & (g != w))
        assert not bad.any(), f"{name}: {m}"


@pytest.mark.parametrize("case", PEEL2_CASES)
def test_stream_reference_peel2_matches_pallas(case):
    clip, uv, tex, scissor, op, depth0 = peel2_case(case)
    su = jsetup.setup_triangles(
        jnp.asarray(clip), jnp.asarray(uv), jnp.asarray(tex),
        jnp.ones((len(clip),), bool),
        jnp.asarray([0, 0, FB_W, FB_H, 0, 1], jnp.float32),
        jnp.asarray(scissor), tile_w=TILE_W, tile_h=TILE_H, **GRID)
    binned = jbinning.bin_triangles(su, entry_cap=1024, max_tiles_per_tri=8,
                                    broad_cap=64, **GRID)
    assert int(binned.overflow) == 0
    kw = dict(fb_w=FB_W, fb_h=FB_H, tile_w=TILE_W, tile_h=TILE_H, **GRID,
              depth_state=depth_state(op))
    want, want2, _ = rasterize_visibility_pallas(
        binned, jnp.asarray(depth0), jnp.asarray(scissor), chunk=128,
        interpret=True, peel2=True, **kw)
    tb = to_torch(binned)
    _build.reset_launches()
    got, got2 = raster_cuda.rasterize_visibility(
        tb, torch.from_numpy(depth0), scissor, peel2=True, **port(kw))
    assert not _build.launches   # CPU tensors take the plain version
    assert_layer_matches(got, want, tb, f"{case} layer 1")
    assert_layer_matches(got2, want2, tb, f"{case} layer 2")
    assert (got.owner >= 0).any()
    if case in ("prior_record", "back_to_front"):
        assert (got2.owner >= 0).all()


def counts_table(rng, near_quads: bool, T=1500):
    """Deep tile segments (several 128-row chunks) and optionally two
    full-cover quads in front, which end most segments early.  The entry
    capacity leaves room past every segment: no chunk window of the JAX
    kernel clamps against it (raster_pallas.py:343-344)."""
    clip = np.ones((T, 3, 4), np.float32)
    clip[..., :2] = (rng.uniform(-1.1, 1.1, (T, 1, 2))
                     + 0.3 * rng.uniform(-1, 1, (T, 3, 2)))
    clip[..., 2] = rng.uniform(0.2, 0.95, (T, 1))
    if near_quads:
        clip[:4] = layers_scene([0.05, 0.1])
    uv = rng.random((T, 3, 2)).astype(np.float32)
    su = jsetup.setup_triangles(
        jnp.asarray(clip), jnp.asarray(uv), jnp.zeros((T,), jnp.int32),
        jnp.ones((T,), bool),
        jnp.asarray([0, 0, FB_W, FB_H, 0, 1], jnp.float32),
        jnp.asarray([0, 0, FB_W, FB_H], jnp.int32), tile_w=TILE_W,
        tile_h=TILE_H, **GRID)
    return jbinning.bin_triangles(su, entry_cap=1 << 13, max_tiles_per_tri=8,
                                  broad_cap=64, **GRID)


@pytest.mark.parametrize("case", ["exit_le", "exit_less",
                                  "scissor_no_exit", "prior_depth"])
def test_stream_reference_counts_match_pallas_debug_counts(case):
    rng = np.random.default_rng(57)
    binned = counts_table(rng, near_quads=case.startswith("exit"))
    ts = np.asarray(binned.tile_start)
    assert np.diff(ts).min() > 2 * 128      # three chunks or more
    assert ts[-1] + 128 <= binned.entry_channels.shape[0]
    op = CompareOp.LESS if case == "exit_less" else CompareOp.LESS_OR_EQUAL
    depth0 = np.ones((FB_H, FB_W), np.float32)
    if case == "prior_depth":
        depth0 = (rng.integers(20000, 40000, (FB_H, FB_W))
                  / 65535.0).astype(np.float32)
    # the scissor keeps a column of every tile at depth 1: no exit
    scissor = np.asarray((1, 0, FB_W - 2, FB_H) if case == "scissor_no_exit"
                         else (0, 0, FB_W, FB_H), np.int32)
    kw = dict(fb_w=FB_W, fb_h=FB_H, tile_w=TILE_W, tile_h=TILE_H, **GRID,
              depth_state=depth_state(op))
    want, _, want_nvis = rasterize_visibility_pallas(
        binned, jnp.asarray(depth0), jnp.asarray(scissor), chunk=128,
        interpret=True, debug_counts=True, **kw)
    tb = to_torch(binned)
    got, nvis = raster_cuda.rasterize_visibility(
        tb, torch.from_numpy(depth0), scissor, chunk=128, counts=True,
        **port(kw))
    np.testing.assert_array_equal(nvis.numpy(), np.asarray(want_nvis))
    assert_layer_matches(got, want, tb, case)
    skipped = int(binned.num_entries) - int(nvis.sum())
    assert (skipped > 0) == (case != "scissor_no_exit"), skipped


SLIVER_W, SLIVER_H, SLIVER_TS = 1920, 1080, 32   # tiles that keep it narrow
SLIVER_DIMS = dict(fb_w=SLIVER_W, fb_h=SLIVER_H, tile_w=SLIVER_TS,
                   tile_h=SLIVER_TS, grid_w=SLIVER_W // SLIVER_TS,
                   grid_h=-(-SLIVER_H // SLIVER_TS))
SLIVER_ORDER = 4.0   # the sliver is drawn after the quad's four triangles


def sliver_table():
    """A nearly degenerate triangle (the sliver) whose z plane dips below
    its CH_ZMIN bound at some covered pixel, and a quad over the 3x3 tiles
    around that pixel, in front of the bound and behind the dip, drawn
    twice: four rows, a whole chunk of the JAX kernel's 4-entry unroll.
    Returns the port's binned table, the pixel (px, py) and the quad's
    depth."""
    W, H, TS = SLIVER_W, SLIVER_H, SLIVER_TS
    grid = {k: SLIVER_DIMS[k] for k in ("grid_w", "grid_h")}
    sx = np.array([1592.34859772, 1647.14708893, 1614.07301195])
    sy = np.array([672.10818587, 585.8446154, 638.0123347])
    sliver = np.ones((1, 3, 4), np.float32)
    sliver[0, :, 0] = sx / W * 2 - 1
    sliver[0, :, 1] = sy / H * 2 - 1
    sliver[0, :, 2] = [0.98037156, 0.97925051, 0.97559488]

    def table(clip):
        T = len(clip)
        su = tsetup.setup_triangles(
            torch.from_numpy(clip), torch.zeros((T, 3, 2)),
            torch.zeros(T, dtype=torch.int32), torch.ones(T, dtype=torch.bool),
            [0, 0, W, H, 0, 1], [0, 0, W, H], tile_w=TS, tile_h=TS, **grid)
        return su, tbinning.bin_triangles(su, entry_cap=1024, broad_cap=4,
                                          **grid)

    # the sliver's deepest dip below its bound, at a covered pixel center
    su, _ = table(sliver)
    ch = su.channels[0]
    ys, xs = np.mgrid[580:680, 1590:1650]
    xf = torch.from_numpy(xs.ravel() + 0.5).float()
    yf = torch.from_numpy(ys.ravel() + 0.5).float()
    z = (ch[tsetup.CH_Z] * xf + ch[tsetup.CH_Z + 1] * yf) + ch[tsetup.CH_Z + 2]
    e0 = (ch[0] * xf + ch[1] * yf) + ch[2]
    e1 = (ch[3] * xf + ch[4] * yf) + ch[5]
    inside = (e0 > 0) & (e1 > 0) & ((ch[tsetup.CH_TWOA] - e0) - e1 > 0)
    zq = torch.round(z * 65535.0)
    i = int(torch.where(inside, zq, torch.inf).argmin())
    bound = float(ch[tsetup.CH_ZMIN])
    assert inside[i] and zq[i] < bound, (float(zq[i]), bound)
    px, py = int(xs.ravel()[i]), int(ys.ravel()[i])

    # the quad is streamed first in every tile it covers (its own bound
    # is smaller)
    d = float((zq[i] + bound) // 2) / 65535.0
    x0, y0 = (px // TS - 1) * TS, (py // TS - 1) * TS
    quad = np.ones((2, 3, 4), np.float32)
    for k, tri in enumerate([[(0, 0), (1, 0), (0, 1)], [(1, 1), (0, 1),
                                                        (1, 0)]]):
        for c, (u, v) in enumerate(tri):
            quad[k, c, 0] = (x0 - 0.25 + u * 3 * TS) / W * 2 - 1
            quad[k, c, 1] = (y0 - 0.25 + v * 3 * TS) / H * 2 - 1
    quad[..., 2] = d
    _, binned = table(np.concatenate([quad, quad, sliver]))
    assert int(binned.overflow) == 0 and int(binned.num_broad) == 0
    return binned, px, py, d


def test_early_exit_skips_a_sliver_whose_plane_dips_below_its_bound():
    """Pins a fault of the reference's design (ROADMAP Queue 3, R7), which
    the port keeps: CH_ZMIN bounds a triangle's corner depths less the f32
    evaluation error of its z plane, but on a nearly degenerate triangle
    the rounding of |2A| scales the whole plane, which then dips below the
    bound.  A tile covered in front of the bound ends its stream before the
    sliver, although the sliver passes the depth test at some pixel: the
    kernel's answer (the stream version) differs there from the no-exit
    resolve, which draws the sliver."""
    binned, px, py, d = sliver_table()
    W, H = SLIVER_W, SLIVER_H
    kw = dict(depth_state=depth_state(CompareOp.LESS_OR_EQUAL), **SLIVER_DIMS)
    depth0 = torch.ones((H, W))
    got = raster_cuda.rasterize_visibility(binned, depth0, (0, 0, W, H),
                                           chunk=1, **port(kw))
    exact = rasterize_visibility_reference(binned, depth0, (0, 0, W, H),
                                           **port(kw))
    assert float(exact.order[py, px]) == SLIVER_ORDER
    assert float(got.order[py, px]) != SLIVER_ORDER
    assert float(got.depth[py, px]) == pytest.approx(d, abs=1e-7)
    # with chunks long enough to hold the whole segment the exit never
    # runs, and the two resolves agree
    whole = raster_cuda.rasterize_visibility(binned, depth0, (0, 0, W, H),
                                             chunk=64, **port(kw))
    for f in exact._fields:
        assert torch.equal(getattr(whole, f), getattr(exact, f)), f


def test_pallas_early_exit_skips_the_same_sliver():
    """The JAX Pallas kernel (interpret mode) has the fault the previous
    test pins: on the port's sliver table, its chunked early exit skips the
    sliver at the same pixel, and its maps equal the stream version's at
    the same chunk; without the exit (noexit) it draws the sliver there."""
    binned, px, py, d = sliver_table()
    W, H = SLIVER_W, SLIVER_H
    jb = {f: jnp.asarray(getattr(binned, f).numpy())
          for f in BinnedEntries._fields if getattr(binned, f) is not None}
    for f in ("entry_channels", "broad_channels"):
        jb[f] = jnp.asarray(order_values(getattr(binned, f)))
    jb = jbinning.BinnedEntries(broad_channels_cm=jb["broad_channels"].T, **jb)
    kw = dict(depth_state=depth_state(CompareOp.LESS_OR_EQUAL), **SLIVER_DIMS)
    scissor = jnp.asarray((0, 0, W, H), jnp.int32)
    depth0 = np.ones((H, W), np.float32)
    # chunk 4 (a multiple of the kernel's unroll): the quads' four rows,
    # then the gate before the sliver
    want, _ = rasterize_visibility_pallas(
        jb, jnp.asarray(depth0), scissor, chunk=4, interpret=True, **kw)
    drawn, _ = rasterize_visibility_pallas(
        jb, jnp.asarray(depth0), scissor, chunk=4, interpret=True,
        noexit=True, **kw)
    assert float(drawn.order[py, px]) == SLIVER_ORDER
    assert float(want.order[py, px]) != SLIVER_ORDER
    assert float(want.depth[py, px]) == pytest.approx(d, abs=1e-7)
    got = raster_cuda.rasterize_visibility(
        binned, torch.from_numpy(depth0), (0, 0, W, H), chunk=4,
        **port(kw))
    for f in ("owner", "depth", "order", "tex"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
