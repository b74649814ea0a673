"""The port's tile binning (tyleri_tpu_torch.ops.binning) against the JAX
package's on one fixed setup table fed to both.

Both sorts are unstable, so entries with equal keys may come out in a
different order: per tile, the MULTISET of entries (by draw order,
CH_ORDER) must be equal, not the row order.  Everything else is integer
bookkeeping and must be equal exactly: tile_start, the overflow and demand
counters, and the broad list.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tyleri_tpu.ops import binning as jbinning
from tyleri_tpu.ops import setup as jsetup
from tyleri_tpu_torch import _build
from tyleri_tpu_torch.ops import binning as tbinning
from tyleri_tpu_torch.ops import setup as tsetup

from test_torch_setup import order_values, port_channels

FB_W, FB_H, TILE = 192, 128, 8
GRID_W, GRID_H = FB_W // TILE, FB_H // TILE


def setup_table(seed=5, T=1500):
    """A setup table with small, tile-spanning and screen-sized triangles
    (dense, spill and broad entries) and some invalid rows."""
    rng = np.random.default_rng(seed)
    center = rng.uniform(-1.2, 1.2, (T, 1, 2))
    size = rng.choice([0.02, 0.1, 0.4, 2.5], size=(T, 1, 1),
                      p=[0.6, 0.3, 0.09, 0.01])
    xy = center + size * rng.uniform(-1, 1, (T, 3, 2))
    clip = np.ones((T, 3, 4), np.float32)
    clip[..., :2] = xy
    clip[..., 2] = rng.uniform(0.05, 0.95, (T, 1))
    uv = rng.random((T, 3, 2)).astype(np.float32)
    tex = rng.integers(0, 3, T).astype(np.int32)
    valid = rng.random(T) > 0.1
    su = jsetup.setup_triangles(
        jnp.asarray(clip), jnp.asarray(uv), jnp.asarray(tex),
        jnp.asarray(valid),
        jnp.asarray([0, 0, FB_W, FB_H, 0, 1], jnp.float32),
        jnp.asarray([0, 0, FB_W, FB_H], jnp.int32),
        tile_w=TILE, tile_h=TILE, grid_w=GRID_W, grid_h=GRID_H)
    return su


def to_torch(su):
    """The JAX package's setup table in the port's encoding."""
    valid, tile_lo, tile_hi = (torch.from_numpy(np.array(getattr(su, f)))
                               for f in ("valid", "tile_lo", "tile_hi"))
    return tsetup.TriangleSetup(valid, port_channels(su.channels), tile_lo,
                                tile_hi)


CAPS = {
    # every entry placed: no overflow
    "roomy": dict(entry_cap=1 << 15, broad_cap=128, spill_cap=1 << 14),
    # valid_cap, the learned spill-level fit and the broad list all cut
    "tight": dict(entry_cap=1 << 12, broad_cap=4, spill_cap=1 << 12,
                  valid_cap=512, spill_level_caps=(512, 512, 512, 512)),
}


@pytest.mark.parametrize("caps", sorted(CAPS))
def test_bin_triangles_matches_jax(caps):
    kw = dict(grid_w=GRID_W, grid_h=GRID_H, max_tiles_per_tri=16, **CAPS[caps])
    su = setup_table()
    want = jbinning.bin_triangles(su, **kw)
    got = tbinning.bin_triangles(to_torch(su), **kw)

    for name in ("overflow", "num_entries", "dense_demand", "level_demand",
                 "num_broad", "tile_start", "broad_tiles"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    if caps == "roomy":
        assert int(got.overflow) == 0 and int(got.num_broad) > 0
    else:
        assert int(got.overflow) > 0

    ts = got.tile_start.numpy()
    g_ch = order_values(got.entry_channels)
    w_ch = np.asarray(want.entry_channels)
    for tile in range(GRID_W * GRID_H):
        seg = slice(ts[tile], ts[tile + 1])
        np.testing.assert_array_equal(
            np.sort(g_ch[seg, tsetup.CH_ORDER]),
            np.sort(w_ch[seg, tsetup.CH_ORDER]), f"tile {tile}")
        # front to back within the tile: what the early exit relies on
        assert (np.diff(g_ch[seg, tsetup.CH_ZMIN]) >= 0).all()
    np.testing.assert_array_equal(
        got.entry_tile.numpy()[:ts[-1]], np.asarray(want.entry_tile)[:ts[-1]])
    nb = int(got.num_broad)
    np.testing.assert_array_equal(order_values(got.broad_channels)[:nb],
                                  np.asarray(want.broad_channels)[:nb])


def test_spill_rows_matches_jax():
    for spill_cap in (1 << 12, 1 << 16, 3 << 15):
        for K in (4, 16, 32):
            assert tbinning.spill_rows(spill_cap, K) == \
                jbinning.spill_rows(spill_cap, K)
    fit = (1024, 512, 512, 512, 512)
    assert tbinning.spill_rows(1 << 16, 32, fit) == \
        jbinning.spill_rows(1 << 16, 32, fit)


def test_bin_triangles_gathers_extra_rows_like_jax():
    """Extra per-triangle rows (the lit path's normal/w planes) ride the
    same permutations as the entry and broad rows: every live entry's extra
    row is its triangle's, in both packages."""
    su = setup_table(seed=11)
    T = su.valid.shape[0]
    extra = np.random.default_rng(12).random((T, 12)).astype(np.float32)
    caps = CAPS["roomy"]
    want = jbinning.bin_triangles(su, jnp.asarray(extra), grid_w=GRID_W,
                                  grid_h=GRID_H, **caps)
    got = tbinning.bin_triangles(to_torch(su), torch.from_numpy(extra),
                                 grid_w=GRID_W, grid_h=GRID_H, **caps)
    for b, decode in ((got, order_values), (want, np.asarray)):
        n = int(np.asarray(b.tile_start)[-1])
        nb = int(b.num_broad)
        for rows, ch, cap in ((np.asarray(b.entry_extra),
                               decode(b.entry_channels), n),
                              (np.asarray(b.broad_extra),
                               decode(b.broad_channels), nb)):
            tri = ch[:cap, tsetup.CH_ORDER].astype(np.int64)
            assert cap > 0
            np.testing.assert_array_equal(rows[:cap], extra[tri])
    assert got.entry_extra.shape == (caps["entry_cap"], 12)
    assert got.broad_extra.shape == (caps["broad_cap"], 12)


def emit_call(monkeypatch, su, **kw):
    """``bin_triangles`` on the CPU, and its one emit call: (key, opA,
    keywords, outputs)."""
    calls = []
    real = tbinning.emit_entries

    def spy(key, opA, **k):
        out = real(key, opA, **k)
        calls.append((key, opA, k, out))
        return out

    monkeypatch.setattr(tbinning, "emit_entries", spy)
    tbinning.bin_triangles(su, **kw)
    (call,) = calls
    return call


def segment_rows(key, opA, rows, cover, grid_w, ntiles, T):
    """The kernel's rule for one segment (csrc/binning_emit.cu), row i from
    row i of the key and opA: (key2, tri, rows placed)."""
    live, scount, tw, tri = tbinning.unpack_key(key[:rows])
    a = opA[:rows]
    lv = live & (scount >= cover)
    q = torch.div(cover, tw, rounding_mode="floor")
    tile = (((a >> 8) & 0xFF) + q) * grid_w + (a & 0xFF) + (cover - q * tw)
    tile = torch.where(lv, tile, torch.full_like(tile, ntiles))
    return ((tile << 16) | torch.clamp(a >> 16, 0, 65535),
            torch.clamp(tri, max=T - 1), int(lv.sum()))


@pytest.mark.parametrize("K", [8, 16, 32])
@pytest.mark.parametrize("caps", sorted(CAPS))
def test_emit_segments_cover_the_plain_layout(monkeypatch, caps, K):
    """The emit kernel's host-side segment table covers the plain emit's
    concatenation exactly: its length is vcap plus ``spill_rows``, padded to
    entry_cap; each segment, read by the kernel's per-row rule from its
    cover, equals that stretch of the plain emit's key2 and triangle ids,
    in order; the pad is the dead sentinel with triangle 0; the placed
    counts are the segments' sums."""
    kw = dict(CAPS[caps], grid_w=GRID_W, grid_h=GRID_H,
              max_tiles_per_tri=K)
    if "spill_level_caps" in kw:
        kw["spill_level_caps"] = (512,) * len(tbinning._level_caps(1, K))
    su = to_torch(setup_table())
    key, opA, k, (key2, tri, dense, spill) = emit_call(monkeypatch, su, **kw)
    segs = tbinning.emit_segments(k["vcap"], k["caps"], k["entry_cap"], K)
    T, ntiles = su.valid.shape[0], GRID_W * GRID_H
    emitted = k["vcap"] + tbinning.spill_rows(kw["spill_cap"], K,
                                              kw.get("spill_level_caps", ()))
    assert k["vcap"] == min(kw.get("valid_cap") or T, kw["entry_cap"])
    assert sum(s[1] for s in segs) == max(emitted, kw["entry_cap"])
    assert key2.shape == tri.shape == (max(emitted, kw["entry_cap"]),)
    assert [s[0] for s in segs] == list(
        np.cumsum([0] + [s[1] for s in segs[:-1]]))
    covers = [s[2] for s in segs]
    assert covers[:K] == list(range(K)) and covers[K:] in ([], [-1])
    placed = [0, 0]
    for start, rows, cover in segs:
        got = slice(start, start + rows)
        if cover < 0:
            assert bool((key2[got] == ntiles << 16).all())
            assert bool((tri[got] == 0).all())
            continue
        want_k2, want_tri, n = segment_rows(key, opA, rows, cover, GRID_W,
                                            ntiles, T)
        assert torch.equal(key2[got], want_k2), cover
        assert torch.equal(tri[got], want_tri), cover
        placed[cover > 0] += n
    assert placed == [int(dense), int(spill)]


def test_cpu_emit_launches_no_kernel(monkeypatch):
    """CPU tensors take the plain emit: no launch, no count."""
    import collections

    from tyleri_tpu_torch.utils.profiling import tracing

    monkeypatch.setattr(_build, "launches", collections.Counter())
    with tracing() as records:
        tbinning.bin_triangles(to_torch(setup_table()), grid_w=GRID_W,
                               grid_h=GRID_H, **CAPS["roomy"])
    assert _build.launches["bin_emit"] == 0
    assert not records.counters
