"""Draw orders and triangle ids past the f32 and 21-bit ranges: binning's
packed key carries 32-bit triangle ids, and the channel table's CH_ORDER
slot carries each row's int32 draw order as its bit pattern, compared as an
integer by setup, the visibility resolves and K3.

Two equal-depth triangles whose orders are 2^24 + 1 and 2^24 share one
f32 value (16777216.0): with orders as f32 values a depth tie between them
falls to the entry resolved last, which the tables below make the earlier
draw; with integer orders the later draw wins, as Vulkan's submission
order says.

Imports no JAX.  The tests marked ``cuda`` hold the kernels to their plain
versions on the card and skip elsewhere:

    python -m pytest --noconftest -m cuda tests/test_torch_draw_order.py
"""

import numpy as np
import pytest
import torch

from tyleri_tpu_torch.ops import binning as B
from tyleri_tpu_torch.ops import raster_cuda, setup_cuda
from tyleri_tpu_torch.ops import setup as S
from tyleri_tpu_torch.ops.binning import BinnedEntries, bin_triangles
from tyleri_tpu_torch.ops.visibility import (
    rasterize_visibility_last_passing,
    rasterize_visibility_reference,
    rasterize_visibility_stream_reference,
)
from tyleri_tpu_torch.pipeline.state import CompareOp, DepthFormat, DepthState

BIG = 1 << 24
FB = 16                      # one 16 x 16 tile
DIMS = dict(tile_w=FB, tile_h=FB, grid_w=1, grid_h=1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def depth_state(op):
    return DepthState(test_enable=True, write_enable=True, compare_op=op,
                      format=DepthFormat.D16_UNORM)


@pytest.mark.parametrize("tri", [0, 1 << 21, BIG + 1, (1 << 31) - 1])
def test_binning_key_carries_the_triangle_id(tri):
    scount = torch.tensor([0, 5, 31, 31], dtype=torch.int64)
    tw = torch.tensor([1, 7, 32, 1], dtype=torch.int64)
    ids = torch.full((4,), tri, dtype=torch.int64)
    key = B.pack_key(scount, tw, ids)
    live, s, w, t = B.unpack_key(key)
    assert live.all()
    assert torch.equal(s, scount) and torch.equal(w, tw)
    assert torch.equal(t, ids)
    # the most spill first; dead rows sort after every live one
    dead = torch.full((3,), B.DEAD_KEY, dtype=torch.int64)
    keys, perm = torch.sort(torch.cat([dead, key]))
    assert perm[:4].tolist() == [6, 5, 4, 3]
    assert (keys[4:] == B.DEAD_KEY).all()
    assert not B.unpack_key(dead)[0].any()


def twin_triangles(orders):
    """Two coincident triangles at one depth inside the tile, setup with
    the given draw orders: (setup, the table with the first row resolved
    first)."""
    clip = torch.tensor([[[-0.75, -0.75, 0.5, 1.0], [0.75, -0.75, 0.5, 1.0],
                          [-0.75, 0.75, 0.5, 1.0]]]).repeat(2, 1, 1)
    uv = torch.zeros((2, 3, 2))
    su = S.setup_triangles(clip, uv, torch.zeros(2, dtype=torch.int32),
                           torch.ones(2, dtype=torch.bool),
                           [0, 0, FB, FB, 0, 1], [0, 0, FB, FB],
                           order=torch.tensor(orders), **DIMS)
    zero = torch.zeros((), dtype=torch.int32)
    binned = BinnedEntries(
        entry_channels=su.channels.clone(),
        entry_tile=torch.zeros(2, dtype=torch.int32),
        tile_start=torch.tensor([0, 2], dtype=torch.int32),
        num_entries=torch.tensor(2, dtype=torch.int32), overflow=zero,
        broad_channels=torch.zeros((1, S.NUM_CHANNELS)),
        broad_tiles=torch.tensor([[1, 1, 0, 0]], dtype=torch.int32),
        num_broad=zero, dense_demand=torch.tensor(2, dtype=torch.int32),
        level_demand=torch.zeros(1, dtype=torch.int32))
    return su, binned


RESOLVES = {
    "stream": rasterize_visibility_stream_reference,
    "no_exit": rasterize_visibility_reference,
}


@pytest.mark.parametrize("resolve", sorted(RESOLVES))
@pytest.mark.parametrize("op,winner", [(CompareOp.LESS_OR_EQUAL, 0),
                                       (CompareOp.LESS, 1)])
def test_twins_give_a_depth_tie_to_the_later_draw(resolve, op, winner):
    """Rows 0 and 1 draw at 2^24 + 1 and 2^24, resolved in that order:
    under LESS_OR_EQUAL the later draw (row 0) wins the tie, under LESS
    the earlier (row 1)."""
    su, binned = twin_triangles([BIG + 1, BIG])
    orders = S.decode_order(su.channels[:, S.CH_ORDER])
    assert orders.tolist() == [BIG + 1, BIG]
    # as f32 values the two orders were one
    assert np.float32(BIG + 1) == np.float32(BIG)
    vis = RESOLVES[resolve](binned, torch.ones((FB, FB)), (0, 0, FB, FB),
                            fb_w=FB, fb_h=FB, depth_state=depth_state(op),
                            **DIMS)
    won = vis.owner >= 0
    assert won.sum() > 50
    assert (vis.owner[won] == winner).all()
    assert (vis.order[won] == orders[winner].to(torch.float32)).all()


def test_peel2_keeps_the_earlier_draw_under_the_later():
    su, binned = twin_triangles([BIG + 1, BIG])
    vis, vis2 = rasterize_visibility_stream_reference(
        binned, torch.ones((FB, FB)), (0, 0, FB, FB), fb_w=FB, fb_h=FB,
        depth_state=depth_state(CompareOp.LESS_OR_EQUAL), peel2=True, **DIMS)
    won = vis.owner >= 0
    assert won.sum() > 50
    assert (vis.owner[won] == 0).all()
    # the record holder before the winner: the earlier draw, resolved after
    # it, does not pass; it is drawn before the winner, so layer 2 holds it
    assert (vis2.owner[won] == 1).all()


def test_last_passing_takes_the_largest_order():
    su, binned = twin_triangles([BIG, BIG + 1])
    ds = DepthState(test_enable=False, write_enable=True,
                    compare_op=CompareOp.ALWAYS, format=DepthFormat.D16_UNORM)
    vis = rasterize_visibility_last_passing(
        binned, torch.ones((FB, FB)), (0, 0, FB, FB), fb_w=FB, fb_h=FB,
        depth_state=ds, **DIMS)
    won = vis.owner >= 0
    assert won.sum() > 50 and (vis.owner[won] == 1).all()


def to_device(binned, device) -> BinnedEntries:
    return BinnedEntries(*(t.to(device) if t is not None else None
                           for t in binned))


def big_order_table(device, seed=3, T=600):
    """Random triangles at depths snapped to a few D16 values (many exact
    ties), with draw orders 2^24 + a permutation, binned on ``device``."""
    rng = np.random.default_rng(seed)
    W, H, tile = 128, 64, 16
    clip = np.ones((T, 3, 4), np.float32)
    clip[..., :2] = rng.uniform(-1.1, 1.1, (T, 1, 2)) + rng.uniform(
        -0.3, 0.3, (T, 3, 2))
    clip[..., 2] = rng.integers(1, 5, (T, 1)) / 8.0
    dims = dict(tile_w=tile, tile_h=tile, grid_w=W // tile, grid_h=H // tile)
    order = torch.from_numpy(BIG + rng.permutation(T)).to(device)
    su = S.setup_triangles(
        torch.from_numpy(clip).to(device),
        torch.from_numpy(rng.random((T, 3, 2)).astype(np.float32)).to(device),
        torch.zeros(T, dtype=torch.int32, device=device),
        torch.ones(T, dtype=torch.bool, device=device),
        [0, 0, W, H, 0, 1], [0, 0, W, H], order=order, **dims)
    binned = bin_triangles(su, entry_cap=1 << 14, max_tiles_per_tri=8,
                           broad_cap=64, grid_w=W // tile, grid_h=H // tile)
    return binned, dict(fb_w=W, fb_h=H, **dims)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["base", "peel2", "counts"])
@pytest.mark.parametrize("op", [CompareOp.LESS_OR_EQUAL, CompareOp.LESS])
def test_k3_equals_its_twin_on_orders_past_2_24(cuda_device, variant, op):
    binned, kw = big_order_table(cuda_device)
    assert int(binned.overflow) == 0
    flags = dict(peel2=variant == "peel2", counts=variant == "counts")
    depth0 = torch.ones((kw["fb_h"], kw["fb_w"]), device=cuda_device)
    args = (depth0, (0, 0, kw["fb_w"], kw["fb_h"]))
    got = raster_cuda.rasterize_visibility(
        binned, *args, depth_state=depth_state(op), chunk=8, **flags, **kw)
    cpu = to_device(binned, "cpu")
    want = rasterize_visibility_stream_reference(
        cpu, depth0.cpu(), args[1], depth_state=depth_state(op), chunk=8,
        **flags, **kw)
    if variant == "base":
        got, want = (got,), (want,)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if isinstance(g, torch.Tensor):
            assert torch.equal(g.cpu(), w)
            continue
        for f in g._fields:
            a, b = getattr(g, f).cpu(), getattr(w, f)
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), f
    # the tie rule saw the integer orders: some pixels resolve a tie
    assert (got[0].owner >= 0).sum() > 1000


@pytest.mark.cuda
def test_k3_gives_a_depth_tie_to_the_later_draw(cuda_device):
    _, binned = twin_triangles([BIG + 1, BIG])
    binned = to_device(binned, cuda_device)
    vis = raster_cuda.rasterize_visibility(
        binned, torch.ones((FB, FB), device=cuda_device), (0, 0, FB, FB),
        fb_w=FB, fb_h=FB, depth_state=depth_state(CompareOp.LESS_OR_EQUAL),
        **DIMS)
    won = vis.owner >= 0
    assert int(won.sum()) > 50 and bool((vis.owner[won] == 0).all())


@pytest.mark.cuda
def test_fused_setup_writes_orders_past_2_24(cuda_device):
    """Rows past 2^24 carry their own order (the row index) exactly."""
    T = BIG + 4096
    corners = torch.zeros((T, 3, 5), device=cuda_device)
    corners[:, :, 0] = torch.tensor([-0.5, 0.5, -0.5], device=cuda_device)
    corners[:, :, 1] = torch.tensor([-0.5, -0.5, 0.5], device=cuda_device)
    corners[:, :, 2] = 0.5
    draw = torch.zeros(T, dtype=torch.int32, device=cuda_device)
    valid = torch.ones(T, dtype=torch.bool, device=cuda_device)
    mvps = torch.eye(4, device=cuda_device).reshape(1, 16)
    su, _, _ = setup_cuda.fused_setup(
        corners, draw, draw, valid, mvps, True, [0, 0, 64, 64, 0, 1],
        [0, 0, 64, 64], tile_w=16, tile_h=16, grid_w=4, grid_h=4)
    got = S.decode_order(su.channels[BIG - 4096:, S.CH_ORDER])
    want = torch.arange(BIG - 4096, T, dtype=torch.int32, device=cuda_device)
    assert torch.equal(got, want)
    # every row past 2^24 is its own: no two rows share an order
    assert int(torch.unique(got).numel()) == got.numel()


def synthetic_setup(T, device):
    """T live rows, each covering one tile of a 120 x 68 grid, with order t
    and a z-min bound that varies with t."""
    t = torch.arange(T, device=device)
    gw, gh = 120, 68
    lo = torch.stack([t % gw, (t // gw) % gh], dim=1).to(torch.int32)
    ch = torch.zeros((T, S.NUM_CHANNELS), device=device)
    ch[:, S.CH_ORDER] = S.encode_order(t)
    ch[:, S.CH_ZMIN] = (t % 65536).to(torch.float32)
    return S.TriangleSetup(valid=torch.ones(T, dtype=torch.bool,
                                            device=device),
                           channels=ch, tile_lo=lo, tile_hi=lo), gw, gh


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_binning_places_triangle_ids_past_2_21(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    T = (1 << 21) + 1
    su, gw, gh = synthetic_setup(T, torch.device(device))
    b = bin_triangles(su, grid_w=gw, grid_h=gh, entry_cap=T + 4096,
                      max_tiles_per_tri=32, broad_cap=16)
    assert int(b.overflow) == 0 and int(b.num_entries) == T
    n = int(b.tile_start[-1])
    orders = S.decode_order(b.entry_channels[:n, S.CH_ORDER])
    assert torch.equal(torch.sort(orders).values,
                       torch.arange(T, dtype=torch.int32, device=device))
    # the last triangle lands in its own tile
    last = T - 1
    tile = (last // gw % gh) * gw + last % gw
    seg = slice(int(b.tile_start[tile]), int(b.tile_start[tile + 1]))
    assert last in S.decode_order(b.entry_channels[seg, S.CH_ORDER]).tolist()
