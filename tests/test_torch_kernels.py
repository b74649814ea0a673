"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card.  Built with -fmad=false, each kernel rounds every multiply and
add as eager PyTorch does, so the comparison is bit for bit.

This file imports no JAX (the card's machine has none) and skips where no
CUDA device exists.  On the card, run it without the repository's root
conftest (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import functools

import numpy as np
import pytest
import torch

from tyleri_tpu_torch.pipeline.state import CompareOp, DepthFormat, DepthState
from tyleri_tpu_torch.ops import raster_cuda, setup_cuda
from tyleri_tpu_torch.ops import setup as S
from tyleri_tpu_torch.ops.binning import BinnedEntries, bin_triangles
from tyleri_tpu_torch.ops.visibility import (
    rasterize_visibility_reference,
    rasterize_visibility_stream_reference,
)
from tyleri_tpu_torch.testing.overdraw import overdraw_table
from tyleri_tpu_torch.tools import exp_fixed_grid, exp_mxu

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def rand_scene(rng, T, D):
    """Random corners: off-screen and back-facing rows, 10 % fully behind
    the near plane, 10 % crossing it, some degenerate."""
    corner = rng.uniform(-1.5, 1.5, (T, 3, 5)).astype(np.float32)
    corner[..., 2] = rng.uniform(-0.5, 3.0, (T, 3))
    k = T // 10
    corner[:k, :, 2] = rng.uniform(-4.0, -2.5, (k, 3))
    corner[k:2 * k, 0, 2] = -3.0
    corner[-10:, 1] = corner[-10:, 0]
    draw = rng.integers(0, D, T).astype(np.int32)
    tex = rng.integers(0, 3, T).astype(np.int32)
    valid = rng.random(T) > 0.15
    mvps = np.stack([np.eye(4, dtype=np.float32) + 0.01 * d
                     for d in range(D)])
    mvps[:, 3, 2] = -0.4
    mvps[:, 3, 3] = 2.0
    return corner, draw, tex, valid, mvps.reshape(D, 16)


@pytest.mark.parametrize("tiles", [(16, 16), (8, 8), (64, 16)])
def test_fused_setup_bit_equal(cuda_device, tiles):
    from tyleri_tpu_torch.pipeline.state import CullMode

    tile_w, tile_h = tiles
    W, H = 320, 192
    dims = dict(tile_w=tile_w, tile_h=tile_h, grid_w=-(-W // tile_w),
                grid_h=-(-H // tile_h))
    viewport = np.asarray([0, 0, W, H, 0, 1], np.float32)
    scissor = np.asarray([4, 3, W - 20, H - 9], np.int32)
    rng = np.random.default_rng(17)
    args = [torch.from_numpy(a).to(cuda_device)
            for a in rand_scene(rng, 50_000, 7)]
    for cull in (None, CullMode.BACK):
        before = setup_cuda.launches
        su_k, n_k, x_k = setup_cuda.fused_setup(
            *args, True, viewport, scissor, cull_mode=cull, **dims)
        su_r, n_r, x_r = setup_cuda.fused_setup_reference(
            *args, True, viewport, scissor, cull_mode=cull, **dims)
        torch.cuda.synchronize()
        assert setup_cuda.launches == before + 1
        assert torch.equal(su_k.channels.view(torch.int32),
                           su_r.channels.view(torch.int32))
        for a, b in ((su_k.valid, su_r.valid), (su_k.tile_lo, su_r.tile_lo),
                     (su_k.tile_hi, su_r.tile_hi), (x_k, x_r)):
            assert torch.equal(a, b)
        assert int(n_k) == int(n_r) > 0


@pytest.mark.parametrize("draw_mod", [(2, 0), (2, 1), (3, 2), (7, 6)])
def test_fused_setup_draw_mask_bit_equal(cuda_device, draw_mod):
    """A mesh device's share of the draws: bit-equal to the plain version,
    masked rows invalid and their crossers neither flagged nor counted."""
    W, H = 320, 192
    dims = dict(tile_w=16, tile_h=16, grid_w=20, grid_h=12)
    viewport = np.asarray([0, -H / 2, W, H, 0, 1], np.float32)  # a band's
    scissor = np.asarray([0, 0, W, H // 2], np.int32)
    rng = np.random.default_rng(23)
    args = [torch.from_numpy(a).to(cuda_device)
            for a in rand_scene(rng, 50_001, 7)]
    got = setup_cuda.fused_setup(*args, True, viewport, scissor,
                                 draw_mod=draw_mod, **dims)
    want = setup_cuda.fused_setup_reference(*args, True, viewport, scissor,
                                            draw_mod=draw_mod, **dims)
    torch.cuda.synchronize()
    assert_setup_equal(got, want)
    masked = args[1] % draw_mod[0] != draw_mod[1]
    assert not (got[0].valid & masked).any()
    assert not (got[2] & masked).any()
    assert int(got[1]) == int(got[2].sum()) > 0


@pytest.mark.parametrize("D", [1, 7, 100, 5_000])
@pytest.mark.parametrize("T", [1, 255, 257, 50_001])
def test_fused_setup_blocks_and_draws(cuda_device, T, D):
    """A block of 128 rows, one short of two, one past two, and many with a
    ragged last block; from one draw to more than fit shared memory."""
    W, H = 300, 170
    dims = dict(tile_w=16, tile_h=16, grid_w=19, grid_h=11)
    viewport = np.asarray([0, 0, W, H, 0, 1], np.float32)
    scissor = np.asarray([0, 0, W, H], np.int32)
    rng = np.random.default_rng(T + D)
    args = [torch.from_numpy(a).to(cuda_device) for a in rand_scene(rng, T, D)]
    got = setup_cuda.fused_setup(*args, True, viewport, scissor, **dims)
    want = setup_cuda.fused_setup_reference(*args, True, viewport, scissor,
                                            **dims)
    torch.cuda.synchronize()
    assert_setup_equal(got, want)


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_fused_setup_on_a_misaligned_corner_view(cuda_device, offset):
    """A corner table that starts 60, 120 or 180 bytes into its storage (a
    later camera's rows): the kernel stages it with scalar loads."""
    W, H = 300, 170
    dims = dict(tile_w=16, tile_h=16, grid_w=19, grid_h=11)
    viewport = np.asarray([0, 0, W, H, 0, 1], np.float32)
    rng = np.random.default_rng(offset)
    corner, *rest = rand_scene(rng, 50_001 + offset, 7)
    corners = torch.from_numpy(corner).to(cuda_device)[offset:]
    assert corners.data_ptr() % 16 != 0
    args = [corners] + [torch.from_numpy(a[offset:]).to(cuda_device)
                        for a in rest[:3]] + [
        torch.from_numpy(rest[3]).to(cuda_device)]
    got = setup_cuda.fused_setup(*args, True, viewport, [0, 0, W, H], **dims)
    want = setup_cuda.fused_setup_reference(*args, True, viewport,
                                            [0, 0, W, H], **dims)
    torch.cuda.synchronize()
    assert_setup_equal(got, want)
    assert int(got[1]) > 0


def assert_setup_equal(got, want):
    """Channels bit for bit, flags, tile boxes and the crossers' count."""
    (su_k, n_k, x_k), (su_r, n_r, x_r) = got, want
    assert torch.equal(su_k.channels.view(torch.int32),
                       su_r.channels.view(torch.int32))
    for a, b in ((su_k.valid, su_r.valid), (su_k.tile_lo, su_r.tile_lo),
                 (su_k.tile_hi, su_r.tile_hi), (x_k, x_r)):
        assert torch.equal(a, b)
    assert n_k.dtype == torch.int32 and n_k.shape == ()
    assert int(n_k) == int(n_r)


def binned_scene(device, rng, W, H, tile, T=3000):
    """Many overlapping triangles (long, front-to-back tile segments that
    exercise the early exit), a few broad ones."""
    center = rng.uniform(-1.1, 1.1, (T, 1, 2))
    size = rng.choice([0.03, 0.15, 0.6, 3.0], size=(T, 1, 1),
                      p=[0.6, 0.3, 0.095, 0.005])
    clip = np.ones((T, 3, 4), np.float32)
    clip[..., :2] = center + size * rng.uniform(-1, 1, (T, 3, 2))
    clip[..., 2] = rng.uniform(0.0, 1.0, (T, 3))
    uv = rng.random((T, 3, 2)).astype(np.float32)
    tex = rng.integers(0, 4, T).astype(np.int32)
    t = [torch.from_numpy(a).to(device) for a in (clip, uv, tex)]
    valid = torch.ones(T, dtype=torch.bool, device=device)
    gw, gh = -(-W // tile[0]), -(-H // tile[1])
    su = S.setup_triangles(*t, valid, [0, 0, W, H, 0, 1], [0, 0, W, H],
                           tile_w=tile[0], tile_h=tile[1], grid_w=gw,
                           grid_h=gh)
    b = bin_triangles(su, grid_w=gw, grid_h=gh, entry_cap=1 << 17,
                      max_tiles_per_tri=16, broad_cap=1024, spill_cap=1 << 16)
    assert int(b.overflow) == 0 and int(b.num_broad) > 0
    return b, dict(fb_w=W, fb_h=H, tile_w=tile[0], tile_h=tile[1],
                   grid_w=gw, grid_h=gh)


def assert_layers_equal(got, want):
    """Every map bit for bit, owner ids included (one table for both)."""
    for f in got._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), f


@pytest.mark.parametrize("case", ["le", "less", "le_scissor_prior",
                                  "less_d32", "tile8_chunk7"])
def test_visibility_equal_to_plain(cuda_device, case):
    tile = (8, 8) if case == "tile8_chunk7" else (16, 16)
    chunk = 7 if case == "tile8_chunk7" else 64
    op = CompareOp.LESS if case.startswith("less") else \
        CompareOp.LESS_OR_EQUAL
    fmt = DepthFormat.D32_SFLOAT if case == "less_d32" else \
        DepthFormat.D16_UNORM
    rng = np.random.default_rng(43)
    W, H = 300, 170     # not a multiple of the tile: ragged edge tiles
    b, dims = binned_scene(cuda_device, rng, W, H, tile)
    scissor = (5, 9, 250, 150) if "scissor" in case else (0, 0, W, H)
    depth0 = torch.ones((H, W), device=cuda_device)
    if "prior" in case:
        depth0 = torch.from_numpy(
            (rng.integers(0, 64, (H, W)) * 1024 / 65535.0).astype(
                np.float32)).to(cuda_device)
    ds = DepthState(test_enable=True, write_enable=True, compare_op=op,
                    format=fmt)
    before = raster_cuda.launches()
    got = raster_cuda.rasterize_visibility(b, depth0, scissor, chunk=chunk,
                                           depth_state=ds, **dims)
    want = rasterize_visibility_stream_reference(
        b, depth0, scissor, depth_state=ds, chunk=chunk, **dims)
    exact = rasterize_visibility_reference(b, depth0, scissor,
                                           depth_state=ds, **dims)
    torch.cuda.synchronize()
    assert raster_cuda.launches() == before + 1
    assert_layers_equal(got, want)
    assert (got.owner >= 0).float().mean() > 0.5
    # the no-exit resolve agrees on this table (no near-degenerate plane
    # dips below its z bound here)
    for f in ("depth", "order", "uw", "vw", "iw", "tex"):
        assert torch.equal(getattr(got, f), getattr(exact, f)), f


@functools.lru_cache(maxsize=None)
def deep_scene(device, tile, W=300, H=170, T=16_000, seed=71,
               zero_share=0.0):
    """Layers of small triangles crowded toward the frame's center, half at
    depths from a coarse set (exact ties), half at one depth each, drawn
    in a random order, and a few broad triangles behind them: the central
    tiles' segments run to several chunks of 256 rows and the early exit
    stops most of them partway; the edge tiles are ragged at W x H.  With
    ``zero_share`` that share of the triangles lies at z = 0."""
    rng = np.random.default_rng(seed)
    center = np.clip(rng.normal(0.0, 0.3, (T, 1, 2)), -1.05, 1.05)
    xy = center + 0.06 * rng.uniform(-1, 1, (T, 3, 2))
    z = np.where(rng.random((T, 1)) < 0.5, rng.integers(1, 9, (T, 1)) / 9.0,
                 rng.uniform(0.0, 1.0, (T, 1)) + rng.uniform(0, 0.01, (T, 3)))
    if zero_share:
        z = np.where(rng.random((T, 1)) < zero_share, 0.0, z)
    n = T + 4
    clip = np.ones((n, 3, 4), np.float32)
    clip[:T, :, :2] = xy
    clip[:T, :, 2] = np.minimum(z, 1.0)
    clip[T:, :, :2] = [[-3, -3], [3, -3], [0, 3]]
    clip[T:, :, 2] = rng.uniform(0.6, 0.95, (4, 1))
    uv = rng.random((n, 3, 2)).astype(np.float32)
    tex = rng.integers(0, 4, n).astype(np.int32)
    order = rng.permutation(n).astype(np.float32)
    t = [torch.from_numpy(a).to(device) for a in (clip, uv, tex, order)]
    gw, gh = -(-W // tile[0]), -(-H // tile[1])
    su = S.setup_triangles(
        t[0], t[1], t[2], torch.ones(n, dtype=torch.bool, device=device),
        [0, 0, W, H, 0, 1], [0, 0, W, H], tile_w=tile[0], tile_h=tile[1],
        grid_w=gw, grid_h=gh, order=t[3])
    b = bin_triangles(su, grid_w=gw, grid_h=gh, entry_cap=1 << 19,
                      max_tiles_per_tri=16, broad_cap=1024, spill_cap=1 << 17)
    assert int(b.overflow) == 0 and int(b.num_broad) > 0
    return b, dict(fb_w=W, fb_h=H, tile_w=tile[0], tile_h=tile[1],
                   grid_w=gw, grid_h=gh)


@pytest.mark.parametrize("chunk", [7, 64, 256])
@pytest.mark.parametrize("tile", [(8, 8), (16, 16), (64, 16), (16, 32),
                                  (8, 4)])
@pytest.mark.parametrize("variant", ["base", "peel2", "counts"])
def test_visibility_instances_by_tile_and_chunk(cuda_device, variant, tile,
                                                chunk):
    """Each instance's launch geometry (two pixels a thread; one partial
    warp of 16 threads at 8x4), tile order and chunk ring against the
    stream plain version, bit for bit; some tile's exit falls on a
    prefetched chunk."""
    b, dims = deep_scene(cuda_device, tile)
    W, H = dims["fb_w"], dims["fb_h"]
    ds = DepthState(test_enable=True, write_enable=True,
                    compare_op=CompareOp.LESS_OR_EQUAL)
    depth0 = torch.ones((H, W), device=cuda_device)
    kw = dict(depth_state=ds, chunk=chunk, peel2=variant == "peel2",
              counts=variant == "counts", **dims)
    before = raster_cuda.variant_launches[variant]
    got = raster_cuda.rasterize_visibility(b, depth0, (0, 0, W, H), **kw)
    want = rasterize_visibility_stream_reference(b, depth0, (0, 0, W, H),
                                                 **kw)
    torch.cuda.synchronize()
    assert raster_cuda.variant_launches[variant] == before + 1
    if variant == "base":
        assert_layers_equal(got, want)
        return
    assert_layers_equal(got[0], want[0])
    if variant == "peel2":
        assert_layers_equal(got[1], want[1])
        assert (got[1].owner >= 0).any()
        return
    assert torch.equal(got[1], want[1])
    nvis = got[1].flatten()
    seg = b.tile_start[1:] - b.tile_start[:-1]
    assert ((nvis >= chunk) & (nvis < seg)).any()


def test_visibility_rejects_a_misaligned_entry_table(cuda_device):
    b, dims = deep_scene(cuda_device, (16, 16))
    ent = b.entry_channels
    shifted = torch.empty(ent.numel() + 1, device=cuda_device)[1:].view(
        ent.shape)
    shifted.copy_(ent)
    ds = DepthState(test_enable=True, write_enable=True,
                    compare_op=CompareOp.LESS_OR_EQUAL)
    before = raster_cuda.launches()
    with pytest.raises(ValueError, match="aligned"):
        raster_cuda.rasterize_visibility(
            b._replace(entry_channels=shifted),
            torch.ones((dims["fb_h"], dims["fb_w"]), device=cuda_device),
            (0, 0, dims["fb_w"], dims["fb_h"]), depth_state=ds, **dims)
    assert raster_cuda.launches() == before


@pytest.mark.parametrize("case", ["le_d16", "less_d16", "le_d32",
                                  "less_d32"])
def test_visibility_peel2_equal_to_stream_plain(cuda_device, case):
    op = CompareOp.LESS if case.startswith("less") else \
        CompareOp.LESS_OR_EQUAL
    fmt = DepthFormat.D32_SFLOAT if case.endswith("d32") else \
        DepthFormat.D16_UNORM
    rng = np.random.default_rng(61)
    W, H = 300, 170
    b, dims = overdraw_table(cuda_device, rng, W, H)
    assert int(b.overflow) == 0 and int(b.num_broad) > 0
    ds = DepthState(test_enable=True, write_enable=True, compare_op=op,
                    format=fmt)
    depth0 = torch.ones((H, W), device=cuda_device)
    before = raster_cuda.variant_launches["peel2"]
    got = raster_cuda.rasterize_visibility(b, depth0, (0, 0, W, H), chunk=16,
                                           depth_state=ds, peel2=True, **dims)
    want = rasterize_visibility_stream_reference(
        b, depth0, (0, 0, W, H), depth_state=ds, peel2=True, **dims)
    torch.cuda.synchronize()
    assert raster_cuda.variant_launches["peel2"] == before + 1
    for g, w in zip(got, want):
        assert_layers_equal(g, w)
    # both layers are populated, and some layer-2 slots are record gates
    assert (got[1].owner >= 0).float().mean() > 0.3
    assert ((got[1].owner < 0) & (got[1].order >= 0)).any()


@pytest.mark.parametrize("chunk", [64, 7])
def test_visibility_counts_equal_to_stream_plain(cuda_device, chunk):
    rng = np.random.default_rng(67)
    W, H = 300, 170
    b, dims = overdraw_table(cuda_device, rng, W, H)
    ds = DepthState(test_enable=True, write_enable=True,
                    compare_op=CompareOp.LESS_OR_EQUAL)
    depth0 = torch.ones((H, W), device=cuda_device)
    before = raster_cuda.variant_launches["counts"]
    vis, nvis = raster_cuda.rasterize_visibility(
        b, depth0, (0, 0, W, H), chunk=chunk, depth_state=ds, counts=True,
        **dims)
    want, want_nvis = rasterize_visibility_stream_reference(
        b, depth0, (0, 0, W, H), depth_state=ds, counts=True, chunk=chunk,
        **dims)
    torch.cuda.synchronize()
    assert raster_cuda.variant_launches["counts"] == before + 1
    assert_layers_equal(vis, want)
    assert torch.equal(nvis, want_nvis)
    # the early exit skipped part of the table, and not all of it
    assert 0 < int(nvis.sum()) < int(b.num_entries)


def ui_depth(device, W, H, tile, seed=3):
    """An incoming depth buffer as the UI pass leaves it for the mesh pass:
    z = 0 rectangles (a block of whole tiles among them), random D16
    values and cleared areas."""
    rng = np.random.default_rng(seed)
    d = (rng.integers(0, 65536, (H, W)) / 65535.0).astype(np.float32)
    for _ in range(10):
        x0, y0 = rng.integers(0, W - 8), rng.integers(0, H - 8)
        d[y0:y0 + rng.integers(8, 60), x0:x0 + rng.integers(8, 80)] = 1.0
    for _ in range(16):
        x0, y0 = rng.integers(0, W - 4), rng.integers(0, H - 4)
        d[y0:y0 + rng.integers(4, 40), x0:x0 + rng.integers(4, 60)] = 0.0
    # whole tiles of UI where the central layers pile up
    cx, cy = (W // 2) // tile[0] * tile[0], (H // 2) // tile[1] * tile[1]
    d[cy - tile[1]:cy + tile[1], cx - 2 * tile[0]:cx + 2 * tile[0]] = 0.0
    return torch.from_numpy(d).to(device)


@pytest.mark.parametrize("chunk", [7, 64])
@pytest.mark.parametrize("tile", [(8, 8), (16, 16), (64, 16)])
@pytest.mark.parametrize("variant", ["base", "peel2"])
def test_visibility_on_a_ui_depth_buffer(cuda_device, variant, tile, chunk):
    """K3 resolving against the depth a UI pass wrote (the UI frame's mesh
    pass): z = 0 rectangles, tiles that are UI throughout (their deepest
    incoming depth is 0, so the early exit stops at the first chunk whose
    bound is above 0), random D16 values and cleared areas, with a tenth of
    the triangles at z = 0 (LESS_OR_EQUAL ties with the UI): bit-equal to
    the stream plain version."""
    b, dims = deep_scene(cuda_device, tile, zero_share=0.1)
    W, H = dims["fb_w"], dims["fb_h"]
    depth0 = ui_depth(cuda_device, W, H, tile)
    ds = DepthState(test_enable=True, write_enable=True,
                    compare_op=CompareOp.LESS_OR_EQUAL)
    kw = dict(depth_state=ds, chunk=chunk, peel2=variant == "peel2", **dims)
    before = raster_cuda.variant_launches[variant]
    got = raster_cuda.rasterize_visibility(b, depth0, (0, 0, W, H), **kw)
    want = rasterize_visibility_stream_reference(b, depth0, (0, 0, W, H),
                                                 **kw)
    torch.cuda.synchronize()
    assert raster_cuda.variant_launches[variant] == before + 1
    layers = zip(got, want) if variant == "peel2" else [(got, want)]
    for g, w in layers:
        assert_layers_equal(g, w)
    vis = got[0] if variant == "peel2" else got
    ui = depth0 == 0
    # z = 0 fragments took LESS_OR_EQUAL ties on the UI's pixels; the rest
    # of the UI stayed in front
    assert ((vis.owner >= 0) & ui).any() and ((vis.owner < 0) & ui).any()
    assert torch.equal(vis.depth[ui], depth0[ui])


def test_wrappers_reject_bad_input(cuda_device):
    b = BinnedEntries(*(torch.zeros(1, device=cuda_device)
                        for _ in BinnedEntries._fields))
    ds = DepthState(test_enable=True, write_enable=True,
                    compare_op=CompareOp.LESS_OR_EQUAL)
    with pytest.raises(ValueError):
        raster_cuda.rasterize_visibility(
            b, torch.ones((8, 8), device=cuda_device), (0, 0, 8, 8),
            fb_w=8, fb_h=8, tile_w=8, tile_h=8, grid_w=1, grid_h=1,
            depth_state=ds)
    with pytest.raises(ValueError):   # as raster_pallas.py:567-568
        raster_cuda.rasterize_visibility(
            b, torch.ones((8, 8), device=cuda_device), (0, 0, 8, 8),
            fb_w=8, fb_h=8, tile_w=8, tile_h=8, grid_w=1, grid_h=1,
            depth_state=ds, peel2=True, counts=True)
    corners = torch.zeros((4, 3, 5), device=cuda_device)
    with pytest.raises(ValueError):   # tri_draw must be int32
        setup_cuda.fused_setup(
            corners, torch.zeros(4, device=cuda_device),
            torch.zeros(4, dtype=torch.int32, device=cuda_device),
            torch.ones(4, dtype=torch.bool, device=cuda_device),
            torch.zeros((1, 16), device=cuda_device), True,
            [0, 0, 8, 8, 0, 1], [0, 0, 8, 8], tile_w=8, tile_h=8,
            grid_w=1, grid_h=1)


# ---- the probe kernels (tyleri_tpu_torch/tools/, csrc/probes.cu) ----

@pytest.mark.parametrize("C,E,sort", [(32, 1 << 16, True), (24, 70_001, False)])
def test_gather_rows_bit_equal(cuda_device, C, E, sort):
    from tyleri_tpu_torch.tools import exp_binning

    ids, table = exp_binning.tool_inputs(cuda_device, T=50_000, C=C, E=E,
                                         sort=sort, seed=3)
    exp_binning.reset_launches()
    rows, sums = exp_binning.gather_rows(ids, table)
    want_rows, want_sums = exp_binning.gather_rows_reference(ids, table)
    torch.cuda.synchronize()
    assert exp_binning.launches["gather_rows"] == 1
    assert torch.equal(rows, want_rows)
    assert torch.equal(sums.view(torch.int32), want_sums.view(torch.int32))


# every variant of the tool, and two settings it does not time
P7_CASES = {**exp_fixed_grid.VARIANTS,
            "rows32_outs3_nozmax": dict(rows=32, nouts=3, zmax_reduce=False),
            "rows64_outs1_zmax": dict(rows=64, nouts=1)}


@pytest.mark.parametrize("case", sorted(P7_CASES))
def test_fixed_grid_bit_equal(cuda_device, case):
    """On the hot blocks of the CPU tests, one of them in the frame's last
    row, so that the padded last block row (rows 16 and 128) adds 1.0 to
    its pad too."""
    from torch_probe_tables import depth_with_hot_blocks

    kw = P7_CASES[case]
    d = depth_with_hot_blocks(kw["rows"] + kw.get("nouts", 7))
    d[1079, 300] = 2.5
    depth = torch.from_numpy(d).to(cuda_device)
    exp_fixed_grid.reset_launches()
    got = exp_fixed_grid.fixed_grid(depth, **kw)
    want = exp_fixed_grid.fixed_grid_reference(depth, **kw)
    torch.cuda.synchronize()
    assert exp_fixed_grid.launches["fixed_grid"] == 1
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if kw.get("zmax_reduce", True) and kw["rows"] in (16, 128):
        # the pad below row 1080 is 0 + 1.0 under the hot pixel
        assert bool((got[0][1080:, 256:384] == 1.0).all())


def test_fixed_grid_rejects_what_the_kernel_does_not_take(cuda_device):
    """A depth view off the 16-byte grid, and more rows a block than 32
    warps of 8 rows hold, raise before any launch."""
    depth = exp_fixed_grid.depth_input(cuda_device)
    shifted = torch.empty(depth.numel() + 1, device=cuda_device)[1:].view(
        depth.shape)
    shifted.copy_(depth)
    exp_fixed_grid.reset_launches()
    with pytest.raises(ValueError, match="aligned"):
        exp_fixed_grid.fixed_grid(shifted, 16)
    with pytest.raises(ValueError, match="rows"):
        exp_fixed_grid.fixed_grid(depth, exp_fixed_grid.MAX_ROWS + 1)
    assert exp_fixed_grid.launches["fixed_grid"] == 0
    got = exp_fixed_grid.fixed_grid(depth, exp_fixed_grid.MAX_ROWS)
    want = exp_fixed_grid.fixed_grid_reference(depth,
                                               exp_fixed_grid.MAX_ROWS)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)


def poison(n, shape, device):
    """NaN in the n blocks of ``shape`` the allocator hands out next: a
    pixel a kernel misses stays NaN."""
    blocks = [torch.full(shape, float("nan"), device=device)
              for _ in range(n)]
    del blocks


@pytest.mark.parametrize("n_out", range(1, 8))
@pytest.mark.parametrize("case", ["empty", "segments", "jumbled"])
def test_fixed_cost_bit_equal(cuda_device, case, n_out):
    """empty: the tool's segments; segments: 70 % of the tiles 1 to 299
    rows from row 3; jumbled: starts in no order on a 1,000-row table, so
    a CTA's tiles take 0 to 8 trips and bases in the last chunk copy its
    104 rows."""
    from tyleri_tpu_torch.tools import exp_fixedcost

    table, _, depth0, ts = exp_fixedcost.tool_inputs(cuda_device, seed=5)
    if case == "segments":
        ts = exp_fixedcost.segment_starts(cuda_device)
    elif case == "jumbled":
        table = table[:exp_fixedcost.SHORT_E].contiguous()
        ts = exp_fixedcost.jumbled_starts(cuda_device, seed=n_out)
    depth0 = torch.rand(depth0.shape, device=cuda_device)
    poison(n_out, (1088, 1920), cuda_device)
    exp_fixedcost.reset_launches()
    got = exp_fixedcost.fixed_cost(table, ts, depth0, n_out=n_out)
    want = exp_fixedcost.fixed_cost_reference(table, ts, depth0, n_out=n_out)
    torch.cuda.synchronize()
    assert exp_fixedcost.launches["fixed_cost"] == 1
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    for shape in exp_fixedcost.LAUNCH_VARIANTS.values():
        assert torch.equal(exp_fixedcost.fill(*shape, cuda_device),
                           exp_fixedcost.fill_reference(*shape, cuda_device))


def test_fixed_cost_rejects_what_the_kernel_does_not_take(cuda_device):
    """Table or depth views off the 16-byte grid, and rows of a width that
    is no multiple of 4, raise before any launch."""
    from tyleri_tpu_torch.tools import exp_fixedcost

    table = torch.rand((1024, 24), device=cuda_device)
    depth0 = torch.rand((1080, 1920), device=cuda_device)
    ts = exp_fixedcost.jumbled_starts(cuda_device, E=1000)

    def shifted(t):
        out = torch.empty(t.numel() + 1, device=cuda_device)[1:].view(
            t.shape)
        return out.copy_(t)

    exp_fixedcost.reset_launches()
    for args, match in (((shifted(table), ts, depth0), "aligned"),
                        ((table, ts, shifted(depth0)), "aligned"),
                        ((table[:, :22].contiguous(), ts, depth0),
                         "multiple of 4")):
        with pytest.raises(ValueError, match=match):
            exp_fixedcost.fixed_cost(*args, n_out=3)
    assert exp_fixedcost.launches["fixed_cost"] == 0


@pytest.mark.parametrize("shape", [
    (3, 5, 7, 13),     # tile_w % 4 == 1: rows start at every alignment
    (2, 7, 3, 6),      # tile_w % 4 == 2
    (4, 3, 40, 1),     # one column a tile: scalar stores alone
    (1, 2, 9, 130),    # a wide tile: two float4 passes a row, and a tail
    (5, 4, 2, 8),      # aligned, narrower than a warp's columns
])
def test_fill_bit_equal_at_odd_shapes(cuda_device, shape):
    from tyleri_tpu_torch.tools import exp_fixedcost

    grid_h, grid_w, tile_h, tile_w = shape
    # NaN in the block the allocator hands the fill next: a pixel the
    # kernel misses stays NaN
    torch.full((grid_h * tile_h, grid_w * tile_w), float("nan"),
               device=cuda_device)
    exp_fixedcost.reset_launches()
    got = exp_fixedcost.fill(*shape, cuda_device)
    torch.cuda.synchronize()
    assert exp_fixedcost.launches["fill"] == 1
    assert torch.equal(got, exp_fixedcost.fill_reference(*shape, cuda_device))


@pytest.mark.parametrize("level,nout,kind,tpp", [
    (0, 7, "zero", 1), (1, 7, "zero", 4), (2, 7, "zero", 1),
    (2, 7, "one", 1), (2, 3, "many", 4), (2, 1, "many", 1),
    *((0, n, "zero", 1) for n in range(1, 7)),
    *((2, n, "jumbled", 1) for n in range(1, 8)),
    (2, 7, "jumbled", 4), (2, 7, "many", 4), (2, 7, "one", 4),
    (2, 7, "jumbled", 17), (2, 3, "one", 68), (0, 7, "zero", 68),
    (1, 2, "zero", 17)])
def test_pipe_cost_bit_equal(cuda_device, level, nout, kind, tpp):
    """many: 0 to 4 trips a tile, the tiles past the table empty and the
    window across its end clamped; jumbled: starts in no order on a
    1,000-row table, so a CTA's tiles take 0 to 16 trips and every window
    past it clamps at e_cap - 64.  tpp 17 and 68 put 16 tile rows side by
    side, some lanes with a row more than others."""
    from tyleri_tpu_torch.tools import exp_pipecost

    entries, ts_zero, ts_one = exp_pipecost.tool_inputs(cuda_device, seed=7)
    ts = {"zero": ts_zero, "one": ts_one}.get(kind)
    if kind == "many":
        rng = np.random.default_rng(7)
        lens = rng.integers(0, 256, ts_zero.numel() - 1)
        ts = torch.from_numpy(np.minimum(np.concatenate(
            [[0], np.cumsum(lens)]), entries.shape[0]).astype(np.int32)
        ).to(cuda_device)
    elif kind == "jumbled":
        entries = entries[:exp_pipecost.SHORT_E].contiguous()
        ts = exp_pipecost.jumbled_starts(cuda_device, seed=nout)
    poison(nout, (1088, 1920), cuda_device)
    exp_pipecost.reset_launches()
    got = exp_pipecost.run(entries, ts, nout=nout, level=level, tpp=tpp)
    want = exp_pipecost.pipe_cost_reference(entries, ts, nout=nout,
                                            level=level)
    torch.cuda.synchronize()
    assert exp_pipecost.launches["pipe_cost"] == 1
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


def test_pipe_cost_rejects_what_the_kernel_does_not_take(cuda_device):
    """An entry view off the 16-byte grid, rows of a width that is no
    multiple of 4, and fewer rows than a window raise before any launch."""
    from tyleri_tpu_torch.tools import exp_pipecost

    entries, ts, _ = exp_pipecost.tool_inputs(cuda_device)
    entries = entries[:1024]
    shifted = torch.empty(entries.numel() + 1, device=cuda_device)[1:].view(
        entries.shape).copy_(entries)
    exp_pipecost.reset_launches()
    for ent in (shifted, entries[:, :22].contiguous(), entries[:63]):
        with pytest.raises(ValueError, match="aligned"):
            exp_pipecost.run(ent, ts, nout=7, level=2)
    assert exp_pipecost.launches["pipe_cost"] == 0


# ---- P3, P2, P5 (csrc/probes_visibility.cu, probes_mxu.cu, probes.cu) ----

def p3_inputs(device, tile_h, seed=5, skew=False):
    """The CPU tests' snapped random table and segments (``skew``: two
    tiles hold most entries)."""
    from torch_probe_tables import FB_H, FB_W, inputs

    tab, ts, depth0, _, _ = inputs(seed, tile_h, skew=skew)
    t = [torch.from_numpy(a).to(device) for a in (tab, ts, depth0)]
    return (*t, (0, 0, FB_W, FB_H))


P3_CASES = {
    "base": {}, "lex": dict(lex=True), "exit": dict(exit=True),
    "exit2": dict(exit=True, lag2=True), "strip": dict(strip_attrs=True),
    "hoist": dict(hoist_loads=True),
    "hoist_strip": dict(hoist_loads=True, strip_attrs=True),
    "e2stored": dict(exit=True, e2_stored=True),
    "chunk256": dict(chunk=256), "c512": dict(chunk=512),
    "th8": dict(tile_h=8), "th32": dict(tile_h=32),
    "th64c256": dict(tile_h=64, chunk=256), "unroll8": dict(unroll=8),
    "th32u2": dict(tile_h=32, chunk=256, unroll=2),
    # two tiles hold most entries, so the tile order reorders the launch
    "skew": dict(skew=True), "skew_exit": dict(skew=True, exit=True),
    "skew_exit2": dict(skew=True, exit=True, lag2=True),
    "skew_th8": dict(skew=True, tile_h=8),
    "skew_th32hoist": dict(skew=True, tile_h=32, chunk=256,
                           hoist_loads=True),
    "skew_th64c256": dict(skew=True, tile_h=64, chunk=256),
}


@pytest.mark.parametrize("case", sorted(P3_CASES))
def test_probe_visibility_variant_bit_equal(cuda_device, case):
    from tyleri_tpu_torch.tools import exp_visibility as V

    kw = dict(P3_CASES[case])
    tile_h = kw.get("tile_h", 16)
    table, ts, depth0, scissor = p3_inputs(cuda_device, tile_h,
                                           skew=kw.pop("skew", False))
    if kw.get("e2_stored"):
        table = V.refill_e2(table)
    V.reset_launches()
    got, nres = V.run_variant(table, ts, depth0, scissor, **kw)
    grid_w, grid_h = V.grid_of(depth0.shape[1], depth0.shape[0], tile_h)
    want, want_nres = V.variant_reference(
        table, ts, depth0, scissor, tile_h=tile_h, grid_w=grid_w,
        grid_h=grid_h, chunk=kw.get("chunk", 128),
        **{k: v for k, v in kw.items()
           if k not in ("tile_h", "chunk", "unroll")})
    torch.cuda.synchronize()
    assert V.launches["visibility_variant"] == 1
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and torch.equal(
            g.view(torch.int32), w.view(torch.int32))
    assert torch.equal(nres, want_nres)


@pytest.mark.parametrize("exit,lag2", [(True, False), (False, False),
                                       (True, True)])
def test_probe_visibility_packed_bit_equal(cuda_device, exit, lag2):
    from tyleri_tpu_torch.tools import exp_visibility as V

    table, ts, depth0, scissor = p3_inputs(cuda_device, 16, seed=11)
    packed = V.pack5(table)
    got, nres = V.run_packed(packed, ts, depth0, scissor, exit=exit,
                             lag2=lag2)
    grid_w, grid_h = V.grid_of(depth0.shape[1], depth0.shape[0], 16)
    want, want_nres = V.packed_reference(packed, ts, depth0, scissor,
                                         tile_h=16, grid_w=grid_w,
                                         grid_h=grid_h, exit=exit, lag2=lag2)
    torch.cuda.synchronize()
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert torch.equal(nres, want_nres)


@pytest.mark.parametrize("exit,lag2", [(True, False), (True, True)])
def test_probe_visibility_packed_on_skewed_segments(cuda_device, exit, lag2):
    from tyleri_tpu_torch.tools import exp_visibility as V

    table, ts, depth0, scissor = p3_inputs(cuda_device, 16, seed=13,
                                           skew=True)
    packed = V.pack5(table)
    got, nres = V.run_packed(packed, ts, depth0, scissor, exit=exit,
                             lag2=lag2)
    grid_w, grid_h = V.grid_of(depth0.shape[1], depth0.shape[0], 16)
    want, want_nres = V.packed_reference(packed, ts, depth0, scissor,
                                         tile_h=16, grid_w=grid_w,
                                         grid_h=grid_h, exit=exit, lag2=lag2)
    torch.cuda.synchronize()
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert torch.equal(nres, want_nres)


@pytest.mark.parametrize("exit,lag2", [(True, False), (False, False),
                                       (True, True)])
@pytest.mark.parametrize("lane", range(5))
def test_probe_visibility_packed_at_row_edges(cuda_device, lane, exit, lag2):
    """Segments that start and end on every lane of a packed row, an empty
    one, some inside one row, and a last one whose last window is clamped
    at cap - 130 (the packed table without its pad rows)."""
    from torch_probe_tables import (
        packed_edge_segments,
        snapped_table,
        zmin_sorted,
    )

    from tyleri_tpu_torch.tools import exp_visibility as V

    E, fb_w, fb_h = 1600, 256, 96
    rng = np.random.default_rng(40 + lane)
    ts_np = packed_edge_segments(lane, E)
    tab = zmin_sorted(snapped_table(rng, E), ts_np)
    packed = V.pack5(torch.from_numpy(tab))[:-V.ROWS_PER_WIN].to(cuda_device)
    cap = V.PACK * packed.shape[0]
    start, end = int(ts_np[-2]), int(ts_np[-1])
    nch = -(-(end - (start - start % V.PACK)) // V.ENT_PER_WIN)
    assert start - start % V.PACK + (nch - 1) * V.ENT_PER_WIN \
        > cap - V.ENT_PER_WIN   # the last window is clamped
    ts = torch.from_numpy(ts_np).to(cuda_device)
    depth0 = torch.ones((fb_h, fb_w), device=cuda_device)
    scissor = (0, 0, fb_w, fb_h)
    V.reset_launches()
    got, nres = V.run_packed(packed, ts, depth0, scissor, exit=exit,
                             lag2=lag2)
    grid_w, grid_h = V.grid_of(fb_w, fb_h, 16)
    assert grid_w * grid_h + 1 == ts.numel()
    want, want_nres = V.packed_reference(packed, ts, depth0, scissor,
                                         tile_h=16, grid_w=grid_w,
                                         grid_h=grid_h, exit=exit, lag2=lag2)
    torch.cuda.synchronize()
    assert V.launches["visibility_packed"] == 1
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and torch.equal(
            g.view(torch.int32), w.view(torch.int32))
    assert torch.equal(nres, want_nres)


# every variant, at both precisions where the layout has a choice (split
# is bf16 by construction)
MXU_PRECISIONS = [(name, prec) for name, opts in exp_mxu.VARIANTS.items()
                  for prec in ((None,) if opts.get("split")
                               else ("default", "highest"))]


@pytest.mark.parametrize("name,precision", MXU_PRECISIONS)
def test_probe_mxu_equal_on_exact_inputs(cuda_device, name, precision):
    """Every product and partial sum of the exact table is exact, so the
    tensor cores equal the plain version whatever their order of sums
    (values: a zero's sign aside)."""
    from tyleri_tpu_torch.tools import exp_mxu as M

    opts = M.options(name)
    if precision:
        opts["precision"] = precision
    grid = 40
    ent, ts = M.exact_inputs(cuda_device, grid=grid, seg=240,
                             split=opts["split"])
    kw = dict(grid=grid, grid_w=M.grid_dims(16)[0], chunk=128, **opts)
    M.reset_launches()
    got = M.run_mxu(ent, ts, **kw)
    want = M.mxu_reference(ent, ts, **kw)
    torch.cuda.synchronize()
    assert M.launches["mxu"] == 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["mm7_hst", "red", "full", "fatfullc",
                                  "fatsplitfullc", "fat4_def"])
def test_probe_mxu_close_on_the_tools_inputs(cuda_device, name):
    """On the tool's normal table the planes round their sums in other
    orders: within exp_mxu.compare's tolerance, at most 1 pixel in 10^3
    with another winner."""
    from tyleri_tpu_torch.tools import exp_mxu as M

    opts = M.options(name)
    ent, ts, grid = M.tool_inputs(cuda_device, grid=60)
    kw = dict(grid=grid, grid_w=M.grid_dims(16)[0], chunk=128, **opts)
    share, _ = M.compare(M.run_mxu(ent, ts, **kw),
                         M.mxu_reference(ent, ts, **kw), ent, opts, 2)
    assert share <= M.MAX_DIFFERING


# one variant of each layout, stage and attribute kind
MXU_KINDS = ["fat4_hst", "fat4_def", "fatsplit", "fat7_hst", "ew", "red",
             "full", "fatfullc", "fatsplitred", "fatsplitfullc",
             "fatsplit_exit"]


@pytest.mark.parametrize("tile_h,chunk", [(8, 128), (32, 128), (16, 64),
                                          (16, 256), (16, 72)])
@pytest.mark.parametrize("name", MXU_KINDS)
def test_probe_mxu_tiles_and_chunks_on_exact_inputs(cuda_device, name,
                                                    tile_h, chunk):
    """Other tile heights (m-tiles a warpgroup) and chunks (products a
    chunk; 72 ends on half a product): equal to the plain version on the
    exact table where the block's shared memory fits, else the wrapper
    raises before launching (fatfullc, fatsplitfullc and fatsplit_exit
    at tile_h 32, the last two at chunk 256: 14 maps a pixel, and the
    split's 60-lane ring, pass 227 KB)."""
    from tyleri_tpu_torch import _build
    from tyleri_tpu_torch.tools import exp_mxu as M

    opts = M.options(name, tile_h)
    grid = 40
    ent, ts = M.exact_inputs(cuda_device, grid=grid, seg=240, chunk=chunk,
                             split=opts["split"])
    kw = dict(grid=grid, grid_w=M.grid_dims(tile_h)[0], chunk=chunk, **opts)
    mode = 2 if opts["split"] else (0 if opts["precision"] == "highest"
                                    else 1)
    stage = M._stage(opts["do_ew"], opts["do_red"])
    attr = (1 if opts["do_attr"] else 2 if opts["do_attrc"] else 0
            ) if stage == 2 else 0
    M.reset_launches()
    if not _build.load().ty_probe_mxu_smem(mode, opts["nplanes"], chunk,
                                           tile_h, stage, attr):
        with pytest.raises(ValueError, match="shared memory"):
            M.run_mxu(ent, ts, **kw)
        assert M.launches["mxu"] == 0
        return
    got = M.run_mxu(ent, ts, **kw)
    want = M.mxu_reference(ent, ts, **kw)
    torch.cuda.synchronize()
    assert M.launches["mxu"] == 1
    assert torch.equal(got, want)


def test_probe_mosaic_bit_equal(cuda_device):
    from tyleri_tpu_torch.tools import exp_mosaic_probe as P5

    x_t, x_c = P5.tool_inputs(cuda_device)
    x_c = torch.randn(x_c.shape, device=cuda_device)
    got_t, got_c = P5.transpose(x_t), P5.compute(x_c)
    torch.cuda.synchronize()
    assert torch.equal(got_t, P5.transpose_reference(x_t))
    assert torch.equal(got_c.view(torch.int32),
                       P5.compute_reference(x_c).view(torch.int32))
    P5.check_tool_asserts(x_t, got_t, P5.compute(torch.ones_like(x_c)))
