"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card.  Built with -fmad=false, each kernel rounds every multiply and
add as eager PyTorch does, so the comparison is bit for bit.

This file imports no JAX (the card's machine has none) and skips where no
CUDA device exists.  On the card, run it without the repository's root
conftest (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from tyleri_tpu.pipeline.state import CompareOp, DepthFormat, DepthState
from tyleri_tpu_torch.ops import raster_cuda, setup_cuda
from tyleri_tpu_torch.ops import setup as S
from tyleri_tpu_torch.ops.binning import BinnedEntries, bin_triangles
from tyleri_tpu_torch.ops.visibility import (
    rasterize_visibility_reference,
    rasterize_visibility_stream_reference,
)
from tyleri_tpu_torch.testing.overdraw import overdraw_table

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
    from tyleri_tpu.pipeline.state import CullMode

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
