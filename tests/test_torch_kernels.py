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

from tyleri_tpu_torch.pipeline.state import CompareOp, DepthFormat, DepthState
from tyleri_tpu_torch.ops import raster_cuda, setup_cuda
from tyleri_tpu_torch.ops import setup as S
from tyleri_tpu_torch.ops.binning import BinnedEntries, bin_triangles
from tyleri_tpu_torch.ops.visibility import (
    rasterize_visibility_reference,
    rasterize_visibility_stream_reference,
)
from tyleri_tpu_torch.testing.overdraw import overdraw_table
from tyleri_tpu_torch.tools import exp_mxu

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


@pytest.mark.parametrize("rows,nouts,zmax", [(16, 7, True), (128, 7, True),
                                             (32, 3, False), (64, 1, True)])
def test_fixed_grid_bit_equal(cuda_device, rows, nouts, zmax):
    from tyleri_tpu_torch.tools import exp_fixed_grid

    depth = exp_fixed_grid.depth_input(cuda_device, seed=rows)
    depth[::97, ::89] = 2.5   # blocks whose max adds 1.0
    got = exp_fixed_grid.fixed_grid(depth, rows, nouts, zmax)
    want = exp_fixed_grid.fixed_grid_reference(depth, rows, nouts, zmax)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("case,n_out", [("empty", 7), ("segments", 7),
                                        ("segments", 1)])
def test_fixed_cost_bit_equal(cuda_device, case, n_out):
    from tyleri_tpu_torch.tools import exp_fixedcost

    table, _, depth0, ts = exp_fixedcost.tool_inputs(cuda_device, seed=5)
    if case == "segments":
        rng = np.random.default_rng(5)
        lens = rng.integers(0, 300, ts.numel() - 1) * (
            rng.random(ts.numel() - 1) < 0.7)
        ts = torch.from_numpy(np.concatenate([[3], 3 + np.cumsum(lens)])
                              .astype(np.int32)).to(cuda_device)
    depth0 = torch.rand(depth0.shape, device=cuda_device)
    got = exp_fixedcost.fixed_cost(table, ts, depth0, n_out=n_out)
    want = exp_fixedcost.fixed_cost_reference(table, ts, depth0, n_out=n_out)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)
    for shape in exp_fixedcost.LAUNCH_VARIANTS.values():
        assert torch.equal(exp_fixedcost.fill(*shape, cuda_device),
                           exp_fixedcost.fill_reference(*shape, cuda_device))


@pytest.mark.parametrize("level,nout,kind,tpp", [
    (0, 7, "zero", 1), (1, 7, "zero", 4), (2, 7, "zero", 1),
    (2, 7, "one", 1), (2, 3, "many", 4), (2, 1, "many", 1)])
def test_pipe_cost_bit_equal(cuda_device, level, nout, kind, tpp):
    from tyleri_tpu_torch.tools import exp_pipecost

    entries, ts_zero, ts_one = exp_pipecost.tool_inputs(cuda_device, seed=7)
    ts = {"zero": ts_zero, "one": ts_one}.get(kind)
    if ts is None:   # 0 to 4 chunks, windows clamped at the table's end
        rng = np.random.default_rng(7)
        lens = rng.integers(0, 256, ts_zero.numel() - 1)
        ts = torch.from_numpy(np.minimum(np.concatenate(
            [[0], np.cumsum(lens)]), entries.shape[0]).astype(np.int32)
        ).to(cuda_device)
    got = exp_pipecost.run(entries, ts, nout=nout, level=level, tpp=tpp)
    want = exp_pipecost.pipe_cost_reference(entries, ts, nout=nout,
                                            level=level)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


# ---- P3, P2, P5 (csrc/probes_visibility.cu, probes_mxu.cu, probes.cu) ----

def p3_inputs(device, tile_h, seed=5):
    """The CPU tests' snapped random table and segments."""
    from torch_probe_tables import FB_H, FB_W, inputs

    tab, ts, depth0, _, _ = inputs(seed, tile_h)
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
}


@pytest.mark.parametrize("case", sorted(P3_CASES))
def test_probe_visibility_variant_bit_equal(cuda_device, case):
    from tyleri_tpu_torch.tools import exp_visibility as V

    kw = dict(P3_CASES[case])
    tile_h = kw.get("tile_h", 16)
    table, ts, depth0, scissor = p3_inputs(cuda_device, tile_h)
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
