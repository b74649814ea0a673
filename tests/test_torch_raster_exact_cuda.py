"""The exact rasterizer's CUDA kernel (csrc/raster_exact.cu) against its
plain loop (ops/raster_exact.py on CPU tensors), on the card: the same
inputs through both, color and depth equal at every pixel.  The scenes are
a HUD at 1080p through ``passes.ui_pass`` and exact-mode draws under every
compare op, depth write on and off, D16 and D32, every blend factor and
op, raster windows and none, a scissor, triangles across every
framebuffer edge, back-face-culled and zero-area triangles; the HUD and
the exact draws also at 600 to 1,000 triangles, past the 256 of one of
the kernel's cull chunks.  Also: the UI pass on CUDA tensors makes no
synchronizing call.

This file imports no JAX (the card's machine has none) and skips where no
CUDA device exists.  On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_raster_exact_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from tyleri_tpu_torch import _build
from tyleri_tpu_torch.ops import raster_exact
from tyleri_tpu_torch.ops.sampling import make_texel_quads
from tyleri_tpu_torch.pipeline.state import (
    BlendFactor as BF,
    BlendOp,
    BlendState,
    CompareOp,
    CullMode,
    DepthFormat,
    DepthState,
    MESH_PIPELINE_STATE,
    RasterState,
    UI_PIPELINE_STATE,
)
from tyleri_tpu_torch.rendering import passes
from tyleri_tpu_torch.utils.profiling import tracing

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


def arena(rng):
    """Slot 0: 1x1 white (solid); slot 1: an 8x8 checker; slot 2: a 16x16
    glyph texture of seeded RGBA."""
    yy, xx = np.mgrid[0:8, 0:8]
    c = ((xx + yy) % 2).astype(np.float32)
    checker = np.stack([c, 1 - c, np.full_like(c, 0.5), np.ones_like(c)], -1)
    glyph = rng.random((16, 16, 4)).astype(np.float32)
    texels = np.concatenate([np.ones((1, 4), np.float32),
                             checker.reshape(-1, 4), glyph.reshape(-1, 4)])
    offs, ws, hs = [0, 1, 65], [1, 8, 16], [1, 8, 16]
    return [torch.from_numpy(make_texel_quads(texels, offs, ws, hs)),
            torch.tensor(offs, dtype=torch.int32),
            torch.tensor(ws, dtype=torch.int32),
            torch.tensor(hs, dtype=torch.int32)]


def hud(seed, W=1920, H=1080, glyphs=64):
    """The UI pass's inputs: a 480x270 panel at (20, 20) of 8x8 solid quads
    under ``glyphs`` glyph quads of 16-32 px (rows of 32 at a 28 x 40
    pitch from (40, 60), so neighbours overlap) with the 16x16 texture,
    sub-pixel offsets, and seeded vertex colors with alpha; 256 triangles
    at scale 1 with 64 glyphs."""
    rng = np.random.default_rng(seed)
    quads = []                                   # x0, y0, x1, y1, tex
    for i in range(64):
        x0, y0 = 20 + 60 * (i % 8), 20 + 33.75 * (i // 8)
        quads.append((x0, y0, x0 + 60, y0 + 33.75, 0))
    for k in range(glyphs):
        x0 = 40 + 28 * (k % 32) + rng.uniform(0, 1)
        y0 = 60 + 40 * (k // 32) + rng.uniform(0, 1)
        w, h = rng.integers(16, 33, 2)
        quads.append((x0, y0, x0 + w, y0 + h, 2))
    pos = np.asarray([[(x0, y0), (x1, y0), (x1, y1), (x0, y1)]
                      for x0, y0, x1, y1, _ in quads], np.float32)
    uvs = np.tile(np.asarray([(0, 0), (1, 0), (1, 1), (0, 1)], np.float32),
                  (len(quads), 1, 1))
    cols = rng.uniform(0.2, 1.0, (len(quads), 4, 4)).astype(np.float32)
    tri = np.asarray([[0, 1, 2], [0, 2, 3]])
    clip = passes.ui_points_to_clip(pos, np.asarray([W, H], np.float32))
    tex = np.repeat([q[4] for q in quads], 2).astype(np.int32)
    T = 2 * len(quads)
    color = torch.empty((H, W, 4))
    color[..., :] = torch.tensor([0.1, 0.2, 0.3, 1.0])
    return (UI_PIPELINE_STATE, color, torch.ones((H, W)),
            clip[:, tri].reshape(T, 3, 4),
            torch.from_numpy(uvs[:, tri].reshape(T, 3, 2)),
            torch.from_numpy(cols[:, tri].reshape(T, 3, 4)),
            torch.from_numpy(tex), torch.ones((T,), dtype=torch.bool),
            np.asarray([0, 0, W, H, 0, 1], np.float32),
            np.asarray([0, 0, W, H], np.int32), *arena(rng))


def to(args, dev):
    return [a.to(dev) if isinstance(a, torch.Tensor) else a for a in args]


def assert_equal(got, want, before):
    """Color and depth equal at every pixel (value equality: the two zeros
    compare equal); the framebuffer ``before`` shows the scene drew."""
    got_c, got_d = (t.cpu() for t in got)
    want_c, want_d = want
    assert not torch.isnan(want_c).any() and not torch.isnan(want_d).any()
    n_c = int((got_c != want_c).any(-1).sum())
    n_d = int((got_d != want_d).sum())
    assert n_c == 0 and n_d == 0, (
        f"{n_c} px differ in color, {n_d} in depth; e.g. at "
        f"{torch.nonzero((got_c != want_c).any(-1) | (got_d != want_d))[:4]}")
    return float((want_c != before).any(-1).float().mean())


def test_hud_equals_the_loop(cuda_device):
    args = hud(5)
    want = passes.ui_pass(*args)
    before = _build.launches["raster_exact"]
    got = passes.ui_pass(*to(args, cuda_device))
    torch.cuda.synchronize()
    assert _build.launches["raster_exact"] == before + 1
    drew = assert_equal(got, want, args[1])
    assert drew > 0.05, f"the HUD drew {drew:.2%} of the frame"


@pytest.mark.parametrize("glyphs", [256, 384])
def test_hud_past_one_chunk_equals_the_loop(cuda_device, glyphs):
    """A HUD of 320 or 448 quads (640 or 896 triangles): the kernel culls
    256 triangles at a time, so its tiles see triangles of up to four
    chunks, and the tiles right of the panel below the fourth glyph row
    meet their first triangle in a later chunk than the first."""
    args = hud(7 + glyphs, glyphs=glyphs)
    T = args[3].shape[0]
    assert T == 128 + 2 * glyphs > 2 * 256
    want = passes.ui_pass(*args)
    before = _build.launches["raster_exact"]
    got = passes.ui_pass(*to(args, cuda_device))
    torch.cuda.synchronize()
    assert _build.launches["raster_exact"] == before + 1
    drew = assert_equal(got, want, args[1])
    # the last glyph row, drawn only by triangles of the last chunk
    last = want[1][60 + 40 * (glyphs // 32 - 1):, 520:] == 0
    assert drew > 0.05 and bool(last.any()), f"the HUD drew {drew:.2%}"


def test_ui_pass_makes_no_synchronizing_call(cuda_device):
    """The kernel path reads nothing to the host: under the sync debug
    mode's "error" around the call alone, it raises on any synchronizing
    call.  One launch, counted in ``_build.launches`` and in no tracing
    counter."""
    args = to(hud(6), cuda_device)
    passes.ui_pass(*args)                  # builds and loads the library
    torch.cuda.synchronize()
    before = _build.launches["raster_exact"]
    with tracing() as records:
        torch.cuda.set_sync_debug_mode("error")
        try:
            color, depth = passes.ui_pass(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert _build.launches["raster_exact"] == before + 1
    assert not records.counters
    assert not records.spans
    assert float(depth.min()) == 0.0


def exact_scene(seed, T, W, H, fmt):
    """Seeded clip-space triangles: the first four span past every edge of
    the framebuffer, the others anywhere near it; corner z partly outside
    [0, 1], half the triangles flat at n/64 (ties with the prior depth);
    w = 1 or perspective; both windings; the last three of zero area.
    Returns (color0, depth0, clip, uv, tex_id, valid, vertex colors, the
    texture arena)."""
    rng = np.random.default_rng(seed)
    ctr = rng.uniform(-1.3, 1.3, (T, 1, 2))
    ctr[:4] = 0.0
    spread = np.where(np.arange(T)[:, None, None] < 4, 2.5, 0.5)
    xy = ctr + rng.uniform(-1.0, 1.0, (T, 3, 2)) * spread
    z = rng.uniform(-0.1, 1.1, (T, 3))
    z[: T // 2] = rng.integers(4, 60, (T // 2, 1)) / 64.0
    w = np.where(rng.random((T, 1)) < 0.5, 1.0, rng.uniform(0.5, 2.0, (T, 3)))
    clip = np.concatenate([xy * w[..., None], (z * w)[..., None],
                           np.broadcast_to(w, (T, 3))[..., None]], -1)
    clip[-3:, 2] = clip[-3:, 0]
    color0 = rng.random((H, W, 4)).astype(np.float32)
    pick = rng.random((H, W))
    depth0 = np.where(pick < 0.4, rng.choice(z[: T // 2, 0], (H, W)),
                      rng.integers(4, 60, (H, W)) / 64.0)
    depth0 = np.where(pick > 0.8, 1.0, depth0).astype(np.float32)
    if fmt == DepthFormat.D16_UNORM:
        depth0 = (np.round(depth0 * 65535.0) / 65535.0).astype(np.float32)
    t = torch.from_numpy
    return (t(color0), t(depth0), t(clip.astype(np.float32)),
            t(rng.uniform(-0.5, 1.5, (T, 3, 2)).astype(np.float32)),
            t(rng.integers(0, 3, T).astype(np.int32)), t(rng.random(T) < 0.9),
            t(rng.uniform(0.2, 1.0, (T, 3, 4)).astype(np.float32)), arena(rng))


def exact_equals_the_loop(dev, seed, W, H, state, *, window=256,
                          scissor=None, vertex_color=False, T=24):
    color0, depth0, clip, uv, tex, valid, vcol, tex_arena = exact_scene(
        seed, T, W, H, state.depth.format)
    args = [color0, depth0, clip, uv, tex, valid,
            np.asarray([0, 0, W, H, 0, 1], np.float32),
            np.asarray(scissor or (0, 0, W, H), np.int32), *tex_arena]
    kw = dict(state=state, window=window)
    if vertex_color:
        kw.update(with_vertex_color=True, vertex_color=vcol)
    want = raster_exact.rasterize_exact(*args, **kw)
    before = _build.launches["raster_exact"]
    if vertex_color:
        kw["vertex_color"] = vcol.to(dev)
    got = raster_exact.rasterize_exact(*to(args, dev), **kw)
    torch.cuda.synchronize()
    assert _build.launches["raster_exact"] == before + 1
    return assert_equal(got, want, color0)


@pytest.mark.parametrize("fmt", [DepthFormat.D16_UNORM,
                                 DepthFormat.D32_SFLOAT])
@pytest.mark.parametrize("write", [True, False])
@pytest.mark.parametrize("op", list(CompareOp))
def test_exact_compare_ops_equal_the_loop(cuda_device, op, write, fmt):
    """320x288 under 256-px windows (boxes of several windows, windows
    clamped at the edges), a scissor, back faces culled, the mesh blend."""
    state = dataclasses.replace(
        MESH_PIPELINE_STATE,
        depth=DepthState(compare_op=op, write_enable=write, format=fmt),
        raster=RasterState(cull_mode=CullMode.BACK))
    drew = exact_equals_the_loop(cuda_device, 40 + len(op.value), 320, 288,
                                 state, scissor=(5, 7, 300, 270))
    if op == CompareOp.NEVER:
        assert drew == 0
    elif op != CompareOp.EQUAL:    # f32 z planes seldom tie under D32
        assert drew > 0.01, f"drew {drew:.2%}"


BLENDS = {
    "off": BlendState(enable=False),
    "ui": UI_PIPELINE_STATE.blend,
    "mesh": MESH_PIPELINE_STATE.blend,
    "subtract_alpha_factors": BlendState(
        src_color=BF.DST_ALPHA, dst_color=BF.ONE_MINUS_DST_ALPHA,
        color_op=BlendOp.SUBTRACT, src_alpha=BF.SRC_ALPHA,
        dst_alpha=BF.ONE_MINUS_SRC_COLOR, alpha_op=BlendOp.REVERSE_SUBTRACT,
        write_mask=(True, False, True, True)),
    "min_max": BlendState(color_op=BlendOp.MIN, alpha_op=BlendOp.MAX,
                          write_mask=(True, True, False, True)),
    "color_factors": BlendState(
        src_color=BF.ONE_MINUS_SRC_COLOR, dst_color=BF.DST_COLOR,
        src_alpha=BF.ONE_MINUS_DST_COLOR, dst_alpha=BF.ZERO,
        write_mask=(False, True, True, False)),
}


@pytest.mark.parametrize("name", sorted(BLENDS))
def test_exact_blend_states_equal_the_loop(cuda_device, name):
    """Every blend factor and op and partial write masks, with vertex
    colors, on a 200x136 framebuffer smaller than the window (each
    triangle over the whole framebuffer), depth test off."""
    state = dataclasses.replace(
        MESH_PIPELINE_STATE, blend=BLENDS[name],
        depth=DepthState(test_enable=False))
    drew = exact_equals_the_loop(cuda_device, 60 + len(name), 200, 136, state,
                                 vertex_color=True)
    assert drew > 0.01, f"drew {drew:.2%}"


@pytest.mark.parametrize("T,window", [(600, 16), (600, 0), (1000, 64),
                                      (1000, 256)])
def test_exact_past_one_chunk_equals_the_loop(cuda_device, T, window):
    """600 and 1,000 triangles, three and four chunks of the kernel's
    cull, at 320x288 under raster windows and none, a scissor, vertex
    colors, the UI's blend, D16 and LESS_OR_EQUAL with the depth write."""
    state = dataclasses.replace(UI_PIPELINE_STATE,
                                depth=DepthState(format=DepthFormat.D16_UNORM))
    drew = exact_equals_the_loop(cuda_device, T + window, 320, 288, state,
                                 window=window, scissor=(3, 9, 310, 270),
                                 vertex_color=True, T=T)
    assert drew > 0.01, f"drew {drew:.2%}"


@pytest.mark.parametrize("window", [0, 16, 64])
def test_exact_windows_equal_the_loop(cuda_device, window):
    """Small and large raster windows at 200x136, a scissor across the
    framebuffer's corner, vertex colors, the UI's blend and LESS_OR_EQUAL."""
    state = dataclasses.replace(UI_PIPELINE_STATE,
                                depth=DepthState(format=DepthFormat.D16_UNORM))
    drew = exact_equals_the_loop(cuda_device, 80 + window, 200, 136, state,
                                 window=window, scissor=(-10, 12, 180, 200),
                                 vertex_color=True, T=40)
    assert drew > 0.01, f"drew {drew:.2%}"
