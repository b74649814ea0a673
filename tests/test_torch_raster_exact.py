"""The exact rasterizer's plain loop (ops/raster_exact.py) as the CUDA
kernel's twin, on the CPU: what the kernel's tile cull rests on, the draw
regions it culls by, and that CPU tensors keep the loop and its one host
read.  The kernel against the loop runs on the card
(tests/test_torch_raster_exact_cuda.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_golden import (
    FB,
    FLAT,
    arena_from,
    checker_texture,
    random_scene,
    ui_quads,
)
from tyleri_tpu_torch import _build
from tyleri_tpu_torch.ops import raster_exact
from tyleri_tpu_torch.ops import setup as S
from tyleri_tpu_torch.pipeline.state import (
    CullMode,
    DepthState,
    MESH_PIPELINE_STATE,
    RasterState,
    UI_PIPELINE_STATE,
)
from tyleri_tpu_torch.rendering import passes
from tyleri_tpu_torch.utils.math3d import Rect2D, Viewport
from tyleri_tpu_torch.utils.profiling import tracing


def golden_ui(windowed):
    """The golden suite's UI scenes (test_torch_golden.py:246, :260)."""
    if not windowed:
        quads = [(2, 2, 18, 10, (1, 0, 0, 0.5)), (8, 6, 28, 30, (0, 1, 0, 1)),
                 (1, 20, 30, 31, (0, 0, 1, 0.25))]
        W = H = FB
        screen = (32.0, 32.0)
    else:
        W, H = 320, 288
        rng = np.random.default_rng(3)
        quads = []
        for _ in range(6):
            x0, y0 = rng.integers(0, W - 40), rng.integers(0, H - 40)
            x1, y1 = x0 + rng.integers(8, 40), y0 + rng.integers(8, 40)
            quads.append((x0, y0, x1, y1, rng.random(4)))
        screen = (W, H)
    pos, uvs, cols, idx = ui_quads(quads)
    tri = idx.reshape(-1, 3)
    clip = passes.ui_points_to_clip(pos.astype(np.float32),
                                    np.asarray(screen, np.float32))[tri]
    return dict(clip=clip, uv=torch.tensor(uvs[tri], dtype=torch.float32),
                vertex_color=torch.tensor(cols[tri], dtype=torch.float32),
                state=UI_PIPELINE_STATE, W=W, H=H, window=64,
                scissor=Rect2D(0, 0, W, H))


def golden_exact(seed, T, state, scissor=None, cull=None):
    """The golden suite's exact-mode scenes (test_torch_golden.py:119,
    :132, :199): grid-snapped corners, some past every edge."""
    clip, uv = random_scene(np.random.default_rng(seed), T=T)
    if cull is not None:
        state = dataclasses.replace(state, raster=RasterState(cull_mode=cull))
    return dict(clip=torch.tensor(clip, dtype=torch.float32),
                uv=torch.tensor(uv, dtype=torch.float32), vertex_color=None,
                state=state, W=FB, H=FB, window=256,
                scissor=scissor or Rect2D(0, 0, FB, FB))


SCENES = {
    "ui": lambda: golden_ui(False),
    "ui_windowed": lambda: golden_ui(True),
    "exact_flat": lambda: golden_exact(8, 24, FLAT),
    "exact_mesh_blend": lambda: golden_exact(9, 24, MESH_PIPELINE_STATE),
    "exact_scissor": lambda: golden_exact(11, 10, FLAT,
                                          scissor=Rect2D(8, 16, 24, 20)),
    "exact_cull_back": lambda: golden_exact(12, 24, FLAT,
                                            cull=CullMode.BACK),
}


def draw(sc, valid, *, state=None, window=None, depth0=1.0):
    """``rasterize_exact`` on the scene with the triangles of ``valid``."""
    T = sc["clip"].shape[0]
    W, H = sc["W"], sc["H"]
    vc = sc["vertex_color"]
    return raster_exact.rasterize_exact(
        torch.zeros((H, W, 4)), torch.full((H, W), depth0), sc["clip"],
        sc["uv"], torch.zeros((T,), dtype=torch.int32), valid,
        Viewport(0, 0, W, H).as_array(), sc["scissor"].as_array(),
        *arena_from([checker_texture()]), state=state or sc["state"],
        with_vertex_color=vc is not None, vertex_color=vc,
        window=sc["window"] if window is None else window)


def setup(sc):
    T = sc["clip"].shape[0]
    return S.setup_triangles(
        sc["clip"], sc["uv"], torch.zeros((T,), dtype=torch.int32),
        torch.ones((T,), dtype=torch.bool),
        Viewport(0, 0, sc["W"], sc["H"]).as_array(),
        sc["scissor"].as_array(), tile_w=1, tile_h=1, grid_w=sc["W"],
        grid_h=sc["H"], cull_mode=sc["state"].raster.cull_mode,
        front_face=sc["state"].raster.front_face)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_loop_draws_inside_the_pixel_box(name):
    """The premise of the kernel's tile cull: no pixel the plain loop draws
    lies outside its triangle's pixel box (setup's tile_lo/tile_hi at 1x1
    tiles).  Each triangle is drawn alone with no raster window, so the
    loop tests every pixel of the framebuffer, with the depth test off and
    the depth written: every fragment it makes shows in the depth."""
    sc = SCENES[name]()
    T = sc["clip"].shape[0]
    su = setup(sc)
    st = dataclasses.replace(
        sc["state"], depth=DepthState(test_enable=False, write_enable=True))
    drew_any = 0
    for t in range(T):
        valid = torch.zeros((T,), dtype=torch.bool)
        valid[t] = True
        _, depth = draw(sc, valid, state=st, window=0, depth0=2.0)
        ys, xs = torch.nonzero(depth != 2.0, as_tuple=True)
        if not len(xs):
            continue
        drew_any += 1
        (x0, y0), (x1, y1) = su.tile_lo[t].tolist(), su.tile_hi[t].tolist()
        assert bool(su.valid[t]), f"{name}: triangle {t} drew but is not live"
        assert (x0 <= int(xs.min()) and int(xs.max()) <= x1
                and y0 <= int(ys.min()) and int(ys.max()) <= y1), (
            f"{name}: triangle {t} drew x {int(xs.min())}..{int(xs.max())}, "
            f"y {int(ys.min())}..{int(ys.max())} outside its box "
            f"x {x0}..{x1}, y {y0}..{y1}")
    assert drew_any >= T // 4, f"{name}: only {drew_any} of {T} drew"


def loop_pixels(lo, hi, valid, W, H, scissor, window):
    """The pixels the loop of ``rasterize_exact`` visits for a triangle: its
    windows as the loop enumerates and clamps them, each limited to the
    pixels it owns and the scissor."""
    scx, scy, scw, sch = scissor
    if not valid:
        return set()
    if not (0 < window <= W and window <= H):
        pieces = [(0, 0, H, W, (0, H, 0, W))]
    else:
        pieces = [(min(max(gy0, 0), H - window), min(max(gx0, 0), W - window),
                   window, window, (gy0, gy0 + window, gx0, gx0 + window))
                  for gy0 in range(lo[1], hi[1] + 1, window)
                  for gx0 in range(lo[0], hi[0] + 1, window)]
    out = set()
    for oy, ox, rh, rw, own in pieces:
        y0, y1 = max(own[0], scy, oy), min(own[1], scy + sch, oy + rh)
        x0, x1 = max(own[2], scx, ox), min(own[3], scx + scw, ox + rw)
        out |= {(y, x) for y in range(y0, y1) for x in range(x0, x1)}
    return out


@pytest.mark.parametrize("W,H,window,scissor", [
    (96, 80, 32, (0, 0, 96, 80)),
    (96, 80, 32, (7, 5, 60, 200)),
    (96, 80, 16, (-9, -4, 50, 41)),
    (96, 80, 128, (3, 2, 80, 70)),      # past the framebuffer: no windows
    (96, 80, 0, (10, 20, 30, 30)),
])
def test_draw_regions_are_the_loops_windows(W, H, window, scissor):
    """``_draw_regions``, the rectangle the kernel draws each triangle over,
    holds exactly the pixels the loop's windows visit: windows clamped at
    the framebuffer's edges, boxes of several windows, scissors inside,
    across and past the framebuffer, and no windows at all."""
    rng = np.random.default_rng(W + H + window)
    T = 40
    xy = rng.uniform(-1.4, 1.4, (T, 1, 2)) + rng.uniform(-0.6, 0.6, (T, 3, 2))
    clip = np.concatenate([xy, np.full((T, 3, 1), 0.5), np.ones((T, 3, 1))],
                          -1).astype(np.float32)
    clip[-3:, 1] = clip[-3:, 0]                     # zero area: not live
    sc = dict(clip=torch.from_numpy(clip), uv=torch.zeros((T, 3, 2)),
              W=W, H=H, scissor=Rect2D(*scissor), state=FLAT)
    su = setup(sc)
    regions = raster_exact._draw_regions(su, Rect2D(*scissor).as_array(), W,
                                         H, window)
    assert regions.dtype == torch.int32 and regions.shape == (T, 4)
    for t in range(T):
        x0, y0, x1, y1 = regions[t].tolist()
        got = {(y, x) for y in range(y0, y1) for x in range(x0, x1)}
        want = loop_pixels(su.tile_lo[t].tolist(), su.tile_hi[t].tolist(),
                           bool(su.valid[t]), W, H, scissor, window)
        assert got == want, f"triangle {t}: region {regions[t].tolist()}"
    live = (regions[:, 2] > regions[:, 0]) & (regions[:, 3] > regions[:, 1])
    assert int(live.sum()) >= 5


def test_cpu_tensors_take_the_loop_and_read_once():
    """CPU tensors draw through the plain loop: no launch, no count, and
    the one synchronizing read of the triangles' boxes, in its ``ui.read``
    span."""
    sc = golden_ui(False)
    T = sc["clip"].shape[0]
    before = _build.launches["raster_exact"]
    with tracing() as records:
        color, depth = draw(sc, torch.ones((T,), dtype=torch.bool))
    assert _build.launches["raster_exact"] == before
    assert [s.name for s in records.spans] == ["ui.read"]
    assert not records.counters
    assert float(depth.min()) == 0.0 and float(color.abs().sum()) > 0
