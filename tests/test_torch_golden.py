"""The golden suite (tests/test_raster_golden.py) on the port: its mesh pass
(the visibility path and exact mode) and its UI pass against its own numpy
oracle (tyleri_tpu_torch/testing/oracle.py), which implements the Vulkan
raster rules in f64.

Each case is the original's, with the port's classes and the port's
default tiles (16x16); where the original runs the visibility path and exact
mode on the same scene, the two halves are cases of one parametrised test.
Scenes use grid-aligned coordinates, so f32 and f64 make the same coverage
decisions; the budget (the original's :108) allows 0.5 % of pixels more
than 2e-3 off for D16 rounding at quantization boundaries.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tyleri_tpu_torch.ops.sampling import make_texel_quads
from tyleri_tpu_torch.pipeline.state import (
    BlendState,
    CompareOp,
    CullMode,
    DepthFormat,
    DepthState,
    FrontFace,
    MESH_PIPELINE_STATE,
    PipelineState,
    RasterState,
    UI_PIPELINE_STATE,
)
from tyleri_tpu_torch.rendering import passes
from tyleri_tpu_torch.scene.light import DirectionalLight
from tyleri_tpu_torch.testing import oracle
from tyleri_tpu_torch.utils.math3d import Rect2D, Viewport

FLAT = PipelineState(
    blend=BlendState(enable=False),
    depth=DepthState(test_enable=True, write_enable=True,
                     compare_op=CompareOp.LESS_OR_EQUAL,
                     format=DepthFormat.D16_UNORM),
)

FB = 64
HALVES = ["visibility", "exact"]


def random_scene(rng, T=40, grid=16):
    """Triangles with vertices snapped to a coarse NDC grid, flat random z."""
    xy = rng.integers(-grid - 2, grid + 3, size=(T, 3, 2)).astype(
        np.float64) / grid
    z = rng.integers(1, 63, size=(T, 1)).astype(np.float64) / 64.0
    clip = np.zeros((T, 3, 4))
    clip[..., 0] = xy[..., 0]
    clip[..., 1] = xy[..., 1]
    clip[..., 2] = np.broadcast_to(z[:, None], (T, 3, 1))[..., 0]
    clip[..., 3] = 1.0
    uv = rng.random((T, 3, 2))
    return clip, uv


def checker_texture(n=8):
    yy, xx = np.mgrid[0:n, 0:n]
    c = ((xx + yy) % 2).astype(np.float64)
    return np.stack([c, 1 - c, np.full_like(c, 0.5), np.ones_like(c)], -1)


def arena_from(textures):
    """Flatten textures into the arena layout the passes consume."""
    texels, offs, ws, hs = [], [], [], []
    off = 0
    for t in textures:
        h, w = t.shape[:2]
        texels.append(t.reshape(-1, 4))
        offs.append(off)
        ws.append(w)
        hs.append(h)
        off += h * w
    return (torch.from_numpy(make_texel_quads(np.concatenate(texels), offs,
                                              ws, hs)),
            torch.tensor(offs, dtype=torch.int32),
            torch.tensor(ws, dtype=torch.int32),
            torch.tensor(hs, dtype=torch.int32))


def run_oracle(clip, uv, state, tex, sc=None, **kw):
    color = np.zeros((FB, FB, 4), np.float64)
    depth = np.ones((FB, FB), np.float64)
    oracle.rasterize(color, depth, clip, uv, state, Viewport(0, 0, FB, FB),
                     sc or Rect2D(0, 0, FB, FB), texture=tex, **kw)
    return color, depth


def run_pipeline(clip, uv, state, tex, exact=False, plan_kw=None, sc=None,
                 **kw):
    T = clip.shape[0]
    plan = passes.RasterPlan(fb_w=FB, fb_h=FB, entry_cap=4096, exact=exact,
                             **(plan_kw or {}))
    color, depth, stats, order = passes.mesh_pass(
        plan, state, torch.zeros((FB, FB, 4)), torch.ones((FB, FB)),
        torch.tensor(clip, dtype=torch.float32),
        torch.tensor(uv, dtype=torch.float32),
        torch.zeros((T,), dtype=torch.int32), torch.ones((T,), dtype=torch.bool),
        Viewport(0, 0, FB, FB).as_array(),
        (sc or Rect2D(0, 0, FB, FB)).as_array(), *arena_from([tex]), **kw)
    assert (order is None) == exact
    return color.numpy(), depth.numpy(), stats


def assert_images_close(got, want, budget=0.005, tol=2e-3, msg=""):
    diff = (np.abs(got.astype(np.float64) - want).max(axis=-1)
            if got.ndim == 3 else np.abs(got - want))
    bad = (diff > tol).mean()
    assert bad <= budget, f"{msg}: {bad:.4%} pixels differ (budget {budget:.2%})"


@pytest.mark.parametrize("half", HALVES)
def test_matches_oracle_flat(half):
    """:115 (visibility) and :126 (exact)."""
    exact = half == "exact"
    rng = np.random.default_rng(8 if exact else 7)
    clip, uv = random_scene(rng, T=24 if exact else 40)
    tex = checker_texture()
    want_c, want_d = run_oracle(clip, uv, FLAT, tex)
    got_c, got_d, stats = run_pipeline(clip, uv, FLAT, tex, exact=exact)
    assert int(stats.bin_overflow) == 0 and int(stats.tile_overflow) == 0
    assert_images_close(got_c, want_c, msg="color")
    assert_images_close(got_d, want_d, msg="depth")


def test_exact_matches_oracle_mesh_blend():
    """:136 the reference's SrcColor/OneMinusDstColor blend, in order."""
    rng = np.random.default_rng(9)
    clip, uv = random_scene(rng, T=24)
    tex = checker_texture()
    want_c, want_d = run_oracle(clip, uv, MESH_PIPELINE_STATE, tex)
    got_c, got_d, _ = run_pipeline(clip, uv, MESH_PIPELINE_STATE, tex,
                                   exact=True)
    assert_images_close(got_c, want_c, msg="color")
    assert_images_close(got_d, want_d, msg="depth")


def test_visibility_matches_exact_when_single_layer():
    """:147 non-overlapping triangles: both paths agree, any blend."""
    tris = []
    for gy in range(4):
        for gx in range(4):
            x0 = -1 + gx * 0.5 + 0.05
            y0 = -1 + gy * 0.5 + 0.05
            tris.append([[x0, y0, 0.5, 1], [x0 + 0.4, y0, 0.5, 1],
                         [x0, y0 + 0.4, 0.5, 1]])
    clip = np.asarray(tris, np.float64)
    uv = np.broadcast_to(np.array([[0.1, 0.1], [0.9, 0.1], [0.1, 0.9]]),
                         (16, 3, 2)).copy()
    tex = checker_texture()
    a_c, a_d, _ = run_pipeline(clip, uv, MESH_PIPELINE_STATE, tex, exact=True)
    b_c, b_d, _ = run_pipeline(clip, uv, MESH_PIPELINE_STATE, tex)
    np.testing.assert_allclose(a_c, b_c, atol=1e-6)
    # exact mode rounds D16 by division, the visibility path by the
    # reciprocal (R6): 1 ulp
    np.testing.assert_allclose(a_d, b_d, rtol=0, atol=2 ** -24)


def test_depth_tie_later_draw_wins_in_visibility():
    """:165"""
    quad0 = [[[-1, -1, 0.5, 1], [1, -1, 0.5, 1], [1, 1, 0.5, 1]],
             [[-1, -1, 0.5, 1], [1, 1, 0.5, 1], [-1, 1, 0.5, 1]]]
    clip = np.asarray(quad0 + quad0, np.float64)
    uv = np.zeros((4, 3, 2))
    uv[2:] = 0.9
    tex = np.zeros((2, 2, 4))
    tex[0, 0] = [1, 0, 0, 1]
    tex[1, 1] = [0, 1, 0, 1]
    got_c, _, _ = run_pipeline(clip, uv, FLAT, tex)
    want_c, _ = run_oracle(clip, uv, FLAT, tex)
    assert_images_close(got_c, want_c, budget=0.0, msg="tie color")
    assert got_c[32, 32, 1] > 0.5


def test_broad_triangle_path():
    """:181 a screen-filling triangle (broad list) under small ones."""
    big = [[[-4, -4, 0.9, 1], [4, -4, 0.9, 1], [0, 4, 0.9, 1]]]
    small = [[[-0.5, -0.5, 0.25, 1], [0.5, -0.5, 0.25, 1], [0, 0.5, 0.25, 1]]]
    clip = np.asarray(big + small, np.float64)
    uv = np.zeros((2, 3, 2))
    uv[1] = 0.9
    tex = np.zeros((2, 2, 4))
    tex[0, 0] = [1, 0, 0, 1]
    tex[1, 1] = [0, 1, 0, 1]
    want_c, want_d = run_oracle(clip, uv, FLAT, tex)
    got_c, got_d, stats = run_pipeline(
        clip, uv, FLAT, tex, plan_kw={"max_tiles_per_tri": 4, "broad_cap": 8})
    assert int(stats.bin_overflow) == 0
    assert_images_close(got_c, want_c, msg="color")
    assert_images_close(got_d, want_d, msg="depth")


def test_scissor_respected_by_pipeline():
    """:200"""
    rng = np.random.default_rng(11)
    clip, uv = random_scene(rng, T=10)
    tex = checker_texture()
    sc = Rect2D(8, 16, 24, 20)
    want_c, _ = run_oracle(clip, uv, FLAT, tex, sc=sc)
    got_c, _, _ = run_pipeline(clip, uv, FLAT, tex, sc=sc)
    assert_images_close(got_c, want_c, msg="scissor color")
    outside = np.ones((FB, FB), bool)
    outside[16:36, 8:32] = False
    assert np.all(got_c[outside] == 0)


def ui_quads(rng_or_quads):
    pos, uvs, cols, idx = [], [], [], []
    for qi, (x0, y0, x1, y1, c) in enumerate(rng_or_quads):
        base = 4 * qi
        pos += [(x0, y0), (x1, y0), (x1, y1), (x0, y1)]
        uvs += [(0, 0), (1, 0), (1, 1), (0, 1)]
        cols += [tuple(c)] * 4
        idx += [base, base + 1, base + 2, base, base + 2, base + 3]
    return (np.asarray(pos, np.float64), np.asarray(uvs, np.float64),
            np.asarray(cols, np.float64), np.asarray(idx, np.int64))


def run_ui(pos, uvs, cols, idx, screen_pts, W, H, tex):
    tri = idx.reshape(-1, 3)
    o_clip = oracle.make_ui_clip(pos, idx, screen_pts)
    o_color = np.zeros((H, W, 4), np.float64)
    o_depth = np.ones((H, W), np.float64)
    oracle.rasterize(o_color, o_depth, o_clip, uvs[tri], UI_PIPELINE_STATE,
                     Viewport(0, 0, W, H), Rect2D(0, 0, W, H), texture=tex,
                     vertex_color=cols[tri])
    clip = passes.ui_points_to_clip(pos.astype(np.float32),
                                    np.asarray(screen_pts, np.float32))[tri]
    color, depth = passes.ui_pass(
        UI_PIPELINE_STATE, torch.zeros((H, W, 4)), torch.ones((H, W)),
        clip, torch.tensor(uvs[tri], dtype=torch.float32),
        torch.tensor(cols[tri], dtype=torch.float32),
        torch.zeros((len(tri),), dtype=torch.int32),
        torch.ones((len(tri),), dtype=torch.bool),
        Viewport(0, 0, W, H).as_array(), Rect2D(0, 0, W, H).as_array(),
        *arena_from([tex]))
    return color.numpy(), depth.numpy(), o_color


def test_ui_pass_matches_oracle():
    """:214 UI quads: points to NDC, vertex color * texture, the UI blend."""
    pos, uvs, cols, idx = ui_quads([
        (2, 2, 18, 10, (1, 0, 0, 0.5)),
        (8, 6, 28, 30, (0, 1, 0, 1.0)),
        (1, 20, 30, 31, (0, 0, 1, 0.25)),
    ])
    color, depth, o_color = run_ui(pos, uvs, cols, idx, (32.0, 32.0), FB, FB,
                                   checker_texture())
    assert_images_close(color, o_color, budget=0.003, tol=1e-3,
                        msg="ui color")
    assert depth[6, 10] == 0.0   # the UI wrote depth 0 where it drew


def test_ui_windowed_raster_matches_oracle():
    """:268 at framebuffers larger than the raster window small UI quads
    take the window path."""
    FBW, FBH = 320, 288
    rng = np.random.default_rng(3)
    quads = []
    for _ in range(6):
        x0, y0 = rng.integers(0, FBW - 40), rng.integers(0, FBH - 40)
        x1, y1 = x0 + rng.integers(8, 40), y0 + rng.integers(8, 40)
        quads.append((x0, y0, x1, y1, rng.random(4)))
    pos, uvs, cols, idx = ui_quads(quads)
    color, depth, o_color = run_ui(pos, uvs, cols, idx, (FBW, FBH), FBW, FBH,
                                   checker_texture())
    assert_images_close(color, o_color, budget=0.005, tol=1e-3,
                        msg="windowed ui")
    assert float(depth.min()) == 0.0


@pytest.mark.parametrize("half", HALVES)
def test_d32_depth_format_matches_oracle(half):
    """:316 DepthFormat.D32_SFLOAT through both raster paths."""
    d32 = dataclasses.replace(FLAT, depth=dataclasses.replace(
        FLAT.depth, format=DepthFormat.D32_SFLOAT))
    rng = np.random.default_rng(12)
    clip, uv = random_scene(rng, T=16)
    clip[..., 2] = (1 + np.arange(16))[:, None] / 20.0
    tex = checker_texture()
    want_c, want_d = run_oracle(clip, uv, d32, tex)
    got_c, got_d, _ = run_pipeline(clip, uv, d32, tex, exact=half == "exact")
    assert_images_close(got_c, want_c, msg=f"d32 color {half}")
    assert_images_close(got_d, want_d, msg=f"d32 depth {half}")


@pytest.mark.parametrize("half", HALVES)
def test_blend_deviation_with_overdraw(half):
    """:338 three full-screen quads drawn back to front under the mesh
    blend: exact mode reproduces the oracle; the visibility path blends
    only the final fragment, its depth matches and its color deviates."""
    rng = np.random.default_rng(77)
    layers = []
    for i, z in enumerate([0.875, 0.625, 0.375]):
        s = 0.875 - 0.125 * i
        layers += [[[-s, -s, z, 1], [s, -s, z, 1], [s, s, z, 1]],
                   [[-s, -s, z, 1], [s, s, z, 1], [-s, s, z, 1]]]
    clip = np.asarray(layers, np.float64)
    uv = np.broadcast_to(rng.random((len(layers), 1, 2)),
                         (len(layers), 3, 2)).copy()
    tex = checker_texture()
    want_c, want_d = run_oracle(clip, uv, MESH_PIPELINE_STATE, tex)
    got_c, got_d, _ = run_pipeline(clip, uv, MESH_PIPELINE_STATE, tex,
                                   exact=half == "exact")
    assert_images_close(got_d, want_d, msg="depth")
    if half == "exact":
        assert_images_close(got_c, want_c, msg="exact color")
    else:
        dev = np.abs(got_c[..., :3] - want_c[..., :3]).max()
        assert 0.01 < dev <= 1.0


@pytest.mark.parametrize("half", HALVES)
def test_cull_modes_match_oracle_both_windings(half):
    """:380 FRONT and BACK at both front-face conventions."""
    rng = np.random.default_rng(11)
    clip, uv = random_scene(rng, T=48)
    tex = checker_texture()
    for ff in (FrontFace.COUNTER_CLOCKWISE, FrontFace.CLOCKWISE):
        for cm in (CullMode.BACK, CullMode.FRONT):
            st = dataclasses.replace(
                FLAT, raster=RasterState(cull_mode=cm, front_face=ff))
            want, wdepth = run_oracle(clip, uv, st, tex)
            got, gdepth, _ = run_pipeline(clip, uv, st, tex,
                                          exact=half == "exact")
            assert_images_close(got, want, msg=f"cull {cm} {ff} {half}")
            assert_images_close(gdepth, wdepth,
                                msg=f"cull-depth {cm} {ff} {half}")
    none_color, _ = run_oracle(clip, uv, FLAT, tex)
    assert np.abs(none_color - want).max() > 0.1


def test_lit_blinn_phong_matches_oracle():
    """:407 the lit path against the f64 oracle's same model; exact mode
    refuses lit shading, as the reference does (passes.py:439-443)."""
    rng = np.random.default_rng(21)
    clip, uv = random_scene(rng, T=24)
    n = rng.normal(size=(24, 3, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    tex = checker_texture()
    light = DirectionalLight(direction=(0.3, -1.0, -0.5))
    inv_vp = np.eye(4, dtype=np.float32)
    eye = np.asarray([0.0, 0.0, 3.0], np.float32)
    want, _ = run_oracle(clip, uv, FLAT, tex, normals=n, light=light,
                         inv_vp=inv_vp, eye=eye)
    lit = dict(normals=torch.tensor(n, dtype=torch.float32),
               lit_params=(light.as_array(), inv_vp, eye))
    got, _, _ = run_pipeline(clip, uv, FLAT, tex, **lit)
    assert_images_close(got, want, budget=0.005, tol=6e-3, msg="lit")
    unlit, _, _ = run_pipeline(clip, uv, FLAT, tex)
    assert np.abs(unlit - got).max() > 0.05
    with pytest.raises(NotImplementedError):
        run_pipeline(clip, uv, FLAT, tex, exact=True, **lit)
