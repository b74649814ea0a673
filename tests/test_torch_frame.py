"""The port's frame as a whole, through its RenderWindow, against the JAX
package's RenderWindow and against the numpy oracle, on the CPU.

Both packages render from the same bytes: the scene is uploaded once
through the JAX package's API and copied into the port's device
(tyleri_tpu_torch.interop), the port starts from the JAX plan, and each
frame's JAX scene is rebuilt with the port's classes (``from_jax``).  On the
CPU the JAX package takes its XLA path (setup, near clip, binning, the XLA
visibility resolve) unless a test forces its Pallas kernel in interpret
mode; the port takes its own path, with the kernels' plain versions.

Budgets (tests/test_raster_golden.py:108): at most 0.5 % of pixels may
differ, where a pixel differs if any u8 channel does (the golden tolerance
of 2e-3 is below one u8 step).  XLA on the CPU contracts ``a * b + c`` into
fused multiply-adds and PyTorch does not, so an edge or a depth tie can
fall the other way on a few pixels.  Config 1 (one triangle) must match the
JAX frame on every pixel.

Two blend policies, two oracle references
(tyleri_tpu_torch/testing/scene_oracle.py):

* the JAX package's XLA path blends the surviving fragment once per pixel,
  so ``test_frame_matches_jax_and_oracle`` pins the port to "fast" (the
  single layer) and holds both to the oracle's single-survivor mode;
* the default "auto" policy engages peel2 on these scene sizes, as the JAX
  package does on its kernel path: ``test_peel2_frame_matches_jax_and_
  sequential_oracle`` forces the JAX plan onto the Pallas kernel (interpret
  mode) and holds both to the sequential oracle, which blends every
  fragment in draw order as the reference does.
"""

import dataclasses

import numpy as np
import pytest
import torch

import tyleri_tpu as ty
import tyleri_tpu_torch as tt
import tyleri_tpu_torch.rendering.forward
from tyleri_tpu.models import scenes
from tyleri_tpu.scene.render_scene import RenderScene
from tyleri_tpu.window.render_window import RenderWindow as JaxWindow
from tyleri_tpu.window.swapchain import ImageViewSwapchain as JaxSwapchain
from tyleri_tpu_torch.interop import (
    from_jax,
    load_render_device,
    raster_plan_from_jax,
)
from tyleri_tpu_torch.testing.scene_oracle import (
    mismatch_fraction,
    scene_oracle_u8,
)

BUDGET = 0.005


def sponza_small(device, res):
    return scenes.config5_sponza(device, res, grid_n=24)


CONFIGS = {
    "config1": (scenes.config1_triangle, (64, 64), 0.0),
    "config2": (scenes.config2_cube, (96, 72), 0.9),
    "config5": (sponza_small, (160, 96), 1.0),
}


def twin_windows(make, res, callback=None, blend_parity="auto",
                 jax_pallas=False):
    """A JAX window and a port window over the same uploaded scene; with
    ``jax_pallas`` the JAX plan is forced onto its Pallas kernel (interpret
    mode), as tests/test_blend_parity.py:22-26 does."""
    jdev = ty.RenderDeviceBuilder().validation_level(
        ty.ValidationLevel.ERROR).build()
    rig = make(jdev, res)
    tdev = tt.RenderDeviceBuilder().device("cpu").validation_level(
        tt.ValidationLevel.WARNING).debug_callback(callback).build()
    load_render_device(tdev, jdev)
    jwin = JaxWindow(jdev, resolution=res, present_mode="immediate")
    if jax_pallas:
        jrf = jwin.rendering_function
        jrf.plan = dataclasses.replace(jrf.plan, raster=dataclasses.replace(
            jrf.plan.raster, pallas=True, tile_w=128, tile_h=8, chunk=128))
    twin = tt.RenderWindow(tdev, resolution=res, present_mode="immediate",
                           blend_parity=blend_parity)
    trf = twin.rendering_function
    trf.plan = dataclasses.replace(
        trf.plan, raster=raster_plan_from_jax(jwin.rendering_function.plan.raster))
    return rig, jwin, twin


def port_scene(rig, t):
    """The JAX rig's frame at ``t`` as a port RenderScene."""
    scene = RenderScene()
    rig.fill(scene, t)
    return from_jax(scene)


def one_frame(win, rig, t):
    """Render and present one frame; a port window gets a JAX rig's cameras
    rebuilt with the port's classes."""
    scene = win.get_render_scene()
    if (isinstance(win, tt.RenderWindow)
            and not isinstance(rig, tt.scenes.SceneRig)):
        for cam in port_scene(rig, t).render_resources.cameras:
            scene.add_camera(cam)
    else:
        rig.fill(scene, t)
    win.render()
    return win.flush()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_frame_matches_jax_and_oracle(name):
    make, res, t = CONFIGS[name]
    messages = []
    rig, jwin, twin = twin_windows(make, res, messages.append,
                                   blend_parity="fast")
    reports = []
    note = twin.rendering_function.note_overflow
    twin.rendering_function.note_overflow = (
        lambda *a, **k: (reports.append((a, k)), note(*a, **k)))
    want = one_frame(jwin, rig, t)
    got = one_frame(twin, rig, t)
    assert got.shape == want.shape == (res[1], res[0], 4)
    assert got.dtype == np.uint8 and (got[..., :3] > 0).any()

    differ = mismatch_fraction(got, want)
    print(f"{name}: {differ:.4%} px differ from the JAX frame")
    if name == "config1":
        assert differ == 0.0
    assert differ <= BUDGET

    oracle = scene_oracle_u8(twin.render_device,
                             port_scene(rig, t).render_resources,
                             twin.rendering_function.mesh_state, res)
    bad = mismatch_fraction(got, oracle)
    print(f"{name}: {bad:.4%} px differ from the oracle")
    assert bad <= BUDGET

    # the frame's stats reached the capacity feedback; nothing overflowed
    assert len(reports) == 1 and reports[0][1]["n_frames"] == 1
    assert not [m for m in messages if m.message_id == "capacity-overflow"]
    # the two packages grew their plans alike
    assert raster_plan_from_jax(jwin.rendering_function.plan.raster) == \
        twin.rendering_function.plan.raster


def config4_small(device, res):
    return scenes.config4_instances(device, res, n_instances=12)


PEEL2_CONFIGS = {
    # lit: the clip-space mesh pass with world normals; the lit golden
    # tolerance of 6e-3 (tests/test_raster_golden.py:446-449) is more than
    # 1 u8 off
    "config3": (scenes.config3_suzanne, (96, 96), 0.3, 1),
    # 12 instances, with overlap: the two-layer blend deviates from the
    # sequential blend only where a pixel has three or more survivors
    "config4": (config4_small, (128, 72), 0.5, 1),
}


@pytest.mark.parametrize("name", sorted(PEEL2_CONFIGS))
def test_peel2_frame_matches_jax_and_sequential_oracle(name):
    """The "auto" policy engages peel2 in both packages; the frames agree
    within the golden budget, and against the sequential oracle at most
    0.5 % of pixels are more than 1 u8 off, fewer than with the single
    layer."""
    make, res, t, tol = PEEL2_CONFIGS[name]
    rig, jwin, twin = twin_windows(make, res, jax_pallas=True)
    want = one_frame(jwin, rig, t)
    got = one_frame(twin, rig, t)
    trf, jrf = twin.rendering_function, jwin.rendering_function
    assert trf.plan.raster.peel2 and jrf.plan.raster.peel2
    assert trf.plan.lit == jrf.plan.lit == (name == "config3")
    assert got.shape == want.shape and (got[..., :3] > 0).any()
    differ = mismatch_fraction(got, want)
    print(f"{name}: {differ:.4%} px differ from the JAX frame")
    assert differ <= BUDGET

    oracle = scene_oracle_u8(twin.render_device,
                             port_scene(rig, t).render_resources,
                             trf.mesh_state, res, sequential=True)
    bad = mismatch_fraction(got, oracle, tol)
    fast = tt.RenderWindow(twin.render_device, resolution=res,
                           present_mode="immediate", blend_parity="fast")
    bad_fast = mismatch_fraction(one_frame(fast, rig, t), oracle, tol)
    print(f"{name}: {bad:.4%} px more than {tol} u8 off the sequential "
          f"oracle with peel2, {bad_fast:.4%} with the single layer")
    assert bad <= BUDGET and bad < bad_fast


def test_reduced_sponza_converges_through_the_fit_stages():
    """Frames through the port's window move its plan through the near
    clip, the clip skip and both capacity-fit stages, with no overflow, and
    the converged plan renders the frame the first plan rendered."""
    _, res, _ = CONFIGS["config5"]
    messages = []
    dev = tt.RenderDeviceBuilder().device("cpu").validation_level(
        tt.ValidationLevel.WARNING).debug_callback(messages.append).build()
    rig = tt.scenes.config5_sponza(dev, res, grid_n=24)
    win = tt.RenderWindow(dev, resolution=res, present_mode="immediate")
    rf = win.rendering_function
    first = one_frame(win, rig, 0.0)
    entry_cap0 = rf.plan.raster.entry_cap
    stages, clip_skipped = set(), False
    orbit = [0.5 * k for k in range(1, 9)]
    for t in orbit + [0.0] * 24:
        rig.fill(win.get_render_scene(), t)
        win.render()
        stages.add(rf._fit_stage)
        clip_skipped |= not rf.plan.raster.near_clip
    last = win.flush()
    assert stages >= {1, 2}
    assert clip_skipped and not rf.plan.raster.near_clip
    assert rf.plan.raster.entry_cap < entry_cap0
    assert rf.plan.raster.spill_level_caps != ()
    assert not [m for m in messages if m.message_id == "capacity-overflow"]
    np.testing.assert_array_equal(first, last)


def test_profile_stage_timers_cover_the_frame():
    """One CPU frame under the recorder (``utils/profiling.tracing``, which
    testing/profile_frame.py reports from) holds a span for every layer of
    the frame, binning's five parts inside ``bin``, each of positive
    length."""
    from tyleri_tpu_torch.utils.profiling import tracing

    _, res, t = CONFIGS["config5"]
    dev = tt.RenderDeviceBuilder().device("cpu").build()
    rig = tt.scenes.config5_sponza(dev, res, grid_n=24)
    win = tt.RenderWindow(dev, resolution=res, present_mode="immediate")
    with tracing() as records:
        one_frame(win, rig, t)
    spans = records.spans
    names = {s.name for s in spans}
    assert {"plan", "setup", "bin", "raster", "shade",
            "present.enqueue"} <= names, names
    (b,) = [i for i, s in enumerate(spans) if s.name == "bin"]
    assert [s.name for s in spans if s.parent == b] == [
        "bin.sort", "bin.dense", "bin.spill", "bin.tiles", "bin.broad"]
    assert all(s.end_ns > s.start_ns for s in spans)


def ui_overlay(white, glyph, n=6, seed=4, extent=(64, 64)):
    """UI elements in window points: solid quads with per-corner colors and
    alpha on a 1x1 white texture, overlapping, and glyph-sized quads on a
    16x16 texture; [(vertices [4k, 8], indices, texture), ...]."""
    rng = np.random.default_rng(seed)
    W, H = extent
    elements = []
    for tex, size in ((white, (12, 30)), (glyph, (6, 12))):
        verts, idx = [], []
        for q in range(n):
            x0, y0 = rng.uniform(0, W - size[1]), rng.uniform(0, H - size[1])
            x1 = x0 + rng.uniform(*size)
            y1 = y0 + rng.uniform(*size)
            for (x, y), uv in zip(((x0, y0), (x1, y0), (x1, y1), (x0, y1)),
                                  ((0, 0), (1, 0), (1, 1), (0, 1))):
                verts.append([x, y, *uv, *rng.uniform(0.3, 1.0, 3),
                              rng.uniform(0.5, 1.0)])
            b = 4 * q
            idx += [b, b + 1, b + 2, b, b + 2, b + 3]
        elements.append((np.asarray(verts, np.float32),
                         np.asarray(idx, np.uint32), tex))
    return elements


def ui_twins(make, res, blend_parity="fast"):
    """The JAX and port rendering functions over one uploaded scene plus
    the overlay's two textures; the port starts from the JAX plan."""
    jdev = ty.RenderDeviceBuilder().build()
    rig = make(jdev, res)
    rng = np.random.default_rng(1)
    white, glyph = jdev.create_textures([
        ((1, 1), lambda b: b.__setitem__(slice(None), 1.0)),
        ((16, 16), lambda b: b.__setitem__(
            slice(None), rng.random((16, 16, 4), np.float32)))])
    tdev = tt.RenderDeviceBuilder().device("cpu").build()
    load_render_device(tdev, jdev)
    jrf = ty.ForwardRenderingFunction(jdev, JaxSwapchain(res),
                                      blend_parity=blend_parity)
    trf = tt.ForwardRenderingFunction(tdev, tt.ImageViewSwapchain(res),
                                      blend_parity=blend_parity)
    trf.plan = dataclasses.replace(
        trf.plan, raster=raster_plan_from_jax(jrf.plan.raster))
    return rig, jdev, tdev, jrf, trf, (white, glyph)


UI_CONFIGS = {
    "config1": (scenes.config1_triangle, (64, 64), 0.0),
    "config2": (scenes.config2_cube, (96, 72), 0.9),
}


@pytest.mark.parametrize("name", sorted(UI_CONFIGS))
def test_ui_frame_matches_jax(name):
    """The UI overlay first, then the mesh: the port's recorded frame
    against the JAX package's, color within the golden budget and the
    order map (0 where the UI drew) equal."""
    make, res, t = UI_CONFIGS[name]
    rig, jdev, tdev, jrf, trf, (white, glyph) = ui_twins(make, res)
    scene = RenderScene()
    rig.fill(scene, t)
    scene.add_ui(ui_overlay(white, glyph, extent=res))
    want = jrf.record(jdev, scene.render_resources, 1.0, res)
    got = trf.record(tdev, from_jax(scene).render_resources, 1.0, res)
    assert trf.plan.has_ui and jrf.plan.has_ui
    u8 = tt.rendering.forward.quantize_unorm8
    w8 = u8(torch.from_numpy(np.array(want.color)), True).numpy()
    g8 = u8(got.color, True).numpy()
    differ = mismatch_fraction(g8, w8)
    print(f"{name} + UI: {differ:.4%} px differ from the JAX frame")
    assert differ <= BUDGET
    order = got.order.numpy()
    np.testing.assert_array_equal(order, np.asarray(want.order))
    assert (order == 0).mean() > 0.05 and (order >= 1).any()
    # the UI wrote depth 0 where it drew; the mesh is visible elsewhere
    np.testing.assert_array_equal(got.depth.numpy()[order == 0], 0.0)


def test_ui_overlay_occludes_mesh():
    """tests/test_scene_window.py:67-90 on the port's window."""
    dev = tt.RenderDeviceBuilder().device("cpu").build()
    rig = tt.scenes.config1_triangle(dev, (64, 64))
    (white,) = dev.create_textures(
        [((1, 1), lambda b: b.__setitem__(slice(None), 1.0))])
    win = tt.RenderWindow(dev, resolution=(64, 64), present_mode="immediate")
    quad = [((4, 4), (0, 0), (0, 1, 0, 1)), ((28, 4), (1, 0), (0, 1, 0, 1)),
            ((28, 16), (1, 1), (0, 1, 0, 1)), ((4, 16), (0, 1), (0, 1, 0, 1))]
    for _ in range(2):
        scene = win.get_render_scene()
        rig.fill(scene, 0.0)
        scene.add_ui([(quad, [0, 1, 2, 0, 2, 3], white)])
        win.render()
    img = win.flush()
    # the UI drew first with its depth write: no mesh blended in there
    assert img[10, 16, 1] == 255 and img[10, 16, 0] == 0
    assert img[40, 32, 0] > 0


def test_ui_scale_factor_2_matches_oracle():
    """tests/test_scene_window.py:91-137 on the port: at scale factor 2 a
    quad authored in points covers twice the pixels."""
    from tyleri_tpu_torch.testing import oracle
    from tyleri_tpu_torch.utils import math3d

    RES = (64, 64)
    dev = tt.RenderDeviceBuilder().device("cpu").build()
    (white,) = dev.create_textures(
        [((1, 1), lambda b: b.__setitem__(slice(None), 1.0))])
    rf = tt.ForwardRenderingFunction(dev, tt.ImageViewSwapchain(RES))
    scene = tt.RenderScene()
    quad = [((4, 4), (0, 0), (0, 1, 0, 1)), ((16, 4), (1, 0), (0, 1, 0, 1)),
            ((16, 12), (1, 1), (0, 1, 0, 1)), ((4, 12), (0, 1), (0, 1, 0, 1))]
    idx = [0, 1, 2, 0, 2, 3]
    scene.add_ui([(quad, idx, white)])
    frame = rf.record(dev, scene.render_resources, 2.0, RES)
    got = frame.color.numpy()
    assert got[20, 28, 1] > 0.5, "scale_factor division dropped or broken"
    assert got[20, 36, 1] == 0.0, "quad overshoots its scaled extent"
    pos = np.asarray([p for p, _, _ in quad], np.float64)
    uvs = np.asarray([uv for _, uv, _ in quad], np.float64)
    cols = np.asarray([c for _, _, c in quad], np.float64)
    tri = np.asarray(idx).reshape(-1, 3)
    w, h = RES
    o_clip = oracle.make_ui_clip(pos, np.asarray(idx), (w / 2.0, h / 2.0))
    o_color = np.zeros((h, w, 4), np.float64)
    o_depth = np.ones((h, w), np.float64)
    oracle.rasterize(o_color, o_depth, o_clip, uvs[tri], rf.ui_state,
                     math3d.Viewport(0, 0, w, h), math3d.Rect2D(0, 0, w, h),
                     texture=np.ones((1, 1, 4)), vertex_color=cols[tri])
    bad = (np.abs(got - o_color).max(axis=-1) > 1e-3).mean()
    assert bad < 0.003, f"{bad:.3%} pixels differ from the DPI-2 oracle"
    np.testing.assert_allclose(frame.depth.numpy(), o_depth, atol=1e-6)


@pytest.mark.parametrize("name", sorted(UI_CONFIGS))
def test_exact_frame_matches_jax_and_sequential_oracle(name):
    """blend_parity="exact" in both packages: every fragment blends in draw
    order, so both frames hold to the sequential oracle; no order map."""
    make, res, t = UI_CONFIGS[name]
    rig, jdev, tdev, jrf, trf, _ = ui_twins(make, res, blend_parity="exact")
    assert trf.plan.raster.exact and jrf.plan.raster.exact
    scene = RenderScene()
    rig.fill(scene, t)
    want = jrf.record(jdev, scene.render_resources, 1.0, res)
    port = from_jax(scene)
    got = trf.record(tdev, port.render_resources, 1.0, res)
    u8 = tt.rendering.forward.quantize_unorm8
    w8 = u8(torch.from_numpy(np.array(want.color)), True).numpy()
    g8 = u8(got.color, True).numpy()
    differ = mismatch_fraction(g8, w8)
    oracle = scene_oracle_u8(tdev, port.render_resources, trf.mesh_state,
                             res, sequential=True)
    bad = mismatch_fraction(g8, oracle)
    print(f"{name} exact: {differ:.4%} px differ from the JAX frame, "
          f"{bad:.4%} from the sequential oracle")
    assert differ <= BUDGET and bad <= BUDGET
    assert (g8[..., :3] > 0).any()
    np.testing.assert_array_equal(got.order.numpy(), -1.0)


@pytest.mark.parametrize("scale", [1.0, 2.0])
def test_ui_frame_decomposes_into_overlay_and_mesh(scale):
    """The UI draws first at z = 0, so the mesh fails under it: where the
    UI drew, the frame equals the overlay-only frame, which holds to the
    UI oracle; elsewhere it equals the UI-free frame, bit for bit."""
    from tyleri_tpu_torch.testing.scene_oracle import ui_oracle

    res = (96, 72)
    dev = tt.RenderDeviceBuilder().device("cpu").build()
    rig = tt.scenes.config2_cube(dev, res)
    rng = np.random.default_rng(1)
    white, glyph = dev.create_textures([
        ((1, 1), lambda b: b.__setitem__(slice(None), 1.0)),
        ((16, 16), lambda b: b.__setitem__(
            slice(None), rng.random((16, 16, 4), np.float32)))])
    overlay = ui_overlay(white, glyph, extent=(48, 36))
    rf = tt.ForwardRenderingFunction(dev, tt.ImageViewSwapchain(res))

    def frame(cameras, ui):
        scene = tt.RenderScene()
        if cameras:
            rig.fill(scene, 0.9)
        scene.add_ui(overlay if ui else [])
        return rf.record(dev, scene.render_resources, scale, res), scene

    (both, _), (mesh, _), (alone, ui_scene) = (
        frame(True, True), frame(True, False), frame(False, True))
    drew = both.order == 0
    assert 0.05 < float(drew.float().mean()) < 0.9
    assert torch.equal(drew, alone.depth < 1.0)
    assert torch.equal(both.color[drew], alone.color[drew])
    assert torch.equal(both.color[~drew], mesh.color[~drew])
    assert torch.equal(both.depth[~drew], mesh.depth[~drew])
    want, want_d = ui_oracle(dev, ui_scene.render_resources, rf.ui_state, res,
                             scale)
    bad = (np.abs(alone.color.numpy() - want).max(axis=-1) > 1e-3).mean()
    assert bad <= BUDGET, f"{bad:.4%} px off the UI oracle"
    np.testing.assert_array_equal(alone.depth.numpy() == 0, want_d == 0)
