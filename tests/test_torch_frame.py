"""The port's frame as a whole, through its RenderWindow, against the JAX
package's RenderWindow and against the numpy oracle, on the CPU.

Both packages render from the same bytes: the scene is uploaded once
through the JAX package's API and copied into the port's device
(tyleri_tpu_torch.interop), and the port starts from the JAX plan.  On the
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

import tyleri_tpu as ty
import tyleri_tpu_torch as tt
from tyleri_tpu.models import scenes
from tyleri_tpu.scene.render_scene import RenderScene
from tyleri_tpu.window.render_window import RenderWindow as JaxWindow
from tyleri_tpu_torch.interop import load_render_device, raster_plan_from_jax
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


def one_frame(win, rig, t):
    rig.fill(win.get_render_scene(), t)
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

    scene = RenderScene()
    rig.fill(scene, t)
    oracle = scene_oracle_u8(twin.render_device, scene.render_resources,
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

    scene = RenderScene()
    rig.fill(scene, t)
    oracle = scene_oracle_u8(twin.render_device, scene.render_resources,
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
    make, res, _ = CONFIGS["config5"]
    messages = []
    dev = tt.RenderDeviceBuilder().device("cpu").validation_level(
        tt.ValidationLevel.WARNING).debug_callback(messages.append).build()
    rig = make(dev, res)
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
    """The frame profiler's stage timers see every stage of a frame and
    put the stages back afterwards."""
    from tyleri_tpu_torch.testing.profile_frame import STAGES, stage_timers

    make, res, t = CONFIGS["config5"]
    dev = tt.RenderDeviceBuilder().device("cpu").build()
    rig = make(dev, res)
    win = tt.RenderWindow(dev, resolution=res, present_mode="immediate")
    before = [getattr(owner, name) for owner, name in STAGES]
    with stage_timers() as host:
        one_frame(win, rig, t)
    assert set(host) == {name for _, name in STAGES}
    assert all(s > 0 for s in host.values())
    assert [getattr(owner, name) for owner, name in STAGES] == before
