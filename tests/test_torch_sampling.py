"""Anisotropic sampling and the builder's sampler and queue setters, on the
CPU: the port's ``quad_derivatives``, ``sample_anisotropic`` and
``shade_visibility(aniso_taps=)`` against the JAX package's on the same
seeded inputs, and tests/test_device_and_aux.py:14-48,156-211 on the port.

Tolerances: quad derivatives are differences of neighbours, bit-equal.  The
anisotropic taps and the shade compute the footprint's lengths and each
tap's coordinate from products and sums that XLA on the CPU contracts into
fused multiply-adds and PyTorch does not, so a tap's coordinate moves by an
ulp: the samples agree within 1e-5 (a bilinear weight's rounding times a
texel of at most 1), except where a tap lands on a texel boundary and the
ulp moves it to the next texel, at most 0.1 % of the samples.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tyleri_tpu_torch as tt
from tyleri_tpu.ops import sampling as jsampling
from tyleri_tpu.ops import shade as jshade
from tyleri_tpu.ops.visibility import VisibilityBuffer as JaxVis
from tyleri_tpu.pipeline import state as jstate
from tyleri_tpu_torch.device.builders import (
    DeviceSelectionError,
    RenderDeviceBuilder,
)
from tyleri_tpu_torch.interop import from_jax
from tyleri_tpu_torch.ops import sampling as tsampling
from tyleri_tpu_torch.ops import shade as tshade
from tyleri_tpu_torch.ops.visibility import VisibilityBuffer
from tyleri_tpu_torch.window.render_window import WindowHandle

ATOL = 1e-5
MAX_FLIPS = 0.001


def checker_arena(n=8):
    """Slot 0: an n x n stripe texture; slot 1: a 5x3 random texture."""
    yy, xx = np.mgrid[0:n, 0:n]
    c = ((xx + yy) % 2).astype(np.float32)
    t0 = np.stack([c, 1 - c, np.full_like(c, 0.5), np.ones_like(c)], -1)
    t1 = np.random.default_rng(2).random((3, 5, 4)).astype(np.float32)
    texels = np.concatenate([t0.reshape(-1, 4), t1.reshape(-1, 4)])
    offs, ws, hs = [0, n * n], [n, 5], [n, 3]
    quads = jsampling.make_texel_quads(texels, offs, ws, hs)
    return (quads, np.asarray(offs, np.int32), np.asarray(ws, np.int32),
            np.asarray(hs, np.int32))


def assert_samples_close(got, want, what):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    flips = (d.max(axis=-1) > ATOL).mean()
    print(f"{what}: max |diff| {d.max():.3g}, {flips:.4%} beyond {ATOL}")
    assert flips <= MAX_FLIPS, f"{what}: {flips:.4%} of samples"


@pytest.mark.parametrize("H,W", [(8, 12), (7, 12), (8, 11), (9, 13)])
def test_quad_derivatives_equal_jax(H, W):
    f = np.random.default_rng(H * W).random((H, W)).astype(np.float32)
    got = tsampling.quad_derivatives(torch.from_numpy(f))
    want = jsampling.quad_derivatives(jnp.asarray(f))
    for g, w in zip(got, want):
        assert g.shape == (H, W)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the quad shares one difference: pixels 0 and 1 of each row pair
    np.testing.assert_array_equal(got[0][:, 0], got[0][:, 1])


@pytest.mark.parametrize("taps", [2, 4, 16])
def test_sample_anisotropic_matches_jax(taps):
    rng = np.random.default_rng(taps)
    n = 4096
    quads, offs, ws, hs = checker_arena()
    tid = rng.integers(0, 2, n).astype(np.int32)
    u, v = (rng.uniform(-1, 2, n).astype(np.float32) for _ in range(2))
    # footprints from sub-texel to well past ``taps`` texels (clamped)
    d = [(rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 0.5, n)
          ).astype(np.float32) for _ in range(4)]
    got = tsampling.sample_anisotropic(
        *(torch.from_numpy(a) for a in (quads, offs, ws, hs, tid, u, v)),
        *(torch.from_numpy(a) for a in d), taps=taps)
    want = jsampling.sample_anisotropic(
        *(jnp.asarray(a) for a in (quads, offs, ws, hs, tid, u, v)),
        *(jnp.asarray(a) for a in d), taps=taps)
    assert_samples_close(got.numpy(), want, f"{taps} taps")


def test_shade_visibility_with_taps_matches_jax():
    """aniso_taps=8 on a visibility buffer with perspective u/w, v/w, 1/w
    maps and uncovered pixels, blended over a framebuffer."""
    rng = np.random.default_rng(8)
    H, W = 24, 33
    quads, offs, ws, hs = checker_arena()
    y, x = np.mgrid[0:H, 0:W] + 0.5
    iw = (0.5 + 0.02 * x + 0.01 * y).astype(np.float32)
    maps = dict(
        owner=np.where(rng.random((H, W)) < 0.8, 3, -1).astype(np.int32),
        depth=rng.random((H, W)).astype(np.float32),
        order=np.zeros((H, W), np.float32),
        uw=((0.07 * x - 0.02 * y) * iw).astype(np.float32),
        vw=((0.01 * x + 0.3 * y) * iw).astype(np.float32), iw=iw,
        tex=rng.integers(0, 2, (H, W)).astype(np.int32))
    dst = rng.random((H, W, 4)).astype(np.float32)
    blend = jstate.MESH_PIPELINE_STATE.blend
    want = jshade.shade_visibility(
        JaxVis(**{k: jnp.asarray(a) for k, a in maps.items()}),
        *(jnp.asarray(a) for a in (quads, offs, ws, hs)), blend,
        jnp.asarray(dst), aniso_taps=8)
    got = tshade.shade_visibility(
        VisibilityBuffer(**{k: torch.from_numpy(a) for k, a in maps.items()}),
        *(torch.from_numpy(a) for a in (quads, offs, ws, hs)),
        from_jax(blend), torch.from_numpy(dst), aniso_taps=8)
    assert_samples_close(got.numpy(), want, "shade aniso_taps=8")
    plain = tshade.shade_visibility(
        VisibilityBuffer(**{k: torch.from_numpy(a) for k, a in maps.items()}),
        *(torch.from_numpy(a) for a in (quads, offs, ws, hs)),
        from_jax(blend), torch.from_numpy(dst))
    assert (np.abs(got.numpy() - plain.numpy()) > 0.01).any()


def test_builder_defaults_mirror_reference():
    from tyleri_tpu_torch.device import builders as B

    assert B.DEFAULT_APP_NAME == "Tyleri App"          # ref: builders.rs:29
    assert B.DEFAULT_ENGINE_NAME == "Tyleri Engine"    # ref: builders.rs:30
    assert B.DEFAULT_DEPTH_FORMAT == tt.DepthFormat.D16_UNORM
    dev = RenderDeviceBuilder().device("cpu").build()
    assert dev.depth_format == tt.DepthFormat.D16_UNORM
    assert dev.sampler_anisotropy is None


def test_builder_fluent_config():
    msgs = []
    b = (RenderDeviceBuilder().device("cpu").app_name("my app")
         .engine_name("my engine").max_sampler_anisotropy(8.0)
         .depth_format(tt.DepthFormat.D32_SFLOAT).queue_pool_size(2)
         .validation_level(tt.ValidationLevel.INFO)
         .debug_callback(msgs.append))
    assert (b._app_name, b._engine_name) == ("my app", "my engine")
    dev = b.build()
    assert dev.depth_format == tt.DepthFormat.D32_SFLOAT
    assert dev.sampler_anisotropy == 8.0
    assert [m.message_id for m in msgs] == ["sampler-anisotropy"]
    assert "8 footprint taps" in msgs[0].message
    q1 = dev.present_queues.pop()
    q2 = dev.present_queues.pop()
    assert q1 is not q2
    dev.present_queues.push(q1)
    dev.present_queues.push(q2)
    assert dev.present_queues.pop() is q1     # first pushed, first out
    assert dev.present_queues.event() is None  # no stream on the CPU


def test_builder_rejects_zero_queues():
    with pytest.raises(DeviceSelectionError):
        RenderDeviceBuilder().device("cpu").queue_pool_size(0).build()


def test_window_pushes_its_queue_back_when_the_frame_raises():
    dev = RenderDeviceBuilder().device("cpu").queue_pool_size(1).build()
    win = tt.RenderWindow(dev, resolution=(16, 16), present_mode="immediate")

    def boom(*a, **k):
        raise RuntimeError("record failed")

    win.rendering_function.record = boom
    with pytest.raises(RuntimeError):
        win.render()
    q = dev.present_queues.pop()     # would block if the queue were lost
    dev.present_queues.push(q)


def test_present_to_checks_surface_support(monkeypatch):
    headless = WindowHandle()
    os_window = WindowHandle(window=7, display=1)
    RenderDeviceBuilder().device("cpu").present_to(headless).build()
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    with pytest.raises(DeviceSelectionError):
        RenderDeviceBuilder().device("cpu").present_to(os_window).build()
    with pytest.raises(DeviceSelectionError):
        RenderDeviceBuilder().device("cpu").present_to(
            WindowHandle(window=-1)).build()
    dev = RenderDeviceBuilder().device("cpu").build()
    with pytest.raises(ValueError):   # the window re-checks at creation
        tt.RenderWindow(dev, os_window, resolution=(16, 16))
    monkeypatch.setenv("DISPLAY", ":0")
    RenderDeviceBuilder().device("cpu").present_to(os_window).build()
    tt.RenderWindow(dev, os_window, resolution=(16, 16),
                    present_mode="immediate")


def test_anisotropic_sampling_filters_along_major_axis():
    """A footprint spanning several texels in u averages them; a sub-texel
    footprint reproduces bilinear (tests/test_device_and_aux.py:156)."""
    W = H = 8
    tex = np.zeros((W * H, 4), np.float32)
    tex[:, :3] = ((np.arange(W * H) % W) % 2)[:, None]
    tex[:, 3] = 1.0
    quads = torch.from_numpy(tsampling.make_texel_quads(tex, [0], [W], [H]))
    off, tw, th = (torch.tensor([a], dtype=torch.int32) for a in (0, W, H))
    tid = torch.zeros((1,), dtype=torch.int32)
    u = torch.tensor([(1 + 0.5) / W])
    v = torch.tensor([0.5])
    z = torch.zeros_like(u)
    bil = tsampling.sample_bilinear(quads, off, tw, th, tid, u, v)
    assert float(bil[0, 0]) > 0.9
    wide = tsampling.sample_anisotropic(quads, off, tw, th, tid, u, v,
                                        torch.full_like(u, 6.0 / W), z, z, z,
                                        taps=8)
    assert 0.3 < float(wide[0, 0]) < 0.7, float(wide[0, 0])
    tiny = tsampling.sample_anisotropic(
        quads, off, tw, th, tid, u, v, torch.full_like(u, 1e-5), z, z,
        torch.full_like(u, 1e-5), taps=8)
    np.testing.assert_allclose(tiny.numpy(), bil.numpy(), atol=1e-3)


@pytest.mark.parametrize("exact", [False, True])
def test_anisotropy_reaches_the_plan(exact):
    """Builder anisotropy reaches ``plan.raster.aniso_taps`` and the frame
    renders (tests/test_device_and_aux.py:194); exact mode stays bilinear;
    the taps are the rounding clamped to 2..16."""
    dev = RenderDeviceBuilder().device("cpu").max_sampler_anisotropy(
        4.0).build()
    rig = tt.scenes.config2_cube(dev, (64, 64))
    win = tt.RenderWindow(dev, resolution=(64, 64), present_mode="immediate",
                          exact=exact)
    assert win.rendering_function.plan.raster.aniso_taps == (0 if exact
                                                             else 4)
    for f in range(2):
        rig.fill(win.get_render_scene(), 0.2 * f)
        win.render()
    img = win.flush()
    assert (img[..., :3].max(axis=-1) > 0).sum() > 100
    for value, taps in ((1.0, 0), (1.4, 2), (2.6, 3), (99.0, 16)):
        d = RenderDeviceBuilder().device("cpu").max_sampler_anisotropy(
            value).build()
        rf = tt.ForwardRenderingFunction(d, tt.ImageViewSwapchain((8, 8)))
        assert rf.plan.raster.aniso_taps == taps


def test_raster_plan_carries_exact_and_taps_from_jax():
    from tyleri_tpu.rendering.passes import RasterPlan as JaxPlan
    from tyleri_tpu_torch.interop import raster_plan_from_jax

    plan = raster_plan_from_jax(JaxPlan(fb_w=32, fb_h=16, exact=True,
                                        aniso_taps=6))
    assert (plan.exact, plan.aniso_taps) == (True, 6)
    assert dataclasses.replace(plan, exact=False).exact is False
