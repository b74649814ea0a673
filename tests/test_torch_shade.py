"""The port's per-pixel stages — sampling, blending, the deferred shade, the
presentation quantize and depth quantization — against the JAX package on
the same numpy inputs.

Integer work (mirrored-repeat addressing, the texel-quad table, u8
rounding, D16 rounding) must be equal.  Float work differs only where XLA
on the CPU contracts ``a * b + c`` into a fused multiply-add and PyTorch
does not: colors within 2e-6 (a few ulp of values in [0, 1]).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tyleri_tpu.ops import blend as jblend
from tyleri_tpu.ops import depth as jdepth
from tyleri_tpu.ops import sampling as jsampling
from tyleri_tpu.ops import shade as jshade
from tyleri_tpu.ops.visibility import VisibilityBuffer as JaxVis
from tyleri_tpu.pipeline.state import (
    MESH_PIPELINE_STATE,
    UI_PIPELINE_STATE,
    BlendFactor,
    BlendOp,
    BlendState,
    DepthFormat,
)
from tyleri_tpu.rendering.forward import quantize_unorm8 as jquantize
from tyleri_tpu_torch.interop import from_jax
from tyleri_tpu_torch.ops import blend as tblend
from tyleri_tpu_torch.ops import depth as tdepth
from tyleri_tpu_torch.ops import sampling as tsampling
from tyleri_tpu_torch.ops import shade as tshade
from tyleri_tpu_torch.ops.visibility import VisibilityBuffer
from tyleri_tpu_torch.rendering.forward import quantize_unorm8 as tquantize

FLOAT_TOL = 2e-6


def arena(rng):
    """Two textures (5x3 and 4x4) in one texel arena."""
    texels = rng.random((15 + 16, 4)).astype(np.float32)
    return texels, [0, 15], [5, 4], [3, 4]


def test_texel_quads_and_mirror_repeat_equal_jax():
    texels, offs, ws, hs = arena(np.random.default_rng(1))
    np.testing.assert_array_equal(
        tsampling.make_texel_quads(texels, offs, ws, hs),
        jsampling.make_texel_quads(texels, offs, ws, hs))
    i = np.arange(-40, 41, dtype=np.int32)
    for n in (1, 3, 4):
        np.testing.assert_array_equal(
            tsampling.mirror_repeat(torch.from_numpy(i), n).numpy(),
            np.asarray(jsampling.mirror_repeat(jnp.asarray(i), n)))


def test_sample_bilinear_matches_jax():
    rng = np.random.default_rng(2)
    texels, offs, ws, hs = arena(rng)
    quads = tsampling.make_texel_quads(texels, offs, ws, hs)
    meta = [np.asarray(a, np.int32) for a in (offs, ws, hs)]
    tex = rng.integers(0, 2, (64, 48)).astype(np.int32)
    u = rng.uniform(-2.5, 3.5, (64, 48)).astype(np.float32)  # mirrored
    v = rng.uniform(-2.5, 3.5, (64, 48)).astype(np.float32)
    want = jsampling.sample_bilinear(jnp.asarray(quads),
                                     *map(jnp.asarray, meta),
                                     jnp.asarray(tex), jnp.asarray(u),
                                     jnp.asarray(v))
    got = tsampling.sample_bilinear(torch.from_numpy(quads),
                                    *map(torch.from_numpy, meta),
                                    torch.from_numpy(tex), torch.from_numpy(u),
                                    torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FLOAT_TOL)


BLENDS = {
    "mesh": MESH_PIPELINE_STATE.blend,
    "ui": UI_PIPELINE_STATE.blend,
    "off": BlendState(enable=False),
    "dst_alpha_sub": BlendState(
        enable=True, src_color=BlendFactor.DST_ALPHA,
        dst_color=BlendFactor.ONE_MINUS_SRC_ALPHA, color_op=BlendOp.SUBTRACT,
        src_alpha=BlendFactor.ONE, dst_alpha=BlendFactor.DST_COLOR,
        alpha_op=BlendOp.REVERSE_SUBTRACT),
    "min_max_masked": BlendState(
        enable=True, color_op=BlendOp.MIN, alpha_op=BlendOp.MAX,
        write_mask=(True, False, True, False)),
}


@pytest.mark.parametrize("name", sorted(BLENDS))
def test_apply_blend_matches_jax(name):
    rng = np.random.default_rng(3)
    src = rng.random((32, 32, 4)).astype(np.float32)
    dst = rng.random((32, 32, 4)).astype(np.float32)
    state = BLENDS[name]
    want = jblend.apply_blend(state, jnp.asarray(src), jnp.asarray(dst))
    got = tblend.apply_blend(from_jax(state), torch.from_numpy(src),
                             torch.from_numpy(dst))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FLOAT_TOL)


def test_shade_visibility_matches_jax():
    rng = np.random.default_rng(4)
    texels, offs, ws, hs = arena(rng)
    quads = tsampling.make_texel_quads(texels, offs, ws, hs)
    meta = [np.asarray(a, np.int32) for a in (offs, ws, hs)]
    H, W = 40, 56
    owner = np.where(rng.random((H, W)) < 0.7,
                     rng.integers(0, 100, (H, W)), -1).astype(np.int32)
    iw = rng.uniform(0.2, 2.0, (H, W)).astype(np.float32)
    iw[0, :5] = 0.0                                   # guarded division
    maps = dict(owner=owner, depth=rng.random((H, W)).astype(np.float32),
                order=rng.random((H, W)).astype(np.float32),
                uw=(rng.uniform(-1, 2, (H, W)) * iw).astype(np.float32),
                vw=(rng.uniform(-1, 2, (H, W)) * iw).astype(np.float32),
                iw=iw, tex=rng.integers(0, 2, (H, W)).astype(np.int32))
    dst = rng.random((H, W, 4)).astype(np.float32)
    want = jshade.shade_visibility(
        JaxVis(**{k: jnp.asarray(v) for k, v in maps.items()}),
        jnp.asarray(quads), *map(jnp.asarray, meta),
        MESH_PIPELINE_STATE.blend, jnp.asarray(dst))
    got = tshade.shade_visibility(
        VisibilityBuffer(**{k: torch.from_numpy(v) for k, v in maps.items()}),
        torch.from_numpy(quads), *map(torch.from_numpy, meta),
        from_jax(MESH_PIPELINE_STATE.blend), torch.from_numpy(dst))
    np.testing.assert_array_equal(got.numpy()[owner < 0], dst[owner < 0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FLOAT_TOL)


@pytest.mark.parametrize("opaque", [True, False])
def test_quantize_unorm8_equals_jax(opaque):
    rng = np.random.default_rng(5)
    c = rng.uniform(-0.1, 1.1, (16, 16, 4)).astype(np.float32)
    c[0, :4] = np.asarray([0.5, 1.5, 2.5, 254.5], np.float32)[:, None] / 255
    np.testing.assert_array_equal(
        tquantize(torch.from_numpy(c), opaque).numpy(),
        np.asarray(jquantize(jnp.asarray(c), opaque)))


@pytest.mark.parametrize("fmt", [DepthFormat.D16_UNORM,
                                 DepthFormat.D32_SFLOAT])
def test_quantize_depth_equals_jax(fmt):
    z = np.concatenate([np.arange(65536) / 65535.0,
                        np.random.default_rng(6).uniform(-0.2, 1.2, 20000)]
                       ).astype(np.float32)
    np.testing.assert_array_equal(
        tdepth.quantize_depth(torch.from_numpy(z),
                              from_jax(fmt)).numpy(),
        np.asarray(jdepth.quantize_depth(jnp.asarray(z), fmt)))


LIT_TOL = 2e-5   # f32 sums of three products and a pow(x, 32): ~100 ulp


def lit_inputs(rng, H=24, W=40):
    """A lit pixel set: normals (some zero), world positions, the
    DirectionalLight row, an eye, a perspective view-projection."""
    from tyleri_tpu.scene.light import DirectionalLight
    from tyleri_tpu.utils import math3d

    n = rng.normal(size=(H, W, 3)).astype(np.float32)
    n[0, :4] = 0.0
    p = rng.uniform(-2, 2, (H, W, 3)).astype(np.float32)
    light = DirectionalLight(direction=(0.3, -1.0, -0.5)).as_array()
    eye = np.asarray([0.5, 1.0, 3.0], np.float32)
    vp = (np.asarray(math3d.perspective_rh(np.radians(50.0), W / H, 0.1,
                                           50.0), np.float64)
          @ np.asarray(math3d.look_at_rh(eye, [0, 0, 0], [0, 1, 0]),
                       np.float64))
    inv_vp = np.linalg.inv(vp).astype(np.float32)
    return n, p, light, eye, inv_vp


def test_blinn_phong_matches_jax():
    rng = np.random.default_rng(8)
    n, p, light, eye, _ = lit_inputs(rng)
    tex = rng.random(n.shape[:2] + (4,)).astype(np.float32)
    want = jshade.blinn_phong(jnp.asarray(tex), jnp.asarray(n),
                              jnp.asarray(p), jnp.asarray(light),
                              jnp.asarray(eye))
    got = tshade.blinn_phong(torch.from_numpy(tex), torch.from_numpy(n),
                             torch.from_numpy(p), light, eye)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LIT_TOL)
    # zero normals shade ambient only, alpha passes through
    amb = tex[0, :4, :3] * light[6]
    np.testing.assert_allclose(got.numpy()[0, :4, :3], amb, atol=1e-6)
    np.testing.assert_array_equal(got.numpy()[..., 3], tex[..., 3])


def test_unproject_window_matches_jax():
    rng = np.random.default_rng(9)
    _, _, _, _, inv_vp = lit_inputs(rng)
    H, W = 24, 40
    depth = rng.uniform(0.2, 1.0, (H, W)).astype(np.float32)
    viewport = np.asarray([3, 2, W - 6, H - 4, 0.1, 0.9], np.float32)
    want = jshade.unproject_window(None, jnp.asarray(depth),
                                   jnp.asarray(viewport), jnp.asarray(inv_vp),
                                   W, H)
    got = tshade.unproject_window(None, torch.from_numpy(depth), viewport,
                                  inv_vp, W, H)
    want = np.asarray(want)
    # a perspective divide of sums of four products: relative to the
    # position's size
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_lit_shade_visibility_matches_jax():
    """The lit branch: the winner's normal/w planes by owner id (broad
    owners after the entry rows), the unprojected position, Blinn-Phong,
    the blend; pixels without an owner keep the framebuffer."""
    rng = np.random.default_rng(10)
    texels, offs, ws, hs = arena(rng)
    quads = tsampling.make_texel_quads(texels, offs, ws, hs)
    meta = [np.asarray(a, np.int32) for a in (offs, ws, hs)]
    _, _, light, eye, inv_vp = lit_inputs(rng)
    H, W = 24, 40
    E, B = 90, 10
    owner = np.where(rng.random((H, W)) < 0.7,
                     rng.integers(0, E + B, (H, W)), -1).astype(np.int32)
    iw = rng.uniform(0.2, 2.0, (H, W)).astype(np.float32)
    maps = dict(owner=owner, depth=rng.uniform(0.3, 1, (H, W)).astype(
        np.float32), order=rng.random((H, W)).astype(np.float32),
                uw=(rng.uniform(-1, 2, (H, W)) * iw).astype(np.float32),
                vw=(rng.uniform(-1, 2, (H, W)) * iw).astype(np.float32),
                iw=iw, tex=rng.integers(0, 2, (H, W)).astype(np.int32))
    planes = (rng.normal(size=(E + B, 12)) * ([0.02, 0.02, 1] * 4)).astype(
        np.float32)
    viewport = np.asarray([0, 0, W, H, 0, 1], np.float32)
    dst = rng.random((H, W, 4)).astype(np.float32)
    want = jshade.shade_visibility(
        JaxVis(**{k: jnp.asarray(v) for k, v in maps.items()}),
        jnp.asarray(quads), *map(jnp.asarray, meta),
        MESH_PIPELINE_STATE.blend, jnp.asarray(dst),
        lit=(jnp.asarray(planes), jnp.asarray(light), jnp.asarray(inv_vp),
             jnp.asarray(eye), jnp.asarray(viewport)))
    got = tshade.shade_visibility(
        VisibilityBuffer(**{k: torch.from_numpy(v) for k, v in maps.items()}),
        torch.from_numpy(quads), *map(torch.from_numpy, meta),
        from_jax(MESH_PIPELINE_STATE.blend), torch.from_numpy(dst),
        lit=(torch.from_numpy(planes), light, inv_vp, eye, viewport))
    np.testing.assert_array_equal(got.numpy()[owner < 0], dst[owner < 0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LIT_TOL)
    unlit = tshade.shade_visibility(
        VisibilityBuffer(**{k: torch.from_numpy(v) for k, v in maps.items()}),
        torch.from_numpy(quads), *map(torch.from_numpy, meta),
        from_jax(MESH_PIPELINE_STATE.blend), torch.from_numpy(dst))
    assert np.abs(unlit.numpy() - got.numpy()).max() > 0.05
