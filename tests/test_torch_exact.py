"""The port's exact rasterizer (ops/raster_exact.py) against the JAX
package's ``rasterize_exact`` on the same inputs, on the CPU.

Each case draws seeded triangles over a framebuffer that already holds
color and D16-grid depth, so every compare op and the blend see prior
content.  The cases cover the raster window (0, the full framebuffer; 64
and 256, with triangles that span several windows and windows clamped at
the framebuffer's edge), vertex colors, D16 and D32, every CompareOp, the
blend on and off, and a 1x1 (solid) and an 8x8 texture.

Tolerances: XLA on the CPU contracts ``a * b + c`` into fused multiply-adds
and PyTorch does not, so an edge or a depth tie can fall the other way on a
few pixels.  At most 0.5 % of pixels (the golden budget,
tests/test_raster_golden.py:108) may differ in color by more than 2e-3 or
in depth by more than 1 ulp (D16) or 2^-16, a quarter of a D16 step (D32:
under perspective the z plane's terms reach tens, and a contracted sum
rounds by an ulp of its largest term).  Triangles' corner depths are snapped to n/64, where the D16
division of the source (ops/depth.py) and the reciprocal multiplication
XLA compiles it into round alike; ``test_exact_d16_rounds_by_division``
pins the division where they do not (ROADMAP R6).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tyleri_tpu.ops.raster_exact import rasterize_exact as jax_exact
from tyleri_tpu.pipeline import state as jstate
from tyleri_tpu_torch.interop import from_jax
from tyleri_tpu_torch.ops import setup as tsetup
from tyleri_tpu_torch.ops.raster_exact import rasterize_exact
from tyleri_tpu_torch.ops.sampling import make_texel_quads

BUDGET = 0.005
CO = jstate.CompareOp


def arena():
    """Slot 0: a 1x1 texture; slot 1: an 8x8 checker."""
    yy, xx = np.mgrid[0:8, 0:8]
    c = ((xx + yy) % 2).astype(np.float32)
    checker = np.stack([c, 1 - c, np.full_like(c, 0.5), np.ones_like(c)], -1)
    solid = np.asarray([[0.8, 0.4, 0.2, 0.6]], np.float32)
    texels = np.concatenate([solid, checker.reshape(-1, 4)])
    return make_texel_quads(texels, [0, 1], [1, 8], [1, 8]), \
        np.asarray([0, 1], np.int32), np.asarray([1, 8], np.int32), \
        np.asarray([1, 8], np.int32)


def scene(rng, T, W, H, big):
    """T triangles in clip space: corners anywhere over the framebuffer
    (``big`` ones span most of it), z snapped to n/64, w = 1 for some and
    random for the others (perspective-correct attributes)."""
    span = 1.6 if big else 0.5
    ctr = rng.uniform(-1.1, 1.1, (T, 1, 2))
    xy = ctr + rng.uniform(-span, span, (T, 3, 2))
    z = rng.integers(4, 60, (T, 3)) / 64.0
    z[: T // 2] = z[: T // 2, :1]                       # flat for ties
    w = np.where(rng.random((T, 1)) < 0.5, 1.0,
                 rng.uniform(0.5, 2.0, (T, 3)))
    clip = np.concatenate([xy * w[..., None], (z * w)[..., None],
                           np.broadcast_to(w, (T, 3))[..., None]], -1)
    uv = rng.uniform(-0.5, 1.5, (T, 3, 2))
    vcol = rng.uniform(0.2, 1.0, (T, 3, 4))
    return (clip.astype(np.float32), uv.astype(np.float32),
            vcol.astype(np.float32))


# name: (window, (W, H), vertex color, format, compare op, blend, texture)
CASES = {
    "w0_le_d16_blend_8x8": (0, (64, 48), False, "D16_UNORM",
                            "LESS_OR_EQUAL", True, 1),
    "w0_less_d32_noblend_1x1_vc": (0, (64, 48), True, "D32_SFLOAT", "LESS",
                                   False, 0),
    "w0_greater_d16_blend_1x1": (0, (48, 40), False, "D16_UNORM", "GREATER",
                                 True, 0),
    "w0_gequal_d32_blend_8x8_vc": (0, (48, 40), True, "D32_SFLOAT",
                                   "GREATER_OR_EQUAL", True, 1),
    "w0_equal_d16_noblend_8x8": (0, (48, 40), False, "D16_UNORM", "EQUAL",
                                 False, 1),
    "w0_notequal_d16_blend_1x1_vc": (0, (48, 40), True, "D16_UNORM",
                                     "NOT_EQUAL", True, 0),
    "w0_always_d32_blend_8x8": (0, (48, 40), False, "D32_SFLOAT", "ALWAYS",
                                True, 1),
    "w0_never_d16_blend_8x8": (0, (48, 40), False, "D16_UNORM", "NEVER",
                               True, 1),
    "w64_le_d16_blend_1x1_vc": (64, (200, 136), True, "D16_UNORM",
                                "LESS_OR_EQUAL", True, 0),
    "w64_greater_d32_noblend_8x8": (64, (200, 136), False, "D32_SFLOAT",
                                    "GREATER", False, 1),
    "w256_le_d16_blend_8x8_vc": (256, (320, 288), True, "D16_UNORM",
                                 "LESS_OR_EQUAL", True, 1),
}


def run_both(case, T=14, seed=5, scissor=None, test_enable=True,
             write_enable=True, window=None):
    """The case through both rasterizers; ``window`` overrides the case's
    raster window on the same scene."""
    case_window, (W, H), vc, fmt, op, blend, tex = CASES[case]
    window = case_window if window is None else window
    rng = np.random.default_rng(seed)
    clip, uv, vcol = scene(rng, T, W, H, big=case_window > 0)
    blend_state = (jstate.MESH_PIPELINE_STATE.blend if blend
                   else jstate.BlendState(enable=False))
    st = dataclasses.replace(
        jstate.MESH_PIPELINE_STATE, blend=blend_state,
        depth=jstate.DepthState(test_enable=test_enable,
                                write_enable=write_enable,
                                compare_op=CO[op],
                                format=jstate.DepthFormat[fmt]))
    color0 = rng.random((H, W, 4)).astype(np.float32)
    # prior depth: the flat triangles' depths (ties), other n/64 and clear
    pick = rng.random((H, W))
    depth0 = np.where(pick < 0.5, rng.choice(clip[: T // 2, 0, 2]
                                             / clip[: T // 2, 0, 3], (H, W)),
                      rng.integers(4, 60, (H, W)) / 64.0)
    depth0 = np.where(pick > 0.8, 1.0, depth0).astype(np.float32)
    if fmt == "D16_UNORM":
        depth0 = (np.round(depth0 * 65535.0) / 65535.0).astype(np.float32)
    tex_id = np.full((T,), tex, np.int32)
    valid = rng.random(T) < 0.9
    vp = np.asarray([0, 0, W, H, 0, 1], np.float32)
    sc = np.asarray(scissor or (0, 0, W, H), np.int32)
    texels, toff, tw, th = arena()
    vc_kw = dict(with_vertex_color=True) if vc else {}
    want_c, want_d = jax_exact(
        jnp.asarray(color0), jnp.asarray(depth0), jnp.asarray(clip),
        jnp.asarray(uv), jnp.asarray(tex_id), jnp.asarray(valid),
        jnp.asarray(vp), jnp.asarray(sc), jnp.asarray(texels),
        jnp.asarray(toff), jnp.asarray(tw), jnp.asarray(th), state=st,
        vertex_color=jnp.asarray(vcol) if vc else None, window=window,
        **vc_kw)
    t = torch.from_numpy
    got_c, got_d = rasterize_exact(
        t(color0), t(depth0), t(clip), t(uv), t(tex_id), t(valid), vp, sc,
        t(texels), t(toff), t(tw), t(th), state=from_jax(st),
        vertex_color=t(vcol) if vc else None, window=window, **vc_kw)
    return (got_c.numpy(), got_d.numpy(), np.asarray(want_c),
            np.asarray(want_d), color0, depth0)


def assert_close(got_c, got_d, want_c, want_d, name):
    bad_c = (np.abs(got_c - want_c).max(axis=-1) > 2e-3).mean()
    tol = (2.0 ** -16 if "d32" in name else
           np.spacing(np.maximum(np.abs(want_d), 1e-30).astype(np.float32)))
    bad_d = (np.abs(got_d - want_d) > tol).mean()
    print(f"{name}: {bad_c:.4%} px differ in color, {bad_d:.4%} in depth")
    assert bad_c <= BUDGET, f"{name}: color {bad_c:.4%}"
    assert bad_d <= BUDGET, f"{name}: depth {bad_d:.4%}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_exact_matches_jax(case):
    # the 256-px windows cost the reference's loop the most: fewer triangles
    got_c, got_d, want_c, want_d, color0, depth0 = run_both(
        case, T=8 if case.startswith("w256") else 14)
    assert_close(got_c, got_d, want_c, want_d, case)
    drew = (np.abs(want_c - color0).max(axis=-1) > 0).mean()
    if "never" in case:
        assert drew == 0 and (got_c == color0).all()
    else:
        assert drew > 0.002, f"{case}: the triangles drew {drew:.2%}"


def test_exact_windows_cover_the_box_once():
    """Window 64 with triangles spanning several windows and windows
    clamped at the edge: every fragment blends once (a double blend would
    move the blended color), and the windowed path equals window 0 over
    the same framebuffer."""
    window_case = "w64_le_d16_blend_1x1_vc"
    got_c, got_d, want_c, want_d, _, _ = run_both(window_case, T=6, seed=9)
    assert_close(got_c, got_d, want_c, want_d, window_case)
    W, H = CASES[window_case][1]
    rng = np.random.default_rng(9)
    clip, _, _ = scene(rng, 6, W, H, big=True)
    su = tsetup.setup_triangles(
        torch.from_numpy(clip), torch.zeros((6, 3, 2)),
        torch.zeros(6, dtype=torch.int32), torch.ones(6, dtype=torch.bool),
        np.asarray([0, 0, W, H, 0, 1], np.float32), (0, 0, W, H),
        tile_w=1, tile_h=1, grid_w=W, grid_h=H)
    width = (su.tile_hi - su.tile_lo)[su.valid]
    assert int(width.max()) >= 64          # spans several windows
    assert int(su.tile_hi[su.valid][:, 0].max()) >= W - 64 + 1  # edge clamp
    f_c, f_d, _, _, _, _ = run_both(window_case, T=6, seed=9, window=0)
    np.testing.assert_array_equal(got_c, f_c)
    np.testing.assert_array_equal(got_d, f_d)


@pytest.mark.parametrize("test_enable,write_enable",
                         [(False, True), (True, False)])
def test_exact_depth_test_and_write_switches(test_enable, write_enable):
    case = "w0_le_d16_blend_8x8"
    got_c, got_d, want_c, want_d, _, depth0 = run_both(
        case, scissor=(5, 7, 40, 30), test_enable=test_enable,
        write_enable=write_enable)
    assert_close(got_c, got_d, want_c, want_d, case)
    if not write_enable:
        np.testing.assert_array_equal(got_d, depth0)


def test_exact_d16_rounds_by_division():
    """R6: exact mode quantizes D16 as ops/depth.py does,
    round(z * 65535) / 65535; K3 multiplies by the f32 reciprocal.  A
    full-screen quad at a depth whose two roundings differ writes the
    division's value."""
    inv = np.float32(1.0) / np.float32(65535.0)
    ks = np.arange(1, 65535)
    div = ks.astype(np.float32) / np.float32(65535.0)
    differs = ks[div != ks.astype(np.float32) * inv]
    k = int(differs[len(differs) // 2])
    z = np.float32(k) / np.float32(65535.0)
    clip = np.asarray([[[-1, -1, z, 1], [3, -1, z, 1], [-1, 3, z, 1]]],
                      np.float32)
    W = H = 16
    texels, toff, tw, th = arena()
    st = from_jax(jstate.MESH_PIPELINE_STATE)
    _, depth = rasterize_exact(
        torch.zeros((H, W, 4)), torch.ones((H, W)), torch.from_numpy(clip),
        torch.zeros((1, 3, 2)), torch.zeros(1, dtype=torch.int32),
        torch.ones(1, dtype=torch.bool),
        np.asarray([0, 0, W, H, 0, 1], np.float32), (0, 0, W, H),
        torch.from_numpy(texels), torch.from_numpy(toff),
        torch.from_numpy(tw), torch.from_numpy(th), state=st)
    want = np.float32(k) / np.float32(65535.0)
    assert want != np.float32(k) * inv
    np.testing.assert_array_equal(depth.numpy(), np.full((H, W), want))
