"""The depth states K3 does not take, on the CPU: the port's last-passing
resolve (ops/visibility.py::rasterize_visibility_last_passing) against the
JAX package's XLA ``rasterize_visibility`` on the same binned tables, the
routing of the mesh pass, and frames through the port's RenderWindow
against the numpy oracle.

Under ALWAYS, NEVER, the test off or the write off the reference lets the
last drawn passing fragment own the pixel (tyleri_tpu/ops/visibility.py:
194-207).  The scenes are grid-snapped (tests/test_torch_visibility.py), so
coverage and D16 depths are exact whatever the evaluation order: owner
validity, depth (D16), draw order and texture slot must be equal; D32
depths and the u/w, v/w, 1/w maps agree to 2 ulp of the sum of their
plane's terms (XLA contracts ``a * x + b`` and PyTorch does not).  Owner
ids index the entry table and are not compared (ROADMAP, "What parity
compares").
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tyleri_tpu_torch as tt
from test_torch_visibility import (
    FB_H,
    FB_W,
    GRID,
    TILE_H,
    TILE_W,
    binned_table,
    snapped_scene,
    to_torch,
)
from tyleri_tpu.ops import visibility as jvis
from tyleri_tpu.pipeline.state import CompareOp, DepthFormat, DepthState
from tyleri_tpu_torch.interop import from_jax
from tyleri_tpu_torch.ops import setup as tsetup
from tyleri_tpu_torch.ops.visibility import (
    k3_supports,
    rasterize_visibility_last_passing,
)
from tyleri_tpu_torch.testing.scene_oracle import (
    mismatch_fraction,
    scene_oracle_u8,
)

# name: (test_enable, write_enable, compare op)
STATES = {
    "always": (True, True, CompareOp.ALWAYS),
    "never": (True, True, CompareOp.NEVER),
    "test_off_write_on": (False, True, CompareOp.LESS_OR_EQUAL),
    "test_off_write_off": (False, False, CompareOp.LESS_OR_EQUAL),
    "write_off_less": (True, False, CompareOp.LESS),
    "write_off_le": (True, False, CompareOp.LESS_OR_EQUAL),
}
FORMATS = {"d16": DepthFormat.D16_UNORM, "d32": DepthFormat.D32_SFLOAT}


def resolve_both(state, fmt, seed=31):
    test, write, op = STATES[state]
    ds = DepthState(test_enable=test, write_enable=write, compare_op=op,
                    format=FORMATS[fmt])
    rng = np.random.default_rng(seed)
    clip, uv, tex = snapped_scene(rng)
    scissor = np.asarray((0, 0, FB_W, FB_H), np.int32)
    binned = binned_table(clip, uv, tex, scissor)
    # prior content on the D16 grid (the triangles' depths are n/64)
    depth0 = (rng.integers(0, 64, (FB_H, FB_W)) * 1024 / 65535.0
              ).astype(np.float32)
    kw = dict(fb_w=FB_W, fb_h=FB_H, tile_w=TILE_W, tile_h=TILE_H, **GRID)
    want, overflow = jvis.rasterize_visibility(
        binned, jnp.asarray(depth0), jnp.asarray(scissor), cap_per_tile=256,
        chunk=32, depth_state=ds, **kw)
    assert int(overflow) == 0 and int(binned.overflow) == 0
    tb = to_torch(binned)
    got = rasterize_visibility_last_passing(
        tb, torch.from_numpy(depth0), scissor, depth_state=from_jax(ds), **kw)
    return got, want, tb, depth0


def plane_tol(binned, owner, row):
    """2 ulp of the sum of the winner's plane terms at each pixel."""
    ch = torch.cat([binned.entry_channels, binned.broad_channels]).numpy()
    ch = ch[np.maximum(owner, 0)].astype(np.float64)
    y, x = np.mgrid[0:FB_H, 0:FB_W] + 0.5
    terms = (np.abs(ch[..., row]) * x + np.abs(ch[..., row + 1]) * y
             + np.abs(ch[..., row + 2]))
    return np.where(owner >= 0, 2 * 2.0 ** -23 * terms, 0.0)


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("state", sorted(STATES))
def test_last_passing_matches_jax_xla(state, fmt):
    got, want, binned, depth0 = resolve_both(state, fmt)
    owner = got.owner.numpy()
    won = owner >= 0
    np.testing.assert_array_equal(won, np.asarray(want.owner) >= 0)
    if state == "never":
        assert not won.any()
    else:
        assert won.mean() > 0.2, won.mean()
    np.testing.assert_array_equal(got.order.numpy(), np.asarray(want.order))
    np.testing.assert_array_equal(got.tex.numpy(), np.asarray(want.tex))
    gd, wd = got.depth.numpy(), np.asarray(want.depth)
    if fmt == "d16" or not STATES[state][1]:
        np.testing.assert_array_equal(gd, wd)
    else:
        assert (np.abs(gd - wd) <= plane_tol(binned, owner, tsetup.CH_Z)).all()
    if not STATES[state][1]:
        np.testing.assert_array_equal(gd, depth0)   # the write is off
    for m, row in (("uw", tsetup.CH_UW), ("vw", tsetup.CH_VW),
                   ("iw", tsetup.CH_INVW)):
        g, w = getattr(got, m).numpy(), np.asarray(getattr(want, m))
        assert (np.abs(g - w) <= plane_tol(binned, owner, row)).all(), m


def test_last_passing_refuses_the_other_compare_ops_and_k3_states():
    """GREATER (and every op but LESS, LESS_OR_EQUAL, ALWAYS and NEVER)
    raises on the visibility path, as tyleri_tpu/ops/visibility.py:158-162
    does; the states K3 takes are K3's."""
    rng = np.random.default_rng(31)
    scissor = np.asarray((0, 0, FB_W, FB_H), np.int32)
    binned = to_torch(binned_table(*snapped_scene(rng), scissor))
    kw = dict(fb_w=FB_W, fb_h=FB_H, tile_w=TILE_W, tile_h=TILE_H, **GRID)
    for op in (CompareOp.GREATER, CompareOp.EQUAL, CompareOp.NOT_EQUAL,
               CompareOp.GREATER_OR_EQUAL):
        ds = from_jax(DepthState(compare_op=op, write_enable=False))
        with pytest.raises(NotImplementedError):
            rasterize_visibility_last_passing(
                binned, torch.ones((FB_H, FB_W)), scissor, depth_state=ds,
                **kw)
        # with the test off, the compare op plays no part
        rasterize_visibility_last_passing(
            binned, torch.ones((FB_H, FB_W)), scissor,
            depth_state=dataclasses.replace(ds, test_enable=False), **kw)
    k3_state = from_jax(DepthState())
    assert k3_supports(k3_state)
    with pytest.raises(ValueError):
        rasterize_visibility_last_passing(
            binned, torch.ones((FB_H, FB_W)), scissor, depth_state=k3_state,
            **kw)


FRAME_STATES = ("always", "never", "test_off_write_on", "write_off_le")


@pytest.mark.parametrize("state", FRAME_STATES)
def test_frame_under_depth_state_matches_oracle(state):
    """Config 2 through the port's RenderWindow under a state K3 does not
    take: the last-passing resolve, no peel2, one "k3-envelope" message;
    within the golden budget of the oracle, which blends the surviving
    fragment once (the visibility path's rule)."""
    test, write, op = STATES[state]
    res = (96, 72)
    msgs = []
    dev = tt.RenderDeviceBuilder().device("cpu").validation_level(
        tt.ValidationLevel.WARNING).debug_callback(
            lambda m: msgs.append(m.message_id)).build()
    rig = tt.scenes.config2_cube(dev, res)
    win = tt.RenderWindow(dev, resolution=res, present_mode="immediate")
    rf = win.rendering_function
    rf.mesh_state = dataclasses.replace(rf.mesh_state, depth=dataclasses.replace(
        rf.mesh_state.depth, test_enable=test, write_enable=write,
        compare_op=from_jax(op)))
    for _ in range(2):
        rig.fill(win.get_render_scene(), 0.9)
        win.render()
    img = win.flush()
    assert not rf.plan.raster.peel2
    assert msgs.count("k3-envelope") == 1
    scene = tt.RenderScene()
    rig.fill(scene, 0.9)
    want = scene_oracle_u8(dev, scene.render_resources, rf.mesh_state, res)
    bad = mismatch_fraction(img, want)
    print(f"{state}: {bad:.4%} px differ from the oracle")
    assert bad <= 0.005
    covered = (img[..., :3] > 0).any(axis=-1).mean()
    assert covered == 0 if state == "never" else covered > 0.1
