"""The port's triangle setup (tyleri_tpu_torch.ops.setup, .clip, .setup_cuda
and rendering.passes._fused_clip_subset) against the JAX package on the
same numpy inputs.

Tolerances.  XLA on the CPU contracts ``a * b + c`` into a fused
multiply-add; eager PyTorch rounds the product and the sum separately.  The
two packages therefore cannot agree bit for bit here, only to rounding:

* float plane channels: the error of each plane, evaluated over the
  framebuffer plus its one-tile border (|dA|*W + |dB|*H + |dC|), within
  1e-5 of the plane's magnitude over the same domain;
* valid, the tile bbox and the exact-integer channels (CH_ZMIN, CH_META,
  CH_ORDER) equal.

At least 99.5 % of rows must meet both.  A row misses only where a
rounding difference moves a value across a decision boundary (a floor, a
compare) or is amplified by a nearly degenerate triangle (a thin sliver's
planes scale with 1/area); the test prints how many rows did, and holds
every row that both sides keep to 1e-3 all the same.

On the card, the CUDA kernel (built with -fmad=false) is bit-equal to the
plain version: tests/test_torch_kernels.py checks that.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tyleri_tpu.ops import clip as jclip
from tyleri_tpu.ops import setup as jsetup
from tyleri_tpu.ops import setup_pallas as jpallas
from tyleri_tpu.pipeline.state import MESH_PIPELINE_STATE
from tyleri_tpu.rendering import passes as jpasses
from tyleri_tpu_torch.interop import from_jax
from tyleri_tpu_torch.ops import clip as tclip
from tyleri_tpu_torch.ops import setup as tsetup
from tyleri_tpu_torch.ops import setup_cuda
from tyleri_tpu_torch.rendering import passes as tpasses

FB_W, FB_H = 256, 128
TILE_W, TILE_H = 64, 16
DIMS = dict(tile_w=TILE_W, tile_h=TILE_H, grid_w=FB_W // TILE_W,
            grid_h=FB_H // TILE_H)
VIEWPORT = np.asarray([0, 0, FB_W, FB_H, 0, 1], np.float32)
SCISSOR = np.asarray([0, 0, FB_W, FB_H], np.int32)
PLANES = (tsetup.CH_E0, tsetup.CH_E1, tsetup.CH_Z, tsetup.CH_INVW,
          tsetup.CH_UW, tsetup.CH_VW)
EXACT = (tsetup.CH_ZMIN, tsetup.CH_META, tsetup.CH_ORDER)
RTOL = 1e-5
MAX_ROW_MISMATCH = 0.005


def rand_scene(rng, T, D, behind_frac=0.0):
    """tests/test_setup_pallas.py's generator (copied): random corners
    (off-screen and back-facing ones among them), some fully behind the
    near plane, some crossing it; plus degenerate (zero-area) rows."""
    corner = rng.uniform(-1.5, 1.5, (T, 3, 5)).astype(np.float32)
    corner[..., 2] = rng.uniform(-0.5, 3.0, (T, 3))  # z spread
    if behind_frac:
        k = int(T * behind_frac)
        corner[:k, :, 2] = rng.uniform(-4.0, -2.5, (k, 3))  # fully behind
        corner[k:2 * k, 0, 2] = -3.0                        # crossing
    corner[-10:, 1] = corner[-10:, 0]                       # degenerate
    draw = rng.integers(0, D, T).astype(np.int32)
    tex = rng.integers(0, 3, T).astype(np.int32)
    valid = rng.random(T) > 0.15
    mvps = np.stack([
        np.asarray(np.eye(4), np.float32) + 0.01 * d for d in range(D)
    ])
    # a mildly perspective-ish matrix so w varies
    for d in range(D):
        mvps[d][3, 2] = -0.4
        mvps[d][3, 3] = 2.0
    return corner, draw, tex, valid, mvps


def t(a):
    return torch.from_numpy(np.array(a))


def np_of(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def port_channels(ch) -> torch.Tensor:
    """A JAX package table's channels in the port's encoding: each CH_ORDER
    value as its int32 bit pattern (setup.encode_order)."""
    out = torch.from_numpy(np.array(ch))
    out[..., tsetup.CH_ORDER] = tsetup.encode_order(out[..., tsetup.CH_ORDER])
    return out


def order_values(ch) -> np.ndarray:
    """The port's channels (a copy) with CH_ORDER decoded to the JAX
    package's f32 draw-order values, which are exact below 2^24."""
    out = np.array(np_of(ch))
    out[..., tsetup.CH_ORDER] = out[..., tsetup.CH_ORDER].view(np.int32)
    return out


def plane_errors(got, want):
    """Per row, the largest plane error relative to the plane's magnitude
    over the evaluation domain (f64)."""
    W, H = FB_W + 128.0, FB_H + 128.0
    g, w = got.astype(np.float64), want.astype(np.float64)
    rel = np.zeros(len(w))
    for p in PLANES:
        err = (np.abs(g[:, p] - w[:, p]) * W
               + np.abs(g[:, p + 1] - w[:, p + 1]) * H
               + np.abs(g[:, p + 2] - w[:, p + 2]))
        mag = np.abs(w[:, p]) * W + np.abs(w[:, p + 1]) * H + np.abs(w[:, p + 2])
        rel = np.maximum(rel, err / np.maximum(mag, 1e-30))
    twoa = tsetup.CH_TWOA
    rel = np.maximum(rel, np.abs(g[:, twoa] - w[:, twoa])
                     / np.maximum(np.abs(w[:, twoa]), 1e-30))
    return rel


def check_setup(got, want, name):
    """Rows where the setups disagree (validity, tile bbox, an exact-integer
    channel, or a float plane beyond RTOL) within the MAX_ROW_MISMATCH
    budget; returns the rows both keep."""
    v_g = np_of(got.valid)
    n = len(v_g)   # a padded JAX kernel table is cut to the port's rows
    v_w = np_of(want.valid)[:n]
    ch_g, ch_w = order_values(got.channels), np_of(want.channels)[:n]
    live = v_g & v_w
    rel = np.where(live, plane_errors(ch_g, ch_w), 0.0)
    differ = (v_g != v_w) | (rel > RTOL)
    for a, b in ((got.tile_lo, want.tile_lo), (got.tile_hi, want.tile_hi)):
        differ |= live & (np_of(a) != np_of(b)[:n]).any(axis=1)
    differ |= live & (ch_g[:, EXACT] != ch_w[:, EXACT]).any(axis=1)
    frac = differ.mean()
    print(f"{name}: {differ.sum()} of {n} rows differ ({frac:.3%}); "
          f"largest plane error {rel.max():.2e}")
    assert frac <= MAX_ROW_MISMATCH
    assert rel.max() <= 1e-3
    return live


def test_constants_equal_the_jax_package():
    for name in ("CH_E0", "CH_E1", "CH_TWOA", "CH_Z", "CH_INVW", "CH_UW",
                 "CH_VW", "CH_META", "CH_ORDER", "CH_ZMIN", "NUM_CHANNELS",
                 "META_TEX_BITS", "META_TEX_MASK", "W_EPS", "ZMIN_SLACK_Q"):
        assert getattr(tsetup, name) == getattr(jsetup, name), name
    assert np.float32(tsetup.INV_D16) == np.float32(1.0 / 65535.0)


def test_transform_corner_table_matches_jax():
    rng = np.random.default_rng(3)
    corner, draw, _, _, mvps = rand_scene(rng, 500, 5)
    want, want_uv = jsetup.transform_corner_table(
        jnp.asarray(corner), jnp.asarray(draw), jnp.asarray(mvps))
    got, got_uv = tsetup.transform_corner_table(
        t(corner), t(draw), t(mvps.reshape(5, 16)))
    h = np.concatenate([corner[..., :3], np.ones((500, 3, 1))], axis=-1)
    # each clip coordinate within 1e-6 of the sum of its terms' magnitudes
    mag = np.einsum("tij,tcj->tci", np.abs(mvps[draw]), np.abs(h))
    assert (np.abs(got.numpy() - np.asarray(want)) <= 1e-6 * mag).all()
    np.testing.assert_array_equal(got_uv.numpy(), np.asarray(want_uv))


def test_setup_triangles_matches_jax():
    rng = np.random.default_rng(5)
    corner, draw, tex, valid, mvps = rand_scene(rng, 700, 5)
    h = np.concatenate([corner[..., :3], np.ones((700, 3, 1), np.float32)],
                       axis=-1)
    clip = np.einsum("tij,tcj->tci", mvps[draw], h).astype(np.float32)
    uv = corner[..., 3:5]
    want = jsetup.setup_triangles(
        jnp.asarray(clip), jnp.asarray(uv), jnp.asarray(tex),
        jnp.asarray(valid), jnp.asarray(VIEWPORT), jnp.asarray(SCISSOR),
        **DIMS)
    got = tsetup.setup_triangles(t(clip), t(uv), t(tex), t(valid), VIEWPORT,
                                 SCISSOR, **DIMS)
    assert check_setup(got, want, "setup_triangles").sum() > 300


@pytest.mark.parametrize("mode", ["clip", "cull"])
def test_near_plane_pass_matches_jax(mode):
    rng = np.random.default_rng(7)
    corner, draw, tex, valid, mvps = rand_scene(rng, 600, 4, behind_frac=0.1)
    h = np.concatenate([corner[..., :3], np.ones((600, 3, 1), np.float32)],
                       axis=-1)
    clip = np.einsum("tij,tcj->tci", mvps[draw], h).astype(np.float32)
    uv = corner[..., 3:5]
    X = 128
    jfn = jclip.near_clip_triangles if mode == "clip" else \
        jclip.near_cull_triangles
    tfn = tclip.near_clip_triangles if mode == "clip" else \
        tclip.near_cull_triangles
    want = jfn(jnp.asarray(clip), jnp.asarray(uv), jnp.asarray(tex),
               jnp.asarray(valid), extra_cap=X)
    got = tfn(t(clip), t(uv), t(tex), t(valid), extra_cap=X)
    assert int(got.crossings) == int(want.crossings) > 0
    assert int(got.overflow) == int(want.overflow)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.order.numpy(), np.asarray(want.order))
    live = np.asarray(want.valid)
    np.testing.assert_array_equal(got.tex_id.numpy()[live],
                                  np.asarray(want.tex_id)[live])
    # intersection vertices are lerps: a*(1-t)+b*t rounded with or without
    # a fused multiply-add
    np.testing.assert_allclose(got.clip.numpy()[live],
                               np.asarray(want.clip)[live],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.uv.numpy()[live], np.asarray(want.uv)[live],
                               rtol=1e-6, atol=1e-6)


def jax_fused(corner, draw, tex, valid, mvps, D):
    corner18 = jpallas.build_corner18(
        jnp.asarray(corner), jnp.asarray(draw), jnp.asarray(tex),
        jnp.asarray(valid))
    return jpallas.fused_setup(
        corner18, jnp.asarray(mvps.reshape(D, 16)), jnp.asarray(True),
        jnp.asarray(VIEWPORT), jnp.asarray(SCISSOR), draw_cap=D,
        interpret=True, **DIMS)


def test_fused_setup_reference_matches_pallas_kernel():
    rng = np.random.default_rng(11)
    T, D = 700, 5
    corner, draw, tex, valid, mvps = rand_scene(rng, T, D, behind_frac=0.1)
    su_j, crossings_j, crossed_j = jax_fused(corner, draw, tex, valid, mvps,
                                             D)
    su_t, crossings_t, crossed_t = setup_cuda.fused_setup(
        t(corner), t(draw), t(tex), t(valid), t(mvps.reshape(D, 16)), True,
        VIEWPORT, SCISSOR, **DIMS)
    assert setup_cuda.launches == 0   # CPU tensors take the plain version
    assert int(crossings_t) == int(crossings_j) > 0
    np.testing.assert_array_equal(crossed_t.numpy(),
                                  np.asarray(crossed_j)[:T])
    assert check_setup(su_t, su_j, "fused_setup").sum() > 300


@pytest.mark.parametrize("draw_mod", [(1, 0), (2, 1), (3, 2)])
def test_fused_setup_draw_mask_matches_pallas_kernel(draw_mod):
    """The draw mask of a mesh's draws axis: only rows whose draw % n == i
    stay, masked crossers are neither flagged nor counted, and every row
    keeps its global order, as in the JAX kernel (setup_pallas.py:105,
    127)."""
    n, i = draw_mod
    rng = np.random.default_rng(19)
    T, D = 700, 5
    corner, draw, tex, valid, mvps = rand_scene(rng, T, D, behind_frac=0.1)
    corner18 = jpallas.build_corner18(
        jnp.asarray(corner), jnp.asarray(draw), jnp.asarray(tex),
        jnp.asarray(valid))
    su_j, crossings_j, crossed_j = jpallas.fused_setup(
        corner18, jnp.asarray(mvps.reshape(D, 16)), jnp.asarray(True),
        jnp.asarray(VIEWPORT), jnp.asarray(SCISSOR),
        (jnp.int32(n), jnp.int32(i)), draw_cap=D, interpret=True, **DIMS)
    su_t, crossings_t, crossed_t = setup_cuda.fused_setup_reference(
        t(corner), t(draw), t(tex), t(valid), t(mvps.reshape(D, 16)), True,
        VIEWPORT, SCISSOR, draw_mod=draw_mod, **DIMS)
    kept = draw % n == i
    crossers = valid & (corner[:, 0, 2] == -3.0)   # rand_scene's crossers
    assert (crossers & ~kept).any() or n == 1      # some of them masked
    assert int(crossings_t) == int(crossings_j) == int(crossed_t.sum()) > 0
    np.testing.assert_array_equal(crossed_t.numpy(),
                                  np.asarray(crossed_j)[:T])
    assert not (crossed_t.numpy() & ~kept).any()
    assert not (su_t.valid.numpy() & ~kept).any()
    live = check_setup(su_t, su_j, f"fused_setup draw_mod {draw_mod}")
    assert live.sum() > 30
    np.testing.assert_array_equal(
        tsetup.decode_order(su_t.channels[:, tsetup.CH_ORDER]).numpy()[live],
        np.nonzero(live)[0])
    with pytest.raises(ValueError):
        setup_cuda.fused_setup(
            t(corner), t(draw), t(tex), t(valid), t(mvps.reshape(D, 16)),
            True, VIEWPORT, SCISSOR, draw_mod=(n, n), **DIMS)


def test_fused_clip_subset_splice_matches_jax():
    """The hybrid near clip: fed the same kernel output, the port's splice
    rewrites the same parent rows, appends the same extra halves with the
    parent's draw order, and reports the same overflow as the JAX
    version."""
    rng = np.random.default_rng(13)
    T, D, X = 700, 5, 64
    corner, draw, tex, valid, mvps = rand_scene(rng, T, D, behind_frac=0.1)
    su_j, _, crossed_j = jax_fused(corner, draw, tex, valid, mvps, D)
    mvps16 = mvps.reshape(D, 16)
    want, of_j = jpasses._fused_clip_subset(
        su_j, crossed_j, (jnp.asarray(corner), jnp.asarray(draw),
                          jnp.asarray(tex)),
        jnp.asarray(mvps16), jnp.asarray(VIEWPORT), jnp.asarray(SCISSOR),
        MESH_PIPELINE_STATE, X, DIMS)
    N = np.asarray(su_j.valid).shape[0]
    su_in = tsetup.TriangleSetup(
        valid=t(np.asarray(su_j.valid)),
        channels=port_channels(np.asarray(su_j.channels)),
        tile_lo=t(np.asarray(su_j.tile_lo)),
        tile_hi=t(np.asarray(su_j.tile_hi)))
    pad = N - T  # the JAX kernel's table is padded to its block size
    got, of_t = tpasses._fused_clip_subset(
        su_in, t(np.asarray(crossed_j)),
        (t(np.pad(corner, ((0, pad), (0, 0), (0, 0)))),
         t(np.pad(draw, (0, pad))), t(np.pad(tex, (0, pad)))),
        t(mvps16), VIEWPORT, SCISSOR, from_jax(MESH_PIPELINE_STATE), X, DIMS)
    assert int(of_t) == int(of_j) > 0      # more crossers than X
    assert got.channels.shape == tuple(want.channels.shape)
    live = check_setup(got, want, "fused_clip_subset")
    assert live[N:].any()                  # real extra halves
    # both halves of a split carry the parent's draw order
    np.testing.assert_array_equal(
        order_values(got.channels)[live, tsetup.CH_ORDER],
        np.asarray(want.channels)[live, tsetup.CH_ORDER])


def test_setup_lam_matches_jax():
    """The barycentric planes lam[t, i] = (A, B, C) of lambda_i, which the
    lit path interpolates normals with, held like the channel planes: each
    plane's error over the domain within RTOL of its magnitude on 99.5 %
    of the rows both sides keep, and within 1e-3 on all of them."""
    rng = np.random.default_rng(9)
    corner, draw, tex, valid, mvps = rand_scene(rng, 700, 5)
    h = np.concatenate([corner[..., :3], np.ones((700, 3, 1), np.float32)],
                       axis=-1)
    clip = np.einsum("tij,tcj->tci", mvps[draw], h).astype(np.float32)
    uv = corner[..., 3:5]
    want = jsetup.setup_triangles(
        jnp.asarray(clip), jnp.asarray(uv), jnp.asarray(tex),
        jnp.asarray(valid), jnp.asarray(VIEWPORT), jnp.asarray(SCISSOR),
        **DIMS)
    got = tsetup.setup_triangles(t(clip), t(uv), t(tex), t(valid), VIEWPORT,
                                 SCISSOR, **DIMS)
    live = np_of(got.valid) & np_of(want.valid)
    g = np_of(got.lam).astype(np.float64)[live]      # [N, 3, 3]
    w = np_of(want.lam).astype(np.float64)[live]
    W, H = FB_W + 128.0, FB_H + 128.0
    err = (np.abs(g - w) * [W, H, 1.0]).sum(-1).max(-1)
    mag = (np.abs(w) * [W, H, 1.0]).sum(-1).max(-1)
    rel = err / np.maximum(mag, 1e-30)
    assert live.sum() > 300
    assert (rel <= RTOL).mean() >= 1 - MAX_ROW_MISMATCH and rel.max() <= 1e-3
    # the fused path has no attributes to interpolate
    su, _, _ = setup_cuda.fused_setup_reference(
        t(corner), t(draw), t(tex), t(valid), t(mvps.reshape(5, 16)), True,
        VIEWPORT, SCISSOR, **DIMS)
    assert su.lam is None
