"""P2: the port's ``tools/exp_mxu.py`` plain version against the TPU tool's
``_mxu_kernel`` in Pallas interpret mode, on the CPU, at grid 3 and
tile_h 8, for every variant.

* Exact inputs (``exp_mxu.exact_inputs``, one table a layout: lanes k/8,
  the depth plane's slopes k/2^14 and offset k/128): every product and
  partial sum is exact in f32 and in bf16, so every order of summation
  gives the same value and the outputs must be equal (a zero's sign aside:
  a sum over tied winners of -0 is +0 in one order and -0 in another).
* The tool's normal inputs: XLA and PyTorch sum the three products of a
  plane in their own orders, so planes may differ by the rounding of two
  additions; ``exp_mxu.compare`` allows 2^-18 of 3 * max|lane| * 1920 a
  plane (its own lanes' largest |value|), and a depth one D16 step more.
  A plane that close to an edge or a depth bound can give a pixel another
  winner: at most 1 pixel in 10^3 may differ, the others within the bound.
  A fault planted in one plane, beyond that bound, must be reported.
* "default" and split: on the TPU a default-precision product is one bf16
  pass, which rounds both operands to bf16 (nearest even); XLA on the CPU
  ignores the precision.  The tool module's ``jax.lax`` is given a
  ``dot_general`` that rounds both operands to bf16 at precision "default"
  and then multiplies in f32, the TPU's semantics.

Nothing under ``tools/`` is edited.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tyleri_tpu_torch.tools import exp_mxu as M
from test_torch_probes import tool_module

GRID, TILE_H, CHUNK, SEG = 3, 8, 128, 240
GRID_W = M.grid_dims(TILE_H)[0]


def dot_general_bf16_default(lhs, rhs, dimension_numbers, precision=None,
                             preferred_element_type=None, **kw):
    if precision in ("default", jax.lax.Precision.DEFAULT):
        lhs = lhs.astype(jnp.bfloat16).astype(jnp.float32)
        rhs = rhs.astype(jnp.bfloat16).astype(jnp.float32)
    return jax.lax.dot_general(lhs, rhs, dimension_numbers,
                               precision=jax.lax.Precision.HIGHEST,
                               preferred_element_type=preferred_element_type,
                               **kw)


def tpu_tool():
    """The TPU tool, interpreted, whose default-precision products round
    their operands to bf16 as the TPU does."""
    tool = tool_module("exp_mxu")
    lax = types.SimpleNamespace(**{n: getattr(jax.lax, n)
                                   for n in dir(jax.lax)
                                   if not n.startswith("_")})
    lax.dot_general = dot_general_bf16_default
    tool.jax = types.SimpleNamespace(**{n: getattr(jax, n) for n in dir(jax)
                                        if not n.startswith("_")})
    tool.jax.lax = lax
    return tool


def run_both(tool, ent, ts, name):
    opts = M.options(name, TILE_H)
    want = np.asarray(tool.run_mxu(jnp.asarray(ent.numpy()),
                                   jnp.asarray(ts.numpy()), grid=GRID,
                                   grid_w=GRID_W, chunk=CHUNK, **opts))
    got = M.run_mxu(ent, ts, grid=GRID, grid_w=GRID_W, chunk=CHUNK, **opts)
    assert got.shape == want.shape == (GRID, 8, 128 * TILE_H)
    return got.numpy(), want, opts


@pytest.fixture(scope="module")
def tool():
    return tpu_tool()


@pytest.mark.parametrize("name", sorted(M.VARIANTS))
def test_mxu_reference_equals_the_tpu_kernel_on_exact_inputs(tool, name):
    ent, ts = M.exact_inputs("cpu", grid=GRID, seg=SEG, chunk=CHUNK,
                             split=M.options(name)["split"])
    got, want, opts = run_both(tool, ent, ts, name)
    np.testing.assert_array_equal(got, want)
    if opts["do_red"]:   # winners, some of them tied in depth and order
        assert (got[:, 2] >= 0).mean() > 0.3


@pytest.mark.parametrize("name", sorted(M.VARIANTS))
def test_mxu_reference_matches_the_tpu_kernel_on_the_tools_inputs(tool, name):
    ent, ts, _ = M.tool_inputs("cpu", grid=GRID, seg=SEG, chunk=CHUNK,
                               tile_h=TILE_H)
    got, want, opts = run_both(tool, ent, ts, name)
    share, _ = M.compare(torch.tensor(got), torch.tensor(want), ent, opts,
                         -(-SEG // CHUNK))
    assert share <= M.MAX_DIFFERING, (share, opts)


# the offset lanes of the planes each output reads: every plane's (acc's
# bare min over planes and entries moves only where all of them do), the
# depth plane's, split's depth plane's, an attribute plane's (do_attr) and
# a summed coefficient lane (do_attrc)
@pytest.mark.parametrize("name,lanes,delta", [
    ("fat4_hst", (2, 5, 8, 11), 1.0), ("fat4_def", (2, 5, 8, 11), 1.0),
    ("red", (11,), 0.5), ("ew", (11,), 0.5), ("fatsplitred", (57,), 0.5),
    ("full", (14,), 1.0), ("fatfullc", (14,), 1.0)])
def test_mxu_compare_reports_a_plane_offset(name, lanes, delta):
    """A fault planted in the planes, small beside their magnitude (|a x|
    ~ 10^2..10^3 on the tool's table) but beyond the tolerance, is
    reported as more than MAX_DIFFERING of the pixels."""
    ent, ts, _ = M.tool_inputs("cpu", grid=GRID, seg=SEG, chunk=CHUNK,
                               tile_h=TILE_H)
    opts = M.options(name, TILE_H)
    kw = dict(grid=GRID, grid_w=GRID_W, chunk=CHUNK, **opts)
    bad = ent.clone()
    bad[:, list(lanes)] += delta
    share, _ = M.compare(M.mxu_reference(bad, ts, **kw),
                         M.mxu_reference(ent, ts, **kw), ent, opts,
                         -(-SEG // CHUNK))
    assert share > M.MAX_DIFFERING, share


# ---- the kernel's packed formulation (csrc/probes_mxu.cu), on the CPU ----

def cvt_rna_tf32(x):
    """``cvt.rna.tf32.f32``: 10 mantissa bits, to nearest, ties away from
    zero (the magnitude's bits plus half of the dropped 13, truncated)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x):
    big = cvt_rna_tf32(x)
    return big, cvt_rna_tf32(x - big)


def packed_operands(rows, gx, gy, tile_h, nplanes, mode):
    """The kernel's operands for one tile: A [PX, k] (a pixel's row) and B
    [C, nplanes, k] (the column of each entry and plane), one k-block a
    plane holding only that plane's rows: "highest" k8 of 3xTF32
    (xb, yb, 1, xs, ys, xb, yb, 1) against (ab, bb, cb, ab, bb, as, bs, cs);
    "default" bf16 (x, y, 1, 0...) against (a, b, c, 0...) in k16; split
    the 15 split-coordinate rows and a zero row against lanes
    15p..15p+14 and a zero lane."""
    PX = M.TILE_W * tile_h
    xf, yf = (v[0] for v in M._coords(gx, gy, tile_h, PX, "cpu"))
    one, zero = torch.ones(PX), torch.zeros(PX)
    if mode == "highest":
        (xb, xs), (yb, ys) = split_tf32(xf), split_tf32(yf)
        a = torch.stack([xb, yb, one, xs, ys, xb, yb, one], -1)
        cols = []
        for p in range(nplanes):
            (ab, as_), (bb, bs), (cb, cs) = (split_tf32(rows[:, 3 * p + i])
                                             for i in range(3))
            cols.append(torch.stack([ab, bb, cb, ab, bb, as_, bs, cs], -1))
        return a, torch.stack(cols, 1)
    if mode == "default":
        a = torch.stack([M._bf16(xf), M._bf16(yf), one] + [zero] * 13, -1)
        b = torch.zeros((rows.shape[0], nplanes, 16))
        for p in range(nplanes):
            b[:, p, :3] = M._bf16(rows[:, 3 * p:3 * p + 3])
        return a, b

    def hi(v):
        return (v * 0.0625).to(torch.bfloat16).to(torch.float32) * 16.0

    xhi, yhi = hi(xf), hi(yf)
    xlo, ylo = xf - xhi, yf - yhi
    a = torch.stack([xhi, xlo] * 3 + [yhi, ylo] * 3 + [one] * 3 + [zero], -1)
    b = torch.zeros((rows.shape[0], nplanes, 16))
    for p in range(nplanes):
        b[:, p, :15] = M._bf16(rows[:, 15 * p:15 * p + 15])
    return a, b


def reference_planes(rows, gx, gy, tile_h, nplanes, split, bf16):
    """The planes [C, nplanes, PX] as ``mxu_reference`` computes them: the
    chunk's lanes against ``_rhs``, both rounded to bf16 where it rounds
    them."""
    lhs = rows[:, :64 if split else M.K]
    rhs = M._rhs(gx, gy, tile_h, nplanes, split)[0]
    if bf16:
        lhs, rhs = M._bf16(lhs), M._bf16(rhs)
    return (lhs @ rhs).reshape(rows.shape[0], nplanes, -1)


# split has 15 rows a plane in the table's 64 lanes: 4 planes only
@pytest.mark.parametrize("mode,nplanes", [
    ("highest", 4), ("highest", 7), ("default", 4), ("default", 7),
    ("split", 4)])
@pytest.mark.parametrize("table", ["exact", "tool"])
def test_packed_products_give_the_reference_planes(mode, nplanes, table):
    """A * B^T a plane equals the planes the plain version computes bit for
    bit on the exact table (every product and partial sum exact), and is
    within ``compare``'s plane tolerance (2^-18 of the plane's magnitude)
    on the tool's table, where "highest" drops small * small and each sum
    rounds in its own order; for two tiles, the far corner's included."""
    split = mode == "split"
    tile_h = 16
    if table == "exact":
        ent, _ = M.exact_inputs("cpu", grid=2, seg=SEG, chunk=CHUNK,
                                split=split)
    else:
        ent, _, _ = M.tool_inputs("cpu", grid=2, seg=SEG, chunk=CHUNK,
                                  tile_h=tile_h)
    rows = ent[:CHUNK]
    grid_w, grid_h = M.grid_dims(tile_h)
    n = 15 if split else 3
    tol = torch.tensor([M.REL_TOL * M._plane_mag(ent, p * n, n)
                        for p in range(nplanes)])[None, :, None]
    for t in (0, grid_w * grid_h - 1):
        gx, gy = torch.tensor([t % grid_w]), torch.tensor([t // grid_w])
        a, b = packed_operands(rows, gx, gy, tile_h, nplanes, mode)
        got = torch.einsum("xk,cpk->cpx", a, b)
        want = reference_planes(rows, gx, gy, tile_h, nplanes, split,
                                mode != "highest")
        if table == "exact":
            assert torch.equal(got, want)
        else:
            assert ((got - want).abs() <= tol).all(), (
                float(((got - want).abs() / tol).max()))


def test_cvt_rna_tf32_rounds_ties_away_from_zero():
    """1 + 2^-11 is halfway between two TF32 values: away from zero, in
    either sign; just below half rounds down."""
    x = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12,
                      3.0, 1919.5], dtype=torch.float32)
    got = cvt_rna_tf32(x)
    assert got.tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0, 3.0,
                            1920.0]
