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
