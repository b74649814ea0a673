"""The port's probe tools (tyleri_tpu_torch/tools/) against the JAX
package's TPU tools, on the CPU.

Each TPU tool's kernel runs in Pallas interpret mode, on the same numpy
inputs as the port's plain version.  Nothing under ``tools/`` is edited:
a tool module gets a ``pl`` whose ``pallas_call`` interprets, and where a
tool runs its timings when imported (``exp_binning.py``) or inside the
function that builds the kernel (``exp_fixedcost.probe_launch``), only the
needed functions are compiled out of its source.  The plain versions take
the TPU tools' tile shapes here (16 x 128); the kernels' 16x16 tiles are
held to the same plain versions on the card (tests/test_torch_kernels.py).
"""

import ast
import functools
import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tyleri_tpu_torch import _build
from tyleri_tpu_torch.tools import (
    exp_binning,
    exp_fixed_grid,
    exp_fixedcost,
    exp_mosaic_probe,
    exp_mxu,
    exp_pipecost,
    exp_visibility,
)
from torch_probe_tables import depth_with_hot_blocks

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")

# pl with an interpreting pallas_call
PL_INTERPRET = types.SimpleNamespace(
    **{n: getattr(pl, n) for n in dir(pl) if not n.startswith("_")})
PL_INTERPRET.pallas_call = functools.partial(pl.pallas_call, interpret=True)


def tool_module(name):
    """A TPU tool imported from its file, its kernels interpreted."""
    spec = importlib.util.spec_from_file_location(
        f"tpu_tool_{name}", os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = PL_INTERPRET
    return mod


def tool_functions(name, *funcs, **names):
    """Only the named functions (nested ones too) of a TPU tool's source,
    compiled with ``names`` as their globals."""
    path = os.path.join(TOOLS, f"{name}.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    body = [n for n in ast.walk(tree)
            if isinstance(n, ast.FunctionDef) and n.name in funcs]
    assert sorted(n.name for n in body) == sorted(funcs)
    ns = dict(jax=jax, jnp=jnp, pl=PL_INTERPRET, pltpu=pltpu, **names)
    exec(compile(ast.Module(body=body, type_ignores=[]), path, "exec"), ns)
    return ns


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------- P4

def sequential_sum(v):
    s = np.float32(0.0)
    for x in v.astype(np.float32):
        s = np.float32(s + x)
    return s


def test_gather_last_chunk_sum_equals_the_tpu_kernel():
    """The TPU kernel keeps the last chunk's sum of table[id, 0] in its
    [8, 128] output; run_gather's is the same f32 value."""
    T, E = 4096, 8192
    ns = tool_functions("exp_binning", "gather_kernel", "run_gather",
                        T=T, E=E, CHUNK=1024, RING=8)
    rng = np.random.default_rng(0)
    ids = np.sort(rng.integers(0, T, E).astype(np.int32))
    table = rng.random((T, 32), dtype=np.float32)
    want = np.asarray(ns["run_gather"](jnp.asarray(ids), jnp.asarray(table)))
    got = exp_binning.run_gather(t(ids), t(table))
    assert got.shape == want.shape == (8, 128) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0, 0] == sequential_sum(table[ids[-1024:], 0])


@pytest.mark.parametrize("C,E,sort", [(32, 8192, True), (24, 5000, False)])
def test_gather_rows_and_every_chunk_sum(C, E, sort):
    """Rows bit-equal to table[ids]; every chunk's sum (the tail chunk
    shorter) equal to the sequential f32 sum in id order."""
    rng = np.random.default_rng(1)
    T = 3000
    ids = rng.integers(0, T, E).astype(np.int32)
    ids = np.sort(ids) if sort else ids
    table = rng.standard_normal((T, C), dtype=np.float32)
    _build.reset_launches()
    rows, sums = exp_binning.gather_rows(t(ids), t(table))
    np.testing.assert_array_equal(rows.numpy(), table[ids])
    want = [sequential_sum(table[ids[k:k + 1024], 0])
            for k in range(0, E, 1024)]
    np.testing.assert_array_equal(sums.numpy(), np.asarray(want, np.float32))
    assert _build.launches["gather_rows"] == 0


# ---------------------------------------------------------------- P7

@pytest.mark.parametrize("rows,nouts,zmax", [
    (16, 7, True), (32, 7, True), (128, 7, True), (16, 3, True),
    (16, 7, False), (64, 1, True)])
def test_fixed_grid_matches_the_tpu_kernel(rows, nouts, zmax):
    tool = tool_module("exp_fixed_grid")
    depth = depth_with_hot_blocks(rows + nouts)
    want = tool.build(rows, nouts=nouts, zmax_reduce=zmax)(jnp.asarray(depth))
    got = exp_fixed_grid.fixed_grid(t(depth), rows, nouts, zmax)
    assert len(got) == len(want) == nouts
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.shape == w.shape, i
        np.testing.assert_array_equal(g.numpy(), w, f"map {i}")
    if zmax:
        # the hot blocks got the +1.0
        assert (got[0].numpy()[:1080] != depth).sum() > rows * 128


# ---------------------------------------------------------------- P6

def segments(rng, ntiles, E, chunk=128):
    """Tile segments of 0 to 3 chunks, starts not chunk-aligned, inside a
    table of E rows (the TPU probe copies a whole chunk from each base)."""
    lens = rng.integers(0, 2 * chunk, ntiles) * (rng.random(ntiles) < 0.7)
    ts = np.concatenate([[5], 5 + np.cumsum(lens)]).astype(np.int32)
    assert ts[-1] + chunk <= E
    return ts


@pytest.mark.parametrize("case,n_out", [("empty", 7), ("empty", 3),
                                        ("empty", 1), ("segments", 7),
                                        ("segments", 3)])
def test_fixed_cost_matches_the_tpu_kernel(case, n_out):
    tool = tool_module("exp_fixedcost")
    rng = np.random.default_rng(n_out)
    ntiles = tool.GRID_H * tool.GRID_W
    E = 1 << 17
    table = rng.random((E, 24), dtype=np.float32)
    ts = (np.zeros(ntiles + 1, np.int32) if case == "empty"
          else segments(rng, ntiles, E))
    depth0 = rng.random((1080, 1920), dtype=np.float32)
    want = tool.run(jnp.asarray(table), jnp.asarray(ts), jnp.asarray(depth0),
                    n_out=n_out, do_pad=True)
    got = exp_fixedcost.fixed_cost_reference(
        t(table), t(ts), t(depth0), n_out=n_out, chunk=tool.CHUNK,
        tile_w=tool.TILE_W, tile_h=tool.TILE_H)
    assert len(got) == len(want) == n_out
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), f"map {i}")
    if case == "segments":
        assert (got[-1].numpy() > 0).any()


@pytest.mark.parametrize("shape", [(1, 1, 8, 128), (17, 15, 64, 128),
                                   (68, 15, 8, 128)])
def test_launch_probe_matches_the_tpu_kernel(shape):
    ns = tool_functions("exp_fixedcost", "mk")
    x = np.float32(0.25)
    want = np.asarray(ns["mk"](*shape)(jnp.asarray(x)))
    got = exp_fixedcost.probe_launch_fn(*shape)(torch.tensor(x))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------- P1

def pipe_inputs(rng, kind, e_cap=1 << 14, chunk=128):
    ntiles = exp_pipecost.GRID_H * exp_pipecost.GRID_W
    ent = rng.standard_normal((e_cap, 128), dtype=np.float32)
    if kind == "zero":
        ts = np.zeros(ntiles + 1, np.int32)
    elif kind == "one":   # the tool's ts_one: one chunk per tile
        ts = np.minimum(np.arange(ntiles + 1) * chunk, e_cap).astype(np.int32)
    else:                 # 0 to 3 chunks, some windows clamped at the end
        lens = rng.integers(0, 3 * chunk, ntiles) * (rng.random(ntiles) < 0.6)
        ts = np.minimum(np.concatenate([[0], np.cumsum(lens)]),
                        e_cap).astype(np.int32)
    return ent, ts


def fma_tolerance(ent, ts, nout, chunk=128):
    """XLA on the CPU contracts ``s + (c0 * xf) * r`` into a fused
    multiply-add; PyTorch (and the kernel, built with -fmad=false) rounds
    the product first.  Per chunk the two may then differ by one rounding of
    the product and one of the sum, each at most 2^-23 of the magnitude; the
    bound allows twice that per chunk, on the magnitude the plain version
    gives for |entries|: i + sum |c0| * xf * r + (chunks outside the
    scissor)."""
    mag = exp_pipecost.pipe_cost_reference(
        t(np.abs(ent)), t(ts), nout=nout, level=2, chunk=chunk,
        tile_w=128, tile_h=16)
    start, end = ts[:-1].astype(np.int64), ts[1:].astype(np.int64)
    n = np.where(end > start, -(-(end - start) // chunk), 0)
    n = n.reshape(exp_pipecost.GRID_H, exp_pipecost.GRID_W, 1, 1)
    return [2 * 2.0 ** -23 * 2 * n * m.numpy() for m in mag]


@pytest.mark.parametrize("level,nout,kind,tpp", [
    (0, 1, "zero", 1), (0, 7, "zero", 4), (1, 7, "zero", 1),
    (2, 7, "zero", 1), (2, 7, "one", 1), (2, 7, "many", 4), (2, 3, "one", 1)])
def test_pipe_cost_matches_the_tpu_kernel(level, nout, kind, tpp):
    tool = tool_module("exp_pipecost")
    rng = np.random.default_rng(level * 10 + nout)
    ent, ts = pipe_inputs(rng, kind)
    want = tool.run(jnp.asarray(ent), jnp.asarray(ts), nout=nout,
                    level=level, chunk=128, tpp=tpp)
    got = exp_pipecost.pipe_cost_reference(
        t(ent), t(ts), nout=nout, level=level, chunk=128,
        tile_w=tool.TILE_W, tile_h=tool.TILE_H)
    assert len(got) == len(want) == nout
    tol = fma_tolerance(ent, ts, nout) if level == 2 else [0.0] * nout
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape == (68, 15, 16, 128)
        assert (np.abs(g - w) <= tol[i]).all(), f"map {i}"
        assert (g == w).mean() > 0.95, f"map {i}"


# ---------------------------------------------------------------- entry points

# the tools whose full width is a sponza frame or a 1080p grid of tables
# run here at a reduced size (their docstrings' options)
SMALL = {exp_visibility: ["--grid-n", "8", "--resolution", "128x32"],
         exp_mxu: ["--grid", "3", "--tile-h", "8", "--seg", "240"]}


@pytest.mark.parametrize("tool", [exp_binning, exp_fixed_grid, exp_fixedcost,
                                  exp_pipecost, exp_visibility, exp_mxu,
                                  exp_mosaic_probe])
def test_entry_point_needs_a_card_or_cpu(tool, capsys, monkeypatch):
    """Without a card the tool raises; with --device cpu it runs the plain
    versions (at full width, or at the reduced size of ``SMALL``) and
    prints one JSON line per variant, with a host time and no device
    time."""
    import json

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tool.main([])
    _build.reset_launches()
    # one intra-op thread: the plain versions' ops are many and small, and
    # beside other busy processes each parallel region waits for threads
    # they hold (exp_visibility: 3 s alone, 245 s beside five test
    # processes of 8 threads each on 8 cores, 31 s on one thread there)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert tool.main(["--device", "cpu", "--reps", "1",
                          *SMALL.get(tool, [])]) == 0
    finally:
        torch.set_num_threads(threads)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert len(lines) == len(tool.VARIANTS) + len(
        getattr(tool, "LAUNCH_VARIANTS", {})) + (tool is exp_mxu)
    for rec in lines:
        assert rec["device"] == "cpu" and rec["card"] is None
        assert "ms" not in rec and rec["host_ms"] > 0
        assert rec["bound_ms"] > 0 and rec["bound_by"] in (
            "bytes", "operations", "tensor")
    assert not _build.launches
