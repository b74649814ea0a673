"""P3: the port's ``tools/exp_visibility.py`` plain versions against the
TPU tool's ``_variant_kernel`` and ``_packed_kernel`` in Pallas interpret
mode, on the CPU.

The table (``tests/torch_probe_tables.py``) is random but snapped, so every
plane is exact in f32 whatever the order of evaluation (XLA on the CPU
contracts ``a * x + b`` into a fused multiply-add, PyTorch does not): maps
must be bit-equal, owner ids included.  Its segments start off the chunk
grid, some are empty, the last ends near the table's end (where the chunk
clamp re-reads rows), and whole-tile entries make the early exit fire.

Nothing under ``tools/`` is edited: the tool module gets a ``pl`` whose
``pallas_call`` interprets.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tyleri_tpu_torch import _build
from tyleri_tpu_torch.tools import exp_visibility as V
from test_torch_probes import t, tool_module
from torch_probe_tables import FB_H, FB_W, inputs

SCISSOR = np.asarray([0, 0, FB_W, FB_H], np.int32)


def assert_maps_equal(got, want):
    assert len(got) == len(want) == 7
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.shape == w.shape and g.numpy().dtype == w.dtype, i
        np.testing.assert_array_equal(g.numpy(), w, f"map {i}")


CASES = {
    "base": {}, "lex": dict(lex=True), "exit": dict(exit=True),
    "exit_lag2": dict(exit=True, lag2=True),
    "strip": dict(strip_attrs=True), "hoist": dict(hoist_loads=True),
    "e2_stored": dict(exit=True, e2_stored=True),
    "chunk256": dict(chunk=256), "tile_h8": dict(tile_h=8),
    "tile_h32": dict(tile_h=32),
}
TPU_NAMES = dict(exit="exit_test", strip_attrs="strip_attrs",
                 hoist_loads="hoist_loads")


@pytest.mark.parametrize("case", sorted(CASES))
def test_variant_reference_matches_the_tpu_kernel(case):
    kw = dict(CASES[case])
    tile_h, chunk = kw.pop("tile_h", 16), kw.pop("chunk", 128)
    tab, ts, depth0, grid_w, grid_h = inputs(len(case), tile_h)
    if kw.get("e2_stored"):
        tab = V.refill_e2(t(tab)).numpy()
    tool = tool_module("exp_visibility")
    dims = dict(tile_w=128, tile_h=tile_h, grid_w=grid_w, grid_h=grid_h)
    want = tool.run_variant(
        jnp.asarray(tab), jnp.asarray(ts), jnp.zeros((), jnp.int32),
        jnp.asarray(depth0), jnp.asarray(SCISSOR), fb_w=FB_W, fb_h=FB_H,
        chunk=chunk, unroll=4,
        strip_attrs=kw.get("strip_attrs", False),
        hoist_loads=kw.get("hoist_loads", False),
        cond_dma=kw.get("exit", False),
        **{TPU_NAMES.get(k, k): v for k, v in kw.items()
           if k not in ("strip_attrs", "hoist_loads")}, **dims)
    got, nres = V.variant_reference(t(tab), t(ts), t(depth0), SCISSOR,
                                    chunk=chunk, **dims, **kw)
    assert_maps_equal(got, want)
    if not kw.get("hoist_loads"):   # (hoisted, most tiles read a dead row)
        assert (got[0].numpy() >= 0).mean() > 0.2
    # the resolved entries: every live one without an exit, fewer with it
    seg = int(ts[-1] - ts[0])
    assert (int(nres.sum()) < seg) if kw.get("exit") else \
        (int(nres.sum()) >= seg)


def test_run_variant_on_the_cpu_is_the_plain_version():
    tab, ts, depth0, grid_w, grid_h = inputs(3, 16)
    _build.reset_launches()
    got, nres = V.run_variant(t(tab), t(ts), t(depth0), SCISSOR, lex=True)
    want, want_nres = V.variant_reference(
        t(tab), t(ts), t(depth0), SCISSOR, tile_h=16, grid_w=grid_w,
        grid_h=grid_h, chunk=128, lex=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(nres, want_nres) and not _build.launches


def test_pack5_matches_the_tpu_tool():
    tool = tool_module("exp_visibility")
    tab = np.random.default_rng(5).standard_normal((1603, 24)).astype(
        np.float32)
    want = np.asarray(tool.pack5(jnp.asarray(tab)))
    got = V.pack5(t(tab))
    assert got.shape == want.shape == (321 + 26, 128)
    np.testing.assert_array_equal(got.numpy(), want)


def packed_tool():
    """The TPU tool with the global its packed kernel reads (R8)."""
    tool = tool_module("exp_visibility")
    tool.e2_stored = False
    return tool


@pytest.mark.parametrize("mode", ["exit", "noexit", "lag2"])
def test_packed_reference_matches_the_tpu_kernel(mode):
    tab, ts, depth0, grid_w, grid_h = inputs(11, 16)
    exit, lag2 = mode != "noexit", mode == "lag2"
    tool = packed_tool()
    packed = V.pack5(t(tab))
    want = tool.run_packed(
        jnp.asarray(packed.numpy()), jnp.asarray(ts), jnp.zeros((), jnp.int32),
        jnp.asarray(depth0), jnp.asarray(SCISSOR), fb_w=FB_W, fb_h=FB_H,
        tile_w=128, tile_h=16, grid_w=grid_w, grid_h=grid_h, exit_test=exit,
        lag2=lag2)
    got, nres = V.packed_reference(packed, t(ts), t(depth0), SCISSOR,
                                   tile_h=16, grid_w=grid_w, grid_h=grid_h,
                                   exit=exit, lag2=lag2)
    assert_maps_equal(got, want)
    # the exit skips entries; two chunks back, less often
    seg = int(ts[-1] - ts[0])
    assert int(nres.sum()) <= seg and (int(nres.sum()) < seg) == (
        mode == "exit")


def test_packed_kernel_reads_an_undefined_e2_stored():
    """R8: the TPU tool's _packed_kernel tests ``if e2_stored:`` in its
    resolve, a name that is neither its parameter nor a module global, so
    every packed5 variant raises when traced."""
    tab, ts, depth0, grid_w, grid_h = inputs(11, 16)
    tool = tool_module("exp_visibility")
    assert not hasattr(tool, "e2_stored")
    with pytest.raises(NameError, match="e2_stored"):
        tool.run_packed(
            jnp.asarray(V.pack5(t(tab)).numpy()), jnp.asarray(ts),
            jnp.zeros((), jnp.int32), jnp.asarray(depth0),
            jnp.asarray(SCISSOR), fb_w=FB_W, fb_h=FB_H, tile_w=128,
            tile_h=16, grid_w=grid_w, grid_h=grid_h)


def test_ptxas_report_names_each_instance():
    """The build keeps ptxas's report; each kernel instance is named with
    its template arguments (P3's registers by tile height, PERF.md)."""
    from tyleri_tpu_torch import _build

    sym = ("_ZN53_GLOBAL__N__9da35aca_20_probes_visibility_cu_dab9b320"
           "14variant_kernelILi32ELi4ELb0ELi0ELb0ELb0ELb0ELb0EEEvNS_6ParamsE")
    text = (f"ptxas info    : 0 bytes gmem\n"
            f"ptxas info    : Compiling entry function '{sym}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {sym}\n"
            f"    0 bytes stack frame, 472 bytes spill stores, 472 bytes "
            f"spill loads\n"
            f"ptxas info    : Used 255 registers, used 1 barriers\n"
            f"ptxas info    : Compiling entry function "
            f"'_Z18fused_setup_kernelPKfPKiS2_' for 'sm_90a'\n"
            f"ptxas info    : Function properties for "
            f"_Z18fused_setup_kernelPKfPKiS2_\n"
            f"    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
            f"loads\n"
            f"ptxas info    : Used 40 registers, used 0 barriers\n")
    found = _build.parse_ptxas(text)
    assert found == {sym: (255, 472),
                     "_Z18fused_setup_kernelPKfPKiS2_": (40, 0)}
    assert _build.demangle(list(found)) == [
        "variant_kernel<32, 4, false, 0, false, false, false, false>",
        "fused_setup_kernel"]


def test_library_key_covers_the_shared_header(tmp_path, monkeypatch):
    """csrc/tile_order.cuh is compiled into K3's and P3's objects: an edit
    to it alone must build a new library, not load the old one."""
    from tyleri_tpu_torch import _build

    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    header = tmp_path / "h.cuh"
    header.write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    before = _build.library_path()
    header.write_text("// two\n")
    assert _build.library_path() != before
    assert _build._sources() == [str(tmp_path / "a.cu")]
