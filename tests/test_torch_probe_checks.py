"""The P6 and P1 wrappers' argument checks, P1's staged-bytes figure and
the tools' jumbled tile starts, on the CPU.

The checks (``check_kernel_inputs``) guard what the kernels need: the bulk
copies and the 16-byte loads want 16-byte aligned tables, entries and
depths, and rows of a multiple of 4 floats.  On the card the wrappers run
them before every launch (tests/test_torch_kernels.py); they look only at
dtypes, shapes and addresses, so they run on CPU tensors too.
"""

import numpy as np
import pytest
import torch

from tyleri_tpu_torch.tools import _common, exp_fixedcost, exp_pipecost


def shifted(t):
    """A copy of ``t`` 4 bytes off the 16-byte grid."""
    out = torch.empty(t.numel() + 1)[1:].view(t.shape)
    assert out.data_ptr() % 16
    return out.copy_(t)


def p6_inputs():
    return (torch.rand((256, 24)), exp_fixedcost.jumbled_starts("cpu", E=256),
            torch.rand((1080, 1920)))


P6_BAD = {
    "table_off_grid": (lambda t, s, d: (shifted(t), s, d, 7), "aligned"),
    "depth_off_grid": (lambda t, s, d: (t, s, shifted(d), 7), "aligned"),
    "rows_of_22": (lambda t, s, d: (t[:, :22].contiguous(), s, d, 7),
                   "multiple of 4"),
    "table_f64": (lambda t, s, d: (t.double(), s, d, 7), "table"),
    "starts_i64": (lambda t, s, d: (t, s.long(), d, 7), "tile_start"),
    "depth_strided": (lambda t, s, d: (t, s, d.t().contiguous().t(), 7),
                      "depth0"),
    "n_out_8": (lambda t, s, d: (t, s, d, 8), "n_out"),
}


@pytest.mark.parametrize("case", sorted(P6_BAD))
def test_fixed_cost_checks_raise(case):
    make, match = P6_BAD[case]
    with pytest.raises(ValueError, match=match):
        exp_fixedcost.check_kernel_inputs(*make(*p6_inputs()))


@pytest.mark.parametrize("n_out", [1, 7])
def test_fixed_cost_checks_pass_the_tool_shapes(n_out):
    exp_fixedcost.check_kernel_inputs(*p6_inputs(), n_out)


def p1_inputs():
    ntiles = (exp_pipecost.FRAME_H // exp_pipecost.TILE) * (
        exp_pipecost.FRAME_W // exp_pipecost.TILE)
    return torch.rand((1000, 24)), torch.zeros(ntiles + 1, dtype=torch.int32)


P1_BAD = {
    "entries_off_grid": (lambda e, s: (shifted(e), s, {}), "aligned"),
    "rows_of_22": (lambda e, s: (e[:, :22].contiguous(), s, {}), "aligned"),
    "fewer_rows_than_a_window": (lambda e, s: (e[:63], s, {}), "E >= 64"),
    "starts_short": (lambda e, s: (e, s[:-1], {}), "tile_start"),
    "tpp_3": (lambda e, s: (e, s, dict(tpp=3)), "tpp"),
    "nout_8": (lambda e, s: (e, s, dict(nout=8)), "nout"),
    "level_3": (lambda e, s: (e, s, dict(level=3)), "level"),
}


@pytest.mark.parametrize("case", sorted(P1_BAD))
def test_pipe_cost_checks_raise(case):
    make, match = P1_BAD[case]
    entries, ts, kw = make(*p1_inputs())
    with pytest.raises(ValueError, match=match):
        exp_pipecost.check_kernel_inputs(
            entries, ts, **{**dict(nout=7, level=2, tpp=1), **kw})


@pytest.mark.parametrize("tpp", [1, 2, 4, 17, 68])
def test_pipe_cost_checks_pass_every_tpp_that_divides_68(tpp):
    exp_pipecost.check_kernel_inputs(*p1_inputs(), nout=7, level=2, tpp=tpp)


def test_staged_bytes_by_hand():
    """ts_one gives each of the 68 x 120 tiles one window of 64 rows of 24
    f32 (6,144 bytes); ts_zero none.  The floor adds those bytes to the
    bound's: 7 maps of 1088 x 1920 f32 and, at level 2, the 8,161 tile
    starts and a scalar a chunk."""
    entries, ts_zero, ts_one = exp_pipecost.tool_inputs("cpu")
    tiles = 68 * 120
    assert exp_pipecost.staged(ts_one, nout=7, level=2)["staged_bytes"] \
        == tiles * 64 * 24 * 4 == 50_135_040
    assert exp_pipecost.staged(ts_zero, nout=7, level=2)[
        "staged_bytes"] == 0
    assert exp_pipecost.staged(ts_one, nout=7, level=0)["staged_bytes"] == 0
    maps = 7 * 1088 * 1920 * 4
    floor = exp_pipecost.staged(ts_one, nout=7, level=2)["staged_floor_ms"]
    assert floor == (maps + 4 * (8161 + tiles) + 50_135_040) / 3.35e12 * 1e3
    assert abs(floor - 0.0324) < 5e-5
    # the bound's own definition is unchanged: the maps, the starts and a
    # scalar a chunk
    assert exp_pipecost.pipe_cost_bound(ts_one, 7, 2)["bytes"] \
        == maps + 4 * (8161 + tiles)


def test_the_tool_reports_the_staged_bytes(monkeypatch, capsys):
    """run_variants' lines carry staged_bytes and staged_floor_ms: the
    hand count for v_loop1 and v_loop1_tpp4, none for the variants on
    ts_zero or below level 2 (the timing is stubbed: only the records
    are read)."""
    monkeypatch.setattr(_common, "timing", lambda fn, device, reps: {
        "host_ms": 1.0})
    recs = {r["variant"]: r for r in exp_pipecost.run_variants(
        torch.device("cpu"), 1)}
    capsys.readouterr()
    for name, rec in recs.items():
        want = 50_135_040 if exp_pipecost.VARIANTS[name]["ts"] == "one" \
            else 0
        assert rec["staged_bytes"] == want, name
        assert rec["staged_floor_ms"] >= rec["bound_ms"]


def test_jumbled_starts_cover_the_cases():
    """Each tool's jumbled tile starts give CTAs of 8 tiles both empty
    tiles and tiles of several trips, starts off the chunk grid, P6 bases
    in the short last chunk and P1 windows clamped at the table's end."""
    ts = exp_fixedcost.jumbled_starts("cpu").numpy().astype(np.int64)
    start, end = ts[:-1], ts[1:]
    base = start - start % 128
    n = np.where(end > start, -(-(end - base) // 128), 0).reshape(68, 15, 8)
    assert ((n == 0).any(2) & (n > 1).any(2)).mean() > 0.9
    assert (start % 128 != 0).mean() > 0.9
    assert ((n.ravel() > 0) & (base >= 896)).any()
    ts = exp_pipecost.jumbled_starts("cpu").numpy().astype(np.int64)
    start, end = ts[:-1], ts[1:]
    n = np.where(end > start, -(-(end - start) // 64), 0)
    last = start + (n - 1) * 64
    assert ((n > 0) & (last > 1000 - 64)).sum() > 100
    assert n.max() == 16
