"""The check that decides ``correct``, held to what it must catch: the
control (the reference computed with its vertex stage in bfloat16) fails
every cell's limits, and a run whose timed path is broken underneath
comes out not correct, once for each fault a cell can have.  On the CPU
at small sizes (``conftest.TINY``); the limits are the cells' own."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import compare, harness, reference, scene, spec
from benchmark.tests.conftest import ROOT, tiny_copy

SEEDS = (2**31 + 11, 2**31 + 12, 2**31 + 13)
CELLS = ("sponza-1m-1080p.walk", "instances-100-1080p.spin",
         "sponza-1m-1080p.walk-hud256", "sponza-1m-1080p.still")


def _fails(numbers: dict, limits: dict) -> bool:
    return any(numbers[k] > limits[k] for k in limits)


@pytest.mark.parametrize("cell_name", CELLS)
def test_control_fails_the_limits(tmp_path, cell_name):
    cell = spec.cell(cell_name, tiny_copy(tmp_path))
    limits = spec.cell(cell_name, ROOT).limits["limits"]
    for seed in SEEDS:
        sc = scene.generator(cell.config["generator"]).build(
            cell.config["params"], seed)
        ov = cell.traffic["overlay"]
        overlay = (scene.generator(ov["generator"]).build(ov["params"], seed)
                   if ov else None)
        clock = harness.Clock(cell.traffic["time"], seed)
        clock.first = 0  # the window's frame times, from the seed's start
        t = clock(5)
        want = reference.render(sc, sc.frame(t), cell.config, "cpu", overlay)
        low = reference.render(sc, sc.frame(t), cell.config, "cpu", overlay,
                               precision="bf16")
        assert _fails(compare.numbers(low, want), limits), (seed, limits)


def _stale_frame(monkeypatch):
    """Every present shows the frame before it again."""
    from tyleri_tpu_torch.window import render_window

    wait = render_window._InFlight.wait
    last = {}

    def stale(self):
        img, stats = wait(self)
        prev = last.get("img", img)
        last["img"] = img
        return prev, stats

    monkeypatch.setattr(render_window._InFlight, "wait", stale)


def _half_the_triangles(monkeypatch):
    """The setup drops the second half of every frame's triangle table."""
    from tyleri_tpu_torch.rendering import passes

    setup = passes.fused_setup

    def half(corners, tri_draw, tri_tex, tri_valid, *a, **k):
        tri_valid = tri_valid.clone()
        tri_valid[tri_valid.shape[0] // 2:] = False
        return setup(corners, tri_draw, tri_tex, tri_valid, *a, **k)

    monkeypatch.setattr(passes, "fused_setup", half)


def _one_tile_lost(monkeypatch):
    """The visibility resolve loses the tile that most fragments won: no
    fragment owns its pixels."""
    from tyleri_tpu_torch.rendering import passes

    resolve = passes.rasterize_visibility

    def lost(*a, **k):
        out = resolve(*a, **k)
        layers = (out,) if hasattr(out, "owner") else out
        h, w = layers[0].owner.shape
        won = (layers[0].owner[:h // 16 * 16, :w // 16 * 16] >= 0).reshape(
            h // 16, 16, w // 16, 16).sum(dim=(1, 3))
        ty, tx = divmod(int(won.argmax()), w // 16)
        for layer in layers:
            layer.owner[ty * 16:ty * 16 + 16, tx * 16:tx * 16 + 16] = -1
        return out

    monkeypatch.setattr(passes, "rasterize_visibility", lost)


FAULTS = {"stale_frame": _stale_frame,
          "half_the_triangles": _half_the_triangles,
          "one_tile_lost": _one_tile_lost}
# a still camera presents the same frame every time: a stale frame is no
# fault there
CASES = [(c, f) for c in CELLS for f in FAULTS
         if not (f == "stale_frame" and c.endswith(".still"))]


@pytest.mark.parametrize("cell_name,fault", CASES)
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch,
                                            peel2_at_tiny, cell_name, fault):
    cell = spec.cell(cell_name, tiny_copy(tmp_path))
    sound = harness.measure(cell, SEEDS[0], 1.0, False, device_type="cpu")
    assert sound["result"]["correct"], sound["result"]["checks"]
    FAULTS[fault](monkeypatch)
    broken = harness.measure(cell, SEEDS[0], 1.0, False, device_type="cpu")
    assert not broken["result"]["correct"], broken["result"]["checks"]


def test_block_mismatch_reads_one_tile():
    want = np.zeros((96, 160, 4), np.uint8)
    got = want.copy()
    got[16:32, 32:48, 0] = 9
    n = compare.numbers(got, want)
    assert n["block_mismatch"] == 1.0
    assert n["mismatch"] == pytest.approx(256 / (96 * 160))
    got[16:32, 32:48, 0] = 1      # the presentation's rounding
    assert compare.numbers(got, want) == {"mismatch": 0.0,
                                          "block_mismatch": 0.0}
    got[16:32, 32:48, 0] = 8      # an interpolation's rounding
    n = compare.numbers(got, want)
    assert n["block_mismatch"] == 0.0 and n["mismatch"] > 0
