"""The benchmark's scanned-statue configuration (``lucy-28m-1080p``, drawn
by ``benchmark/scenes/lucy.py``) at a small size on the CPU: the surface is
closed and wound outward with the counts the configuration states, the port
draws it through ``RenderWindow`` as the benchmark's harness drives it and
agrees with the benchmark's plain reference within the cell's own limits,
and the window counts binning's work once a reported frame."""

import json
import os
import shutil

import numpy as np
import pytest

from benchmark import harness, spec
from benchmark.scenes import lucy
from tyleri_tpu_torch.rendering import forward
from tyleri_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "lucy-28m-1080p.orbit"
SEED = 2**31 + 21
# 31,680 triangles at 320 x 180: about four a covered pixel
SMALL = {"cells": [40, 100, 28], "resolution": [320, 180]}


def small_copy(dst) -> str:
    """The checkout's benchmark files in ``dst``, the statue at SMALL and
    its traffic's warm-up, check and trace shortened."""
    dst = str(dst)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for sub, name, edit in (
            ("configs", "lucy-28m-1080p.json",
             lambda c: c["params"].update(SMALL)),
            ("traffic", "orbit.json",
             lambda t: t.update(
                 warmup={"min_frames": 4, "stable_frames": 2,
                         "max_frames": 12},
                 check={"frames": 2}, trace={"slices": 1, "frames": 2}))):
        path = os.path.join(dst, "benchmark", sub, name)
        with open(path) as f:
            data = json.load(f)
        edit(data)
        with open(path, "w") as f:
            json.dump(data, f)
    return dst


@pytest.fixture
def one_layer(monkeypatch):
    """The blend policy's two-layer bound below the small statue's
    triangles: one layer, as the configuration states at its size."""
    monkeypatch.setattr(forward, "BLEND_PARITY_PEEL2_MAX_TRIS", 9000)


def test_statue_is_closed_with_the_stated_counts():
    cfg = spec.cell(CELL).config
    nx, ny, nz = cfg["params"]["cells"]
    quads = 2 * (nx * ny + ny * nz + nz * nx)
    assert 2 * quads == cfg["triangles"] == 28_055_740
    assert quads + 2 == 14_027_872          # the scan's vertex count
    pos, uv, faces = lucy.statue(dict(cfg["params"], **SMALL))
    assert len(pos) == len(faces) // 2 + 2 and len(uv) == len(pos)
    f = faces.astype(np.int64)
    # every directed edge once and its reverse once: closed, wound outward
    directed = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    key = directed[:, 0] * len(pos) + directed[:, 1]
    rev = directed[:, 1] * len(pos) + directed[:, 0]
    assert len(np.unique(key)) == len(key)
    assert np.array_equal(np.sort(key), np.sort(rev))
    # outward: the signed volume is positive, about the box's
    tri = pos[f].astype(np.float64)
    vol = np.einsum("ij,ij->i", tri[:, 0],
                    np.cross(tri[:, 1], tri[:, 2])).sum() / 6
    assert 0.3 < vol < 1.2


def test_small_statue_agrees_with_the_reference(tmp_path, one_layer):
    cell = spec.cell(CELL, small_copy(tmp_path))
    res = harness.measure(cell, SEED, 1.0, False, device_type="cpu")[
        "result"]
    limits = spec.cell(CELL, ROOT).limits["limits"]
    assert res["correct"] and res["attempted"] > 0, res["checks"]
    for k, lim in limits.items():
        assert res["checks"][k]["value"] <= lim


def test_window_counts_binning_work(tmp_path, one_layer):
    cell = spec.cell(CELL, small_copy(tmp_path))
    run = harness.Run(cell, SEED, "cpu")
    with profiling.tracing() as rec:
        for _ in range(4):
            run.frame()
        run.window.flush()
    counts = {}
    for per_frame in rec.counters.values():
        for name, n in per_frame.items():
            counts[name] = counts.get(name, 0) + n
    assert counts["bin.reported"] == len(run.stats) == 4
    # every triangle of the closed surface is live and narrow on screen
    assert counts["bin.live"] == 4 * run.scene.triangle_count
    assert counts["bin.entries"] >= counts["bin.live"]
